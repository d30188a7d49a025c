"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
only torch and the port (no jax), so it runs on the GPU machine as is:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: K1's planes and K3's correlations are compared bit for bit
(the kernel and the plain version do the same IEEE-rounded ops in the
same order); K2's events, bytes and carry are compared exactly.
"""

import io

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

THR, LIM = 1.5, 2.3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _modem(mode):
    from minimodem_tpu_torch.models.modem import FskModem

    return FskModem(mode, device="cpu")


def _noisy(mode, seed, n_bytes=40):
    rng = np.random.default_rng(seed)
    m = _modem(mode)
    text = rng.integers(32, 127, size=n_bytes, dtype=np.uint8).tobytes()
    wav = m.modulate(text.upper() if mode == "rtty" else text)
    wav = wav + (rng.random(wav.size, dtype=np.float32)
                 - np.float32(0.5)) * np.float32(0.6)
    return m.cfg, wav.astype(np.float32)


@pytest.mark.parametrize("mode", ["1200", "300", "same", "rtty"])
def test_fused_kernel_equals_plain(cuda, mode):
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)

    cfg, wav = _noisy(mode, 1)
    scorer = FusedScorer(geo_from_key(device_rx_key(cfg)))
    t_total = 1 << 17
    x = np.zeros((2, t_total + scorer.geo.halo), np.float32)
    x[0, :min(len(wav), x.shape[1])] = wav[:x.shape[1]]
    x[1] = np.random.default_rng(2).standard_normal(x.shape[1])
    xt = torch.from_numpy(x).to(cuda)
    launches = FusedScorer.launches
    k = scorer(xt, t_total)
    assert FusedScorer.launches == launches + 1
    p = score_planes_plain(xt, scorer.geo, t_total)
    np.testing.assert_array_equal(k.cpu().numpy(), p.cpu().numpy())


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mode", ["1200", "same", "rtty"])
def test_correlate_kernel_equals_plain(cuda, mode, batch):
    """K3 on overlapping chunk rows of one stream (a row stride, no copy),
    as DemodScorer.score_chunks hands them over, equals the plain version
    on the same rows."""
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain
    from minimodem_tpu_torch.ops.demod import geometry_from_config, make_basis

    cfg, wav = _noisy(mode, 5, n_bytes=120)
    geo = geometry_from_config(cfg, "float32")
    t_len = 1 << 14
    s_len = t_len + geo.max_begin
    flat = np.zeros(batch * t_len + geo.halo, np.float32)
    n = min(len(wav), flat.size)
    flat[:n] = wav[:n]
    rows = torch.from_numpy(flat).to(cuda).unfold(0, t_len + geo.halo, t_len)
    assert rows.shape[0] == batch
    corr = Correlator(make_basis(geo, np.float32))
    launches = Correlator.launches + Correlator.batch_launches
    k = corr(rows, s_len)
    assert Correlator.launches + Correlator.batch_launches == launches + 1
    p = correlate_plain(rows, corr.basis(cuda), s_len)
    np.testing.assert_array_equal(k.cpu().numpy().view(np.uint32),
                                  p.cpu().numpy().view(np.uint32))


def _cases():
    m = _modem("1200")
    gap = np.zeros(24000, np.float32)
    yield "gap", m.cfg, np.concatenate(
        [m.modulate(b"first burst"), gap, m.modulate(b"second")]), False
    yield "rx_one", m.cfg, np.concatenate(
        [m.modulate(b"only this"), gap, m.modulate(b"not this")]), True
    for mode in ("1200", "same", "rtty"):
        cfg, wav = _noisy(mode, 3)
        yield mode, cfg, wav, False


@pytest.mark.parametrize("name", ["gap", "rx_one", "1200", "same", "rtty"])
def test_mega_kernel_equals_plain(cuda, name):
    """K2 on the card's K1 planes (a batch of 3 streams of different
    lengths, one thread each) equals the plain K2 on a CPU copy."""
    from minimodem_tpu_torch.ops.device_rx import (
        _collect, _round_up_pow2, device_rx_key, geo_from_key,
        make_score_packer_planes)
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, MegaStatics

    cfg, wav, rx_one = next(c for c in _cases() if c[0] == name)[1:]
    key = device_rx_key(cfg)
    totals = np.asarray([len(wav), len(wav) * 2 // 3, len(wav) // 3],
                        np.int32)
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    packer, _ = make_score_packer_planes(key, t_total, "float32")
    x = np.zeros((3, t_total + geo_from_key(key).halo), np.float32)
    for i, n in enumerate(totals):
        x[i, :n] = wav[:n]
    planes = packer(torch.from_numpy(x).to(cuda))
    mega = MegaRx(MegaStatics.build(key, t_total, rx_one))
    ci = torch.zeros((3, 8), dtype=torch.int32)
    cf = torch.zeros((3, 4), dtype=torch.float32)
    tt = torch.from_numpy(totals)
    k = mega(planes, tt.to(cuda), (THR, LIM), ci.to(cuda), cf.to(cuda), True)
    p = mega(planes.cpu(), tt, (THR, LIM), ci, cf, True)
    for a, b in zip(_collect(k[:4], 3), _collect(p[:4], 3)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(k[4].cpu().numpy(), p[4].numpy())
    np.testing.assert_array_equal(k[5].cpu().numpy(), p[5].numpy())


def test_pipelined_cuda_equals_cpu(cuda):
    """Several segments with a carried state and asynchronous uploads:
    the rendered output on the card equals the CPU run's."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver
    from minimodem_tpu_torch.rx.engine import Receiver

    m = _modem("1200")
    p1 = bytes(33 + (i % 94) for i in range(300))
    samples = np.concatenate([m.modulate(p1), np.zeros(48000, np.float32),
                              m.modulate(b"tail")]).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        sink, errs = io.BytesIO(), []
        rx = Receiver(m.cfg, RxOptions(), get_codec("ascii8"), sink.write,
                      errs.append)
        pr = PipelinedReceiver(m.cfg, segment_len=1 << 16, device=dev)
        for seg in pr.run(samples, THR, LIM):
            rx.render_events(*seg)
        outs.append((sink.getvalue(), "".join(errs)))
    assert outs[0] == outs[1]
    assert outs[1][0] == p1 + b"tail"


@pytest.mark.parametrize("engine", ["device", "host", "host-native"])
def test_cli_cuda_equals_cpu(cuda, tmp_path, engine):
    import sys

    from minimodem_tpu_torch import cli

    cfg, wav = _noisy("1200", 4, n_bytes=200)
    path = str(tmp_path / "g.wav")
    from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

    s = open_stream("file", None, Direction.PLAYBACK, SampleFormat.FLOAT,
                    48000, 1, "test", path)
    s.write(wav)
    s.close()

    class _Out:
        def __init__(self):
            self.buffer = io.BytesIO()

        def write(self, s):
            return len(s)

        def flush(self):
            pass

    results = []
    for dev in ("cpu", "cuda"):
        old = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = _Out(), io.StringIO()
        try:
            rc = cli.main(["--rx", "--file", path, "1200", "--device", dev,
                           "--engine", engine])
            results.append((rc, sys.stdout.buffer.getvalue(),
                            sys.stderr.getvalue()))
        finally:
            sys.stdout, sys.stderr = old
    assert results[0] == results[1]
    assert results[0][0] == 0 and "NOCARRIER" in results[0][2]


@pytest.mark.parametrize("case", ["perfect", "autodetect"])
def test_host_engine_cuda_equals_cpu(cuda, case):
    """The host engine's float64 route (Bell-202 at 24 kHz with 1200/2400
    Hz tones: confidence=inf) and -a with a retune between two bursts, on
    the card and on the CPU."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.rx.engine import Receiver
    from minimodem_tpu_torch.utils.cfloat import f32

    def modem(baud, rate, mark, space):
        m = _modem(str(baud))
        m.preset = bell_like(baud, rate, mark_f=f32(mark), space_f=f32(space))
        m.cfg = m.preset.cfg
        return m

    if case == "perfect":
        m = modem(1200, 24000, 1200, 2400)
        cfg, samples, opts = m.cfg, m.modulate(b"perfect line\n"), {}
    else:
        w1 = modem(300, 24000, 1200, 2400).modulate(b"AT 1200")
        w2 = modem(300, 24000, 1800, 3000).modulate(b"AT 1800")
        samples = np.concatenate([w1, np.zeros(24000, np.float32), w2])
        cfg = bell_like(300, 24000).cfg
        opts = {"carrier_autodetect_threshold": 0.001}
    outs = []
    for dev in ("cpu", cuda):
        sink, err = io.BytesIO(), io.StringIO()
        Receiver(cfg, RxOptions(**opts), get_codec("ascii8"), sink.write,
                 err.write, device=dev).run(samples.copy(), engine="host")
        outs.append((sink.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    if case == "perfect":
        assert outs[1][0] == b"perfect line\n"
        assert "confidence=inf" in outs[1][1]
        assert "(rate perfect)" in outs[1][1]
    else:
        assert outs[1][0] == b"AT 1200AT 1800"
