"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
only torch and the port (no jax), so it runs on the GPU machine as is:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: K1's planes are compared bit for bit (the kernel and the plain
version do the same IEEE-rounded ops in the same order); K2's events,
bytes and carry are compared exactly.
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


def test_cli_cuda_equals_cpu(cuda, tmp_path):
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
            rc = cli.main(["--rx", "--file", path, "1200", "--device", dev])
            results.append((rc, sys.stdout.buffer.getvalue(),
                            sys.stderr.getvalue()))
        finally:
            sys.stdout, sys.stderr = old
    assert results[0] == results[1]
    assert results[0][0] == 0 and "NOCARRIER" in results[0][2]
