"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
only torch and the port (no jax), so it runs on the GPU machine as is:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: K1's planes, K3's correlations and K5's channels are
compared bit for bit (the kernel and the plain version do the same
IEEE-rounded ops in the same order); K2's events, bytes and carry are
compared exactly; K4's flat-schedule audio bit for bit, its
frame-schedule audio within _turns_atol (a float64 prefix summed in the
CPU's order, where the plain version on the card takes CUDA's parallel
cumsum).
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


def test_fused_kernel_equals_plain_at_the_path_shape(cuda):
    """K1 at the device engine's shape, one 2^21-sample Bell-202 segment
    (512 tiles of 4096 offsets), bit for bit."""
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)

    cfg, wav = _noisy("1200", 6, n_bytes=400)
    scorer = FusedScorer(geo_from_key(device_rx_key(cfg)))
    assert scorer.tile == 4096
    t_total = 1 << 21
    x = np.resize(wav, (1, t_total + scorer.geo.halo))
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    k = scorer(xt, t_total)
    p = score_planes_plain(xt, scorer.geo, t_total)
    np.testing.assert_array_equal(k.cpu().numpy(), p.cpu().numpy())


def _k3_input(case, batch):
    """(basis [4, nb], stream, max_begin) of a K3 card case: a preset's
    basis and noisy audio (nb 37: 1200 at 44.1 kHz, 40: 1200, 92: same,
    147: 300 at 44.1 kHz, 1056: rtty), or a seeded normal basis and
    stream of nb 4096, K3's longest filter."""
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.demod import geometry_from_config, make_basis

    rng = np.random.default_rng(5)
    if case == "nb4096":
        basis = rng.standard_normal((4, 4096)).astype(np.float32)
        wav = rng.standard_normal(batch * (1 << 14) + 8192).astype(np.float32)
        return basis, wav, 4096
    mode, _, rate = case.partition("@")
    m = FskModem(mode, sample_rate=int(rate or 48000), device="cpu")
    wav = m.modulate(rng.integers(65, 91, size=120, dtype=np.uint8).tobytes())
    wav = (wav + (rng.random(wav.size, dtype=np.float32) - np.float32(0.5))
           * np.float32(0.6)).astype(np.float32)
    geo = geometry_from_config(m.cfg, "float32")
    return make_basis(geo, np.float32), wav, geo.max_begin


@pytest.mark.parametrize("layout", ["chunks", "odd_stride", "ragged"])
@pytest.mark.parametrize("batch", [1, 22, 64])
@pytest.mark.parametrize(
    "case", ["1200@44100", "1200", "same", "300@44100", "rtty", "nb4096"])
def test_correlate_kernel_equals_plain(cuda, case, batch, layout):
    """K3 on overlapping chunk rows of one stream (a row stride, no copy),
    as DemodScorer.score_chunks hands them over, equals the plain version
    on the same rows bit for bit.  `odd_stride`: rows one sample off the
    chunk grid and an odd row stride, so most rows start off the 16-byte
    grid (the kernel's plain-load staging); `ragged`: s_len % 4 != 0 (its
    scalar stores)."""
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain

    basis, wav, max_begin = _k3_input(case, batch)
    nb = basis.shape[1]
    t_len = 1 << 14
    s_len = t_len + max_begin
    if layout == "ragged":
        s_len -= s_len % 4 == 0
        assert s_len % 4
    length = s_len + nb - 1
    step = t_len + (layout == "odd_stride")
    flat = np.zeros(1 + (batch - 1) * step + length, np.float32)
    n = min(len(wav), flat.size)
    flat[:n] = wav[:n]
    start = int(layout == "odd_stride")
    rows = torch.from_numpy(flat).to(cuda)[start:].unfold(0, length, step)
    assert rows.shape[0] == batch
    corr = Correlator(basis)
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


def _k1_planes(cuda, cfg, streams, t_total):
    """K1's planes on the card for streams [B] of audio (zero-padded)."""
    from minimodem_tpu_torch.ops.device_rx import (
        device_rx_key, geo_from_key, make_score_packer_planes)

    key = device_rx_key(cfg)
    packer, _ = make_score_packer_planes(key, t_total, "float32")
    x = np.zeros((len(streams), t_total + geo_from_key(key).halo), np.float32)
    for i, s in enumerate(streams):
        n = min(len(s), x.shape[1])
        x[i, :n] = s[:n]
    return key, packer(torch.from_numpy(x).to(cuda))


def _k2_equals_plain(key, planes, totals, rx_one=False, carry=None,
                     finalize=True, compact=True, stop_on_overflow=False):
    """K2 on the card against the plain K2 on a CPU copy of the same
    inputs: events, bytes and carry exactly.  -> (kernel's outputs, its
    MegaRx)."""
    from minimodem_tpu_torch.ops.device_rx import _collect
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, MegaStatics

    b = planes.shape[0]
    st = MegaStatics.build(key, planes.shape[2], rx_one, compact,
                           stop_on_overflow)
    mega = MegaRx(st)
    if carry is None:
        carry = (torch.zeros((b, 8), dtype=torch.int32),
                 torch.zeros((b, 4), dtype=torch.float32))
    ci, cf = (c.cpu() for c in carry)
    tt = torch.as_tensor(np.asarray(totals, np.int32))
    k = mega(planes, tt.to(planes.device), (THR, LIM), ci.to(planes.device),
             cf.to(planes.device), finalize)
    p = mega(planes.cpu(), tt, (THR, LIM), ci, cf, finalize)
    for a, c in zip(_collect(k[:4], b, compact), _collect(p[:4], b, compact)):
        assert len(a) == len(c)
        for u, v in zip(a, c):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(k[4].cpu().numpy(), p[4].numpy())
    np.testing.assert_array_equal(k[5].cpu().numpy().view(np.int32),
                                  p[5].numpy().view(np.int32))
    return k, mega


@pytest.mark.parametrize("name", ["gap", "rx_one", "1200", "same", "rtty"])
def test_mega_kernel_equals_plain(cuda, name):
    """K2 on the card's K1 planes (a batch of 3 streams of different
    lengths, one CTA each) equals the plain K2 on a CPU copy."""
    from minimodem_tpu_torch.ops.device_rx import _round_up_pow2

    cfg, wav, rx_one = next(c for c in _cases() if c[0] == name)[1:]
    totals = [len(wav), len(wav) * 2 // 3, len(wav) // 3]
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    key, planes = _k1_planes(cuda, cfg, [wav[:n] for n in totals], t_total)
    _k2_equals_plain(key, planes, totals, rx_one)


@pytest.mark.parametrize("min_stages", [4, 18])
def test_mega_kernel_160_streams(cuda, monkeypatch, min_stages):
    """160 Bell-202 streams of differing totals (more CTAs than SMs), with
    the smallest ring and one of 18 stages."""
    from minimodem_tpu_torch.ops import mega_rx
    from minimodem_tpu_torch.ops.device_rx import _round_up_pow2

    monkeypatch.setattr(mega_rx, "RING_MIN_STAGES", min_stages)

    cfg, wav = _noisy("1200", 7, n_bytes=300)
    totals = [100000 - 293 * i for i in range(160)]
    t_total = _round_up_pow2(max(totals) + cfg.nsamples_overscan + 1)
    streams = [np.roll(wav, -997 * i)[:n] for i, n in enumerate(totals)]
    key, planes = _k1_planes(cuda, cfg, streams, t_total)
    _, mega = _k2_equals_plain(key, planes, totals)
    assert mega.ring.stages == min_stages and mega.ring.hold_all


def test_mega_kernel_carried_unaligned_pos(cuda):
    """A stream in two calls, the first ending at a pos that is not a
    multiple of the ring's window: the second call, started from the
    carry, equals the plain K2 from the same carry."""
    from minimodem_tpu_torch.ops.device_rx import _round_up_pow2

    cfg, wav = _noisy("1200", 8, n_bytes=200)
    n = len(wav)
    t_total = _round_up_pow2(n + cfg.nsamples_overscan + 1)
    key, planes = _k1_planes(cuda, cfg, [wav], t_total)
    for cut in range(n // 2, n // 2 + 4000, 97):
        first, mega = _k2_equals_plain(key, planes, [cut], finalize=False)
        if int(first[4][0, 0]) % mega.ring.window:
            break
    else:
        pytest.fail("no cut left pos off the ring's window grid")
    _k2_equals_plain(key, planes, [n], carry=(first[4], first[5]))


def test_mega_kernel_dual_layout_confidence_ring(cuda):
    """The dual layout (sync and data expect differ) at the widest scan
    window K2 serves, 4.5 baud at 48 kHz: the ring holds the two
    confidence planes only and the winner's ampl and bits come from
    global memory.  Its planes come from the FFT correlation (K1's tiles
    do not hold such a bit span)."""
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.demod import (
        correlate_fft, geometry_from_config, make_basis, score_frame_channels)
    from minimodem_tpu_torch.ops.device_rx import _round_up_pow2, device_rx_key

    pre = bell_like(4.5, 48000, do_rx_sync=True, do_tx_sync_bytes=2,
                    sync_byte=0xAB)
    m = _modem("1200")
    m.preset, m.cfg = pre, pre.cfg
    rng = np.random.default_rng(9)
    wav = m.modulate(b"slow")
    wav = (wav + (rng.random(wav.size, dtype=np.float32) - np.float32(0.5))
           * np.float32(0.3)).astype(np.float32)
    n = len(wav)
    t_total = _round_up_pow2(n + pre.cfg.nsamples_overscan + 1)
    geo = geometry_from_config(pre.cfg)
    x = np.zeros((2, t_total + geo.halo), np.float32)
    x[:, :n] = wav
    basis = torch.from_numpy(make_basis(geo, np.float32)).to(cuda)
    corr = correlate_fft(torch.from_numpy(x).to(cuda), basis,
                         t_total + geo.max_begin)
    ch = score_frame_channels(corr, geo, t_total)
    planes = torch.stack([ch[r].view(torch.int32) for r in (
        "conf_data", "ampl_data", "bits_lo", "conf_sync", "ampl_sync")],
        dim=1).contiguous()
    k, mega = _k2_equals_plain(device_rx_key(pre.cfg), planes,
                               [n, n * 3 // 4])
    assert mega.st.dual and not mega.ring.hold_all and mega.ring.n_held == 2
    assert int(k[3].sum()) > 0


def _uic_signal(direction, n_frames, seed, noise=0.3):
    """A UIC-751-3 burst: n_frames telegrams of seeded data bits after the
    sync pattern 11110010, keyed as raw frame bits between mark leaders
    (tests/test_features.py::test_uic_decode), plus uniform noise."""
    from minimodem_tpu_torch.models.presets import uic
    from minimodem_tpu_torch.ops.tx import ToneGenerator
    from minimodem_tpu_torch.sigio import SampleFormat

    rng = np.random.default_rng(seed)
    cfg = uic(direction).cfg
    gen = ToneGenerator(cfg.sample_rate, SampleFormat.FLOAT)

    def key(bits):
        for v in bits:
            gen.tone(float(cfg.mark_f if v else cfg.space_f),
                     cfg.bit_nsamples_tx)

    key([1] * 8)
    for _ in range(n_frames):
        data = int(rng.integers(0, 1 << 39))
        key([1, 1, 1, 1, 0, 0, 1, 0] + [(data >> i) & 1 for i in range(39)])
    key([1] * 8)
    wav = gen.synthesize()
    wav = wav + (rng.random(wav.size, dtype=np.float32)
                 - np.float32(0.5)) * np.float32(noise)
    return cfg, wav.astype(np.float32)


def _slow_dual(seed):
    """Bell-like 2 baud at 48 kHz with sync bytes (the dual layout): a scan
    window of ~30000 samples, whose two confidence planes no ring holds."""
    from minimodem_tpu_torch.models.presets import bell_like

    pre = bell_like(2, 48000, do_rx_sync=True, do_tx_sync_bytes=2,
                    sync_byte=0xAB)
    m = _modem("1200")
    m.preset, m.cfg = pre, pre.cfg
    rng = np.random.default_rng(seed)
    wav = m.modulate(b"ok")
    return pre.cfg, (wav + (rng.random(wav.size, dtype=np.float32)
                            - np.float32(0.5)) * np.float32(0.3)).astype(
                                np.float32)


@pytest.mark.parametrize("mode", ["wide", "stop_on_overflow", "bits_hi",
                                  "no_ring", "no_ring_wide", "no_ring_dual"])
def test_mega_kernel_modes_equal_plain(cuda, monkeypatch, mode):
    """K2's modes on the card against the plain K2: wide records (one per
    frame); stop-on-overflow (wide, each record's scan position in lane
    5), stopped at the first overflow and resumed from its carry; UIC's 47
    frame bits (the bits_hi plane, planes from make_score_packer through
    K3); the read without a ring, forced by a shared-memory budget of 0,
    compact and wide with stop-on-overflow, and where no ring holds the
    dual layout's scan window (2 baud)."""
    from minimodem_tpu_torch.ops import mega_rx
    from minimodem_tpu_torch.ops.correlate import Correlator
    from minimodem_tpu_torch.ops.device_rx import _round_up_pow2

    kw = {}
    if mode in ("wide", "stop_on_overflow", "no_ring", "no_ring_wide"):
        cfg, wav, _ = next(c for c in _cases() if c[0] == "gap")[1:]
        kw = {"compact": mode == "no_ring",
              "stop_on_overflow": mode in ("stop_on_overflow",
                                           "no_ring_wide")}
        if mode.startswith("no_ring"):
            monkeypatch.setattr(mega_rx, "SMEM_MAX", 0)
    elif mode == "bits_hi":
        cfg, wav = _uic_signal("train", 30, 11)
        kw = {"compact": False}
    else:
        cfg, wav = _slow_dual(12)
    totals = [len(wav), len(wav) * 3 // 4]
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    k3 = Correlator.launches + Correlator.batch_launches
    key, planes = _k1_planes(cuda, cfg, [wav[:n] for n in totals], t_total)
    if mode == "bits_hi":
        assert Correlator.launches + Correlator.batch_launches > k3
        assert planes.shape[1] == 4
    k, mega = _k2_equals_plain(key, planes, totals, **kw)
    assert (mega.ring.stages == 0) == mode.startswith("no_ring")
    assert int(k[1].sum()) >= 2
    if kw.get("stop_on_overflow"):
        ci, cf = k[4].clone(), k[5]
        assert (ci[:, 5] == 1).all()
        ci[:, 5] = 0
        _k2_equals_plain(key, planes, totals, carry=(ci, cf), **kw)


@pytest.mark.parametrize("case", ["uic", "float64", "20baud", "1baud"])
def test_score_packer_cuda_equals_cpu(cuda, case):
    """make_score_packer, the planes of the geometries K1 does not serve,
    on the card and on the CPU, two noisy streams of the geometry's own
    signal.  K3 (UIC, 20 baud) and the float64 chain are the same IEEE ops
    on both, bit for bit; on the FFT route (1 baud, a window around its
    first frame) the frame bits are equal and the confidence and amplitude
    planes within rtol 5e-4, atol 1e-4 (tests/test_torch_device_rx_wide.py
    holds the port's FFT route to the JAX package's at the same
    tolerance)."""
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.correlate import Correlator
    from minimodem_tpu_torch.ops.device_rx import (
        device_rx_key, geo_from_key, make_score_packer_planes)
    from minimodem_tpu_torch.ops.fused_score import serves
    from minimodem_tpu_torch.utils.cfloat import f32

    rng = np.random.default_rng(13)
    start = 0
    if case == "uic":
        cfg, wav = _uic_signal("ground", 6, 13)
    else:
        baud, rate, kw = {"float64": (1200, 24000, {"mark_f": f32(1200),
                                                    "space_f": f32(2400)}),
                          "20baud": (20, 48000, {}),
                          "1baud": (1, 48000, {})}[case]
        pre = bell_like(baud, rate, **kw)
        m = _modem("1200")
        m.preset, m.cfg = pre, pre.cfg
        cfg, wav = pre.cfg, m.modulate(b"ab")
        start = 40000 if case == "1baud" else 0   # 1 baud: frame at 48000
    key = device_rx_key(cfg)
    geo = geo_from_key(key)
    assert not serves(geo)
    t_total = 1 << 14
    x = np.zeros((2, t_total + geo.halo), np.float32)
    for row in x:
        seg = wav[start:start + x.shape[1]]
        row[:len(seg)] = seg + (rng.random(len(seg), dtype=np.float32)
                                - np.float32(0.5)) * np.float32(0.3)
    packer, n_planes = make_score_packer_planes(key, t_total, "float32")
    k3 = Correlator.launches + Correlator.batch_launches
    got = packer(torch.from_numpy(x).to(cuda)).cpu().numpy()
    ref = packer(torch.from_numpy(x)).numpy()
    assert got.shape == (2, n_planes, t_total)
    assert np.count_nonzero(ref[:, 0]) > 0
    if case in ("uic", "20baud"):
        assert Correlator.launches + Correlator.batch_launches == k3 + 1
    if case == "1baud":
        np.testing.assert_array_equal(got[:, 2], ref[:, 2])
        np.testing.assert_allclose(got[:, :2].view(np.float32),
                                   ref[:, :2].view(np.float32),
                                   rtol=5e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, ref)


def _k5_geo(name):
    """The port's geometry of a K5 case (the geometries K1 does not serve,
    and Bell-202 for the host engines)."""
    from minimodem_tpu_torch.models.presets import bell202, bell_like, uic
    from minimodem_tpu_torch.ops.demod import geometry_from_config
    from minimodem_tpu_torch.utils.cfloat import f32

    cfg = {"uic-train": lambda: uic("train").cfg,
           "float64": lambda: bell_like(1200, 24000, mark_f=f32(1200),
                                        space_f=f32(2400)).cfg,
           "20 baud": lambda: bell_like(20, 48000).cfg,
           "1 baud": lambda: bell_like(1, 48000).cfg,
           "2 baud dual": lambda: bell_like(
               2, 48000, do_rx_sync=True, do_tx_sync_bytes=2,
               sync_byte=0xAB).cfg,
           "1200": lambda: bell202().cfg}[name]()
    return cfg, geometry_from_config(cfg)


@pytest.mark.parametrize("layout", ["contiguous", "row_stride",
                                    "column_stride"])
@pytest.mark.parametrize("name", ["uic-train", "float64", "20 baud",
                                  "1 baud", "2 baud dual", "1200"])
def test_frame_channels_kernel_equals_plain(cuda, name, layout):
    """K5 on the card against the plain score_frame_channels on the card,
    every word of the output bit for bit (NaN and inf included): seeded
    correlations of a data frame, all zeros, mark == space ties, a sync
    frame with sub-FLT_EPSILON noise, a per-offset mix of those, and the
    data frame with NaN and inf correlations (tests/
    test_torch_frame_channels.py _corr), written at a column offset t0
    into the device packer's plane rows and into the host scorer's
    CHANNELS rows, n ragged (not a multiple of the kernel's 256
    threads); the float64 geometry's correlation in float64; uic-train's
    47 frame bits (bits_hi).  `row_stride`: the correlation a slice of
    wider rows, as the FFT route hands it over; `column_stride`: every
    other column of a wider tensor (the wrapper's copy)."""
    from minimodem_tpu_torch.ops.demod import CHANNELS, score_frame_channels
    from minimodem_tpu_torch.ops.device_rx import plane_names
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    from .test_torch_frame_channels import _corr

    _, geo = _k5_geo(name)
    n, t0 = 1000 - 3, 37
    c = torch.from_numpy(_corr(geo, n + 5, seed=15, special=True)).to(cuda)
    if layout == "row_stride":
        wide = torch.full(c.shape[:2] + (c.shape[2] + 41,), float("nan"),
                          dtype=c.dtype, device=cuda)
        wide[..., :c.shape[2]] = c
        c = wide[..., :c.shape[2]]
        assert not c.is_contiguous() and c.stride(2) == 1
    elif layout == "column_stride":
        wide = torch.zeros(c.shape[:2] + (2 * c.shape[2],), dtype=c.dtype,
                           device=cuda)
        wide[..., ::2] = c
        c = wide[..., ::2]
        assert c.stride(2) == 2
    assert c.dtype == (torch.float64 if geo.use_f64 else torch.float32)
    fc = FrameChannels(geo)
    ref = score_frame_channels(c, geo, n)
    for rows in (plane_names(geo), CHANNELS):
        out = torch.full((c.shape[0], len(rows), t0 + n + 9), -7,
                         dtype=torch.int32, device=cuda)
        want = out.clone()
        for r, k in enumerate(rows):
            want[:, r, t0:t0 + n] = ref[k].view(torch.int32)
        launches, calls = FrameChannels.launches, score_frame_channels.calls
        fc(c, n, out, rows, t0)
        torch.cuda.synchronize()
        assert FrameChannels.launches == launches + 1
        assert score_frame_channels.calls == calls
        np.testing.assert_array_equal(out.cpu().numpy(), want.cpu().numpy())
    if name == "uic-train":
        assert geo.n_bits == 47 and bool((ref["bits_hi"] != 0).any())
    assert bool(ref["conf_data"].isnan().any())


@pytest.mark.parametrize("case", ["uic", "float64", "1baud"])
def test_score_packer_launches_frame_channels(cuda, monkeypatch, case):
    """make_score_packer on the card scores every tile through K5 (the
    tile cut to 4096 offsets: three tiles, the last ragged) and calls no
    plain version; its planes equal the plain chain's on the card (stage
    1, then score_frame_channels), bit for bit."""
    from minimodem_tpu_torch.ops import device_rx
    from minimodem_tpu_torch.ops.demod import (
        correlator_for, make_basis, score_frame_channels)

    cfg, _ = _k5_geo({"uic": "uic-train", "float64": "float64",
                      "1baud": "1 baud"}[case])
    key = device_rx.device_rx_key(cfg)
    geo = device_rx.geo_from_key(key)
    tile, t_total = 4096, 3 * 4096 - 700
    monkeypatch.setattr(device_rx, "SCORE_TILE", tile)
    rng = np.random.default_rng(16)
    x = torch.from_numpy((rng.random((3, t_total + geo.halo),
                                     dtype=np.float32) - np.float32(0.5))
                         * np.float32(0.6)).to(cuda)
    before = _counts()
    got = device_rx.make_score_packer(key, t_total, "float32")(x)
    after = _counts()
    assert after["k5"] == before["k5"] + 3
    assert after["plain"] == before["plain"]
    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    xp = torch.nn.functional.pad(x, (0, 3 * tile + geo.halo - x.shape[1]))
    rows = device_rx.plane_names(geo)
    for k in range(3):
        t0 = k * tile
        n = min(tile, t_total - t0)
        ch = score_frame_channels(
            stage1(xp[:, t0:t0 + tile + geo.halo], tile + geo.max_begin),
            geo, tile)
        want = torch.stack([ch[r][:, :n].view(torch.int32) for r in rows], 1)
        np.testing.assert_array_equal(got[:, :, t0:t0 + n].cpu().numpy(),
                                      want.cpu().numpy())


@pytest.mark.parametrize("mode", ["1200", "perfect"])
def test_score_chunks_equals_score_on_card(cuda, monkeypatch, mode):
    """DemodScorer on the card: score_chunks (batched overlapping chunk
    rows, K3b then K5) bit-identical with score() chunk by chunk (K3a
    then K5), across batch boundaries and the zero-padded tail, with K5
    launched once a batch and once a chunk and no plain version called;
    the float64 geometry (the float64 chain, then K5 on a float64
    correlation) as well."""
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.demod import DemodScorer
    from minimodem_tpu_torch.utils.cfloat import f32

    m = _modem("1200")
    if mode == "perfect":
        m = FskModem("1200", sample_rate=24000, device="cpu")
        m.preset = bell_like(1200, 24000, mark_f=f32(1200),
                             space_f=f32(2400))
        m.cfg = m.preset.cfg
    cfg = m.cfg
    rng = np.random.default_rng(22)
    wav = m.modulate(rng.integers(32, 127, size=45, dtype=np.uint8)
                     .tobytes())
    wav = (wav + (rng.random(wav.size, dtype=np.float32)
                  - np.float32(0.5)) * np.float32(0.6)).astype(np.float32)
    sc = DemodScorer(cfg, chunk_len=2048 if mode == "perfect" else 4096,
                     device=cuda)
    monkeypatch.setattr(DemodScorer, "BATCH", 2)
    n_chunks = -(-len(wav) // sc.chunk_len)
    assert n_chunks >= 5 and n_chunks % 2 == 1
    before = _counts()
    allc = sc.score_chunks(wav)
    ones = [sc.score(wav[i * sc.chunk_len:]) for i in range(n_chunks)]
    after = _counts()
    assert after["k5"] == before["k5"] + (n_chunks + 1) // 2 + n_chunks
    assert after["plain"] == before["plain"]
    for i, one in enumerate(ones):
        for k in one:
            np.testing.assert_array_equal(
                allc[k][i * sc.chunk_len:(i + 1) * sc.chunk_len].view(
                    np.uint32), one[k].view(np.uint32), err_msg=k)


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
                      errs.append, device=dev)
        pr = PipelinedReceiver(m.cfg, segment_len=1 << 16, device=dev)
        for seg in pr.run(samples, THR, LIM):
            rx.render_events(*seg)
        outs.append((sink.getvalue(), "".join(errs)))
    assert outs[0] == outs[1]
    assert outs[1][0] == p1 + b"tail"


@pytest.mark.parametrize("k", [0, 2, 5])
def test_wirepack_unpack_cuda_equals_cpu(cuda, k):
    """unpack_expand on the card: every float32 word of the row equals the
    CPU's and the raw int16 wire's normalization on the card, the masked
    tail included (a tone that starts negative, an escape pattern,
    silence; w 8 and 12)."""
    from minimodem_tpu_torch.ops import wirepack as wp
    from minimodem_tpu_torch.ops.device_rx import normalize_input

    n = 50000
    tone = (np.sin(2 * np.pi * 2200 / 48000 * np.arange(n) + 4.0)
            * 32000).astype(np.int16)
    esc = np.resize(np.array([0, 0, 32767, -32768], np.int16), n)
    xs = [tone, esc, np.zeros(n, np.int16)]
    totals = [n, n - 777, n // 2]
    n_target = n + 1000
    for w in (8, 12):
        e_cap = wp.exc_capacity(max(wp.count_exceptions(x, k, w) for x in xs))
        wire = np.stack([wp.pack(x, n, k, w, e_cap).view(np.int16)
                         for x in xs])
        tot = torch.tensor(totals, dtype=torch.int32)
        spec = (k, w, n, e_cap, n_target)
        got = wp.unpack_expand(torch.from_numpy(wire).to(cuda),
                               tot.to(cuda), *spec).cpu().numpy()
        ref = wp.unpack_expand(torch.from_numpy(wire), tot, *spec).numpy()
        raw = np.zeros((3, n_target), np.int16)
        for i, (x, t) in enumerate(zip(xs, totals)):
            raw[i, :t] = x[:t]
        norm = normalize_input(torch.from_numpy(raw).to(cuda),
                               "int16").cpu().numpy()
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      norm.view(np.uint32))


def test_wirepack_decode_cuda_equals_raw(cuda):
    """A segmented stream on the packed wire on the card: per-segment
    events equal the raw int16 wire's on the card and the packed wire's
    on the CPU, through K1 and K2 (no plain call on the card)."""
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, mega_rx_plain

    m = _modem("1200")
    p1 = bytes(33 + (i % 94) for i in range(300))
    wav = np.concatenate([m.modulate(p1), np.zeros(48000, np.float32),
                          m.modulate(b"tail")])
    s16 = np.clip(np.rint(wav * 32768.0), -32768, 32767).astype(np.int16)

    def run(dev, wire_pack):
        pr = PipelinedReceiver(m.cfg, segment_len=1 << 16, device=dev)
        return [tuple(np.asarray(a).tobytes() for a in seg)
                for seg in pr.run(s16, THR, LIM, wire_pack=wire_pack)]

    raw = run(cuda, False)
    launches = FusedScorer.launches, MegaRx.launches
    plain = score_planes_plain.calls + mega_rx_plain.calls
    packed = run(cuda, True)
    assert FusedScorer.launches - launches[0] == len(packed) >= 3
    assert MegaRx.launches - launches[1] == len(packed)
    assert score_planes_plain.calls + mega_rx_plain.calls == plain
    assert packed == raw == run("cpu", True)


def _stream_events(cfg, samples, feed_size, device, **kw):
    from minimodem_tpu_torch.ops.device_rx import DeviceStreamReceiver

    sr = DeviceStreamReceiver(cfg, segment_len=1 << 15, device=device, **kw)
    run = sr.rx.run_events_batch
    sr.calls = 0

    def counted(*a, **k):
        sr.calls += 1
        return run(*a, **k)

    sr.rx.run_events_batch = counted
    parts = [sr.feed(samples[off:off + feed_size])
             for off in range(0, len(samples), feed_size)]
    parts.append(sr.finish())
    return parts, sr


def _parts_equal(a, b):
    return len(a) == len(b) and all(
        len(u) == len(v) and all(np.array_equal(s, t) for s, t in zip(u, v))
        for u, v in zip(a, b))


@pytest.mark.parametrize("feed_size", [4096, 30000])
def test_stream_cuda_equals_cpu_and_oneshot(cuda, feed_size):
    """DeviceStreamReceiver on the card: per feed the events and bytes of
    the same stream on the CPU, rendered the one-shot DeviceReceiver's
    output on the card; K1 and K2 launched once a segment, no plain
    call."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, mega_rx_plain
    from minimodem_tpu_torch.rx.engine import Receiver

    m = _modem("1200")
    payload = bytes(33 + (i % 94) for i in range(600))
    samples = np.concatenate([m.modulate(payload),
                              np.zeros(30000, np.float32),
                              m.modulate(b"second carrier")])
    ref, _ = _stream_events(m.cfg, samples, feed_size, "cpu")
    FusedScorer.launches = MegaRx.launches = 0
    score_planes_plain.calls = mega_rx_plain.calls = 0
    got, sr = _stream_events(m.cfg, samples, feed_size, cuda)
    assert sr.compact and sr.calls >= 5
    assert FusedScorer.launches == MegaRx.launches == sr.calls
    assert score_planes_plain.calls == mega_rx_plain.calls == 0
    assert _parts_equal(got, ref)

    def render(parts):
        sink, errs = io.BytesIO(), []
        rx = Receiver(m.cfg, RxOptions(), get_codec("ascii8"), sink.write,
                      errs.append, device=cuda)
        for p in parts:
            rx.render_events(*p)
        return sink.getvalue(), "".join(errs)

    (one,), _ = DeviceReceiver(m.cfg, device=cuda).run_events_batch(
        samples[None], [len(samples)], THR, LIM)
    assert render(got) == render([one])
    assert render(got)[0] == payload + b"second carrier"


def test_stream_stop_on_overflow_seeded_cuda_equals_cpu(cuda):
    """The live -a receiver on the card: stop on overflow from a seeded
    carry, lane 5 rebased, stop flag and carry as on the CPU."""
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

    m = _modem("1200")
    _, seed = DeviceReceiver(m.cfg, compact=False, stop_on_overflow=True,
                             device="cpu").run_events_batch(
        m.modulate(b"seed")[None], [len(m.modulate(b"seed"))], THR, LIM,
        finalize=False)
    seed["pos"][0] = 0
    seed["stop"][0] = False
    burst = m.modulate(bytes(48 + i % 40 for i in range(300)))
    samples = np.concatenate([burst, np.zeros(60000, np.float32), burst])
    runs = [_stream_events(m.cfg, samples, 7000, d, stop_on_overflow=True,
                           initial_carry={k: v.copy()
                                          for k, v in seed.items()})
            for d in ("cpu", cuda)]
    (ref, sr_c), (got, sr_g) = runs
    assert _parts_equal(got, ref)
    assert sr_g.stopped and sr_c.stopped
    assert sr_g.abs_pos == sr_c.abs_pos and sr_g.consumed_total > 0
    for k in seed:
        np.testing.assert_array_equal(sr_g._carry[k], sr_c._carry[k])


def test_live_cli_cuda_equals_cpu(cuda):
    """minimodem-tpu-torch --rx -A through a stand-in capture library:
    --device cuda prints what --device cpu prints."""
    import ctypes
    import sys

    from minimodem_tpu_torch import cli
    from minimodem_tpu_torch.sigio import alsa

    m = _modem("1200")
    capture = np.concatenate([m.modulate(b"live on the card"),
                              np.zeros(40000, np.float32)])

    class Capture:
        pos = 0

        def snd_pcm_open(self, pcmref, device, direction, mode):
            return 0

        def snd_pcm_set_params(self, *a):
            return 0

        def snd_pcm_readi(self, pcm, ptr, count):
            n = min(count, len(capture) - self.pos)
            raw = capture[self.pos:self.pos + n].tobytes()
            ctypes.memmove(ptr, raw, len(raw))
            self.pos += n
            return n

        def snd_pcm_drain(self, pcm):
            return 0

        def snd_pcm_close(self, pcm):
            return 0

    class _Out:
        def __init__(self):
            self.buffer = io.BytesIO()

        def write(self, s):
            return len(s)

        def flush(self):
            pass

    results = []
    old_lib = alsa._lib, alsa._tried
    try:
        for dev in ("cpu", "cuda"):
            alsa._lib, alsa._tried = Capture(), True
            old = sys.stdout, sys.stderr
            sys.stdout, sys.stderr = _Out(), io.StringIO()
            try:
                rc = cli.main(["--rx", "-A", "1200", "--device", dev])
                results.append((rc, sys.stdout.buffer.getvalue(),
                                sys.stderr.getvalue()))
            finally:
                sys.stdout, sys.stderr = old
    finally:
        alsa._lib, alsa._tried = old_lib
    assert results[0] == results[1]
    assert results[1][:2] == (0, b"live on the card")


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


# ---------------------------------------------------------------------
# device TX synthesis and the on-device loopback
# ---------------------------------------------------------------------

def _turns_atol(seg_len, cfg) -> float:
    """One float32 ulp of the largest per-sample turns of a seg_len-sample
    tone segment, times 2pi, plus one ulp of a phase and of the sine (the
    tolerance of tests/test_torch_tx_device.py): where a float64 prefix
    sum of non-integers is summed in another order on the card, a phase
    can round to the neighbouring float32."""
    turns = seg_len * max(float(cfg.mark_f), float(cfg.space_f)) \
        / cfg.sample_rate + 1.0
    ulp = float(np.spacing(np.float32(turns)))
    return 2 * np.pi * (ulp + 2.0 ** -24) + 2.0 ** -24


def _samples_close(got, ref, atol, share=1.0):
    diff = np.abs(got.cpu().numpy().astype(np.float64) - ref.numpy())
    assert diff.max() <= atol, diff.max()
    assert np.count_nonzero(diff) <= share * diff.size


@pytest.mark.parametrize("shape", [(4, 4096), (1, 77824)])
def test_device_synthesize_cuda_equals_cpu(cuda, shape):
    """Flat schedules (B = 4, and one 64.3 s stream: 77160 bits padded to
    77824): the phase is exact integer counts and one FMA on both devices,
    so only the float64 sine's last rounding may differ (one float32
    ulp)."""
    from minimodem_tpu_torch.ops.tx_device import device_synthesize

    cfg = _modem("1200").cfg
    bits = torch.from_numpy(np.random.default_rng(shape[0]).integers(
        0, 2, shape, dtype=np.uint8))
    got = device_synthesize(bits.to(cuda), cfg, 0.8)
    ref = device_synthesize(bits, cfg, 0.8)
    assert got.shape == (shape[0], shape[1] * cfg.bit_nsamples_tx)
    _samples_close(got, ref, 2.0 ** -23, share=1e-4)


@pytest.mark.parametrize("mode", ["rtty", "1200-1.5"])
def test_device_synthesize_frames_cuda_equals_cpu(cuda, mode):
    from minimodem_tpu_torch.ops.tx_device import (device_synthesize_frames,
                                                   frame_synth_params)

    m = _modem(mode.split("-")[0])
    if mode == "1200-1.5":
        m.cfg.nstopbits = np.float32(1.5)
        m.cfg.finalize()
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(
        0, 2, (3, 512, m.cfg.n_data_bits), dtype=np.uint8))
    nf = torch.tensor([512, 300, 0], dtype=torch.int32)
    got = device_synthesize_frames(bits.to(cuda), nf.to(cuda), m.cfg, 2, 2)
    ref = device_synthesize_frames(bits, nf, m.cfg, 2, 2)
    # no bound on the share of differing samples: at Bell-202 a mark bit
    # is a whole number of turns, so many frame phases are integers that
    # the two prefix sums put on either side of 1.0 (0 + e or 1 - e),
    # which moves the rounding of every sample of the segment
    _samples_close(got, ref, _turns_atol(
        max(frame_synth_params(m.cfg)["seg_len"]), m.cfg))


def _frames_case(mode):
    m = _modem(mode.split("-")[0])
    if mode == "1200-1.5":
        m.cfg.nstopbits = np.float32(1.5)
        m.cfg.finalize()
    return m.cfg


def _bit_words(t):
    return t.contiguous().view(torch.int32).cpu().numpy()


@pytest.mark.parametrize("mode,pad", [("1200", 5000), ("1200", 5001),
                                      ("300", 4099)])
@pytest.mark.parametrize("batch", [1, 3, 129])
def test_tx_synth_bits_equals_plain(cuda, batch, mode, pad):
    """K4 in flat mode against its plain route on the card (unpack,
    device_synthesize, the zero tail), bit for bit: integer phase counts,
    one correctly rounded FMA and CUDA's float64 sine on both sides.  A
    width on the 16-byte grid and off it (width % 4 != 0: every row past
    the first starts off the grid, scalar stores at its edges); K4's
    8192-sample tiles end inside a bit (40 and 160 samples a bit)."""
    from minimodem_tpu_torch.ops.tx_device import TxSynth, synth_bits_plain

    cfg = _modem(mode).cfg
    rng = np.random.default_rng(batch)
    n_bits = 4096 + 512 * (batch % 3)
    packed = torch.from_numpy(np.packbits(
        rng.integers(0, 2, (batch, n_bits), dtype=np.uint8), axis=1,
        bitorder="little")).to(cuda)
    width = n_bits * cfg.bit_nsamples_tx + pad
    launches = TxSynth.launches
    got = TxSynth(cfg, 0.8).bits(packed, width)
    assert TxSynth.launches == launches + 1
    np.testing.assert_array_equal(
        _bit_words(got), _bit_words(synth_bits_plain(packed, cfg, width, 0.8)))


def test_tx_synth_bits_writes_the_tail(cuda):
    """Into a buffer filled with NaN first: every sample of the row
    written, the tail past the schedule (the halo included) 0.0."""
    from minimodem_tpu_torch.ops.tx_device import TxSynth, synth_bits_plain

    cfg = _modem("1200").cfg
    packed = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 64), dtype=np.uint8)).to(cuda)
    n_samples = 512 * cfg.bit_nsamples_tx
    width = n_samples + 4096 * 3 + 17
    out = torch.full((2, width), float("nan"), device=cuda)
    TxSynth(cfg).bits(packed, width, out=out)
    assert not torch.isnan(out).any()
    assert torch.count_nonzero(out[:, n_samples:]) == 0
    np.testing.assert_array_equal(
        _bit_words(out), _bit_words(synth_bits_plain(packed, cfg, width)))


@pytest.mark.parametrize("mode", ["rtty", "tdd", "1200-1.5"])
def test_tx_synth_frames_within_turns_atol(cuda, mode):
    """K4 in frames mode at n_frames = F_pad, partial and 0 (the trailer
    at the end, over padded frames, and right after the leader), against
    the plain route on the card and on the CPU, within the tolerance of a
    float64 prefix summed in another order; every sample written (NaN
    first), 0.0 after the trailer."""
    from minimodem_tpu_torch.ops.tx_device import (
        TxSynth, frame_synth_params, frames_len, synth_frames_plain)

    cfg = _frames_case(mode)
    rng = np.random.default_rng(7)
    n_pad = 96
    bits = torch.from_numpy(rng.integers(
        0, 2, (3, n_pad, cfg.n_data_bits), dtype=np.uint8))
    nf = torch.tensor([n_pad, 41, 0], dtype=torch.int32)
    lt = (2, 2)
    width = frames_len(cfg, n_pad, lt) + 3000
    out = torch.full((3, width), float("nan"), device=cuda)
    launches = TxSynth.frames_launches
    got = TxSynth(cfg, 0.7).frames(bits.to(cuda), nf.to(cuda), lt, width,
                                   out=out)
    assert TxSynth.frames_launches == launches + 1
    assert not torch.isnan(got).any()
    atol = _turns_atol(max(frame_synth_params(cfg)["seg_len"]), cfg)
    for dev in (cuda, "cpu"):
        ref = synth_frames_plain(bits.to(dev), nf.to(dev), cfg, lt, width,
                                 0.7)
        _samples_close(got, ref.cpu().double(), atol)
    # the CPU's plain version word for word (K4 sums in the CPU's order)
    np.testing.assert_array_equal(_bit_words(got), _bit_words(ref))
    assert torch.count_nonzero(got[:, frames_len(cfg, n_pad, lt):]) == 0


def _sine_edges():
    """0, the smallest subnormal, the floats either side of each quarter
    turn (0.25, 0.5, 0.75) and the float just below 1, as bit patterns."""
    quarters = [int(np.float32(q).view(np.uint32)) for q in (0.25, 0.5, 0.75)]
    return [0, 1] + [q + e for q in quarters for e in (-1, 0, 1)] + [
        0x3F7FFFFF]


@pytest.mark.parametrize("lo,hi,stride", [
    (0, 0x3F7FFFFF, 4099),                     # a strided sweep of [0, 1)
    (0x3E000000, 0x3F7FFFFF, 97)])             # denser over [1/8, 1)
def test_k4_sine_equals_cuda_sin(cuda, lo, hi, stride):
    """K4's sine (sin_2pi: CUDA's own float64 operations for the domain
    [0, 2 pi)) against CUDA's sin rounded to float32, every bit; the
    whole range is chip_smoke.py phase 11's."""
    from minimodem_tpu_torch.ops.tx_device import sin_check

    assert sin_check(lo, hi, stride, cuda) == (0, None)


@pytest.mark.parametrize("bits", _sine_edges())
def test_k4_sine_edge_values(cuda, bits):
    from minimodem_tpu_torch.ops.tx_device import sin_check

    assert sin_check(bits, bits, 1, cuda) == (0, None)


def test_tx_synth_refuses_cpu_tensors(cuda):
    from minimodem_tpu_torch.ops.tx_device import TxSynth

    cfg = _modem("1200").cfg
    packed = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        TxSynth(cfg).bits(packed, 64 * cfg.bit_nsamples_tx)
    with pytest.raises(ValueError, match="CUDA"):
        TxSynth(cfg).frames(torch.zeros((1, 4, 8), dtype=torch.uint8),
                            torch.zeros(1, dtype=torch.int32).to(cuda),
                            (2, 2), 10 ** 4)


def test_loopback_synthesizes_through_k4(cuda):
    """DeviceLoopback on the card, flat and frames mode: K4 launched, the
    plain synthesis never called."""
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import (
        TxSynth, device_synthesize, device_synthesize_frames,
        tx_bit_schedule, tx_frame_schedule)

    plain = device_synthesize.calls + device_synthesize_frames.calls
    k4 = (TxSynth.launches, TxSynth.frames_launches)
    cfg = _modem("1200").cfg
    texts = _payloads(2, 60)
    DeviceLoopback(cfg, device=cuda).run_events_batch(
        [tx_bit_schedule(t, cfg, Ascii8Codec()) for t in texts])
    cfg15 = _frames_case("1200-1.5")
    rows = [tx_frame_schedule(t, cfg15, Ascii8Codec()) for t in texts]
    DeviceLoopback(cfg15, device=cuda).run_events_frames_batch(
        [r[0] for r in rows], rows[0][1:])
    assert (TxSynth.launches, TxSynth.frames_launches) == (k4[0] + 1,
                                                           k4[1] + 1)
    assert device_synthesize.calls + device_synthesize_frames.calls == plain


def _events_close(got, ref):
    """Types, integer lanes and bytes equal; NOCARRIER confidence and
    amplitude totals within rtol 2e-6, atol 1e-5."""
    assert len(got) == len(ref)
    for (tt, tp, tb), (rt, rp, rb) in zip(got, ref):
        np.testing.assert_array_equal(tt, rt)
        np.testing.assert_array_equal(tb, rb)
        nc = tt == 2
        np.testing.assert_array_equal(tp[:, [0, 3, 4, 5]], rp[:, [0, 3, 4, 5]])
        np.testing.assert_array_equal(tp[~nc], rp[~nc])
        np.testing.assert_allclose(tp[nc][:, 1:3].view(np.float32),
                                   rp[nc][:, 1:3].view(np.float32),
                                   rtol=2e-6, atol=1e-5)


def _payloads(n, k):
    return [bytes(33 + (i * 7 + 13 * j) % 94 for i in range(k))
            for j in range(n)]


@pytest.mark.parametrize("mode", ["1200", "same", "1200-1.5"])
def test_loopback_cuda_equals_cpu(cuda, mode):
    """Two streams of 1-3 s, flat mode (1200, SAME) and frames mode
    (Bell-202 with 1.5 stop bits): the loopback on the card against
    device="cpu", event for event, every stream decoding its payload.
    (At 1.5 stop bits the receiver, like the reference's, can lose a
    byte in a few hundred; both packages lose the same one, so the frames
    case keeps to 120 bytes.)"""
    from minimodem_tpu_torch.bench import _render_ok
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import (tx_bit_schedule,
                                                   tx_frame_schedule)
    from minimodem_tpu_torch.ops.fused_score import FusedScorer
    from minimodem_tpu_torch.ops.mega_rx import MegaRx

    m = _modem(mode.split("-")[0])
    texts = _payloads(2, 300)
    if mode == "1200-1.5":
        m.cfg.nstopbits = np.float32(1.5)
        m.cfg.finalize()
        texts = _payloads(2, 120)
    runs = []
    for dev in ("cpu", cuda):
        k1, k2 = FusedScorer.launches, MegaRx.launches
        lb = DeviceLoopback(m.cfg, device=dev)
        if mode == "1200-1.5":
            rows = [tx_frame_schedule(t, m.cfg, Ascii8Codec()) for t in texts]
            runs.append(lb.run_events_frames_batch([r[0] for r in rows],
                                                   rows[0][1:]))
        else:
            runs.append(lb.run_events_batch(
                [tx_bit_schedule(t, m.cfg, Ascii8Codec()) for t in texts]))
        launched = (FusedScorer.launches - k1, MegaRx.launches - k2)
    assert launched == (1, 1)
    _events_close(runs[1], runs[0])
    assert _render_ok(m.cfg, "ascii8", texts, runs[1])


def test_loopback_rtty_frames_cuda_equals_cpu(cuda):
    """rtty's fractional stop bits through build_loop at a frame pad of 7
    on both devices (the plain CPU scorer of 1056-tap bits is slow)."""
    from minimodem_tpu_torch.bench import _render_ok
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback, _collect
    from minimodem_tpu_torch.ops.tx_device import tx_frame_schedule

    m = _modem("rtty")
    texts = [b"RYRY", b"CQ 73"]
    rows = [tx_frame_schedule(t, m.cfg, get_codec("baudot", usos=True))
            for t in texts]
    lt = rows[0][1:]
    bits = np.zeros((2, 7, m.cfg.n_data_bits), np.uint8)
    for i, r in enumerate(rows):
        bits[i, :len(r[0])] = r[0]
    nf = np.asarray([len(r[0]) for r in rows], np.int32)
    runs = []
    for dev in ("cpu", cuda):
        lb = DeviceLoopback(m.cfg, device=dev)
        totals = np.asarray([(lt[0] + lt[1]) * lb.bit_ns + n * lb.frame_len
                             for n in nf], np.int32)
        out = lb.build_loop(7, True, lt)(
            torch.from_numpy(bits).to(dev), torch.from_numpy(totals).to(dev),
            (THR, LIM), torch.from_numpy(nf).to(dev))
        runs.append(_collect(out, 2))
    _events_close(runs[1], runs[0])
    assert _render_ok(m.cfg, "baudot", texts, runs[1])


def test_loopback_128_short_streams(cuda):
    """B = 128 streams of distinct payloads in one batch, every one
    byte-exact; a depth-2 pipeline with prefetch and a chain of two give
    the synchronous call's results."""
    from minimodem_tpu_torch.bench import _render_ok
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule

    cfg = _modem("1200").cfg
    texts = _payloads(128, 150)
    scheds = [tx_bit_schedule(t, cfg, Ascii8Codec()) for t in texts]
    lb = DeviceLoopback(cfg, device=cuda)
    sync = lb.run_events_batch(scheds)
    assert _render_ok(cfg, "ascii8", texts, sync)
    rev = scheds[::-1]
    handles = [lb.dispatch_events_batch(s) for s in (scheds, rev, scheds)]
    lb.prefetch_events_batch(handles[0])
    res = [lb.collect_events_batch(h) for h in handles]
    chained = lb.run_events_chain([rev, scheds])
    for got in (res[0], res[1][::-1], res[2], chained[:128][::-1],
                chained[128:]):
        _events_close(got, sync)


@pytest.fixture(scope="module")
def world1():
    """A world of one rank on the card (NCCL, a localhost store) and its
    (1, 1) mesh, torn down after the module's fleet tests."""
    import torch.distributed as dist

    from minimodem_tpu_torch.parallel.sharding import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    made = not dist.is_initialized()
    mesh = make_mesh(device="cuda")
    yield mesh
    if made:
        dist.destroy_process_group()


def _counts():
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain
    from minimodem_tpu_torch.ops.fused_score import (FusedScorer,
                                                     score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, mega_rx_plain

    from minimodem_tpu_torch.ops.demod import score_frame_channels
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    return {"k1": FusedScorer.launches, "k2": MegaRx.launches,
            "k3": Correlator.launches + Correlator.batch_launches,
            "k5": FrameChannels.launches,
            "plain": score_planes_plain.calls + mega_rx_plain.calls
            + correlate_plain.calls + score_frame_channels.calls}


@pytest.mark.parametrize("enc", [None, "ulaw"])
def test_fleet_receiver_world1_equals_device_receiver(world1, enc):
    """ShardedReceiver at world size 1 on the card: K1 and K2 launched,
    no plain version, and every part of every stream equal to the
    single-card DeviceReceiver's."""
    from minimodem_tpu_torch.bench import _encode_wire
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver
    from minimodem_tpu_torch.parallel.service import ShardedReceiver

    cfg = _modem("1200").cfg
    texts = _payloads(3, 120)
    waves = [_modem("1200").modulate(t) for t in texts]
    if enc:
        waves = [_encode_wire(w, enc) for w in waves]
    x = np.zeros((3, max(map(len, waves))), waves[0].dtype)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    totals = [len(w) for w in waves]
    before = _counts()
    got, stats = ShardedReceiver(cfg, world1).run_events_batch(
        x, totals, THR, LIM, in_encoding=enc)
    after = _counts()
    assert after["k1"] > before["k1"] and after["k2"] > before["k2"]
    assert after["plain"] == before["plain"]
    ref, _ = DeviceReceiver(cfg, device="cuda").run_events_batch(
        x, totals, THR, LIM, in_encoding=enc)
    for g, r, t in zip(got, ref, texts):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
        assert g[2].tobytes() == t
    assert stats["devices"] == 1
    assert stats["frames_total"] == sum(len(t) for t in texts)


def test_fleet_loopback_world1_equals_device_loopback(world1):
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule
    from minimodem_tpu_torch.parallel.service import ShardedLoopback

    cfg = _modem("1200").cfg
    texts = _payloads(5, 150)
    scheds = [tx_bit_schedule(t, cfg, Ascii8Codec()) for t in texts]
    before = _counts()
    got = ShardedLoopback(cfg, world1).run_events_batch(scheds)
    after = _counts()
    assert after["k1"] > before["k1"] and after["k2"] > before["k2"]
    assert after["plain"] == before["plain"]
    ref = DeviceLoopback(cfg, device="cuda").run_events_batch(scheds)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [1, 3])
def test_sharded_step_world1_equals_score_fn(world1, batch):
    """sharded_decode_step at world size 1: K3 launched (the one-row form
    at batch 1), the channels bit for bit those of _build_score_fn."""
    from minimodem_tpu_torch.ops.demod import (CHANNELS, _build_score_fn,
                                               geometry_from_config)
    from minimodem_tpu_torch.parallel.sharding import sharded_decode_step

    cfg, wav = _noisy("1200", 9, n_bytes=200)
    t_len = 1 << 15
    x = np.resize(wav, (batch, t_len)).astype(np.float32)
    before = _counts()
    out = sharded_decode_step(cfg, world1, x, t_len)
    after = _counts()
    assert after["k3"] > before["k3"] and after["plain"] == before["plain"]
    assert after["k5"] > before["k5"]
    geo = geometry_from_config(cfg)
    xs = np.zeros((batch, t_len + geo.halo), np.float32)
    xs[:, :t_len] = x
    ref = _build_score_fn(geo, t_len, "cuda:0")(
        torch.from_numpy(xs).cuda()).cpu().numpy()
    for i, k in enumerate(CHANNELS):
        np.testing.assert_array_equal(out[k].view(np.int32), ref[:, i],
                                      err_msg=k)
