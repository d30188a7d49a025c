"""The device engine on every geometry: the port's DeviceReceiver,
PipelinedReceiver and state machine (minimodem_tpu_torch/ops/device_rx.py,
ops/mega_rx.py) against the JAX package on the geometries K1 does not
serve and in K2's wide, bits_hi and stop-on-overflow modes.

On the CPU the port runs the kernels' plain versions and the JAX package
its XLA receiver with the hybrid harvester off (MINIMODEM_TPU_HYBRID=0,
as in tests/test_torch_mega_rx.py).  Geometries, each at B = 2 streams of
seeded numpy audio:

  uic-train, uic-ground   39 data bits, 47 frame bits: wide records and
                          the bits_hi plane; stage 1 through K3
  float64                 Bell-202 at 24 kHz with 1200/2400 Hz tones
                          (perfect-capable): the float64 chain
  20 baud at 48 kHz       2400-tap bits, past K1's shared memory: K3
  1 baud at 48 kHz        48000-tap bits: the FFT stage 1, a scan window
                          of 72000 samples
  2 baud dual at 48 kHz   sync bytes (the dual layout) at a scan window
                          no ring of K2 holds

The state machine is held exactly: mega_rx_plain fed the JAX package's
own score planes gives the JAX XLA receiver's events, bytes and carry bit
for bit, in every mode.  The whole receiver (the port's scorer, then its
state machine) is held at the decisions: event types, frame bits, frame
starts, scan positions, counts and bytes identical, and the rendered
stdout and stderr byte-identical.  Its float lanes (confidence and
amplitude, per frame and as NOCARRIER totals) carry the scorers' known
last-bit drift (the port's magnitudes are sqrt(c*c + s*s) and its comb
sums run in ascending tap order, where XLA uses hypot and its own
reduction tree; ops/demod.py) and agree within rtol 2e-6, atol 1e-5.  On
the FFT route (nb > 4096) the transforms also sum in another order than
XLA's (ops/demod.py correlate_fft): the decisions stay identical and the
float lanes, and the confidence= and ampl= values the NOCARRIER lines
print, agree within rtol 5e-4, atol 1e-4 (a confidence is an SNR,
whose noise magnitude takes the transform's round-off relative to the
whole window).
"""

import io
import re

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem

THR, LIM = 1.5, 2.3
RTOL, ATOL = 2e-6, 1e-5
FFT_RTOL, FFT_ATOL = 5e-4, 1e-4
GEOMETRIES = ("uic-train", "uic-ground", "float64", "20baud", "1baud",
              "2baud-dual")
FFT_ROUTE = ("1baud", "2baud-dual")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def sequential_xla():
    from minimodem_tpu.ops import device_rx as D

    mp = pytest.MonkeyPatch()
    mp.setenv("MINIMODEM_TPU_HYBRID", "0")
    D._build_device_rx.cache_clear()
    yield
    D._build_device_rx.cache_clear()
    mp.undo()


# ----------------------------------------------------------------------
# signals
# ----------------------------------------------------------------------

def _noisy(wav, rng, amp=0.3):
    return (wav + (rng.random(wav.size, dtype=np.float32) - np.float32(0.5))
            * np.float32(amp)).astype(np.float32)


def _uic_burst(cfg, n_frames, rng):
    """n_frames UIC-751-3 telegrams of seeded data bits after the sync
    pattern 11110010, keyed as raw frame bits between mark leaders
    (tests/test_features.py::test_uic_decode)."""
    from minimodem_tpu_torch.ops.tx import ToneGenerator
    from minimodem_tpu_torch.sigio import SampleFormat

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
    return gen.synthesize()


def _bell(baud, rate, **kw):
    """(JAX cfg, port cfg, a JAX modem keyed to it)."""
    from minimodem_tpu.models.presets import bell_like as jax_bell
    from minimodem_tpu_torch.models.presets import bell_like

    m = FskModem("1200", sample_rate=rate)
    m.preset = jax_bell(baud, rate, **kw)
    m.cfg = m.preset.cfg
    return m.cfg, bell_like(baud, rate, **kw).cfg, m


def _geometry(name, seed=0):
    """(JAX cfg, port cfg, [two streams of float32 audio]) of a named
    geometry; the audio is made from a seed with numpy."""
    from minimodem_tpu.models.presets import uic as jax_uic
    from minimodem_tpu_torch.models.presets import uic
    from minimodem_tpu_torch.utils.cfloat import f32

    rng = np.random.default_rng(GEOMETRIES.index(name) + 10 * seed)
    if name.startswith("uic"):
        direction = name.split("-")[1]
        cfg = uic(direction).cfg
        gap = np.zeros(20000, np.float32)
        streams = [_noisy(np.concatenate([_uic_burst(cfg, 10, rng), gap,
                                          _uic_burst(cfg, 8, rng)]), rng)
                   for _ in range(2)]
        return jax_uic(direction).cfg, cfg, streams
    if name == "float64":
        jcfg, cfg, m = _bell(1200, 24000, mark_f=f32(1200), space_f=f32(2400))
        texts = [b"perfect line one\n", b"perfect line two, longer\n"]
        gap = np.zeros(6000, np.float32)
        streams = [np.concatenate([m.modulate(t), gap, m.modulate(t[:7])])
                   for t in texts]
        return jcfg, cfg, streams
    if name == "20baud":
        jcfg, cfg, m = _bell(20, 48000)
        return jcfg, cfg, [_noisy(m.modulate(t), rng) for t in (b"hi", b"20")]
    if name == "1baud":
        jcfg, cfg, m = _bell(1, 48000)
        return jcfg, cfg, [_noisy(m.modulate(t), rng) for t in (b"ab", b"c")]
    if name == "2baud-dual":
        jcfg, cfg, m = _bell(2, 48000, do_rx_sync=True, do_tx_sync_bytes=2,
                             sync_byte=0xAB)
        return jcfg, cfg, [_noisy(m.modulate(t), rng) for t in (b"ok", b"K")]
    raise KeyError(name)


def _batch(streams):
    n = max(len(s) for s in streams)
    x = np.zeros((len(streams), n), np.float32)
    for i, s in enumerate(streams):
        x[i, :len(s)] = s
    return x, [len(s) for s in streams]


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------

def _render(cfg, events, compact):
    """The port's Receiver rendering of one stream's events -> (stdout,
    stderr)."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.rx.engine import Receiver

    out, err = io.BytesIO(), io.StringIO()
    codec = "uic-" + ("train" if "train" in str(cfg.expect_data_string)
                      else "ground") if cfg.n_data_bits > 8 else "ascii8"
    rx = Receiver(cfg, RxOptions(), get_codec(codec), out.write, err.write,
                  device="cpu")
    rx.render_events(*events)
    return out.getvalue(), err.getvalue()


def _float_lanes(types, compact):
    """Per record, the payload lanes that hold floats: 1, 2 of a NOCARRIER
    (its confidence and amplitude totals); 2, 3 of a wide frame record."""
    lanes = np.zeros((len(types), 6), bool)
    lanes[types == 2, 1:3] = True
    if not compact:
        lanes[types == 0, 2:4] = True
    return lanes


def _tol(fft):
    return dict(rtol=FFT_RTOL, atol=FFT_ATOL) if fft else dict(rtol=RTOL,
                                                                atol=ATOL)


def assert_events_equal(got, ref, fft=None):
    """Per stream (ev_type, ev_pay[, bytes]).  fft None: identical.  Else
    the decisions identical (types, integer lanes, frame bits, bytes) and
    the float lanes within the route's tolerance (_tol)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        np.testing.assert_array_equal(g[0], r[0])
        if len(g) == 3:
            np.testing.assert_array_equal(g[2], r[2])
        gp, rp = np.asarray(g[1], np.uint32), np.asarray(r[1], np.uint32)
        if fft is None:
            np.testing.assert_array_equal(gp, rp)
            continue
        fl = _float_lanes(np.asarray(g[0]), len(g) == 3)
        np.testing.assert_array_equal(gp[~fl], rp[~fl])
        np.testing.assert_allclose(gp[fl].view(np.float32),
                                   rp[fl].view(np.float32), **_tol(fft))


_CARRY_FLOATS = ("track_amplitude", "peak_confidence", "conf_total",
                 "ampl_total")


def assert_carry_equal(got, ref, fft=None):
    """Carry fields identical; with fft not None the float fields within
    the route's tolerance."""
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if fft is not None and k in _CARRY_FLOATS:
            np.testing.assert_allclose(a, b, err_msg=k, **_tol(fft))
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


_NUM = re.compile(r"(confidence|ampl)=([0-9.]+|inf|nan)")


def assert_render_equal(got, ref, fft):
    """Rendered (stdout, stderr): identical, except that on the FFT route
    the confidence= and ampl= values of the NOCARRIER lines agree within
    FFT_RTOL / FFT_ATOL (plus the last printed digit)."""
    assert got[0] == ref[0]
    if not fft:
        assert got[1] == ref[1]
        return
    assert _NUM.sub(r"\1=#", got[1]) == _NUM.sub(r"\1=#", ref[1])
    g = [float(v) for _, v in _NUM.findall(got[1])]
    r = [float(v) for _, v in _NUM.findall(ref[1])]
    np.testing.assert_allclose(g, r, rtol=FFT_RTOL, atol=FFT_ATOL + 1e-3)


def _jax_rx(jcfg, x, totals, carry=None, finalize=True, **kw):
    from minimodem_tpu.ops.device_rx import DeviceReceiver

    return DeviceReceiver(jcfg, **kw).run_events_batch(
        x, totals, THR, LIM, carry=carry, finalize=finalize)


def _port_rx(cfg, x, totals, carry=None, finalize=True, **kw):
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

    return DeviceReceiver(cfg, device="cpu", **kw).run_events_batch(
        x, totals, THR, LIM, carry=carry, finalize=finalize)


# ----------------------------------------------------------------------
# the receiver, geometry by geometry
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", GEOMETRIES)
def test_device_receiver_matches_jax(name):
    """DeviceReceiver with the JAX package's default mode (compact for <= 8
    data bits, wide records for UIC) at B = 2: events, bytes and carry as
    the JAX DeviceReceiver, and the same rendered output."""
    jcfg, cfg, streams = _geometry(name)
    x, totals = _batch(streams)
    ref, ref_carry = _jax_rx(jcfg, x, totals)
    got, carry = _port_rx(cfg, x, totals)
    fft = name in FFT_ROUTE
    assert_events_equal(got, ref, fft)
    assert_carry_equal(carry, ref_carry, fft)
    compact = cfg.n_data_bits <= 8
    assert all(len(e) == (3 if compact else 2) for e in got)
    for g, r in zip(got, ref):
        assert_render_equal(_render(cfg, g, compact),
                            _render(cfg, r, compact), fft)
    out, err = _render(cfg, got[0], compact)
    assert err.count("### CARRIER") >= 1 and "NOCARRIER" in err
    if name.startswith("uic"):
        assert out.count(b"Train ID") >= 15
    elif name == "float64":
        assert out == b"perfect line one\nperfect"
        assert "confidence=inf" in err and "(rate perfect)" in err
    else:
        assert out in (b"hi", b"ab", b"ok")


@pytest.mark.parametrize("name", ["float64", "1200"])
def test_wide_records_match_jax(name):
    """compact=False on <= 8 data bits: one wide record per frame, with
    its bits, confidence, amplitude and frame start, as the JAX XLA
    receiver's."""
    if name == "1200":
        m = FskModem("1200")
        from minimodem_tpu_torch.models.presets import bell202

        jcfg, cfg = m.cfg, bell202().cfg
        streams = [m.modulate(b"wide records"), m.modulate(b"two")]
    else:
        jcfg, cfg, streams = _geometry(name)
    x, totals = _batch(streams)
    ref, ref_carry = _jax_rx(jcfg, x, totals, compact=False)
    got, carry = _port_rx(cfg, x, totals, compact=False)
    assert_events_equal(got, ref, False)
    assert_carry_equal(carry, ref_carry, False)
    assert (got[0][0] == 0).sum() >= 10
    compact_ev, _ = _port_rx(cfg, x, totals)
    assert _render(cfg, got[0], False) == _render(cfg, compact_ev[0], True)


@pytest.mark.parametrize("name", ["uic-train", "float64"])
def test_carried_segment_matches_jax(name):
    """A segment decoded with finalize=False, then the rest from its carry
    rebased by a step (as PipelinedReceiver does): the carry after the
    first segment equals JAX's field for field, and the second segment's
    events equal JAX's from the same carry."""
    jcfg, cfg, streams = _geometry(name)
    x, totals = _batch(streams)
    cut = min(totals) // 2
    ref1, ref_carry = _jax_rx(jcfg, x[:, :cut + 4000], [cut] * 2,
                              finalize=False)
    got1, carry = _port_rx(cfg, x[:, :cut + 4000], [cut] * 2, finalize=False)
    assert_events_equal(got1, ref1, False)
    assert_carry_equal(carry, ref_carry, False)
    step = cut // 2
    carry = {k: np.asarray(v).copy() for k, v in ref_carry.items()}
    carry["pos"] = carry["pos"] - np.int32(step)
    rest = [t - step for t in totals]
    ref2, ref_carry2 = _jax_rx(jcfg, x[:, step:], rest, carry=carry)
    got2, carry2 = _port_rx(cfg, x[:, step:], rest, carry=carry)
    assert_events_equal(got2, ref2, False)
    assert_carry_equal(carry2, ref_carry2, False)
    assert any(len(e[0]) for e in got2)


def _two_bursts(name):
    """Two bursts on one band with silence between them, so the carrier
    drops (a reported overflow) and the silence overflows again."""
    jcfg, cfg, streams = _geometry(name)
    gap = np.zeros(60000 if name == "float64" else 40000, np.float32)
    return jcfg, cfg, [np.concatenate([s, gap, s[:len(s) // 2]])
                       for s in streams]


@pytest.mark.parametrize("name", ["float64", "uic-ground"])
def test_stop_on_overflow_matches_jax(name):
    """stop_on_overflow (the device -a loop's mode): each stream stops at
    its first no-confidence overflow with wide records whose lane 5 holds
    each iteration's scan position; resumed from the carry with stop
    cleared, it stops at the next one.  Events and carry as JAX's."""
    jcfg, cfg, streams = _two_bursts(name)
    x, totals = _batch(streams)
    carry_j = carry_t = None
    for call in range(3):
        ref, carry_j = _jax_rx(jcfg, x, totals, carry=carry_j,
                               finalize=False, stop_on_overflow=True)
        got, carry_t = _port_rx(cfg, x, totals, carry=carry_t,
                                finalize=False, stop_on_overflow=True)
        assert_events_equal(got, ref, False)
        assert_carry_equal(carry_t, carry_j, False)
        assert all(len(e) == 2 for e in got)
        if call == 0:
            assert carry_t["stop"].all()
            frames = got[0][0] == 0
            pos = got[0][1][frames, 5].astype(np.int64)
            assert frames.sum() >= 2 and (np.diff(pos) > 0).all()
        carry_j = {k: np.asarray(v).copy() for k, v in carry_j.items()}
        carry_t = {k: np.asarray(v).copy() for k, v in carry_t.items()}
        carry_j["stop"][:] = False
        carry_t["stop"][:] = False


# ----------------------------------------------------------------------
# the plain K2 against the XLA receiver, on the JAX package's planes
# ----------------------------------------------------------------------

def _jax_planes(key, x, t_total):
    """The JAX make_score_packer's channels for each stream, in the port's
    plane layout (ops/device_rx.py plane_names), as int32 bit patterns."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops.device_rx import geo_from_key, plane_names

    fn = jax.jit(jax.vmap(D.make_score_packer(key, t_total, "float32")))
    packed = np.asarray(fn(jnp.asarray(x))).view(np.int32)   # [B, 8, T]
    row = {"conf_data": 0, "conf_sync": 1, "ampl_data": 2, "ampl_sync": 3,
           "bits_lo": 4, "bits_hi": 5}
    return packed[:, [row[n] for n in plane_names(geo_from_key(key))]]


@pytest.mark.parametrize("mode", ["compact", "wide", "stop_on_overflow",
                                  "bits_hi"])
def test_plain_k2_matches_xla_receiver(mode):
    """mega_rx_plain on the JAX package's own score planes against the JAX
    XLA receiver (_build_device_rx) in the same mode, with the XLA
    receiver's event bounds: compact, wide, stop-on-overflow (wide) on
    Bell-202 with a gap, and UIC's 47-bit frames (wide, bits_hi)."""
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops.device_rx import _collect, device_rx_key
    from minimodem_tpu_torch.ops.mega_rx import (MegaReceiver, MegaRx,
                                                 MegaStatics)

    if mode == "bits_hi":
        jcfg, cfg, streams = _geometry("uic-train")
    else:
        m = FskModem("1200")
        from minimodem_tpu_torch.models.presets import bell202

        jcfg, cfg = m.cfg, bell202().cfg
        gap = np.zeros(30000, np.float32)
        streams = [np.concatenate([m.modulate(t), gap, m.modulate(b"again")])
                   for t in (b"first", b"second burst")]
    compact = mode == "compact"
    sor = mode == "stop_on_overflow"
    key = device_rx_key(cfg)
    assert key == D.device_rx_key(jcfg)
    x, totals = _batch(streams)
    t_total = D._round_up_pow2(max(totals) + cfg.nsamples_overscan + 1)
    xp = np.zeros((2, t_total + D.geo_from_key(key).halo), np.float32)
    xp[:, :x.shape[1]] = x
    fn, _, _ = D._build_device_rx(key, t_total, False, "float32", True,
                                  compact, stop_on_overflow=sor)
    out = fn(xp, np.asarray(totals, np.int32), np.float32(THR),
             np.float32(LIM), D.zero_carry(2))
    ref = D._collect_results(out[:-1], 2, compact)
    st = MegaStatics.build(key, t_total, False, compact, sor)
    ci, cf = MegaReceiver.carry_to_arrays(None, 2)
    got = MegaRx(st)(torch.from_numpy(_jax_planes(key, xp, t_total)),
                     torch.tensor(totals, dtype=torch.int32), (THR, LIM),
                     torch.from_numpy(ci), torch.from_numpy(cf), True)
    assert_events_equal(_collect(got[:4], 2, compact), ref)
    assert_carry_equal(MegaReceiver.arrays_to_carry(got[4].numpy(),
                                                    got[5].numpy()),
                       {k: np.asarray(v) for k, v in out[-1].items()})
    if not compact:
        # the XLA receiver's event bound (device_rx.py:442-445); compact
        # Bell-202 keeps the megakernel's, the route the JAX package
        # takes for it on the TPU
        assert st.max_events == ((t_total // max(1, min(
            cfg.frame_nsamples - cfg.nsamples_overscan, *st.try_max))
            + 23) // 8) * 8


# ----------------------------------------------------------------------
# the scorer for the geometries K1 does not serve
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uic-ground", "float64", "20baud", "1baud"])
def test_score_packer_matches_jax(name):
    """make_score_packer against the JAX make_score_packer at the channel
    values, two streams: frame bits exact and confidence and amplitude
    within rtol 2e-6, atol 1e-5 (the port's magnitudes are sqrt(c*c + s*s)
    where XLA's are hypot; ops/demod.py), through K3 (UIC, 20 baud) and
    the float64 chain; on the FFT route (1 baud) within FFT_RTOL /
    FFT_ATOL.  On the FFT route only the offsets whose bit windows lie in
    the audio are compared: past its end both scorers see their own
    transform round-off, whose mark > space ties fall either way."""
    from minimodem_tpu_torch.ops.device_rx import (
        device_rx_key, geo_from_key, make_score_packer, plane_names)
    from minimodem_tpu_torch.ops.fused_score import serves

    jcfg, cfg, streams = _geometry(name)
    key = device_rx_key(cfg)
    geo = geo_from_key(key)
    assert not serves(geo)
    t_total = 1 << 14 if name == "20baud" else 1 << 16
    start = 0 if name == "1baud" else geo.nb * 4   # 1 baud: the first frame
    x = np.zeros((2, t_total + geo.halo), np.float32)
    scored = np.zeros((2, t_total), bool)
    for i, s in enumerate(streams):
        seg = s[start:start + x.shape[1]]
        x[i, :len(seg)] = seg
        scored[i, :max(0, len(seg) - geo.halo)] = True
    if name != "1baud":
        scored[:] = True
    assert scored.sum() >= t_total // 2
    ref = _jax_planes(key, x, t_total)
    got = make_score_packer(key, t_total, "float32")(
        torch.from_numpy(x)).numpy()
    names = plane_names(geo)
    assert got.shape == ref.shape == (2, len(names), t_total)
    for i, n in enumerate(names):
        g, r = got[:, i][scored], ref[:, i][scored]
        if n.startswith("bits"):
            np.testing.assert_array_equal(g, r, err_msg=n)
        else:
            np.testing.assert_allclose(g.view(np.float32), r.view(np.float32),
                                       err_msg=n, **_tol(name == "1baud"))
    assert np.count_nonzero(ref[:, 0][scored]) > 0


@pytest.mark.parametrize("rate", [8000, 48000])
def test_scorer_route_is_k1_exactly_where_k1_fits(rate):
    """One eligibility rule (fused_score.serves) decides the score route
    and K1's own check: float32, <= 32 frame bits and a tile whose CTA
    fits the shared memory.  Bauds 1-1200 and every preset: K1 builds
    where it serves and refuses elsewhere, and the planes come from
    make_score_packer there (the route of uic, float64 and slow bauds)."""
    from minimodem_tpu_torch.config import ConfigError
    from minimodem_tpu_torch.models.presets import PRESETS, bell_like
    from minimodem_tpu_torch.ops import fused_score as FS
    from minimodem_tpu_torch.ops.demod import geometry_from_config

    cfgs = [make(sample_rate=rate).cfg for make in PRESETS.values()]
    for b in (1, 2, 4.5, 5, 10, 20, 29, 30, 31, 45.45, 100, 300, 1200):
        try:
            cfgs.append(bell_like(float(b), rate).cfg)
        except ConfigError:
            pass
    routes = set()
    for cfg in cfgs:
        geo = geometry_from_config(cfg)
        if FS.serves(geo):
            assert FS.FusedScorer(geo).tile == FS.pick_tile(geo)
        else:
            with pytest.raises(ValueError):
                FS.FusedScorer(geo)
        routes.add((FS.serves(geo), geo.use_f64 or geo.n_bits > 32
                    or FS.pick_tile(geo) is None))
    assert routes == {(True, False), (False, True)}


def test_no_ring_where_no_scan_window_fits():
    """K2's ring geometry: none where a scan window of the held planes does
    not fit the shared memory (1 baud, 72000 samples; 2 baud in the dual
    layout, two confidence planes of 36000), the confidence plane alone
    at 2 baud single."""
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops import mega_rx as M
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    def ring(baud, **kw):
        key = device_rx_key(bell_like(baud, 48000, **kw).cfg)
        return M.ring_geometry(M.MegaStatics.build(key, 1 << 16, False))

    assert ring(1).stages == 0
    assert ring(2, do_rx_sync=True, sync_byte=0xAB).stages == 0
    r = ring(2)
    assert r.n_held == 1 and r.window * (r.stages - 1) >= 36000
    assert r.smem_bytes <= M.SMEM_MAX


@pytest.mark.parametrize("rate", [8000, 48000])
def test_candidate_tables_fit_k_max(rate):
    """No preset, and no bell_like baud from 1 to 9600, has more than 15
    scan candidates in a table (K2's tables hold K_MAX = 16)."""
    from minimodem_tpu_torch.config import ConfigError
    from minimodem_tpu_torch.models.presets import PRESETS, bell_like
    from minimodem_tpu_torch.ops import mega_rx as M
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    cfgs = [make(sample_rate=rate).cfg for make in PRESETS.values()]
    for b in list(range(1, 50)) + list(range(50, 9601, 37)):
        try:
            cfgs.append(bell_like(float(b), rate).cfg)
        except ConfigError:        # tones past Nyquist at this rate
            pass
    assert len(cfgs) > 100
    worst = max(len(g[k]) for cfg in cfgs
                for g in M._static_geom(device_rx_key(cfg)).values()
                for k in ("coarse", "fine"))
    assert worst <= 15 < M.K_MAX


# ----------------------------------------------------------------------
# the pipelined receiver and the loopback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uic-train", "float64"])
def test_pipelined_receiver_matches_jax(name):
    """Both packages' PipelinedReceiver at a short segment (a carried state
    across segments; wide tuples for UIC), rendered through each package's
    Receiver: the same stdout and stderr."""
    from minimodem_tpu.codecs import get_codec as jax_codec
    from minimodem_tpu.config import RxOptions as JaxRxOptions
    from minimodem_tpu.ops.device_rx import PipelinedReceiver as JaxPR
    from minimodem_tpu.rx.engine import Receiver as JaxReceiver
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver
    from minimodem_tpu_torch.rx.engine import Receiver

    jcfg, cfg, streams = _geometry(name)
    samples = np.concatenate(streams + streams)
    codec = name if name.startswith("uic") else "ascii8"
    seg_len = 1 << (16 if name.startswith("uic") else 14)
    sink_j, errs_j = io.BytesIO(), []
    jpr = JaxPR(jcfg, segment_len=seg_len)
    assert len(samples) > jpr.segment_len
    rj = JaxReceiver(jcfg, JaxRxOptions(), jax_codec(codec), sink_j.write,
                     errs_j.append)
    for seg in jpr.run(samples, THR, LIM):
        rj.render_events(*seg)
    sink_t, errs_t = io.BytesIO(), []
    tpr = PipelinedReceiver(cfg, segment_len=seg_len, device="cpu")
    rt = Receiver(cfg, RxOptions(), get_codec(codec), sink_t.write,
                  errs_t.append, device="cpu")
    segs = list(tpr.run(samples, THR, LIM))
    assert len(segs) >= 2
    assert all(len(s) == (2 if name.startswith("uic") else 3) for s in segs)
    for seg in segs:
        rt.render_events(*seg)
    assert sink_t.getvalue() == sink_j.getvalue() != b""
    assert "".join(errs_t) == "".join(errs_j)
