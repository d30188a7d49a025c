"""K2 parity: the port's state machine (minimodem_tpu_torch/ops/mega_rx.py)
fed the JAX package's own score planes.

On the CPU the port runs the kernel's plain version.  Its events and
bytes must be identical to the JAX package's DeviceReceiver (XLA engine,
CPU) for the same audio, and in one case to the interpret-mode Pallas
megakernel (pattern of tests/test_pallas_rx.py:12-46).  A carry produced
by the JAX receiver must resume in the port with the same decisions.

The XLA reference runs with its hybrid harvester off
(MINIMODEM_TPU_HYBRID=0): the harvester's vectorised replay of locked
frame runs sums ampl_total one ulp away from the sequential order on the
rx_one case, where the sequential XLA loop and the Pallas megakernel —
the TPU main path, which the port follows — agree bit for bit.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from minimodem_tpu.models.modem import FskModem

THR, LIM = 1.5, 2.3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def sequential_xla(monkeypatch):
    from minimodem_tpu.ops import device_rx as D

    monkeypatch.setenv("MINIMODEM_TPU_HYBRID", "0")
    D._build_device_rx.cache_clear()
    yield
    D._build_device_rx.cache_clear()


def _jax_planes(cfg, x, t_total):
    """The JAX package's score planes for one stream, in the port's layout
    [P, T] int32 (rows cd, ad, bl (, cs, as))."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import device_rx as D

    key = D.device_rx_key(cfg)
    fn, n_ch, rows = D.make_score_packer_planes(key, t_total, "float32")
    out = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    order = [rows["cd"], rows["ad"], rows["bl"]]
    if tuple(D.geo_from_key(key).req_sync) != tuple(
            D.geo_from_key(key).req_data):
        order += [rows["cs"], rows["as_"]]
    return out[order].view(np.int32)


def _port_k2(cfg, planes, total, t_total, rx_one=False, carry=None,
             finalize=True):
    """The port's K2 (plain, CPU) on given planes -> (events, carry)."""
    from minimodem_tpu_torch.ops.device_rx import _collect, device_rx_key
    from minimodem_tpu_torch.ops.mega_rx import (MegaReceiver, MegaRx,
                                                 MegaStatics)

    key = device_rx_key(cfg)
    mega = MegaRx(MegaStatics.build(key, t_total, rx_one))
    ci, cf = MegaReceiver.carry_to_arrays(carry, 1)
    out = mega(torch.from_numpy(planes)[None],
               torch.tensor([total], dtype=torch.int32), (THR, LIM),
               torch.from_numpy(ci), torch.from_numpy(cf), finalize)
    return (_collect(out[:4], 1)[0],
            MegaReceiver.arrays_to_carry(out[4].numpy(), out[5].numpy()))


def _assert_events_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


_CASES = ("gap", "noise", "rate_slop", "same", "rtty", "rx_one")


def _case(name):
    """(rx cfg, audio float32, rx_one) for a named scenario; inputs are
    made from a seed with numpy."""
    rng = np.random.default_rng(sorted(_CASES).index(name))
    gap = np.zeros(24000, np.float32)
    if name == "gap":
        m = FskModem("1200")
        wav = np.concatenate([m.modulate(b"first burst, then silence"), gap,
                              m.modulate(b"re-acquired")])
        return m.cfg, wav, False
    if name == "rx_one":
        m = FskModem("1200")
        wav = np.concatenate([m.modulate(b"only this one"), gap,
                              m.modulate(b"never decoded")])
        return m.cfg, wav, True
    if name == "noise":
        m = FskModem("1200")
        text = rng.integers(32, 127, size=40, dtype=np.uint8).tobytes()
        wav = m.modulate(text)
        wav = wav + (rng.random(wav.size, dtype=np.float32)
                     - np.float32(0.5)) * np.float32(0.8)
        return m.cfg, wav.astype(np.float32), False
    if name == "rate_slop":
        wav = FskModem("305").modulate(b"305 baud into a 300 baud rx")
        return FskModem("300").cfg, wav, False
    if name == "same":
        m = FskModem("same")
        return m.cfg, m.modulate(b"ZCZC-WXR-RWT-020103+0015-"), False
    if name == "rtty":
        m = FskModem("rtty")
        return m.cfg, m.modulate(b"RYRY THE QUICK BROWN FOX 73"), False
    raise KeyError(name)


def _jax_device_rx(cfg, wav, rx_one, carry=None, finalize=True, total=None):
    from minimodem_tpu.ops.device_rx import DeviceReceiver

    total = len(wav) if total is None else total
    ev, c = DeviceReceiver(cfg, rx_one=rx_one).run_events_batch(
        wav[None, :], [total], THR, LIM, carry=carry, finalize=finalize)
    return ev[0], c


@pytest.mark.parametrize("name", _CASES)
def test_plain_k2_on_jax_planes_matches_device_receiver(name):
    from minimodem_tpu.ops.device_rx import _round_up_pow2, geo_from_key
    from minimodem_tpu.ops.device_rx import device_rx_key as jkey

    cfg, wav, rx_one = _case(name)
    halo = geo_from_key(jkey(cfg)).halo
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    x = np.zeros(t_total + halo, np.float32)
    x[:len(wav)] = wav
    ref, _ = _jax_device_rx(cfg, wav, rx_one)
    got, _ = _port_k2(cfg, _jax_planes(cfg, x, t_total), len(wav), t_total,
                      rx_one)
    _assert_events_equal(got, ref)
    assert len(ref[2]) > 0 and len(ref[0]) >= 2


def test_plain_k2_matches_interpret_megakernel(monkeypatch):
    """The interpret-mode Pallas megakernel on the same audio."""
    from jax.experimental import pallas as pl

    from minimodem_tpu.ops import pallas_rx as P
    from minimodem_tpu.ops.device_rx import _round_up_pow2, geo_from_key
    from minimodem_tpu.ops.device_rx import device_rx_key as jkey

    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    P.build_mega_rx.cache_clear()
    P._mega_run_fn.cache_clear()
    try:
        cfg, wav, _ = _case("gap")
        ref, _ = P.MegaReceiver(cfg).run_events_batch(
            wav[None, :], [len(wav)], THR, LIM)
    finally:
        P.build_mega_rx.cache_clear()
        P._mega_run_fn.cache_clear()
    halo = geo_from_key(jkey(cfg)).halo
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    x = np.zeros(t_total + halo, np.float32)
    x[:len(wav)] = wav
    got, _ = _port_k2(cfg, _jax_planes(cfg, x, t_total), len(wav), t_total)
    _assert_events_equal(got, ref[0])


def _planes_of(cfg, wav, total):
    from minimodem_tpu.ops.device_rx import _round_up_pow2, geo_from_key
    from minimodem_tpu.ops.device_rx import device_rx_key as jkey

    t_total = _round_up_pow2(total + cfg.nsamples_overscan + 1)
    x = np.zeros(t_total + geo_from_key(jkey(cfg)).halo, np.float32)
    n = min(len(wav), x.size)
    x[:n] = wav[:n]
    return _jax_planes(cfg, x, t_total), t_total


def test_jax_carry_resumes_in_port():
    """Segment 1 decodes in the JAX receiver (finalize=False); its carry,
    rebased onto segment 2, resumes in the port's K2 and gives JAX's own
    second-segment result.  The port's carry after segment 1 equals
    JAX's field for field."""
    from minimodem_tpu.ops.device_rx import PipelinedReceiver as JPR

    m = FskModem("1200")
    text = bytes(33 + (i % 94) for i in range(240))
    wav = np.concatenate([m.modulate(text[:150]), np.zeros(9000, np.float32),
                          m.modulate(text[150:])]).astype(np.float32)
    pr = JPR(m.cfg, segment_len=1 << 16)
    seg, step = pr.segment_len, pr.step
    assert len(wav) > seg
    total_nf = seg - pr._lookahead + m.cfg.expect_nsamples

    ev1, carry = _jax_device_rx(m.cfg, wav[:seg], False, finalize=False,
                                total=total_nf)
    planes, t_total = _planes_of(m.cfg, wav[:seg], total_nf)
    port_ev1, port_carry = _port_k2(m.cfg, planes, total_nf, t_total,
                                    finalize=False)
    _assert_events_equal(port_ev1, ev1)
    for k in carry:
        np.testing.assert_array_equal(np.asarray(port_carry[k]),
                                      np.asarray(carry[k]), err_msg=k)

    carry = {k: np.asarray(v).copy() for k, v in carry.items()}
    carry["pos"] = carry["pos"] - np.int32(step)
    tail = wav[step:]
    ref2, _ = _jax_device_rx(m.cfg, tail, False, carry=carry)
    planes, t_total = _planes_of(m.cfg, tail, len(tail))
    got2, _ = _port_k2(m.cfg, planes, len(tail), t_total, carry=carry)
    _assert_events_equal(got2, ref2)
    assert bytes(ev1[2]) + bytes(ref2[2]) == text


def test_zero_carry_matches_jax():
    """A fresh carry has JAX's fields and dtypes and packs to the same
    arrays as no carry at all."""
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops import device_rx as TD
    from minimodem_tpu_torch.ops.mega_rx import MegaReceiver

    ref, got = D.zero_carry(3), TD.zero_carry(3)
    assert tuple(got) == TD.CARRY_FIELDS == D.CARRY_FIELDS
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for a, b in zip(MegaReceiver.carry_to_arrays(got, 3),
                    MegaReceiver.carry_to_arrays(None, 3)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_runs_plain_only_on_cpu():
    from minimodem_tpu_torch.ops import mega_rx as M
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    st = M.MegaStatics.build(device_rx_key(FskModem("1200").cfg), 1 << 14,
                             False)
    planes = torch.zeros((1, 3, 1 << 14), dtype=torch.int32)
    args = (torch.tensor([1 << 14], dtype=torch.int32), (THR, LIM),
            torch.zeros((1, 8), dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.float32), True)
    calls, launches = M.mega_rx_plain.calls, M.MegaRx.launches
    out = M.MegaRx(st)(planes, *args)
    assert int(out[1][0]) == 0 and int(out[3][0]) == 0     # silence
    assert M.mega_rx_plain.calls == calls + 1
    assert M.MegaRx.launches == launches
    with pytest.raises(ValueError):
        M.MegaRx(st)(planes.to("meta"), *args)


@pytest.mark.parametrize("mode", ["uic-train"])
def test_wide_geometry_on_jax_planes_matches_device_receiver(mode):
    """More than 8 data bits (UIC, once refused): the port's K2 in wide
    mode, fed the JAX package's planes with the bits_hi plane, gives the
    JAX DeviceReceiver's wide records and carry bit for bit."""
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu.ops.tx import ToneGenerator
    from minimodem_tpu.sigio import SampleFormat
    from minimodem_tpu_torch.ops.device_rx import _collect, device_rx_key
    from minimodem_tpu_torch.ops.mega_rx import (MegaReceiver, MegaRx,
                                                 MegaStatics)

    cfg = FskModem(mode).cfg
    rng = np.random.default_rng(3)
    gen = ToneGenerator(cfg.sample_rate, SampleFormat.FLOAT)
    bits = [1] * 8
    for _ in range(6):
        data = int(rng.integers(0, 1 << 39))
        bits += [1, 1, 1, 1, 0, 0, 1, 0] + [(data >> i) & 1
                                            for i in range(39)]
    for v in bits + [1] * 8:
        gen.tone(float(cfg.mark_f if v else cfg.space_f), cfg.bit_nsamples_tx)
    wav = gen.synthesize().astype(np.float32)
    (ref_t, ref_p), = D.DeviceReceiver(cfg).run_events_batch(
        wav[None, :], [len(wav)], THR, LIM)[0]
    key = device_rx_key(cfg)
    t_total = D._round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    x = np.zeros(t_total + D.geo_from_key(key).halo, np.float32)
    x[:len(wav)] = wav
    import jax
    import jax.numpy as jnp

    packed = np.asarray(jax.jit(D.make_score_packer(key, t_total, "float32"))(
        jnp.asarray(x))).view(np.int32)
    planes = packed[[0, 2, 4, 5]]            # cd, ad, bits_lo, bits_hi
    st = MegaStatics.build(key, t_total, False, compact=False)
    assert st.bits_hi and st.n_planes == 4
    ci, cf = MegaReceiver.carry_to_arrays(None, 1)
    out = MegaRx(st)(torch.from_numpy(planes)[None],
                     torch.tensor([len(wav)], dtype=torch.int32), (THR, LIM),
                     torch.from_numpy(ci), torch.from_numpy(cf), True)
    got_t, got_p = _collect(out[:4], 1, False)[0]
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_array_equal(got_p, ref_p)
    frames = got_t == 0
    assert frames.sum() == 6 and (got_p[frames, 1] != 0).any()   # bits_hi


def test_float64_geometry_matches_jax():
    """Perfect-capable geometries score in float64 in the JAX package
    (once refused here): MegaReceiver decodes them on the CPU with the
    JAX DeviceReceiver's events and bytes, confidence=inf included."""
    from minimodem_tpu.models.presets import bell_like as jax_bell
    from minimodem_tpu.ops.device_rx import DeviceReceiver
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.mega_rx import MegaReceiver

    jcfg = jax_bell(1200.0, 24000).cfg
    jcfg.mark_f, jcfg.space_f = np.float32(1200), np.float32(2400)
    jcfg.finalize()
    cfg = bell_like(1200.0, 24000).cfg
    cfg.mark_f, cfg.space_f = np.float32(1200), np.float32(2400)
    cfg.finalize()
    m = FskModem("1200", sample_rate=24000)
    m.cfg = jcfg
    wav = m.modulate(b"rate perfect")
    ref, _ = DeviceReceiver(jcfg).run_events_batch(
        wav[None, :], [len(wav)], THR, LIM)
    got, _ = MegaReceiver(cfg, device="cpu").run_events_batch(
        wav[None, :], [len(wav)], THR, LIM)
    _assert_events_equal(got[0], ref[0])
    assert bytes(got[0][2]) == b"rate perfect"
    assert np.isinf(got[0][1][-1, 1:2].view(np.float32)).all()


# ----------------------------------------------------------------------
# the CUDA kernel's formulation, on the CPU: its warp-parallel search rule
# and its ring geometry (the card tests hold the kernel itself)
# ----------------------------------------------------------------------

_SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 1.5, 2.3, 3.0]


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(hs.data())
def test_find_frame_parallel_equals_sequential(data):
    """The ballot and max-reduction rule picks the sequential replay's
    winner: confidences with ties, NaN, +-inf, 0 and -0; limits 0, finite
    and inf; short tables ended by -1; reads out of range."""
    from minimodem_tpu_torch.ops.mega_rx import _find_frame, find_frame_parallel

    n = data.draw(hs.integers(1, 48), label="t_scored")
    # ties: a few values recur often
    value = hs.one_of(hs.sampled_from(_SPECIAL), hs.sampled_from([2.0, 4.0]),
                      hs.floats(width=32))
    conf = np.array(data.draw(hs.lists(value, min_size=n, max_size=n),
                              label="conf"), np.float32)
    ampl = np.arange(n, dtype=np.float32) + np.float32(0.5)
    bits = (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(
        np.uint32).view(np.int32)
    cands = data.draw(hs.lists(hs.integers(0, 56), max_size=16), label="cands")
    table = cands + [-1] * data.draw(hs.integers(0, 32 - len(cands)))
    pos = data.draw(hs.integers(-8, n + 8), label="pos")
    limit = np.float32(data.draw(hs.one_of(
        hs.sampled_from([0.0, -0.0, 1.5, 2.0, 2.3, 4.0, np.inf]),
        hs.floats(width=32, allow_nan=False)), label="limit"))
    seq = _find_frame(conf, ampl, bits, n, pos, table, limit)
    par = find_frame_parallel(conf, ampl, bits, n, pos, table, limit)
    assert [np.float32(v).view(np.uint32) for v in seq[:2]] == \
        [np.float32(v).view(np.uint32) for v in par[:2]]
    assert tuple(seq[2:]) == tuple(par[2:])


_NAN, _INF = float("nan"), float("inf")


@pytest.mark.parametrize("conf,table,limit,winner", [
    ([1.5, 4.0], [0, 1], 1.5, 0),          # cv == limit stops the search
    ([2.0, 4.0, 4.0], [0, 1, 2], _INF, 1),  # ties: the first of the largest
    ([4.0, 4.0, 9.0], [2, 1, 0], 3.0, 0),  # table order, not offset order
    ([_NAN, 1.0, _NAN], [0, 2, 1], 0.5, 2),  # NaN never wins
    ([_INF, 5.0, _INF], [1, 0, 2], _INF, 1),  # inf >= inf
    ([-0.0, 0.0, -1.0], [0, 1, 2], 0.0, None),  # nothing > 0: no winner
    ([3.0, 5.0], [1, -1, 0], 4.0, 0),      # -1 ends the table
    ([3.0, 5.0], [1, 0], -_INF, 0),        # any cv > 0 reaches -inf
])
def test_find_frame_parallel_cases(conf, table, limit, winner):
    from minimodem_tpu_torch.ops.mega_rx import _find_frame, find_frame_parallel

    conf = np.array(conf, np.float32)
    n = len(conf)
    ampl = np.arange(n, dtype=np.float32) + np.float32(0.5)
    bits = np.arange(n, dtype=np.int32) * 3 + 1
    seq = _find_frame(conf, ampl, bits, n, 0, table, np.float32(limit))
    par = find_frame_parallel(conf, ampl, bits, n, 0, table, np.float32(limit))
    want = (0, 0, 0, 0) if winner is None else (
        conf[table[winner]], ampl[table[winner]], int(bits[table[winner]]),
        table[winner])
    for got in (seq, par):
        assert [np.float32(v).view(np.uint32) for v in got[:2]] == \
            [np.float32(v).view(np.uint32) for v in want[:2]]
        assert tuple(got[2:]) == tuple(want[2:])


@pytest.mark.parametrize("name", ["noise", "same"])
def test_plain_k2_with_parallel_search_matches_device_receiver(name,
                                                               monkeypatch):
    """The whole state machine with the warp-parallel search rule in place
    of the sequential replay gives JAX's events (the dual layout too)."""
    from minimodem_tpu.ops.device_rx import _round_up_pow2, geo_from_key
    from minimodem_tpu.ops.device_rx import device_rx_key as jkey
    from minimodem_tpu_torch.ops import mega_rx as M

    monkeypatch.setattr(M, "_find_frame", M.find_frame_parallel)
    cfg, wav, rx_one = _case(name)
    t_total = _round_up_pow2(len(wav) + cfg.nsamples_overscan + 1)
    x = np.zeros(t_total + geo_from_key(jkey(cfg)).halo, np.float32)
    x[:len(wav)] = wav
    ref, _ = _jax_device_rx(cfg, wav, rx_one)
    got, _ = _port_k2(cfg, _jax_planes(cfg, x, t_total), len(wav), t_total,
                      rx_one)
    _assert_events_equal(got, ref)


def _ring_rule(st):
    w = max(st.try_max)
    return w, w + max(w - 1 + st.frame_nsamples - st.overscan, w)


@pytest.mark.parametrize("rate", [8000, 24000, 48000])
def test_ring_geometry_covers_every_served_preset(rate):
    """For every preset (K2 serves them all), the ring's G and S cover a
    scan window plus one advance, fit the CTA's shared memory, and hold
    every plane exactly when a covering ring of every plane fits (UIC's
    bits_hi plane is read from global memory, never held)."""
    from minimodem_tpu_torch.models.presets import PRESETS
    from minimodem_tpu_torch.ops import mega_rx as M
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    served = 0
    for name, make in PRESETS.items():
        cfg = make(sample_rate=rate).cfg
        key = device_rx_key(cfg)
        served += 1
        st = M.MegaStatics.build(key, 1 << 16, False,
                                 compact=cfg.n_data_bits <= 8)
        ring = M.ring_geometry(st)
        _, need = _ring_rule(st)
        n_all = 5 if st.dual else 3
        assert ring.window * (ring.stages - 1) >= need, name
        assert ring.stages >= M.RING_MIN_STAGES
        assert ring.smem_bytes == M.ring_smem_bytes(ring.n_held, ring.stages)
        assert ring.smem_bytes <= 232448, name
        assert ring.hold_all == (
            M.ring_smem_bytes(n_all, ring.stages) <= 232448), name
        assert ring.n_held == (n_all if ring.hold_all else n_all - 2), name
        assert ring.hold_all, name            # every preset fits whole
    assert served == len(PRESETS) == 11


@pytest.mark.parametrize("baud,sync", [(30, False), (10, False), (4.5, False),
                                       (4.5, True)])
def test_ring_geometry_slow_bauds(baud, sync):
    """Slow geometries of the JAX megakernel's route, up to its widest
    scan window (4.5 baud at 48 kHz, ~16000 samples), in the single and
    the dual layout: the ring holds the confidence plane(s) only, covers
    an advance where that fits, and always holds a scan window within the
    shared memory (tests/test_torch_device_rx_wide.py has the slower
    bauds, where no ring holds one)."""
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops import mega_rx as M
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    kw = {"do_rx_sync": True, "sync_byte": 0xAB} if sync else {}
    key = device_rx_key(bell_like(baud, 48000, **kw).cfg)
    assert M.megakernel_route(key)
    st = M.MegaStatics.build(key, 1 << 16, False)
    assert st.dual == sync
    ring = M.ring_geometry(st)
    w, need = _ring_rule(st)
    n_conf = 2 if sync else 1
    assert not ring.hold_all and ring.n_held == n_conf
    assert ring.window * (ring.stages - 1) >= w
    assert ring.smem_bytes <= 232448
    covering = -(-need // ring.window) + 1
    if M.ring_smem_bytes(n_conf, covering) <= 232448:
        assert ring.stages == covering
    else:
        assert M.ring_smem_bytes(n_conf, ring.stages + 1) > 232448
