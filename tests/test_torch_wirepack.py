"""The delta-bitpack wire (minimodem_tpu_torch/ops/wirepack.py) against
the JAX package's (minimodem_tpu/ops/wirepack.py), on the CPU.

  - the host half (a copy of the JAX module): pack bytes, exception
    counts, the chooser and the spec token equal the JAX module's, with
    the native packer and with the NumPy one;
  - unpack_expand equals the JAX unpack_expand bit for bit over the whole
    row [B, n_target], the masked tail included, for the cases of
    tests/test_wirepack.py (tone, silence, escape; k 0..5; w 8 and 12;
    randomized cuts and extras), a signal that starts negative (the int32
    header seeds) and exceptions more than 65535 samples apart (dummy
    records);
  - decodes: the port with wire_pack=True gives the same events and bytes
    as with wire_pack=False and the same bytes and stderr as the JAX
    package with wire_pack=True, for one segment, bucketed lengths, a
    segmented stream, the per-segment raw fallback, the env switch and a
    geometry K1 does not serve (uic-train: K3 and make_score_packer).

The port runs with device="cpu" (the kernels' plain versions); the JAX
package runs its XLA receiver with the hybrid harvester off
(MINIMODEM_TPU_HYBRID=0, as in tests/test_torch_mega_rx.py).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem as JaxModem
from minimodem_tpu.ops import wirepack as jwp
from minimodem_tpu_torch.models.modem import FskModem
from minimodem_tpu_torch.ops import wirepack as wp

THR, LIM = 1.5, 2.3


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


def _tone(freq, n, amp=32000.0, rate=48000, phase=0.0):
    return (np.sin(2 * np.pi * freq / rate * np.arange(n) + phase)
            * amp).astype(np.int16)


def _gaps():
    """Two exceptions 69980 samples apart: dummy records in between."""
    x = np.zeros(70000, np.int16)
    x[10] = 32000
    x[69990] = -32000
    return x


SIGNALS = {
    "tone": _tone(2200, 48000),
    "silence": np.zeros(9000, np.int16),
    "escape": np.array([0, 0, 0, 0, 32767, -32768, 32767, -32768] * 40,
                       np.int16),
    # the first samples, hence the header seeds, are negative
    "negative": _tone(1200, 20000, phase=np.pi * 1.25),
    "gaps": _gaps(),
}

_jax_unpack = jax.jit(jwp.unpack_expand, static_argnums=(2, 3, 4, 5, 6, 7))


def _both(wires, totals, spec, n_target, extra=0):
    """The port's and the JAX unpack_expand on the same int16 rows."""
    w16 = np.stack([w.view(np.int16) for w in wires])
    tot = np.asarray(totals, np.int32)
    ours = wp.unpack_expand(torch.from_numpy(w16), torch.from_numpy(tot),
                            *spec, n_target, extra).numpy()
    ref = np.asarray(_jax_unpack(jnp.asarray(w16), jnp.asarray(tot), *spec,
                                 n_target, extra))
    return ours, ref


# ----------------------------------------------------------------------
# the host half
# ----------------------------------------------------------------------

@pytest.mark.parametrize("packer", ["native", "numpy"])
def test_host_half_equals_jax(packer, monkeypatch):
    """pack bytes, count_exceptions and choose_params equal the JAX
    module's for every signal, k and w; with "numpy" both modules run
    their NumPy fallbacks (no native library)."""
    if packer == "native":
        assert wp._native() is not None, "the native packer did not build"
    else:
        monkeypatch.setattr(wp, "_native", lambda: None)
        monkeypatch.setattr(jwp, "_native", lambda: None)
    rng = np.random.default_rng(19)
    for name, x in SIGNALS.items():
        assert wp.choose_params(x) == jwp.choose_params(x), name
        for k in (0, 2, wp.MAX_ORDER):
            for w in (6, 8, 12):
                n_exc = wp.count_exceptions(x, k, w)
                assert n_exc == jwp.count_exceptions(x, k, w), (name, k, w)
                e_cap = wp.exc_capacity(n_exc)
                n_packed = len(x) + int(rng.integers(0, 300))
                a = wp.pack(x, n_packed, k, w, e_cap)
                assert np.array_equal(a, jwp.pack(x, n_packed, k, w, e_cap))
                assert np.array_equal(a, wp._pack_py(x, n_packed, k, w,
                                                     e_cap)), (name, k, w)
                assert len(a) == wp.row_bytes(n_packed, k, w, e_cap)


def test_spec_token_and_capacity_equal_jax():
    for spec in ((0, 8, 1 << 21, 16384), (5, 14, 33000, 0), (3, 10, 77, 9)):
        tok = wp.spec_str(*spec)
        assert tok == jwp.spec_str(*spec)
        assert wp.parse_spec(tok) == jwp.parse_spec(tok) == spec
    for s in ("int16", "ulaw", None, "float32"):
        assert wp.parse_spec(s) is None and jwp.parse_spec(s) is None
    for n in (0, 1, 511, 13000, 1 << 20):
        assert wp.exc_capacity(n) == jwp.exc_capacity(n)
    rng = np.random.default_rng(3)
    x = rng.integers(-32768, 32768, 4000).astype(np.int16)
    with pytest.raises(ValueError):
        wp.pack(x, 4000, 2, 6, 16)
    assert wp.choose_params(x) is None
    assert wp.choose_params(np.zeros(5000, np.float32)) is None


# ----------------------------------------------------------------------
# the device half
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", range(wp.MAX_ORDER + 1))
def test_unpack_equals_jax_bit_for_bit(k):
    """Every signal of SIGNALS in one batch, packed at one layout, for w 8
    and 12: the port's rows equal JAX's at every position, and equal the
    raw int16 wire's normalization, zero past each row's total."""
    xs = list(SIGNALS.values())
    n_target = max(len(x) for x in xs) + 777
    for w in (8, 12):
        e_cap = wp.exc_capacity(max(wp.count_exceptions(x, k, w)
                                    for x in xs))
        spec = (k, w, n_target, e_cap)
        wires = [wp.pack(x, n_target, k, w, e_cap) for x in xs]
        ours, ref = _both(wires, [len(x) for x in xs], spec, n_target)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32)), w
        for row, x in zip(ours, xs):
            raw = np.zeros(n_target, np.float32)
            raw[:len(x)] = x.astype(np.float32) / np.float32(32768.0)
            assert np.array_equal(row.view(np.uint32), raw.view(np.uint32))


@pytest.mark.parametrize("trial", range(4))
def test_unpack_randomized_cuts_and_extras(trial):
    """tests/test_wirepack.py's randomized round trip, four rows a call:
    random k, w, n_packed, n_target and extra, and each row its own cut
    (totals) and spikes."""
    rng = np.random.default_rng(7 + trial)
    n = int(rng.integers(50, 4000))
    k = int(rng.integers(0, wp.MAX_ORDER + 1))
    w = int(rng.choice([6, 8, 10, 12, 14]))
    n_packed = n + int(rng.integers(0, 300))
    n_target = n_packed + int(rng.integers(0, 500))
    xs, cuts = [], []
    for _ in range(4):
        x = (np.sin(np.linspace(0, rng.uniform(1, 300), n))
             * int(rng.integers(1, 32000))).astype(np.int16)
        x[rng.integers(0, n, 5)] = rng.integers(-32768, 32768,
                                                5).astype(np.int16)
        xs.append(x)
        cuts.append(int(rng.integers(1, n // 2)))
    extra = int(rng.integers(0, n - max(cuts) + 1))
    e_cap = wp.exc_capacity(max(wp.count_exceptions(x, k, w) for x in xs))
    wires = [wp.pack(x, n_packed, k, w, e_cap) for x in xs]
    ours, ref = _both(wires, cuts, (k, w, n_packed, e_cap), n_target, extra)
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
    for row, x, cut in zip(ours, xs, cuts):
        want = np.zeros(n_target, np.float32)
        m = min(cut + extra, n)
        want[:m] = x[:m].astype(np.float32) / np.float32(32768.0)
        assert np.array_equal(row, want), (trial, k, w, cut, extra)


def test_unpack_drops_slots_past_n_exc():
    """Slots past the header's n_exc hold whatever the buffer held (pack
    into a dirty `out` leaves them): they must not reach the samples."""
    x = SIGNALS["tone"]
    k, w = 2, 8
    e_cap = wp.exc_capacity(wp.count_exceptions(x, k, w))
    clean = wp._pack_py(x, len(x), k, w, e_cap)
    dirty = wp._pack_py(x, len(x), k, w, e_cap,
                        out=np.full(len(clean), 0xA5, np.uint8))
    got = [wp.unpack_expand(torch.from_numpy(b.view(np.int16)[None]),
                            torch.tensor([len(x)], dtype=torch.int32),
                            k, w, len(x), e_cap, len(x)).numpy()
           for b in (clean, dirty)]
    assert not np.array_equal(clean, dirty)
    assert np.array_equal(got[0], got[1])
    with pytest.raises(ValueError):
        wp.unpack_expand(torch.zeros((1, 8), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 0, 8, 8, 0, 8)


# ----------------------------------------------------------------------
# decodes
# ----------------------------------------------------------------------

PAYLOAD = b"the quick brown fox jumps over the lazy dog 0123456789\n"


def _s16(wav):
    return np.clip(np.rint(wav * 32768.0), -32768, 32767).astype(np.int16)


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(p, q)
                                    for p, q in zip(a, b))


@pytest.mark.parametrize("cut", [0, 12345])
def test_one_shot_and_bucketed_lengths_match_jax(cut):
    """One segment at a bucket-aligned and at a mid-bucket length: the
    port's packed decode equals its raw decode (events and bytes), and
    its bytes and stderr equal the JAX package's packed decode."""
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver

    m = FskModem("1200", device="cpu")
    s16 = _s16(m.modulate(PAYLOAD * 4))
    x = s16[:len(s16) - cut]
    pr = PipelinedReceiver(m.cfg, device="cpu")
    ev = {wpk: list(pr.run(x, THR, LIM, wire_pack=wpk))
          for wpk in (False, True)}
    assert len(ev[True]) == 1 and _same(ev[True][0], ev[False][0])
    got = m.demodulate(x, return_events=True, wire_pack=True)
    want = JaxModem("1200").demodulate(x, return_events=True,
                                       wire_pack=True)
    assert got == want
    if not cut:
        assert got[0] == PAYLOAD * 4


def _segmented(m, sig, seg, wire_pack):
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver

    pr = PipelinedReceiver(m.cfg, segment_len=seg, device="cpu")
    out = [tuple(np.asarray(a).tobytes() for a in o)
           for o in pr.run(sig, THR, LIM, wire_pack=wire_pack)]
    return out, pr.raw_segments


def _render(pkg, cfg, segs):
    """Each package's Receiver.render_events over per-segment events ->
    (stdout, stderr)."""
    if pkg == "jax":
        from minimodem_tpu.codecs import get_codec
        from minimodem_tpu.config import RxOptions
        from minimodem_tpu.rx.engine import Receiver
        kw = {}
    else:
        from minimodem_tpu_torch.codecs import get_codec
        from minimodem_tpu_torch.config import RxOptions
        from minimodem_tpu_torch.rx.engine import Receiver
        kw = {"device": "cpu"}
    sink, errs = io.BytesIO(), []
    rx = Receiver(cfg, RxOptions(), get_codec("ascii8"), sink.write,
                  errs.append, **kw)
    for seg in segs:
        rx.render_events(*seg)
    return sink.getvalue(), "".join(errs)


@pytest.mark.parametrize("case", ["segmented", "raw_fallback"])
def test_segmented_matches_raw_and_jax(case):
    """PipelinedReceiver at segment_len 1 << 15 (tests/test_wirepack.py:
    134-165): every segment packed, or a noise burst mid-stream whose
    exceptions overflow segment 0's capacity and go on the raw int16 wire
    for those segments only.  Per-segment events and bytes equal the raw
    wire's; the rendered stdout and stderr equal the JAX package's packed
    decode."""
    from minimodem_tpu.ops.device_rx import PipelinedReceiver as JaxPR

    m = FskModem("1200", device="cpu")
    seg = 1 << 15
    if case == "segmented":
        sig = _s16(m.modulate(PAYLOAD * 4))
    else:
        # a quarter-scale signal and silence around a burst of 17000
        # full-scale noise samples: the whole stream packs (choose_params
        # pays), the burst's segment overflows the 16384 exception slots
        # that segment 0 set (tests/test_wirepack.py's burst of 2 * seg
        # noise samples makes the whole stream incompressible, so there
        # no segment packs at all)
        s16 = _s16(m.modulate(PAYLOAD * 2) * np.float32(0.25))
        rng = np.random.default_rng(11)
        sig = np.concatenate([
            s16, np.zeros(2 * seg, np.int16),
            rng.integers(-32768, 32768, 17000).astype(np.int16),
            np.zeros(seg, np.int16), s16]).astype(np.int16)
        assert wp.choose_params(sig) is not None
    raw, n_raw = _segmented(m, sig, seg, False)
    pk, n_pk = _segmented(m, sig, seg, True)
    assert raw == pk and len(pk) >= 3 and n_raw == 0
    assert n_pk == (case == "raw_fallback"), n_pk
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver

    ours = _render("torch", m.cfg, PipelinedReceiver(
        m.cfg, segment_len=seg, device="cpu").run(sig, THR, LIM,
                                                  wire_pack=True))
    jm = JaxModem("1200")
    theirs = _render("jax", jm.cfg, JaxPR(jm.cfg, segment_len=seg).run(
        sig, THR, LIM, wire_pack=True))
    assert ours == theirs
    if case == "segmented":
        assert ours[0] == PAYLOAD * 4
    else:
        assert ours[0].startswith(PAYLOAD * 2) and PAYLOAD * 2 in ours[0][
            len(PAYLOAD) * 2:]


def test_env_switch(monkeypatch):
    """"auto" packs only with MINIMODEM_TPU_WIREPACK=1 (or on), and only
    streams longer than one segment: with the switch on, a two-segment
    stream goes packed (the bytes of the packed decode), else raw."""
    from minimodem_tpu_torch.ops import device_rx

    m = FskModem("1200", device="cpu")
    s16 = _s16(m.modulate(PAYLOAD * 4))
    packed = []
    real_pack = wp.pack

    def spy(*a, **k):
        packed.append(len(a[0]))
        return real_pack(*a, **k)

    monkeypatch.setattr(wp, "pack", spy)
    for env, want in (("1", True), ("on", True), ("0", False), ("", False)):
        monkeypatch.setenv("MINIMODEM_TPU_WIREPACK", env)
        assert wp.default_on() is want is jwp.default_on()
        packed.clear()
        assert m.demodulate(s16) == PAYLOAD * 4
        assert not packed                     # one segment: never "auto"
        pr = device_rx.PipelinedReceiver(m.cfg, segment_len=1 << 15,
                                          device="cpu")
        list(pr.run(s16, THR, LIM))
        assert bool(packed) is want, env
        packed.clear()
        list(pr.run(s16, THR, LIM, wire_pack=False))
        assert not packed


def test_wide_geometry_matches_raw_and_jax():
    """uic-train (47-bit frames: wide records, the bits_hi plane, stage 1
    through K3 in make_score_packer, past K1) with wire_pack=True: events
    equal the raw wire's, bytes and stderr equal the JAX package's packed
    decode."""
    from .test_torch_device_rx_wide import _uic_burst

    m = FskModem("uic-train", device="cpu")
    wav = np.concatenate([_uic_burst(m.cfg, 4, np.random.default_rng(5)),
                          np.zeros(4000, np.float32)])
    s16 = _s16(wav * np.float32(0.9))
    assert wp.choose_params(s16) is not None
    raw = m.demodulate(s16, return_events=True, wire_pack=False)
    pk = m.demodulate(s16, return_events=True, wire_pack=True)
    assert raw == pk and pk[0].count(b"Train ID") == 4
    assert pk == JaxModem("uic-train").demodulate(s16, return_events=True,
                                                   wire_pack=True)
