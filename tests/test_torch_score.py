"""K1 parity: the port's fused scorer (minimodem_tpu_torch/ops/fused_score.py)
against the JAX package's score packers on the same audio.

On the CPU the port runs the kernel's plain version (correlate +
score_frame_channels).  It is held against
  - the XLA packer (MINIMODEM_TPU_PALLAS=0), which takes magnitudes with
    hypot and sums in XLA's own order, and
  - the fused Pallas scorer in interpret mode, which takes magnitudes as
    sqrt(c*c + s*s) like the port.
Tolerance (the JAX package's own bar between its two scorers,
tests/test_pallas_score.py:93): frame bits exact, NaN / +inf / -inf at
the same offsets, finite conf/ampl within rtol 2e-6, atol 1e-5.
"""

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem

RTOL, ATOL = 2e-6, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interp(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU
    (pattern of tests/test_pallas_score.py:12-58)."""
    from jax.experimental import pallas as pl

    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    from minimodem_tpu.ops import pallas_demod as PD

    monkeypatch.setattr(PD, "backend_supports_pallas", lambda: True)
    monkeypatch.setenv("MINIMODEM_TPU_PALLAS", "1")
    from minimodem_tpu.ops import pallas_score as PS

    def clear():
        from minimodem_tpu.ops import device_rx as D
        from minimodem_tpu.ops import pallas_rx as PR

        PS._build.cache_clear()
        PS._make_packer.cache_clear()
        D._build_device_rx.cache_clear()
        PR._mega_run_fn.cache_clear()
        PR.build_mega_rx.cache_clear()

    clear()
    yield
    clear()


def _audio(mode: str, noise: float, t_total: int, halo: int, seed: int):
    """Modulated text (seeded) + optional uniform noise, zero-padded to
    t_total + halo samples."""
    rng = np.random.default_rng(seed)
    m = FskModem(mode)
    text = rng.integers(32, 127, size=24, dtype=np.uint8).tobytes()
    wav = m.modulate(text if mode != "rtty" else text.upper())
    x = np.zeros(t_total + halo, np.float32)
    n = min(len(wav), x.size)
    x[:n] = wav[:n]
    if noise:
        x += (rng.random(x.size, dtype=np.float32) - np.float32(0.5)) \
            * np.float32(2 * noise)
    return m.cfg, x


def _port_planes(cfg, x, t_total):
    """The port's K1 on the CPU -> (planes [P, T] int32, rows dict)."""
    from minimodem_tpu_torch.ops import device_rx as TD
    from minimodem_tpu_torch.ops.fused_score import FusedScorer

    scorer = FusedScorer(TD.geo_from_key(TD.device_rx_key(cfg)))
    out = scorer(torch.from_numpy(x)[None], t_total)[0].numpy()
    rows = {"cd": 0, "ad": 1, "bl": 2, "cs": 0, "as_": 1}
    if out.shape[0] == 5:
        rows.update(cs=3, as_=4)
    return out, rows


def _assert_close(port_u32, ref_u32, what):
    o = port_u32.view(np.float32)
    r = ref_u32.view(np.float32)
    assert np.array_equal(np.isnan(r), np.isnan(o)), what
    assert np.array_equal(np.isposinf(r), np.isposinf(o)), what
    assert np.array_equal(np.isneginf(r), np.isneginf(o)), what
    fin = np.isfinite(r)
    np.testing.assert_allclose(o[fin], r[fin], rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _check_against_v2(port, rows, ref8):
    """ref8: the JAX packer's 8-row v2 layout [8, T] uint32."""
    np.testing.assert_array_equal(port[rows["bl"]].view(np.uint32), ref8[4])
    assert not ref8[5].any()                  # n_bits <= 32: no bits_hi
    for name, r in (("cd", 0), ("cs", 1), ("ad", 2), ("as_", 3)):
        _assert_close(port[rows[name]], ref8[r], name)


@pytest.mark.parametrize("mode,noise,seed", [
    ("1200", 0.0, 1), ("300", 0.0, 2), ("same", 0.0, 3), ("1200", 0.3, 4),
])
def test_score_vs_xla_packer(monkeypatch, mode, noise, seed):
    import jax

    from minimodem_tpu.ops import device_rx as D

    monkeypatch.setenv("MINIMODEM_TPU_PALLAS", "0")
    cfg = FskModem(mode).cfg
    key = D.device_rx_key(cfg)
    geo = D.geo_from_key(key)
    t_total = 1 << 14
    cfg, x = _audio(mode, noise, t_total, geo.halo, seed)
    ref = np.asarray(jax.jit(D.make_score_packer(key, t_total, "float32"))(
        x))
    port, rows = _port_planes(cfg, x, t_total)
    assert port.shape == ((5 if mode == "same" else 3), t_total)
    _check_against_v2(port, rows, ref)


@pytest.mark.parametrize("mode,noise,seed", [
    ("1200", 0.0, 5), ("same", 0.0, 6), ("1200", 0.3, 7),
])
def test_score_vs_interpret_fused(interp, mode, noise, seed):
    """The fused Pallas scorer in interpret mode: planes layout (MXP1
    comb matmuls) for Bell-202, the 8-row layout for SAME's dual expect."""
    import jax.numpy as jnp

    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu.ops import pallas_score as PS

    cfg = FskModem(mode).cfg
    key = D.device_rx_key(cfg)
    geo = D.geo_from_key(key)
    t_total = PS.T_TILE
    assert PS.fused_packer_eligible(geo, t_total)
    cfg, x = _audio(mode, noise, t_total, geo.halo, seed)
    fn, n_ch, prow = D.make_score_packer_planes(key, t_total, "float32")
    ref = np.asarray(fn(jnp.asarray(x)))
    port, rows = _port_planes(cfg, x, t_total)
    if n_ch == 8:
        _check_against_v2(port, rows, ref)
        return
    np.testing.assert_array_equal(port[rows["bl"]].view(np.uint32),
                                  ref[prow["bl"]])
    _assert_close(port[rows["cd"]], ref[prow["cd"]], "cd")
    _assert_close(port[rows["ad"]], ref[prow["ad"]], "ad")


def test_correlate_matches_jax_fma_chain():
    """correlate() is bit-identical to the JAX package's _correlate_direct
    on the CPU: both are the ascending-j float32 FMA chain (the chain the
    CUDA kernel computes with __fmaf_rn)."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops.demod import _correlate_direct
    from minimodem_tpu_torch.ops.demod import correlate

    rng = np.random.default_rng(11)
    x = rng.standard_normal(400).astype(np.float32)
    basis = rng.standard_normal((4, 37)).astype(np.float32)
    s_len = 400 - 37 + 1
    ref = np.asarray(jax.jit(
        lambda v: _correlate_direct(v, jnp.asarray(basis), s_len))(x))
    out = correlate(torch.from_numpy(x), torch.from_numpy(basis), s_len)
    np.testing.assert_array_equal(out.numpy(), ref)


def _round_f32(q):
    """Exact round-to-nearest-even of a Fraction to float32."""
    from fractions import Fraction

    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    hits = [c for c, d in zip(cands, dist) if d == best]
    if len(hits) > 1:
        hits = [c for c in hits if (int(c.view(np.uint32)) & 1) == 0]
    return hits[0]


def test_fma_f32_correctly_rounded():
    """fma_f32 rounds a * b + c once, including sums that float64 alone
    would double-round onto a float32 tie."""
    from fractions import Fraction

    from minimodem_tpu_torch.ops.demod import fma_f32

    rng = np.random.default_rng(12)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    # cancellation and ties: c = -round(a*b), and c a tiny offset from a
    # float32 midpoint of a*b
    c[1000:2000] = -(a[1000:2000] * b[1000:2000])
    mid = (a[2000:] * b[2000:]).astype(np.float64)
    ulp = np.spacing(np.abs(mid).astype(np.float32)).astype(np.float64)
    c[2000:] = (ulp / 2 * np.sign(mid)).astype(np.float32)
    # float32 subnormal results
    a[2800:] *= np.float32(2.0 ** -70)
    b[2800:] *= np.float32(2.0 ** -70)
    c[2800:] *= np.float32(2.0 ** -140)
    # exact sums just below a float32 tie with an odd lower neighbour:
    # (1 + 2^-23) + 2^-24 * (1 - 2^-46) rounds to a float64 tie, which
    # float32 would then round up to even — the correct result is down
    k = 2.0 ** np.arange(-8, 8)
    a = np.concatenate([a, (2.0 ** -24 * (1 - 2.0 ** -23) * k)
                        .astype(np.float32)])
    b = np.concatenate([b, np.full(k.size, 1 + 2.0 ** -23, np.float32)])
    c = np.concatenate([c, ((1 + 2.0 ** -23) * k).astype(np.float32)])
    a64, b64, c64 = (v.astype(np.float64) for v in (a, b, c))
    naive = (a64 * b64 + c64).astype(np.float32)
    out = fma_f32(*(torch.from_numpy(v) for v in (a64, b64, c64))).numpy()
    assert (naive[-k.size:] != out[-k.size:]).all()
    exp = np.array([_round_f32(Fraction(float(ai)) * Fraction(float(bi))
                               + Fraction(float(ci)))
                    for ai, bi, ci in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(out.view(np.uint32), exp.view(np.uint32))


def test_wrapper_runs_plain_only_on_cpu():
    """A CPU tensor takes the plain version; a non-CPU, non-CUDA tensor
    raises instead of falling back."""
    from minimodem_tpu_torch.ops import device_rx as TD
    from minimodem_tpu_torch.ops import fused_score as FS

    cfg = FskModem("1200").cfg
    scorer = FS.FusedScorer(TD.geo_from_key(TD.device_rx_key(cfg)))
    x = torch.zeros((2, 4096 + scorer.geo.halo))
    calls, launches = FS.score_planes_plain.calls, FS.FusedScorer.launches
    out = scorer(x, 4096)
    assert out.shape == (2, 3, 4096) and out.dtype == torch.int32
    assert FS.score_planes_plain.calls == calls + 1
    assert FS.FusedScorer.launches == launches
    with pytest.raises(ValueError):
        scorer(x.to("meta"), 4096)
    with pytest.raises(ValueError):
        scorer(x[:, :100], 4096)


@pytest.mark.parametrize("rate", [8000, 24000, 48000])
def test_fused_tile_geometry(rate):
    """K1's tile for every preset it serves: a multiple of 8 (the
    kernel's phase-major planes), a CTA within the shared memory, at
    least 8 * max_begin where such a tile fits (a halo recompute of at
    most 1/8), and the smallest such tile."""
    from minimodem_tpu_torch.models.presets import PRESETS
    from minimodem_tpu_torch.ops import fused_score as FS
    from minimodem_tpu_torch.ops.demod import geometry_from_config

    served = 0
    for name, make in PRESETS.items():
        geo = geometry_from_config(make(sample_rate=rate).cfg, "float32")
        if geo.n_bits > 32:
            continue
        served += 1
        tile = FS.pick_tile(geo)
        assert tile % 8 == 0 and tile in FS._TILES, name
        assert FS.smem_bytes(geo, tile) <= 227 * 1024, name
        if tile >= 8 * geo.max_begin:
            smaller = tile // 2
            assert smaller < 8 * geo.max_begin or smaller not in FS._TILES
        else:
            assert tile == FS._TILES[0] or \
                FS.smem_bytes(geo, 2 * tile) > 227 * 1024, name
    assert served == 9
    bell = geometry_from_config(PRESETS["1200"](sample_rate=48000).cfg)
    assert FS.pick_tile(bell) == 4096
