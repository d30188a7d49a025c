"""K3 parity: the port's stage-1 correlation (minimodem_tpu_torch/ops/
correlate.py, ops/demod.py correlator_for) against the JAX package on the
CPU, where the port's wrapper runs the kernel's plain version.

Tolerances, each with its reason:
  - the float32 direct route against the JAX package's jitted
    _correlate_direct: bit-identical (both are the ascending-j float32
    FMA chain; XLA contracts the scan into it on the CPU);
  - against the Pallas kernel K3a/K3b in interpret mode: rtol 1e-5,
    atol 1e-5, the JAX package's own bar between its kernel and the scan
    (tests/test_pallas.py:55,87): the MXU matmul sums in another order;
  - the float64 route against _correlate_direct in float64: rtol 1e-13,
    atol 1e-13 (the port rounds product and sum apart where XLA may
    fuse them; a few float64 ulps over <= 4096 taps);
  - the FFT route against _correlate_fft: atol 2e-6 of the largest
    correlation magnitude (cuFFT / pocketFFT and XLA's FFT sum in other
    orders; float32 round-off of a 2^17-point transform).
"""

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem


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
    """The JAX package's Pallas correlation kernels in interpret mode
    (pattern of tests/test_pallas.py:27-59)."""
    from jax.experimental import pallas as pl

    from minimodem_tpu.ops import pallas_demod as P

    orig_call = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)

    def clear():
        P._build.cache_clear()
        P._build_batch.cache_clear()
        P._make_correlator.cache_clear()

    clear()
    yield P
    clear()


def _geo(mode, precision="auto", **kw):
    from minimodem_tpu.ops.demod import geometry_from_config

    return geometry_from_config(FskModem(mode, **kw).cfg, precision)


def _rows(seed, n_rows, length, stride):
    """n_rows overlapping windows of one seeded stream, `stride` apart,
    as numpy rows and as the port's strided view (no copy)."""
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((n_rows - 1) * stride + length).astype(
        np.float32)
    rows = np.stack([flat[i * stride:i * stride + length]
                     for i in range(n_rows)])
    view = torch.from_numpy(flat).unfold(0, length, stride)
    assert view.stride() == (stride, 1)
    return rows, view


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", ["1200", "300", "same", "rtty"])
def test_correlator_matches_jax_direct(mode, batch):
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops.demod import _correlate_direct, make_basis
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain

    geo = _geo(mode, "float32")
    basis = make_basis(geo, np.float32)
    s_len = 1500
    rows, view = _rows(batch, batch, s_len + geo.nb - 1, 1000)
    ref = np.stack([np.asarray(jax.jit(
        lambda v: _correlate_direct(v, jnp.asarray(basis), s_len))(r))
        for r in rows])
    calls = correlate_plain.calls
    launches = Correlator.launches + Correlator.batch_launches
    out = Correlator(basis)(view, s_len)
    assert correlate_plain.calls == calls + 1
    assert Correlator.launches + Correlator.batch_launches == launches
    assert out.shape == (batch, 4, s_len) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref.view(np.uint32))


def test_correlator_matches_interpret_pallas(interp):
    """K3a (one stream) and K3b (jax.vmap over three streams, the
    custom_vmap rule's batched grid) against the port on the same rows."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops.demod import make_basis
    from minimodem_tpu_torch.ops.correlate import Correlator

    P = interp
    geo = _geo("1200", "float32")
    basis = make_basis(geo, np.float32)
    s_len = P.TILE
    rows, view = _rows(3, 3, s_len + geo.nb + 2048, 5000)
    port = Correlator(basis)
    one = np.asarray(P.correlate_pallas(jnp.asarray(rows[0]), basis, s_len))
    np.testing.assert_allclose(port(view[:1], s_len)[0].numpy(), one,
                               rtol=1e-5, atol=1e-5)
    batched = np.asarray(jax.vmap(
        lambda v: P.correlate_pallas(v, basis, s_len))(jnp.asarray(rows)))
    np.testing.assert_allclose(port(view, s_len).numpy(), batched,
                               rtol=1e-5, atol=1e-5)


def test_f64_route_matches_jax():
    """The perfect-capable geometry scores in float64 with the float64
    basis (not the float32-rounded one)."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops.demod import _correlate_direct, make_basis
    from minimodem_tpu_torch.ops import demod as TD

    geo = _geo("1200", sample_rate=24000)
    geo = type(geo)(**{**geo.__dict__, "use_f64": True})
    basis = make_basis(geo, np.float64)
    s_len = 3000
    x = np.random.default_rng(5).standard_normal(
        (2, s_len + geo.nb - 1)).astype(np.float32)
    ref = np.stack([np.asarray(jax.jit(lambda v: _correlate_direct(
        v.astype(jnp.float64), jnp.asarray(basis), s_len))(r)) for r in x])
    out = TD.correlator_for(geo, basis)(torch.from_numpy(x), s_len)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13, atol=1e-13)
    # a float32-rounded basis would miss that tolerance by far
    off = TD.correlator_for(geo, basis.astype(np.float32).astype(
        np.float64))(torch.from_numpy(x), s_len)
    assert np.abs(off.numpy() - ref).max() > 1e-9


def test_fft_route_matches_jax():
    """nb > 4096 (10 baud at 48 kHz, nb 4800) takes the FFT route on both
    sides."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops.demod import _correlate_fft, make_basis
    from minimodem_tpu_torch.ops import demod as TD

    geo = _geo("10")
    assert geo.nb > 4096 and not geo.use_f64
    basis = make_basis(geo, np.float32)
    length = 1 << 14
    s_len = length - geo.nb + 1
    x = np.random.default_rng(6).uniform(-1, 1, (2, length)).astype(
        np.float32)
    ref = np.stack([np.asarray(jax.jit(lambda v: _correlate_fft(
        v, jnp.asarray(basis), s_len))(r)) for r in x])
    out = TD.correlator_for(geo, basis)(torch.from_numpy(x), s_len).numpy()
    assert out.dtype == np.float32 and out.shape == (2, 4, s_len)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6 * scale)


def _check_tile(nb, s_len):
    """K3's tile rule at one geometry, for the batches the host engines
    launch: the smallest power-of-two tile from TILE_MIN that holds the
    halo rule (tile >= 8 * (nb - 1)) up to TILE_MAX unless the next tile
    up would not fill the card (an SM without a CTA, or rounds of CTAs
    under ROUND_FILL full); a CTA within the shared memory; at least one CTA
    per SM wherever s_len allows it; the CTAs' tiles cover every offset
    exactly once (the kernel's s0 = blockIdx.x * tile, n_s = min(tile,
    s_len - s0))."""
    from minimodem_tpu_torch.ops import correlate as K

    for batch in (1, 22, 64):
        tile = K.pick_tile(nb, s_len, batch)
        n_x = -(-s_len // tile)

        def ctas(t):
            return batch * -(-s_len // t)

        halo_tile = min(K.HALO_RATIO * (nb - 1), K.TILE_MAX)
        assert K.TILE_MIN <= tile <= K.TILE_MAX and tile & (tile - 1) == 0
        assert K.smem_bytes(nb, tile) <= 232_448, (nb, batch, tile)
        assert tile >= halo_tile or not K.fills_the_card(ctas(2 * tile))
        assert tile == K.TILE_MIN or tile // 2 < halo_tile
        assert tile == K.TILE_MIN or K.fills_the_card(ctas(tile))
        if s_len >= K.SMS * K.TILE_MIN:
            assert ctas(tile) >= K.SMS, (nb, s_len, batch, tile)
        covered = np.zeros(s_len, np.int32)
        for bx in range(n_x):
            s0 = bx * tile
            n_s = min(tile, s_len - s0)
            assert n_s > 0
            covered[s0:s0 + n_s] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("rate", [8000, 24000, 44100, 48000])
def test_correlate_tile_rule_presets(rate):
    """Every preset's geometry at the host engines' chunk length."""
    from minimodem_tpu_torch.models.presets import PRESETS
    from minimodem_tpu_torch.ops.correlate import MAX_NB, pick_tile
    from minimodem_tpu_torch.ops.demod import DemodScorer

    for name, make in PRESETS.items():
        sc = DemodScorer(make(sample_rate=rate).cfg, "float32", device="cpu")
        assert sc.geo.nb <= MAX_NB, name
        _check_tile(sc.geo.nb, sc.chunk_len + sc.geo.max_begin)
    if rate == 48000:
        sc = DemodScorer(PRESETS["1200"]().cfg, device="cpu")
        assert pick_tile(sc.geo.nb, sc.chunk_len + sc.geo.max_begin, 1) == 512


@pytest.mark.parametrize("nb", [1, 7, 8, 37, 92, 147, 1056, 4095, 4096])
def test_correlate_tile_rule_nb(nb):
    """Synthetic filter lengths up to K3's limit, at the host chunk length
    plus a frame of ~11 bits, and at a short row."""
    _check_tile(nb, (1 << 17) + 10 * nb)
    _check_tile(nb, 3000 + 3)


def test_correlator_checks_and_raises():
    """CPU tensors take the plain version; a non-CPU, non-CUDA tensor, a
    wrong dtype, a non-unit column stride or short rows raise instead of
    falling back."""
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain

    c = Correlator(np.ones((4, 8), np.float32))
    x = torch.zeros((2, 100))
    calls = correlate_plain.calls
    assert c(x, 93).shape == (2, 4, 93)
    assert correlate_plain.calls == calls + 1
    with pytest.raises(ValueError):
        c(x.to("meta"), 93)
    with pytest.raises(ValueError):
        c(x.double(), 93)
    with pytest.raises(ValueError):
        c(torch.zeros((100, 2)).t(), 93)
    with pytest.raises(ValueError):
        c(x, 94)
    with pytest.raises(ValueError):
        Correlator(np.ones((4, 4097), np.float32))
