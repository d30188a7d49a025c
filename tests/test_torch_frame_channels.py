"""K5's CPU side: the port's frame channels (ops/demod.py
score_frame_channels, the plain version of csrc/frame_channels.cu) against
the JAX package's score_frame_channels (minimodem_tpu/ops/demod.py:215) on
the same seeded correlations, and the wrapper (ops/frame_channels.py
FrameChannels): its tables, its CPU route, its refusals, and the two
scorers that reach it (make_score_packer, _build_score_fn).

Tolerance (the JAX package's own bar between its two scorers,
tests/test_pallas_score.py:93): frame bits exact, NaN / +inf / -inf at
the same offsets, finite conf/ampl within rtol 2e-6, atol 1e-5.  The port
takes magnitudes as sqrt(c*c + s*s) where the JAX XLA path uses hypot,
and sums the comb taps in ascending order where XLA picks its own tree.
The kernel itself runs only on the card (tests/test_torch_gpu.py holds it
to the plain version bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

RTOL, ATOL = 2e-6, 1e-5
GEOMETRIES = ("uic-train", "2 baud dual", "float64", "20 baud", "1200")
KINDS = ("signal", "zero", "tie", "sub-eps", "mixed")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(name):
    from minimodem_tpu.models.presets import bell_like, bell202, uic
    from minimodem_tpu.utils.cfloat import f32

    if name == "uic-train":
        return uic("train").cfg
    if name == "2 baud dual":
        return bell_like(2, 48000, do_rx_sync=True, do_tx_sync_bytes=2,
                         sync_byte=0xAB).cfg
    if name == "float64":
        return bell_like(1200, 24000, mark_f=f32(1200),
                         space_f=f32(2400)).cfg
    if name == "20 baud":
        return bell_like(20, 48000).cfg
    return bell202().cfg


def _geos(name):
    """(the JAX geometry, the port's) of a geometry."""
    from minimodem_tpu.ops import demod as JD
    from minimodem_tpu_torch.config import ModemConfig
    from minimodem_tpu_torch.ops import demod as TD

    jcfg = _jax_cfg(name)
    jgeo = JD.geometry_from_config(jcfg)
    tgeo = TD.geometry_from_config(ModemConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}))
    assert dataclasses.asdict(tgeo) == dataclasses.asdict(jgeo)
    return jgeo, tgeo


def _frame_columns(geo, req, rng, length):
    """A level for each correlation column: the frame `req` asks for (its
    don't-care bits seeded) over the bit windows, so that offset 0 scores
    a frame that meets it."""
    frame = np.array([r if r >= 0 else rng.integers(0, 2) for r in req])
    k = np.searchsorted(np.asarray(geo.bit_begin), np.arange(length),
                        side="right") - 1
    return frame[np.maximum(k, 0)].astype(bool)


def _corr(geo, t_len, seed, special=False):
    """Seeded correlations [len(KINDS) (+ 1), 4, t_len + max_begin] shaped
    like a keyed signal's, one row a kind: 'signal' (a data frame, one
    strong band a bit window, the other weak), 'zero' (all zero: 0/0
    SNRs), 'tie' (both bands equal: the strict mark > space is false),
    'sub-eps' (a sync frame whose weak band lies below FLT_EPSILON after
    the scaling: noise gated to 0, inf SNRs) and 'mixed' (each offset one
    of the four at random).  With special, one more row of the signal
    with NaN and inf correlations (outside the JAX comparison: hypot(inf,
    nan) is inf where sqrt gives nan)."""
    rng = np.random.default_rng(seed)
    dtype = np.float64 if geo.use_f64 else np.float32
    length = t_len + geo.max_begin
    scale = geo.nb / 2.0                       # magnitudes ~1 after scal
    amp = (1.0 + 0.2 * rng.random(length)) * scale
    phi = rng.random(length) * 2 * np.pi
    weak = (0.1 * rng.random((2, length)) - 0.05) * scale
    strong = np.stack([amp * np.cos(phi), amp * np.sin(phi)])

    def keyed(bit, weak):
        c = np.empty((4, length))
        c[0:2] = np.where(bit, strong, weak)
        c[2:4] = np.where(bit, weak, strong)
        return c

    sig = keyed(_frame_columns(geo, geo.req_data, rng, length), weak)
    tie = sig.copy()
    tie[2:4] = tie[0:2]
    sub = keyed(_frame_columns(geo, geo.req_sync, rng, length),
                1e-12 * weak)
    zero = np.zeros_like(sig)
    pick = rng.integers(0, 4, size=length)
    mixed = np.choose(pick, [sig, zero, tie, sub])
    rows = [sig, zero, tie, sub, mixed]
    if special:
        odd = sig.copy()
        at = rng.integers(0, length, size=(3, max(length // 50, 4)))
        odd[0, at[0]] = np.nan
        odd[2, at[1]] = np.inf
        odd[3, at[2]] = -np.inf
        rows.append(odd)
    return np.stack(rows).astype(dtype)


def _port_channels(out: dict) -> dict:
    return {k: v.numpy().view(np.uint32 if k.startswith("bits")
                              else np.float32) for k, v in out.items()}


def _assert_channels(port: dict, ref: dict, conf_rows=slice(None)):
    """Bits exact, NaN / inf classes equal, finite values within the
    tolerance (conf only on conf_rows)."""
    for k in ("bits_lo", "bits_hi"):
        np.testing.assert_array_equal(port[k], np.asarray(ref[k], np.uint32),
                                      err_msg=k)
    for k in ("conf_data", "conf_sync", "ampl_data", "ampl_sync"):
        o, r = port[k], np.asarray(ref[k])
        assert o.dtype == np.float32, k
        assert np.array_equal(np.isnan(o), np.isnan(r)), k
        assert np.array_equal(np.isposinf(o), np.isposinf(r)), k
        assert np.array_equal(np.isneginf(o), np.isneginf(r)), k
        if k.startswith("conf"):
            o, r = o[conf_rows], r[conf_rows]
        fin = np.isfinite(r)
        np.testing.assert_allclose(o[fin], r[fin], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", GEOMETRIES)
def test_plain_channels_match_jax(name):
    """The port's plain score_frame_channels against the JAX package's on
    the same correlations, one row of each kind: uic-train's 47 frame
    bits (bits_hi), the 2-baud dual layout (sync and data expect differ),
    the float64 geometry (a float64 correlation), 20 baud and Bell-202.
    The mixed row's finite conf values are left out of the tolerance
    check (its bits, NaN / inf classes and ampl are held): a frame whose
    taps mix signal, tie, zero and sub-eps columns can have a divergence
    near or above 1, where conf = snr * (1 - divergence) magnifies the
    last-bit differences of the magnitudes (at 20 baud two offsets of 96
    differ by 2.7e-6 relative)."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import demod as JD
    from minimodem_tpu_torch.ops import demod as TD

    jgeo, tgeo = _geos(name)
    t_len = 96
    corr = _corr(tgeo, t_len, seed=GEOMETRIES.index(name))
    dtype = jnp.float64 if jgeo.use_f64 else jnp.float32
    ref = jax.jit(jax.vmap(lambda c: JD.score_frame_channels(
        c, jgeo, t_len, dtype)))(corr)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    port = _port_channels(TD.score_frame_channels(torch.from_numpy(corr),
                                                  tgeo, t_len))
    _assert_channels(port, ref, conf_rows=slice(0, KINDS.index("mixed")))
    conf = port["conf_data"]
    kinds = dict(zip(KINDS, range(len(KINDS))))
    # the kinds reach what they are there for
    assert conf[kinds["signal"], 0] > 0 and np.isfinite(conf[0]).all()
    assert np.isposinf(port["conf_sync"][kinds["sub-eps"], 0])
    assert (port["bits_lo"][kinds["tie"]] == 0).all()
    for k, req in (("conf_data", tgeo.req_data), ("conf_sync", tgeo.req_sync)):
        # all-zero frames: 0/0 where the frame bits (all 0) meet req
        z = port[k][kinds["zero"]]
        assert np.isnan(z).all() if max(req) <= 0 else (z == 0).all()
    if name == "uic-train":
        assert tgeo.n_bits == 47 and (port["bits_hi"] != 0).any()
    if name == "2 baud dual":
        assert tgeo.req_sync != tgeo.req_data
        assert not np.array_equal(port["conf_sync"], port["conf_data"])


@pytest.mark.parametrize("name", GEOMETRIES)
def test_frame_channels_cpu_route_is_plain(name):
    """FrameChannels on a CPU correlation: one call of the plain
    score_frame_channels and no launch; the channels of offsets [0, n)
    land in the named rows at column t0, and nothing else of the output
    changes (NaN and inf correlations included)."""
    from minimodem_tpu_torch.ops.demod import CHANNELS, score_frame_channels
    from minimodem_tpu_torch.ops.device_rx import plane_names
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    _, geo = _geos(name)
    n, t0 = 77, 19
    corr = torch.from_numpy(_corr(geo, 90, seed=7, special=True))
    ref = score_frame_channels(corr, geo, n)
    fc = FrameChannels(geo)
    for rows in (plane_names(geo), CHANNELS):
        out = torch.full((corr.shape[0], len(rows) + 1, t0 + n + 5), -7,
                         dtype=torch.int32)
        calls, launches = score_frame_channels.calls, FrameChannels.launches
        assert fc(corr, n, out, rows, t0) is out
        assert score_frame_channels.calls == calls + 1
        assert FrameChannels.launches == launches
        for r, k in enumerate(rows):
            np.testing.assert_array_equal(
                out[:, r, t0:t0 + n].numpy(),
                ref[k].view(torch.int32).numpy(), err_msg=k)
        keep = torch.ones(out.shape, dtype=torch.bool)
        keep[:, :len(rows), t0:t0 + n] = False
        assert (out[keep] == -7).all()


@pytest.mark.parametrize("name", GEOMETRIES)
def test_frame_channels_tables(name):
    """The wrapper's host tables against the geometry: the bit offsets,
    the requirement masks (each set bit a required frame bit, the value
    its level), the scaling rounded to float32, and the row map of the
    device packer's planes and of the host scorer's CHANNELS."""
    from minimodem_tpu_torch.ops.demod import CHANNELS
    from minimodem_tpu_torch.ops.device_rx import plane_names
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels, row_map

    _, geo = _geos(name)
    fc = FrameChannels(geo)
    assert fc.begin("cpu").tolist() == list(geo.bit_begin)
    assert fc.begin("cpu").dtype == torch.int32
    for (mask, val), req in (((fc.d_mask, fc.d_val), geo.req_data),
                             ((fc.s_mask, fc.s_val), geo.req_sync)):
        assert mask < 1 << 64 and val & ~mask == 0
        for k, r in enumerate(req):
            assert (mask >> k) & 1 == (r >= 0)
            if r >= 0:
                assert (val >> k) & 1 == r
    assert fc.scal == float(np.float32(geo.magscalar))
    assert row_map(CHANNELS) == (0, 1, 2, 3, 4, 5)
    names = plane_names(geo)
    m = row_map(names)
    for c, r in zip(CHANNELS, m):
        assert r == (names.index(c) if c in names else -1)
    assert (m[CHANNELS.index("bits_hi")] >= 0) == (geo.n_bits > 32)


def test_frame_channels_refusals():
    """What the wrapper does not take raises: more than 64 frame bits, a
    correlation of the wrong shape, type or length, output rows of the
    wrong type or size, an unknown channel name, and a device that is
    neither the CPU nor CUDA."""
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    _, geo = _geos("1200")
    with pytest.raises(ValueError, match="frame bits"):
        FrameChannels(dataclasses.replace(
            geo, n_bits=65, bit_begin=tuple(range(65)),
            req_data=(-1,) * 65, req_sync=(-1,) * 65))
    fc = FrameChannels(geo)
    n = 8
    width = n + geo.max_begin
    corr = torch.zeros((2, 4, width))
    out = torch.zeros((2, 6, n), dtype=torch.int32)
    for bad in (torch.zeros((2, 3, width)), torch.zeros((4, width)),
                torch.zeros((2, 4, width), dtype=torch.float16),
                torch.zeros((2, 4, width - 1))):
        with pytest.raises(ValueError):
            fc(bad, n, out)
    for bad in (torch.zeros((2, 6, n)),
                torch.zeros((2, 5, n), dtype=torch.int32),
                torch.zeros((2, 6, n - 1), dtype=torch.int32),
                torch.zeros((1, 6, n), dtype=torch.int32),
                torch.zeros((2, n, 6), dtype=torch.int32).transpose(1, 2)):
        with pytest.raises(ValueError):
            fc(corr, n, bad)
    with pytest.raises(ValueError, match="no channels named"):
        fc(corr, n, out, ("conf_data", "snr"))
    with pytest.raises(ValueError, match="no frame-channel kernel"):
        fc(corr.to("meta"), n, out.to("meta"))


@pytest.mark.parametrize("name", ["uic-train", "float64", "2 baud dual"])
def test_score_packer_reaches_frame_channels(monkeypatch, name):
    """make_score_packer scores every tile through FrameChannels, a ragged
    last tile included (the tile cut to 1024 offsets), with the planes of
    the plain chain: stage 1, score_frame_channels over the whole tile,
    its first t_total - t0 offsets."""
    from minimodem_tpu_torch.ops import device_rx
    from minimodem_tpu_torch.ops.demod import (
        correlator_for, make_basis, score_frame_channels)
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    jcfg = _jax_cfg(name)
    from minimodem_tpu_torch.config import ModemConfig

    cfg = ModemConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    key = device_rx.device_rx_key(cfg)
    geo = device_rx.geo_from_key(key)
    tile, t_total = 1024, 2500 if name != "2 baud dual" else 1100
    monkeypatch.setattr(device_rx, "SCORE_TILE", tile)
    calls = []
    real = FrameChannels.__call__

    def spy(self, corr, n, out, rows, t0=0):
        calls.append((n, t0))
        return real(self, corr, n, out, rows, t0)

    monkeypatch.setattr(FrameChannels, "__call__", spy)
    rng = np.random.default_rng(5)
    n_tiles = -(-t_total // tile)
    x = ((rng.random((2, t_total + geo.halo), dtype=np.float32)
          - np.float32(0.5)) * np.float32(0.6))
    got = device_rx.make_score_packer(key, t_total, "float32")(
        torch.from_numpy(x))
    assert calls == [(min(tile, t_total - k * tile), k * tile)
                     for k in range(n_tiles)]
    rows = device_rx.plane_names(geo)
    assert got.shape == (2, len(rows), t_total)
    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    xp = np.zeros((2, n_tiles * tile + geo.halo), np.float32)
    xp[:, :x.shape[1]] = x
    xp = torch.from_numpy(xp)
    for k in range(n_tiles):
        t0 = k * tile
        n = min(tile, t_total - t0)
        ch = score_frame_channels(
            stage1(xp[:, t0:t0 + tile + geo.halo], tile + geo.max_begin),
            geo, tile)
        for r, c in enumerate(rows):
            np.testing.assert_array_equal(
                got[:, r, t0:t0 + n].numpy(),
                ch[c][:, :n].view(torch.int32).numpy(), err_msg=f"{c} {k}")


@pytest.mark.parametrize("name", ["1200", "float64"])
def test_build_score_fn_reaches_frame_channels(monkeypatch, name):
    """_build_score_fn (DemodScorer, the host engines, the fleet's
    sharded_score_fn) writes its [B, 6, t_len] planes through
    FrameChannels, in CHANNELS order: the plain chain's channels."""
    from minimodem_tpu_torch.ops.demod import (
        CHANNELS, _build_score_fn, correlator_for, make_basis,
        score_frame_channels)
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    _, geo = _geos(name)
    t_len = 700
    seen = []
    real = FrameChannels.__call__

    def spy(self, corr, n, out, rows=CHANNELS, t0=0):
        seen.append((tuple(corr.shape), n, tuple(out.shape), rows, t0))
        return real(self, corr, n, out, rows, t0)

    monkeypatch.setattr(FrameChannels, "__call__", spy)
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.random((3, t_len + geo.halo), dtype=np.float32)
                          - np.float32(0.5)) * np.float32(0.6))
    got = _build_score_fn(geo, t_len, "cpu")(x)
    s_len = t_len + geo.max_begin
    assert seen == [((3, 4, s_len), t_len, (3, 6, t_len), CHANNELS, 0)]
    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    ch = score_frame_channels(stage1(x, s_len), geo, t_len)
    for i, c in enumerate(CHANNELS):
        np.testing.assert_array_equal(got[:, i].numpy(),
                                      ch[c].view(torch.int32).numpy(),
                                      err_msg=c)
