"""The fleet service (minimodem_tpu_torch/parallel/service.py) against the
JAX package's (minimodem_tpu/parallel/service.py) and the port's
single-card receivers, on the CPU.

The port side runs once for the module in a world of 4 gloo processes
(tests/torch_fleet.py::service_world: ShardedReceiver at dp = 4, (dp, sp)
= (2, 2) and (1, 4), ShardedLoopback at dp = 4), every case on every
rank; the JAX side runs here on the 8 virtual CPU devices of the root
conftest.py, as tests/test_service.py runs it, with the XLA receiver's
hybrid harvester off (MINIMODEM_TPU_HYBRID=0, as in
tests/test_torch_mega_rx.py).

The bar, per stream: event types, integer lanes and byte streams equal to
the JAX fleet's, every part equal to the port's DeviceReceiver's /
DeviceLoopback's; the NOCARRIER float lanes (confidence and amplitude
totals) within RTOL / ATOL of JAX's (the scorers' stated drift,
tests/test_torch_loopback.py); decode_batch returns the sent texts;
frames_total and events_total equal JAX's, mean_confidence within
relative MEAN_RTOL (a float sum in another order: JAX's float32 psum,
the port's float64 all_reduce).

In the same world: the six spans of a u-law call on every rank, and its
decode of channels made by the benchmark's tones against the benchmark's
plain reference (mmbench/reference/), bit for bit.
"""

import numpy as np
import pytest
import torch

from . import torch_fleet as F

RTOL, ATOL = 2e-6, 1e-5
MEAN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    """Every rank's results of the service cases."""
    from minimodem_tpu_torch.parallel.launch import spawn_world

    return spawn_world(F.service_world, 4, timeout=300)


@pytest.fixture(scope="module")
def jax_fleet():
    """fn(dp, sp, mode="1200", **kw) -> the JAX ShardedReceiver on a
    (dp, sp) mesh of the virtual CPU devices, with the sequential XLA
    receiver."""
    import jax

    from minimodem_tpu.models.modem import FskModem
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu.parallel.service import ShardedReceiver
    from minimodem_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (conftest re-exec)")
    mp = pytest.MonkeyPatch()
    mp.setenv("MINIMODEM_TPU_HYBRID", "0")
    D._build_device_rx.cache_clear()

    def make(dp, sp, mode="1200", **kw):
        return ShardedReceiver(FskModem(mode).cfg,
                               make_mesh(dp * sp, dp=dp, sp=sp), **kw)

    yield make
    D._build_device_rx.cache_clear()
    mp.undo()


def case(port, name):
    """Rank 0's result of a case; a case that raised fails here with the
    rank's traceback."""
    r = port[0][name]
    if isinstance(r, tuple) and len(r) == 2 and r[0] == "error":
        pytest.fail(f"the port's {name} raised:\n{r[1]}")
    return r


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def assert_events_equal(got, ref):
    """Every part of every stream's tuple equal."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def assert_events_match(got, ref):
    """Types, integer lanes and bytes equal; NOCARRIER float lanes (1:
    confidence total, 2: amplitude total) within RTOL / ATOL."""
    assert len(got) == len(ref)
    for (tt, tp, tb), (jt, jp, jb) in zip(got, ref):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tb, jb)
        nc = tt == 2
        for lane in range(6):
            if lane in (1, 2):
                np.testing.assert_array_equal(tp[~nc, lane], jp[~nc, lane])
                np.testing.assert_allclose(
                    tp[nc, lane].view(np.float32),
                    jp[nc, lane].view(np.float32), rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(tp[:, lane], jp[:, lane])


def assert_stats_match(got, ref):
    for k in ("devices", "events_total", "frames_total"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["mean_confidence"],
                               ref["mean_confidence"], rtol=MEAN_RTOL)


def single_card(name, mode="1200", enc=None, **kw):
    """The port's DeviceReceiver on the same batch (compact auto)."""
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

    x, totals = F.batch(name, mode, enc)
    return DeviceReceiver(F.modem(mode).cfg, device="cpu", **kw) \
        .run_events_batch(x, totals, F.THR, F.LIM,
                          in_encoding=enc if enc == "ulaw" else None)[0]


def jax_events(svc, name, mode="1200", enc=None):
    x, totals = F.batch(name, mode, enc)
    return svc.run_events_batch(
        x, totals, F.THR, F.LIM, in_encoding=enc if enc == "ulaw" else None)


def test_every_rank_returns_every_stream(port):
    """Results are assembled on every rank: each rank's result of every
    case equals rank 0's."""
    assert len(port) == 4
    for rank in range(1, 4):
        for name in port[0]:
            assert _same(port[rank][name], port[0][name]), (rank, name)


def test_decode_batch_dp4(port, jax_fleet):
    outs, stats = case(port, "decode_dp4")
    texts = F.TEXTS["five"]
    assert outs == texts
    assert stats["devices"] == 4
    assert stats["frames_total"] == sum(len(t) for t in texts)
    assert stats["mean_confidence"] > 1.5
    assert stats["events_total"] >= 2 * len(texts)  # CARRIER+NOCARRIER
    j_outs, j_stats = jax_fleet(4, 1).decode_batch(F.streams("five"))
    assert j_outs == texts
    assert_stats_match(stats, j_stats)


@pytest.mark.parametrize("name,enc", [("events_dp4", None),
                                      ("ulaw_dp4", "ulaw")])
def test_events_match_single_card_and_jax(port, jax_fleet, name, enc):
    """dp = 4: the per-stream results (event log and on-device-decoded
    byte stream) equal the port's compact DeviceReceiver's exactly and
    JAX's fleet's; the u-law wire expands on each rank."""
    texts = "two" if enc is None else "three"
    got, stats = case(port, name)
    assert all(len(e) == 3 for e in got)        # compact: + byte stream
    assert_events_equal(got, single_card(texts, enc=enc))
    ref, j_stats = jax_events(jax_fleet(4, 1), texts, enc=enc)
    assert_events_match(got, ref)
    assert_stats_match(stats, j_stats)
    for e, t in zip(got, F.TEXTS[texts]):
        assert e[2].tobytes() == t


def test_compact_vs_wide_service_equality(port):
    """compact (production) and wide event modes of the fleet agree: the
    same carrier-transition events, decoded bytes and fleet stats."""
    from minimodem_tpu_torch.ops.device_rx import EV_FRAME

    r = case(port, "compact_vs_wide_dp4")
    (outs_c, stats_c), ev_c = r[True]
    (outs_w, stats_w), ev_w = r[False]
    assert outs_c == outs_w == F.TEXTS["three"]
    for k in ("devices", "frames_total", "mean_confidence"):
        assert stats_c[k] == stats_w[k], k
    assert stats_c["events_total"] <= stats_w["events_total"]
    assert_events_equal(ev_w, single_card("three", compact=False))
    for tup_c, tup_w in zip(ev_c, ev_w):
        keep = tup_w[0] != EV_FRAME
        np.testing.assert_array_equal(tup_c[0], tup_w[0][keep])


@pytest.mark.parametrize("name,dp,sp", [("sp22", 2, 2), ("sp14", 1, 4)])
def test_sp_sharded_full_decode(port, jax_fleet, name, dp, sp):
    """sp-sharded scoring, the planes gathered along sp, K2 replicated:
    byte- and event-exact against the single-card receiver, and against
    JAX's fleet on the same mesh."""
    (outs, stats), (got, stats_e) = case(port, name)
    texts = F.TEXTS["sp"]
    assert outs == texts
    assert stats["frames_total"] == sum(len(t) for t in texts)
    assert stats == stats_e
    assert_events_equal(got, single_card("sp"))
    ref, j_stats = jax_events(jax_fleet(dp, sp), "sp")
    assert_events_match(got, ref)
    assert_stats_match(stats, j_stats)


def test_sp_u8_wire_masks_at_shard_positions(port, jax_fleet):
    """A u-law wire at (2, 2): the halo of the last shard is the silence
    codeword and each shard masks its tail at shard-absolute positions,
    so the events equal the single card's and JAX's."""
    got, stats = case(port, "ulaw_sp22")
    assert_events_equal(got, single_card("three", enc="ulaw"))
    ref, j_stats = jax_events(jax_fleet(2, 2), "three", enc="ulaw")
    assert_events_match(got, ref)
    assert_stats_match(stats, j_stats)


def test_sp_int16_wire_halo(port):
    """An int16 wire at (1, 4): the halo crosses the sp group as bytes
    (no int16 collective on NCCL or gloo) and arrives intact."""
    got, _ = case(port, "int16_sp14")
    assert_events_equal(got, single_card("three", enc="int16"))


def test_sp_sharded_dual_expect_same_mode(port, jax_fleet):
    """SAME (--sync-byte) is dual-expect: the sp path gathers all 5 plane
    rows and still matches the single card and JAX's fleet."""
    (outs, stats), (got, _) = case(port, "same_sp22")
    assert outs == F.TEXTS["same"]
    assert_events_equal(got, single_card("same", "same"))
    svc = jax_fleet(2, 2, "same")
    ref, _ = jax_events(svc, "same", "same")
    assert_events_match(got, ref)
    assert_stats_match(stats, svc.decode_batch(F.streams("same", "same"))[1])


def test_sharded_loopback_matches_device_loopback(port, jax_fleet):
    """ShardedLoopback runs DeviceLoopback's per-device program on each
    rank: every result part equals the single-card loopback's, with dp
    padding by empty streams (5 streams on dp = 4), and JAX's fleet
    loopback's."""
    from minimodem_tpu.parallel.service import ShardedLoopback as JaxFleet
    from minimodem_tpu.parallel.sharding import make_mesh as jax_mesh
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    got = case(port, "loopback_dp4")
    scheds = F.schedules()
    assert len(got) == len(F.TEXTS["loopback"])
    assert_events_equal(got, DeviceLoopback(
        F.modem().cfg, device="cpu").run_events_batch(scheds))
    ref = JaxFleet(jax_fleet(4, 1).cfg, jax_mesh(4, dp=4, sp=1)) \
        .run_events_batch(scheds)
    assert_events_match(got, ref)
    for e, t in zip(got, F.TEXTS["loopback"]):
        assert e[2].tobytes() == t


def test_batch_padding_to_dp(port):
    # 3 streams on a 4-wide dp axis: rows pad with silence and drop
    outs, stats = case(port, "padding_dp4")
    assert outs == F.TEXTS["pad"]
    assert stats["frames_total"] == 6


def test_errors_match_jax(port, jax_fleet):
    """The JAX package's ValueErrors, same texts: ShardedLoopback on an sp
    mesh, and an sp shard shorter than the geometry's halo (1 baud)."""
    from minimodem_tpu.parallel.service import ShardedLoopback as JaxFleet
    from minimodem_tpu.parallel.sharding import make_mesh as jax_mesh

    errs = case(port, "errors")
    with pytest.raises(ValueError) as e:
        JaxFleet(jax_fleet(1, 1).cfg, jax_mesh(4, dp=2, sp=2))
    assert errs["loopback_sp"] == ("ValueError", str(e.value))
    with pytest.raises(ValueError) as e:
        jax_fleet(1, 4, "1").run_events_batch(np.zeros((1, 100), np.float32),
                                              [100])
    assert errs["halo_sp"] == ("ValueError", str(e.value))


@pytest.mark.parametrize("name,dp,sp", [("spans_dp4", 4, 1),
                                        ("spans_sp22", 2, 2)])
def test_fleet_call_records_its_six_spans(port, name, dp, sp):
    """Under torch.profiler one u-law call records on every rank the six
    spans in call order: rx.wire's bytes are the rank block's wire (rows
    x width u-law bytes), rx.upload's the totals, fleet.reduce's
    ranks the dp group's size, fleet.gather's streams and bytes the
    rank's rows and their event and byte arrays.  Outside a profiler the
    same call records nothing."""
    from minimodem_tpu_torch.ops.device_rx import (
        STAGE_CHUNK_BYTES, _round_up_pow2, device_rx_key, geo_from_key)

    x, _ = F.ulaw_channels()
    events = case(port, "ulaw_ref_dp4")["events"]
    cfg = F.modem().cfg
    need = x.shape[1] + cfg.nsamples_overscan + 1
    width = (_round_up_pow2(need) + geo_from_key(device_rx_key(cfg)).halo
             if sp == 1 else _round_up_pow2(-(-need // sp)))
    rows = len(x) // dp
    ranks = case(port, name)
    assert len(ranks) == 4
    for rank, (on, off) in enumerate(ranks):
        assert [n for n, _ in on] == list(F.FLEET_SPANS), rank
        c = dict(on)
        assert c["rx.wire"]["bytes"] == rows * width
        # the shard's u-law bytes of samples, in 4 MiB chunks (none where
        # the last sp shard lies past the samples)
        cols = max(0, min(x.shape[1] - rank % sp * (width if sp > 1 else 0),
                          width))
        assert c["rx.wire"]["chunks"] == -(-rows * cols // STAGE_CHUNK_BYTES)
        assert c["rx.upload"]["bytes"] == rows * 4     # the int32 totals
        assert c["fleet.reduce"]["ranks"] == dp
        assert c["fleet.gather"]["streams"] == rows
        mine = events[rank // sp * rows:(rank // sp + 1) * rows]
        assert c["fleet.gather"]["bytes"] == sum(a.nbytes for e in mine
                                                 for a in e)
        assert off == 0


def test_ulaw_fleet_equals_the_benchmarks_reference(port):
    """dp = 4 on 8 seeded u-law Bell-202 channels made by the benchmark's
    tones: every rank's events and bytes equal the benchmark's plain
    reference (g711.ulaw_expand, the score planes in float32, the state
    machine; no kernel of the port) event for event and byte for byte,
    and the bytes are the keyed ones."""
    from mmbench.drivers import _common
    from mmbench.reference import g711
    from mmbench.reference import modem as ref_modem

    x, pay = F.ulaw_channels()
    g = F.bell202_geometry()
    n = x.shape[1]
    t_total = ref_modem.round_up_bucket(n + g.overscan + 1)
    xf = np.zeros((len(x), t_total + g.halo), np.float32)
    xf[:, :n] = g711.ulaw_expand(x)
    ref = _common.ref_decode(_common.ref_planes(xf, g, t_total, "cpu"), g,
                             t_total, [n] * len(x), True, F.THR, F.LIM)
    case(port, "ulaw_ref_dp4")
    for rank in range(4):
        got = port[rank]["ulaw_ref_dp4"]["events"]
        np.testing.assert_array_equal(port[rank]["ulaw_ref_dp4"]["x"], x)
        assert len(got) == len(ref) == 8
        for e, r in zip(got, ref):
            assert len(e) == len(r) == 3
            for a, b in zip(e, r):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for e, p in zip(got, pay):
            assert e[2].tobytes() == p.tobytes()
