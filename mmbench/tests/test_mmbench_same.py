"""The NOAA SAME cell (same.alerts128) on the CPU: the alert feeds'
schedules (35,030 bits on every seed), the cell's files and shapes, the
rooflines' counts at the dual layout, a tiny traced cell through
harness.run_cell (correct, the loopback host's spans and the device
metrics' readers), the faults it has to catch (a decoded byte altered, a
sync plane zeroed), the control, and the reference's dual planes against
reference/score.py's."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mmbench import harness, span_coverage
from mmbench.control import control
from mmbench.reference import modem, score, sync
from mmbench.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "same.alerts128"
# one alert of one transmission each, a short preamble and pauses: a
# stream of 466 bits, scored over 2^16 offsets (~1 s a batch on the CPU)
TINY = dict(streams=2, payload_sets=1, in_flight=2, check_streams=2,
            alerts_per_stream=1, repeats=1, locations=1, preamble_bytes=4,
            idle_bits=16)
SECONDS = 4.0
N = 35_030 * 92                # samples of a stream at the cell's size


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(**traffic):
    cell = harness.resolve(harness.load_manifest(ROOT), CELL, ROOT)
    assert cell.traffic["driver"] == "loopback_sync"
    cell.traffic.update(traffic)
    return cell


def _driver(cell, seed=1):
    return harness.load_driver(cell.traffic["driver"]).Driver(
        cell, seed, "cpu", Spans())


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, harness.reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**33 + 7])
def test_schedule_is_35030_bits_on_every_seed(seed):
    """6 alerts of 3 headers (77 bytes) and 3 NNNN, each after 16 x 0xAB
    and before 521 idle mark bits, no leader, 2 trailer bits."""
    drv = _driver(_cell(), seed)
    drv.make_inputs()
    assert drv.schedule_bits() == 35_030
    assert len(drv.scheds) == 8 and {len(s) for s in drv.scheds} == {128}
    assert {len(s) for ss in drv.scheds for s in ss} == {35_030}
    assert drv.audio_batch == pytest.approx(128 * N / 48000)
    bits = drv.scheds[seed % 8][seed % 128]
    pre = np.unpackbits(np.full(16, 0xAB, np.uint8), bitorder="little")
    head = np.packbits(bits[128:128 + 616], bitorder="little").tobytes()
    assert np.array_equal(bits[:128], pre)
    assert len(head) == 77 and head.startswith(b"ZCZC-")
    assert head[5:9] in (b"WXR-", b"EAS-", b"CIV-", b"PEP-")
    assert head[54:55] == b"+" and head.endswith(b"-")
    assert bits[744:1265].all() and np.array_equal(bits[1265:1393], pre)
    eom = 3 * 1265
    assert np.packbits(bits[eom + 128:eom + 160],
                       bitorder="little").tobytes() == b"NNNN"
    assert bits[-523:].all()
    assert len(drv.sample) == 16


def test_cell_files_and_shapes():
    """128 streams of 3,222,760 samples (67.14 s) into five planes at nb
    92, 4,378 frames each, and the cell's metrics."""
    cell = _cell()
    s = _driver(cell).shapes()
    assert s["synthesis"] == {"streams": 128, "samples": N, "bits": 35_030}
    assert s["score"] == {"streams": 128, "offsets": N, "nb": 92,
                          "n_bits": 8, "planes": 5, "halo": 645 + 92}
    assert s["statemachine"]["frames"] == 4378
    assert s["statemachine"]["bytes_out"] == 4378 - 576
    g = modem.geometry(cell.config)
    t_total = modem.round_up_bucket(modem.sched_pad(35_030) * 92
                                    + g.overscan + 1)
    assert t_total == 13 << 18 == 3_407_872
    assert [m["name"] for m in cell.per_layer] == [
        "device_idle_pct.same", "k1_roofline.same", "k2_roofline.same",
        "k4_roofline.same", "host_dispatch_ms.same", "pack_ms.same",
        "enqueue_ms.same", "unpack_ms.same"]
    assert [m["name"] for m in cell.end_to_end] == ["audio_rate", "setup_s"]


def test_rooflines_count_the_dual_layout_at_the_cell_shape():
    """K1's roofline reads the five planes from the score shape (one set
    of frame sums: the kernel masks one confidence twice by an integer
    compare of the frame's bits); K4 writes every keyed sample."""
    shape = _driver(_cell()).shapes()
    for name in ("k1_roofline", "k2_roofline", "k4_roofline"):
        assert harness.reader_path(f"{name}.same").name == f"{name}.py"
    nbytes, flops = _metric("k1_roofline").work(shape["score"])
    assert (nbytes, flops) == (128 * (N + 737) * 4 + 128 * N * 5 * 4,
                               128 * N * (8 * 92 + 10 + 6 * 8 + 6))
    assert _metric("k4_roofline").work(shape["synthesis"]) == (
        128 * (N * 4 + 35_030 / 8), 2 * 128 * N)
    cand = len(modem.statics(modem.geometry(_cell().config), 1 << 18,
                             True).cand_c[1])
    assert _metric("k2_roofline").work(shape["statemachine"]) == (
        128 * (4378 * (cand + 2) * 4 + 4378 - 576), 0)


def _with_kernels(run, records):
    """The run's readers over a made-up device trace."""
    tr = Trace()
    tr.records, tr.window_us = records, (0.0, 1e6)
    return harness.Run(run.cell, run.seed, run.setup_s, run.window,
                       run.spans, run.shapes, tr, {
                           "bytes_per_s": 3.35e12,
                           "fp32_flops_per_s": 67e12}, run.extra)


def test_tiny_traced_cell_reads_its_metrics(one_thread):
    res, run = span_coverage.traced_run(_cell(**TINY), 2**33 + 17, SECONDS,
                                        "cpu")
    assert res["correct"], res["check"]
    assert res["check"]["streams_differing"] == {"value": 0, "limit": 0}
    # K2's bytes written: the reference's decode of the checked streams
    drv = _driver(_cell(**TINY), 2**33 + 17)
    drv.make_inputs()
    decoded = [len(r[2]) for r in drv.reference().values()]
    assert run.shapes["statemachine"]["bytes_out"] == np.mean(decoded) > 0
    got = res["metrics"]
    for name in ("device_idle_pct.same", "host_dispatch_ms.same",
                 "pack_ms.same", "enqueue_ms.same", "unpack_ms.same"):
        assert got[name]["value"] >= 0, name
    # no kernels on the CPU: the rooflines read a made-up trace of them
    rooflines = ("k1_roofline.same", "k2_roofline.same", "k4_roofline.same")
    assert not set(rooflines) & set(got)
    fake = _with_kernels(run, [
        ("tx_synth_bits_kernel", "kernel", 0.0, 10.0, 0),
        ("fused_score_kernel<1, 8, 4, true>", "kernel", 10.0, 4000.0, 0),
        ("mega_rx_kernel", "kernel", 5000.0, 1000.0, 0)])
    k1, k2, k4 = (harness.load_reader(m)(fake) for m in rooflines)
    work = _metric("k1_roofline").work(run.shapes["score"])
    assert k1 == pytest.approx(100 * work[1] / 67e12 / 4e-3)
    assert k2 > 0 and k4 > 0


def test_tiny_cell_one_byte_altered_not_correct(one_thread, monkeypatch):
    from minimodem_tpu_torch.ops import device_rx

    collect = device_rx.DeviceLoopback.collect_events_batch

    def altered(self, handle):
        res = [tuple(np.array(x, copy=True) for x in e)
               for e in collect(self, handle)]
        for e in res:
            assert len(e[2]) > 0
            e[2][len(e[2]) // 2] ^= 1
        return res

    monkeypatch.setattr(device_rx.DeviceLoopback, "collect_events_batch",
                        altered)
    res, _ = harness.run_cell(_cell(**TINY), 2**32 + 91, SECONDS, False,
                              "cpu")
    assert not res["correct"]
    assert res["check"]["streams_differing"]["value"] == 2


def test_tiny_cell_sync_plane_zeroed_not_correct(one_thread, monkeypatch):
    """Zero the sync confidence plane the scorer writes: the state
    machine never acquires, and every sampled stream differs."""
    from minimodem_tpu_torch.ops import fused_score

    score_call = fused_score.FusedScorer.__call__

    def zeroed(self, x, t_len):
        out = score_call(self, x, t_len)
        assert out.shape[1] == 5
        out[:, 3] = 0
        return out

    monkeypatch.setattr(fused_score.FusedScorer, "__call__", zeroed)
    res, _ = harness.run_cell(_cell(**TINY), 2**32 + 91, SECONDS, False,
                              "cpu")
    assert not res["correct"]
    assert res["check"]["streams_differing"]["value"] == 2


def test_control_is_not_correct(one_thread):
    checks = control(_cell(**TINY), 2**32 + 5, "cpu")
    assert checks[0]["name"] == "streams_differing"
    assert checks[0]["value"] > checks[0]["limit"]


def test_dual_planes_less_the_sync_rows_are_the_score_planes(one_thread):
    """At 2 streams x 2 s of seeded alert audio the reference's dual
    planes, with the sync rows taken away, are reference/score.py's three
    planes; the sync rows are the same channels masked by the sync
    byte's pattern, which the preamble's offsets meet."""
    cell = _cell()
    g = modem.geometry(cell.config)
    t = dict(cell.traffic, alerts_per_stream=1)
    head = sync.headers(np.random.default_rng(7), 2, 6)
    bits = sync.alert_schedules(head[:, None], t, 0xAB)[:, :1043]
    x = torch.zeros((2, 96_000 + g.halo))
    from mmbench.reference import synth

    x[:, :1043 * 92] = synth.audio(torch.from_numpy(bits), g)
    want = sync.sync_expectation(g, 0xAB)
    assert want == (1, 1, 0, 1, 0, 1, 0, 1)
    dual = sync.planes(x, g, want, 96_000)
    plain = score.planes(x, g, 96_000)
    assert dual.shape == (2, 5, 96_000) and plain.shape == (2, 3, 96_000)
    assert torch.equal(dual[:, :3], plain)
    conf_s = dual[:, 3].view(torch.float32)
    frame = dual[:, 2] & 0xFF
    hit = frame == 0xAB
    assert torch.equal(conf_s[~hit], torch.zeros_like(conf_s[~hit]))
    assert torch.equal(dual[:, 3][hit], dual[:, 0][hit])
    assert torch.equal(dual[:, 4][hit], dual[:, 1][hit])
    # each preamble frame's aligned offset matches the sync byte
    assert bool(hit[:, 0].all()) and int(hit.sum()) > 2 * 16
