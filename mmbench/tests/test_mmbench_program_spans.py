"""The readers of the program's own spans (mmbench/program_spans.py and
its eight metrics) on a made-up log and trace, against hand-computed
values; None without a log, a trace or the program's recorder; the
offset helper on a real profiler trace; and the tiny cells' traced runs
on the CPU, which print them."""

import json
import statistics
import sys
import time
from types import SimpleNamespace

import pytest

from _cells import tiny_cell
from mmbench import harness, program_spans, span_coverage
from mmbench.trace import Spans, Trace

T0 = 10.0                      # the driver's window, perf_counter seconds
OFF = 5_000_000.0              # trace us less perf_counter us
MS = 1_000_000                 # ns a millisecond


def _rec(name, start_ms, dur_ms, **counts):
    s = int(T0 * 1e9) + int(start_ms * MS)
    end = None if dur_ms is None else s + int(dur_ms * MS)
    return SimpleNamespace(name=name, start=s, end=end, counts=counts)


LOG = [
    _rec("rx.wire", -500, 400, bytes=92_274_688, alloc_bytes=92_274_688),
    _rec("rx.wire", 0, 40, bytes=92_274_688, alloc_bytes=92_274_688),
    _rec("rx.wire", 100, 50, bytes=92_274_688, alloc_bytes=92_274_688),
    _rec("rx.wire", 200, 60, bytes=92_274_688, alloc_bytes=92_274_688),
    _rec("rx.wire", 1000, 10, bytes=1, alloc_bytes=1),    # at t1: out
    _rec("rx.wire", 900, None),                            # open: out
    _rec("rx.upload", 40, 10, bytes=5), _rec("rx.upload", 150, 20, bytes=5),
    _rec("rx.collect", 60, 3), _rec("rx.collect", 170, 5),
    _rec("lb.pack", 300, 2), _rec("lb.pack", 310, 4),
    _rec("lb.enqueue", 302, 0.5),
    _rec("lb.unpack", 320, 1), _rec("lb.unpack", 330, 2),
]
# a kernel inside the first wire copy (10 ms), a copy over the end of the
# second (10 ms of it inside): idle in the wire spans 30 + 40 + 60 ms of
# the 1 s window
DEVICE = [("k", "kernel", 20_000.0, 10_000.0, 0),
          ("Memcpy HtoD", "gpu_memcpy", 140_000.0, 30_000.0, 8)]
HAND = {"wire_copy_ms": 50.0, "wire_alloc_mb": 92.274688, "upload_ms": 15.0,
        "idle_wire_pct": 13.0, "collect_ms": 4.0, "pack_ms": 3.0,
        "enqueue_ms": 0.5, "unpack_ms": 1.5}


def _run(trace=True):
    """A run whose trace clock is perf_counter us + OFF; the benchmark's
    spans on both clocks, a few us apart (median 0)."""
    spans = Spans()
    starts = [T0, T0 + 0.1, T0 + 0.2]
    spans.spans["decode"] = [(s, s + 0.05) for s in starts]
    tr = None
    if trace:
        base = T0 * 1e6 + OFF
        tr = Trace()
        tr.window_us = (base - 5.0, base - 5.0 + 1e6)
        tr.records = [(n, c, base + t, d, b) for n, c, t, d, b in DEVICE]
        tr.host = [("decode", s * 1e6 + OFF + j, s * 1e6 + OFF + j + 5e4)
                   for s, j in zip(starts, (0.0, 3.0, -2.0))]
    return harness.Run(cell=None, seed=0, setup_s=1.0,
                       window={"seconds": 1.0, "t0": T0, "t1": T0 + 1.0,
                               "audio_s": 1.0},
                       spans=spans, shapes={}, trace=tr)


@pytest.fixture
def log(monkeypatch):
    from minimodem_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: list(LOG))


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_reads_its_hand_value(log, name):
    assert harness.load_reader(name)(_run()) == pytest.approx(HAND[name],
                                                              rel=1e-9)


def test_offset_is_the_median_pair(log):
    assert program_spans.offset_us(_run()) == pytest.approx(OFF, abs=1e-6)


def test_wire_alloc_reads_0_where_nothing_was_allocated(monkeypatch):
    """A call that allocates no wire buffer adds no alloc_bytes to its
    rx.wire span: the metric reads 0, not nothing."""
    from minimodem_tpu_torch.utils import trace

    reused = [_rec(r.name, (r.start - T0 * 1e9) / MS,
                   None if r.end is None else (r.end - r.start) / MS,
                   **{k: v for k, v in r.counts.items()
                      if k != "alloc_bytes"}) for r in LOG]
    monkeypatch.setattr(trace, "records", lambda: reused)
    assert harness.load_reader("wire_alloc_mb")(_run()) == 0.0


def test_offset_maps_a_profiled_program_span(tmp_path):
    """On a real torch.profiler trace (CPU), the program's span starts,
    mapped by offset_us through the benchmark's spans, land on their
    "mm." annotations: within 50 us in the median, one span off by at
    most a scheduler quantum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from minimodem_tpu_torch.utils import trace
    from mmbench.trace import WINDOW

    bench = Spans(annotate=True)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first annotations open late (its set-up): one of
        # each kind before the window
        with bench.span("warm-up"), trace.span("warm-up"):
            pass
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(6):
                with bench.span("call"):
                    with trace.span("work"):
                        time.sleep(0.002)
                    with trace.span("tail"):
                        pass
            t1 = time.perf_counter()
    recs = trace.records()[1:]
    trace.clear()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    win = [e for e in events if e["name"] == WINDOW][0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    host = [(e["name"][4:], e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"].startswith("mmb.") and e["name"] != WINDOW
            and e["ts"] + e["dur"] > w0 and e["ts"] < w1]
    run = SimpleNamespace(trace=SimpleNamespace(window_us=(w0, w1),
                                                host=host),
                          window={"t0": t0, "t1": t1}, spans=bench)
    off = program_spans.offset_us(run)
    assert len(recs) == 12
    diffs = []
    for name in ("work", "tail"):
        ts = sorted(e["ts"] for e in events if e["name"] == "mm." + name)
        mine = [r.start * 1e-3 + off for r in recs if r.name == name]
        assert len(ts) == len(mine) == 6
        diffs += [abs(a - b) for a, b in zip(ts, mine)]
    assert statistics.median(diffs) < 50.0
    assert max(diffs) < 20_000.0


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_without_log_or_trace(monkeypatch, name):
    import minimodem_tpu_torch.utils as utils
    from minimodem_tpu_torch.utils import trace

    read = harness.load_reader(name)
    monkeypatch.setattr(trace, "records", lambda: [])
    assert read(_run()) is None
    monkeypatch.setattr(trace, "records", lambda: list(LOG))
    assert read(_run(trace=False)) is None
    # a program without the recorder
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "minimodem_tpu_torch.utils.trace", None)
    assert read(_run()) is None


def test_idle_wire_never_above_the_devices_idle(log):
    run = _run()
    assert harness.load_reader("idle_wire_pct")(run) <= \
        harness.load_reader("device_idle_pct.batch")(run)


@pytest.mark.parametrize("name,metrics,cover", [
    ("uic_train.batch16", ("wire_copy_ms", "wire_alloc_mb", "upload_ms",
                           "idle_wire_pct", "collect_ms"), ("rx",)),
    ("bell202.loopback8", ("pack_ms", "enqueue_ms", "unpack_ms"),
     ("lb.dispatch", "lb.collect")),
])
def test_traced_tiny_cell_prints_the_span_metrics(name, metrics, cover):
    """A traced run at a tiny size on the CPU: the cell's new metrics
    beside the old ones, correct, and the coverage of the benchmark's
    spans by the program's."""
    import torch

    torch.set_num_threads(1)
    res, run = span_coverage.traced_run(tiny_cell(name), 2**33 + 17, 8.0,
                                        "cpu")
    assert res["correct"]
    got = res["metrics"]
    assert set(metrics) <= set(got)
    if "idle_wire_pct" in got:
        assert 0 < got["idle_wire_pct"]["value"] <= \
            got["device_idle_pct.batch"]["value"]
        # channels x (t_total + halo) int16 samples, afresh every call
        from minimodem_tpu_torch.ops import device_rx

        from mmbench.drivers import _common

        cfg = _common.program_config(run.cell)
        n = harness.load_driver("recorded").Driver(
            run.cell, 0, "cpu", Spans()).samples()
        row = device_rx._round_up_pow2(n + cfg.nsamples_overscan + 1) + \
            device_rx.geo_from_key(device_rx.device_rx_key(cfg)).halo
        wire = run.cell.traffic["channels"] * row * 2
        alloc = [r.counts["alloc_bytes"] for r in
                 program_spans.window_records(run, "rx.wire")]
        assert alloc and set(alloc) == {wire}
    c = span_coverage.coverage(run)
    for key in cover:
        assert 0.5 < c["coverage"][key] <= 1.0
