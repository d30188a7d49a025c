"""How far the program's own spans cover the benchmark's spans, in one
traced run of one cell:

    python3 -m mmbench.span_coverage --workload <cell> --seed <n>
        --seconds <s> [--spans N]

It runs the cell as `python3 -m mmbench.run --trace 1` does and prints
one JSON line: the run's `correct` and per-layer metrics, the audio rate
of the traced window, per span name (the program's, and the benchmark's
with "mmb." before it) the count in the window and the mean wall (ms),
and the coverage, each a ratio of the window's summed walls:

  rx            rx.wire + rx.upload + rx.enqueue + rx.collect over the
                benchmark's decode (a DeviceReceiver.run_events_batch call)
  lb.dispatch   lb.pack + lb.upload + lb.enqueue over the benchmark's
                dispatch (DeviceLoopback.dispatch_events_batch)
  lb.collect    lb.wait + lb.unpack over the benchmark's collect

the host's share of the window in each path's top spans (rx.*;
lb.pack + lb.dispatch + lb.prefetch + lb.collect), the host's rate of
the wire copy and of the upload (rx.wire's and rx.upload's `bytes` over
their walls, 10^9 bytes a second), and the spans the program's log
dropped (full).  `--spans N` adds the host cost of
one span, N spans timed with the profiler off and on, beside the same
loop without a span.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness, program_spans

COVER = {
    "rx": (("rx.wire", "rx.upload", "rx.enqueue", "rx.collect"), "decode"),
    "lb.dispatch": (("lb.pack", "lb.upload", "lb.enqueue"), "dispatch"),
    "lb.collect": (("lb.wait", "lb.unpack"), "collect"),
}
SHARE = {
    "rx": ("rx.wire", "rx.upload", "rx.enqueue", "rx.collect"),
    "lb": ("lb.pack", "lb.dispatch", "lb.prefetch", "lb.collect"),
}
RATES = ("rx.wire", "rx.upload")


def traced_run(cell, seed: int, seconds: float, device: str = "cuda"):
    """harness.run_cell with tracing on -> (result, the Run its readers
    saw).  The Run is built inside run_cell, so a subclass that keeps it
    stands in for harness.Run during the call."""
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    plain = harness.Run
    harness.Run = Kept
    try:
        result, _ = harness.run_cell(cell, seed, seconds, True, device)
    finally:
        harness.Run = plain
    return result, runs[0]


def coverage(run) -> dict:
    """Counts, mean walls and coverage ratios of the program's spans in
    the run's window (see the module's docstring)."""
    t0, t1 = run.window["t0"], run.window["t1"]
    names = {r.name for r in program_spans.log() or ()}
    walls = {name: [(r.end - r.start) * 1e-9
                    for r in program_spans.window_records(run, name)]
             for name in names}
    for name in run.spans.spans:
        walls["mmb." + name] = run.spans.within(name, t0, t1)
    spans = {k: {"n": len(v), "mean_ms": 1e3 * sum(v) / len(v)}
             for k, v in sorted(walls.items()) if v}
    cover = {}
    for key, (parts, whole) in COVER.items():
        base = sum(walls.get("mmb." + whole, ()))
        if base > 0 and all(walls.get(p) for p in parts):
            cover[key] = sum(sum(walls[p]) for p in parts) / base
    share = {key: sum(sum(walls.get(p, ())) for p in parts) / (t1 - t0)
             for key, parts in SHARE.items() if walls.get(parts[0])}
    rates = {}
    for name in RATES:
        recs = program_spans.window_records(run, name)
        t = sum(r.end - r.start for r in recs) * 1e-9
        if t > 0:
            rates[name] = sum(r.counts["bytes"] for r in recs) / t / 1e9
    try:
        from minimodem_tpu_torch.utils import trace
        dropped = trace.dropped()
    except ImportError:
        dropped = None
    return {"spans": spans, "coverage": cover, "host_share": share,
            "host_gbps": rates, "dropped": dropped}


def span_cost_us(n: int):
    """Host microseconds a span, timed over n spans with the profiler off
    and on (CPU and, with a card, CUDA activity, as the benchmark's
    trace), and the same loop without a span; None for a program without
    the recorder."""
    import torch

    try:
        from minimodem_tpu_torch.utils import trace
    except ImportError:
        return None

    def loop(with_span: bool) -> float:
        t = time.perf_counter()
        if with_span:
            for _ in range(n):
                with trace.span("cost") as s:
                    s.count(k=1)
        else:
            for _ in range(n):
                pass
        return (time.perf_counter() - t) / n * 1e6

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    bare, off = loop(False), loop(True)
    with torch.profiler.profile(activities=acts):
        on = loop(True)
    trace.clear()
    return {"n": n, "bare_us": bare, "off_us": off, "on_us": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mmbench.span_coverage")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("E: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_manifest(), args.workload)
    result, run = traced_run(cell, args.seed, args.seconds)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"],
           "audio_rate": run.window["audio_s"] / run.window["seconds"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           **coverage(run)}
    if args.spans:
        out["span_cost"] = span_cost_us(args.spans)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
