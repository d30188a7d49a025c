"""The program's own spans (minimodem_tpu_torch/utils/trace.py) as the
metric readers see them.

The program records a span only while torch.profiler records, into an
in-memory log that the readers take in process after the window: each
record's name, start and end in time.perf_counter_ns() (the clock of the
drivers' window and of `Spans`) and its counts.  A
program without that log gives nothing to read, and the readers return
None.

The device records of `Trace` are on the profiler's clock (microseconds
from the trace's base time).  `offset_us` maps the program's clock onto
it through the benchmark's own spans, which sit on both: each is in
`run.spans` (perf_counter seconds) and, as an "mmb." annotation, in
`run.trace.host`.
"""

from __future__ import annotations

import statistics
from bisect import bisect_left

from .trace import busy_intervals


def log():
    """The program's span records, or None where the program keeps
    none."""
    try:
        from minimodem_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def window_records(run, name: str) -> list:
    """The closed records of `name` that started in the driver's
    [t0, t1); none in a run without a trace."""
    recs = log() if run.trace is not None else None
    if not recs:
        return []
    t0, t1 = run.window["t0"] * 1e9, run.window["t1"] * 1e9
    return [r for r in recs if r.name == name and r.end is not None
            and t0 <= r.start < t1]


def mean_ms(run, name: str):
    """The mean wall (ms) of the window's spans `name`, or None."""
    rs = window_records(run, name)
    return 1e-6 * sum(r.end - r.start for r in rs) / len(rs) if rs else None


def mean_count(run, name: str, key: str):
    """The mean count `key` of the window's spans `name` (0 where a span
    has none: nothing was counted inside it), or None."""
    vs = [r.counts.get(key, 0) for r in window_records(run, name)]
    return sum(vs) / len(vs) if vs else None


def offset_us(run):
    """Trace microseconds less perf_counter microseconds: the median over
    the benchmark's spans in the trace, each paired with the span of its
    name in `run.spans` that starts nearest to it.  The pairing starts
    from the first span of each name in the trace and the first of that
    name in the driver's window (the profiler records no span before the
    window), not from the window's annotation: the first annotation a
    profiler records can open a millisecond before its block runs."""
    tr = run.trace
    if tr is None or not tr.host:
        return None
    t0 = run.window["t0"] * 1e6
    hosts = {}
    for name, ts, _ in tr.host:
        hosts.setdefault(name, []).append(ts)
    starts = {name: sorted(a * 1e6 for a, _ in run.spans.spans.get(name, ())
                           if a * 1e6 >= t0) for name in hosts}
    firsts = [min(h) - starts[n][0] for n, h in hosts.items() if starts[n]]
    if not firsts:
        return None
    guess = statistics.median(firsts)
    diffs = []
    for name, h in hosts.items():
        s = starts[name]
        for ts in h if s else ():
            i = bisect_left(s, ts - guess)
            near = min(s[max(i - 1, 0):i + 1],
                       key=lambda v: abs(ts - guess - v))
            diffs.append(ts - near)
    return statistics.median(diffs)


def idle_within_pct(run, name: str):
    """Percent of the traced window in which no device record runs while
    the host is inside a span `name` (spans of one name do not
    overlap)."""
    off = offset_us(run)
    rs = window_records(run, name)
    if off is None or not rs:
        return None
    w0, w1 = run.trace.window_us
    busy = busy_intervals(run.trace.records, w0, w1)
    ends = [b for _, b in busy]
    idle = 0.0
    for r in rs:
        a, b = max(r.start * 1e-3 + off, w0), min(r.end * 1e-3 + off, w1)
        if b <= a:
            continue
        idle += b - a
        for u, v in busy[bisect_left(ends, a):]:
            if u >= b:
                break
            idle -= min(v, b) - max(u, a)
    return 100.0 * idle / (w1 - w0)
