"""Spans and the device trace of one run.

`Spans` keeps the benchmark's own host-clock spans around its calls into
the program (name -> list of (start, end) in perf_counter seconds); with
tracing on each span is also a torch.profiler annotation ("mmb.<name>"),
so the trace shows what the host was doing.

`Trace` runs torch.profiler (CPU and CUDA activity) over the measured
window, exports its Chrome trace to TMPDIR, reads the device records
(kernels, copies, sets) that start inside the window annotation, and
deletes the file.  The readers in mmbench/metrics take what they need
from it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "mmb.window"
NAME_CHARS = 120       # a device operation's name in the breakdown


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.annotate:
            import torch

            with torch.profiler.record_function("mmb." + name):
                t0 = time.perf_counter()
                yield
                self.spans[name].append((t0, time.perf_counter()))
        else:
            t0 = time.perf_counter()
            yield
            self.spans[name].append((t0, time.perf_counter()))

    def within(self, name: str, t0: float, t1: float) -> list:
        """Durations (s) of the spans of `name` that start in [t0, t1)."""
        return [b - a for a, b in self.spans.get(name, ()) if t0 <= a < t1]


class Trace:
    """Device records of the traced window: `records` is a list of
    (name, cat, start_us, dur_us, bytes), `window_us` the window's
    (start, end) on the trace clock, `host` the benchmark's annotations
    as (name, start_us, end_us)."""

    def __init__(self):
        self.records, self.host = [], []
        self.window_us = None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.records.append((e.get("name", ""), cat, float(e["ts"]),
                                     float(e.get("dur", 0.0)),
                                     int((e.get("args") or {}).get(
                                         "bytes", 0) or 0)))
            elif cat == "user_annotation" and str(
                    e.get("name", "")).startswith("mmb."):
                t0 = float(e["ts"])
                self.host.append((e["name"][4:], t0,
                                  t0 + float(e.get("dur", 0.0))))
                if e["name"] == WINDOW:
                    self.window_us = (t0, t0 + float(e.get("dur", 0.0)))
        if self.window_us is not None:
            w0, w1 = self.window_us
            self.records = [r for r in self.records if w0 <= r[2] < w1]
            self.host = [h for h in self.host if h[2] > w0 and h[1] < w1
                         and h[0] != WINDOW[4:]]


def busy_intervals(records, w0: float, w1: float) -> list:
    """The union of the records' [start, end), clipped to [w0, w1)."""
    iv = sorted((max(r[2], w0), min(r[2] + r[3], w1)) for r in records)
    out = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the window by the benchmark span the host was in (or "other")."""
    by_name = defaultdict(float)
    for name, _, _, dur, _ in tr.records:
        by_name[name[:NAME_CHARS]] += dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = tr.window_us
    busy = busy_intervals(tr.records, w0, w1)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if t < w1:
        gaps.append((t, w1))
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in tr.host if h[1] <= mid < h[2]]
        # the innermost span: the latest to start
        name = max(inside, key=lambda h: h[1])[0] if inside else "other"
        idle[name] += (b - a) * 1e-6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps_top]}
