"""What the metric readers in mmbench/metrics share: device time by kernel
name, the busy share of the traced window, and a stage's roofline share.

A roofline share is the least time the card could take for the stage's
work, the larger of its bytes over the peak bandwidth and its FLOPs over
the FP32 peak (mmbench/peaks.json), over the device time of the kernels
that did it.  The work is counted from the cell's shapes, each input byte
read once and each output byte written once, whatever implements it.
"""

from __future__ import annotations

import numpy as np

from .trace import busy_intervals


def kernels(run, names) -> list:
    """The traced window's kernel records whose name holds one of
    `names`."""
    if run.trace is None:
        return []
    return [r for r in run.trace.records
            if r[1] == "kernel" and any(n in r[0] for n in names)]


def idle_pct(run):
    """Percent of the traced window in which no device record ran; over
    several cards, the card with the highest share."""
    if run.trace is None or run.trace.window_us is None:
        return None
    if run.extra.get("ranks"):
        return max(100.0 * (1.0 - r["busy_s"] / r["window_s"])
                   for r in run.extra["ranks"])
    w0, w1 = run.trace.window_us
    busy = sum(b - a for a, b in busy_intervals(run.trace.records, w0, w1))
    return 100.0 * (1.0 - busy / (w1 - w0))


def roofline_pct(run, stage: str, work, time_names, count_name):
    """100 x (launches of `count_name`) x bound(work per launch) / device
    time of every kernel in `time_names`; None without such launches, a
    peak for the card, or the stage in this cell."""
    shape = run.shapes.get(stage)
    if shape is None or run.peaks is None:
        return None
    n = len(kernels(run, (count_name,)))
    t = sum(r[3] for r in kernels(run, time_names)) * 1e-6
    if n == 0 or t <= 0:
        return None
    nbytes, flops = work(shape)
    bound = max(nbytes / run.peaks["bytes_per_s"],
                flops / run.peaks["fp32_flops_per_s"])
    return 100.0 * n * bound / t


def percentile(values, q: float):
    """numpy's linear percentile of a non-empty list, else None."""
    return float(np.percentile(np.asarray(values), q)) if values else None


def audio_rate(run):
    """Audio seconds collected in the window over its seconds."""
    return run.window["audio_s"] / run.window["seconds"]


def mean_span_ms(run, name: str):
    """The mean wall (ms) of the benchmark's spans `name` that started in
    the window."""
    d = run.spans.within(name, run.window["t0"], run.window["t1"])
    return 1e3 * sum(d) / len(d) if d else None
