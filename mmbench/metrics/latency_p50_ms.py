"""latency_p50_ms: the median wall of one request over every request that
completed in the window."""

from mmbench.readers import percentile


def read(run):
    v = percentile(run.window["latencies_s"], 50)
    return None if v is None else 1e3 * v
