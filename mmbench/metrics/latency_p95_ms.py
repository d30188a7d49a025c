"""latency_p95_ms: the 95th percentile of one request's wall over every
request that completed in the window."""

from mmbench.readers import percentile


def read(run):
    v = percentile(run.window["latencies_s"], 95)
    return None if v is None else 1e3 * v
