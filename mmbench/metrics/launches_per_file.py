"""launches_per_file: kernels the card ran in the traced window per
request completed in it (the receivers' launches a file: scoring, state
machine, the wire's conversion, copies' kernels)."""

from mmbench.readers import kernels


def read(run):
    n = len(run.window.get("latencies_s", ()))
    if run.trace is None or n == 0:
        return None
    return len(kernels(run, ("",))) / n
