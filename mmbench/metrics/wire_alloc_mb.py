"""wire_alloc_mb: the mean of rx.wire's count `alloc_bytes` in the
window, in 10^6 bytes: host memory allocated afresh for one call's wire
buffer (ops/mega_rx.py MegaReceiver.run_events_batch), counted where it
is allocated (ops/device_rx.py alloc_wire), 0 where a call allocates
none.  A count, so it repeats exactly for one traffic."""

from mmbench.program_spans import mean_count


def read(run):
    v = mean_count(run, "rx.wire", "alloc_bytes")
    return None if v is None else v / 1e6
