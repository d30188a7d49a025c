"""unpack_ms: the mean host wall (ms) of the program's span lb.unpack in
the window: DeviceLoopback's unpacking of a collected batch's copies into
per-stream events and bytes, and the return of its host buffers
(ops/device_rx.py collect_events_batch)."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "lb.unpack")
