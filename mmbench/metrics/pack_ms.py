"""pack_ms: the mean host wall (ms) of the program's span lb.pack in the
window: DeviceLoopback's packing of a batch's bit schedules into packed
bytes and totals (ops/device_rx.py _flat_parts), the first part of
DeviceLoopback.dispatch_events_batch."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "lb.pack")
