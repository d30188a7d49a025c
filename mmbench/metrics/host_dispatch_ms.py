"""host_dispatch_ms: the mean host wall of one
DeviceLoopback.dispatch_events_batch call in the window (the benchmark's
span around it): the schedules' packing, the pinned upload and the launches
of K4, the scorer and K2."""

from mmbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "dispatch")
