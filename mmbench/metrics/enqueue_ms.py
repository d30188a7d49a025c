"""enqueue_ms: the mean host wall (ms) of the program's span lb.enqueue
in the window: DeviceLoopback's launches of one part's synthesis, scorer
and state machine and the record of its done event (ops/device_rx.py
_dispatch)."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "lb.enqueue")
