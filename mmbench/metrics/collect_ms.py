"""collect_ms: the mean host wall (ms) of the program's span rx.collect
in the window: the wait for the card at the first copy back, the copies
of the event logs and the carry, and their unpacking per stream
(ops/device_rx.py _collect, MegaReceiver.arrays_to_carry)."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "rx.collect")
