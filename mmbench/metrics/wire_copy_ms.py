"""wire_copy_ms: the mean host wall (ms) of the program's span rx.wire
in the window: MegaReceiver.run_events_batch's wire buffer, its
allocation and the copy of the batch into it (ops/mega_rx.py), while the
card waits."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "rx.wire")
