"""upload_ms: the mean host wall (ms) of the program's span rx.upload in
the window: the host-to-device copies of the wire, the totals and the
carry (ops/mega_rx.py MegaReceiver.run_events_batch)."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "rx.upload")
