"""idle_wire_pct: percent of the traced window in which no kernel, copy
or set runs on the card while the host is inside the program's span
rx.wire (the wire copy of ops/mega_rx.py MegaReceiver.run_events_batch):
the part of the card's idle share that the wire copy holds it up.  The
spans are mapped onto the trace's clock by mmbench/program_spans.py."""

from mmbench.program_spans import idle_within_pct


def read(run):
    return idle_within_pct(run, "rx.wire")
