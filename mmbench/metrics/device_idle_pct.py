"""device_idle_pct: percent of the traced window in which no kernel, copy
or set ran on the card (over several cards, the card where it is
highest).  One reader for every cell: device_idle_pct.<suffix> names it
in the cells that report one end-to-end metric each."""

from mmbench.readers import idle_pct


def read(run):
    return idle_pct(run)
