"""fleet_reduce_ms: the median host wall (ms) of the program's span
fleet.reduce in the window, on rank 0: ShardedReceiver.run_events_batch's
all-reduce of the fleet stats and the copy of its result to the host
(parallel/service.py), which waits for this rank's card and, through the
collective, for the slowest rank.  The median, not the mean: in a traced
window the fleet driver's other ranks start their profilers only once
the window has opened, and rank 0's first reduce waits for that start
(seconds on a card), which a mean over a window's calls would carry."""

import statistics

from mmbench.program_spans import window_records


def read(run):
    walls = [r.end - r.start for r in window_records(run, "fleet.reduce")]
    return 1e-6 * statistics.median(walls) if walls else None
