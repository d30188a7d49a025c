"""fleet_gather_ms: the mean host wall (ms) of the program's span
fleet.gather in the window, on rank 0: ShardedReceiver.run_events_batch's
all_gather_object of every rank's per-stream events and bytes
(parallel/service.py _gather_streams): the pickling, the collectives and
the unpickling of every stream's results."""

from mmbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "fleet.gather")
