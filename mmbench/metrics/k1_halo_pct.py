"""k1_halo_pct: the share of K1's stage-1 correlation that is halo, 100 x
(sum k1_correlated / sum k1_offsets - 1) over the window's rx.enqueue
spans: the counts K1's launch adds (ops/fused_score.py launch_counts,
from csrc/fused_score.cu's tile and span), offsets correlated against
offsets scored.  A count, so it repeats exactly for one traffic; None
where the program counts neither."""

from mmbench.program_spans import window_records


def read(run):
    recs = window_records(run, "rx.enqueue")
    scored = sum(r.counts.get("k1_offsets", 0) for r in recs)
    correlated = sum(r.counts.get("k1_correlated", 0) for r in recs)
    return 100.0 * (correlated / scored - 1.0) if scored else None
