"""h2d_gbps: host-to-device bytes over the device time of the copies that
moved them, from the traced window's copy records (10^9 bytes a second);
over several cards, every card's copies together."""


def read(run):
    if run.trace is None:
        return None
    ranks = run.extra.get("ranks")
    if ranks:
        nbytes = sum(r["h2d_bytes"] for r in ranks)
        t = sum(r["h2d_s"] for r in ranks)
    else:
        recs = [r for r in run.trace.records
                if r[1] == "gpu_memcpy" and "HtoD" in r[0] and r[4] > 0]
        nbytes = sum(r[4] for r in recs)
        t = sum(r[3] for r in recs) * 1e-6
    return nbytes / t / 1e9 if t > 0 else None
