"""The sp (time-axis) scaling curve of the fleet service: the full-decode
wall of the same work at sp = 1, 2, 4, 8 (dp = 1).

ShardedReceiver (parallel/service.py) at sp > 1 runs K1 on each rank's
time shard with its right neighbour's halo, all-gathers the score planes
along sp and runs K2 replicated on every rank: scoring scales with sp,
the state machine does not.  Each sp runs in a new world of sp ranks
(parallel/launch.py::spawn_world): NCCL, one rank a card, where the
machine has at least sp cards; otherwise gloo ranks that share the first
card (NCCL takes one rank a device), whose walls measure a shared card
over gloo, not a fleet.  Each row names its backend and the cards its
ranks ran on.  With --device cpu the ranks are gloo ranks on the CPU.

    python -m minimodem_tpu_torch.scripts.sp_scaling_curve [audio_seconds] [batch] [--sp 1,2,4,8] [--device cuda|cpu]

A JSON line a row ({"sp", "batch", "wall_ms", "rtf", "decode_exact",
"backend", "cards"}), then {"curve": [rows with speedup_vs_sp1],
"audio_seconds"}.  wall_ms is the slowest rank's best of 3 timed
run_events_batch calls after one warm call.  Exit code 0 only when every
row decoded exact.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _rank_curve(sp: int, device: str, waves: list,
                payloads: list) -> dict:
    """One rank of the world of sp ranks: one warm call, the decode
    check, the best of 3 walls."""
    from ..models.modem import FskModem
    from ..parallel.service import ShardedReceiver
    from ..parallel.sharding import make_mesh

    x = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    totals = [len(w) for w in waves]
    mesh = make_mesh(sp, dp=1, sp=sp, device=device)
    svc = ShardedReceiver(FskModem("1200").cfg, mesh, device=device)
    svc.run_events_batch(x, totals, 1.5, 2.3)          # kernel build
    outs, _ = svc.decode_batch(waves)
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        svc.run_events_batch(x, totals, 1.5, 2.3)
        dt = min(dt, time.perf_counter() - t0)
    return {"wall_s": dt, "ok": outs == payloads,
            "device": str(svc.rank_device())}


def make_work(audio_seconds: float, batch: int):
    """The JAX script's payloads, one a stream, and their waves (host
    TX)."""
    from ..models.modem import FskModem

    m = FskModem("1200", device="cpu")
    rate = float(m.cfg.data_rate)
    n = max(16, int(audio_seconds * rate / m.cfg.frame_n_bits))
    payloads = [bytes((33 + (i + 3 * s) % 94) for i in range(n))
                for s in range(batch)]
    return payloads, [m.modulate(p) for p in payloads]


def curve_row(sp: int, device: str, payloads: list, waves: list) -> dict:
    """The row of one sp, from a new world of sp ranks."""
    import torch

    from ..parallel.launch import spawn_world

    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = "nccl" if device == "cuda" and cards >= sp else "gloo"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if device == "cuda" and backend == "gloo":
        # every rank on the first card: the children see only it
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    try:
        ranks = spawn_world(_rank_curve, sp, (sp, device, waves, payloads),
                            backend)
    finally:
        if visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    dt = max(r["wall_s"] for r in ranks)
    audio_sec = sum(len(w) for w in waves) / 48000.0
    return {"sp": sp, "batch": len(waves), "wall_ms": round(dt * 1000.0, 1),
            "rtf": round(audio_sec / dt, 1),
            "decode_exact": all(r["ok"] for r in ranks),
            "backend": backend,
            "cards": (len({r["device"] for r in ranks})
                      if device == "cuda" else 0)}


def main(argv=None) -> int:
    import argparse

    from ..cli import _card_ready

    ap = argparse.ArgumentParser(
        prog="python -m minimodem_tpu_torch.scripts.sp_scaling_curve",
        description="full-decode wall of the same work at each sp")
    ap.add_argument("audio_seconds", type=float, nargs="?", default=30.0)
    ap.add_argument("batch", type=int, nargs="?", default=1)
    ap.add_argument("--sp", default="1,2,4,8",
                    help="the sp values, comma-separated (default 1,2,4,8)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if not _card_ready(args.device):
        return 1
    payloads, waves = make_work(args.audio_seconds, args.batch)
    rows = []
    for sp in (int(v) for v in args.sp.split(",")):
        rows.append(curve_row(sp, args.device, payloads, waves))
        print(json.dumps(rows[-1]), flush=True)
    base = rows[0]["wall_ms"]
    for r in rows:
        r["speedup_vs_sp1"] = round(base / r["wall_ms"], 2)
    print(json.dumps({"curve": rows, "audio_seconds":
                      sum(len(w) for w in waves) / 48000.0}), flush=True)
    return 0 if all(r["decode_exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
