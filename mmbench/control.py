"""The correctness check's control: the plain reference put in the
program's place, computed in the step below the configuration's stated
precision (float32 with TF32 off -> TF32: samples and basis rounded to a
10-bit significand before the same multiply-add chain), and judged by the
cell's own comparison against the float32 reference.  It has to come out
not correct.

    python3 -m mmbench.control --workload <cell> --seeds <n>[,<n>...]

Prints one JSON line a seed: the compared numbers with their limits.
Runs no window and none of the program: the inputs are the cell's own,
at its own sizes, on the card when there is one (else the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control(cell, seed: int, device: str) -> list:
    """The cell's compared numbers with the TF32 reference in the
    program's place."""
    from mmbench import harness
    from mmbench.trace import Spans

    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell, seed, device, Spans())
    drv.make_inputs()
    try:
        ref = drv.reference("float32")
        low = drv.reference("tf32")
    finally:
        getattr(drv, "remove_inputs", lambda: None)()
    return drv.judge({k: [v] for k, v in low.items()}, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from mmbench import harness

    cell = harness.resolve(harness.load_manifest(), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control(cell, seed, device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "device": device,
            "control": "tf32", "seconds": time.perf_counter() - t0,
            "correct": all(c["value"] <= c["limit"] for c in checks),
            "check": {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
