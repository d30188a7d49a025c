"""One run of one benchmark cell on the card(s):

    python3 -m mmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the cell's end-to-end metrics
(--trace 0) or its per-layer metrics under torch.profiler (--trace 1) as
one JSON line, the last line of standard output, and each number the
correctness check compared, beside its limit, as the last lines of
standard error.  Exits non-zero, printing no result, without a CUDA card
(or fewer than the cell asks for), without the program, or when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mmbench import harness

    try:
        cell = harness.resolve(harness.load_manifest(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"E: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("E: no CUDA card: the benchmark measures the card and never "
              "falls back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"E: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import minimodem_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"E: the program under test is missing: {e}", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"E: loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
