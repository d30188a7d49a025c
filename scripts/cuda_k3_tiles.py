#!/usr/bin/env python3
"""K3 (minimodem_tpu_torch/csrc/correlate.cu) at the tile its rule picks
(ops/correlate.py pick_tile) and at the other tiles the kernel takes, on
one CUDA card:

    python3 scripts/cuda_k3_tiles.py

For Bell-202 (nb 40) and rtty (nb 1056) at the host engines' chunk length
and for a seeded nb 4096 filter, at one row (the K3a form) and at 22
overlapping chunk rows (the K3b form), it prints one JSON line per shape:
the kernel's device time alone (torch.profiler, mean of 20 launches) per
tile, the rule's tile, and whether every tile's output equals the rule
tile's bit for bit; then the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from minimodem_tpu_torch.models.modem import FskModem  # noqa: E402
from minimodem_tpu_torch.ops import _kernels  # noqa: E402
from minimodem_tpu_torch.ops import correlate as K  # noqa: E402
from minimodem_tpu_torch.ops.demod import DemodScorer, make_basis  # noqa: E402

TILES = (256, 512, 1024, 2048)


def kernel_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if "correlate_kernel" in e.key and us > 0 and e.count:
            return us / e.count / 1e3
    return None


def shapes(dev):
    """(name, basis [4, nb], rows of 22 chunks, s_len) per filter."""
    rng = np.random.default_rng(4)
    for mode in ("1200", "rtty"):
        sc = DemodScorer(FskModem(mode, device="cpu").cfg, device=dev)
        geo, t_len = sc.geo, sc.chunk_len
        basis = make_basis(geo, np.float32)
        yield (f"{mode} nb {geo.nb}", basis, t_len, t_len + geo.halo,
               t_len + geo.max_begin)
    t_len = 1 << 17
    basis = rng.standard_normal((4, 4096)).astype(np.float32)
    yield "seeded nb 4096", basis, t_len, t_len + 10 * 4096 + 4096, \
        t_len + 10 * 4096


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    fn = _kernels.load().mm_correlate
    rng = np.random.default_rng(5)
    for name, basis_np, t_len, length, s_len in shapes(dev):
        nb = basis_np.shape[1]
        basis = torch.from_numpy(basis_np).to(dev)
        flat = rng.uniform(-1, 1, 21 * t_len + length).astype(np.float32)
        rows = torch.from_numpy(flat).to(dev).unfold(0, length, t_len)
        for x in (rows[:1], rows):
            b = x.shape[0]
            rule = K.pick_tile(nb, s_len, b)
            outs, times = {}, {}
            for tile in TILES:
                out = torch.empty((b, 4, s_len), device=dev)

                def launch(tile=tile, out=out):
                    err = fn(x.data_ptr(), x.stride(0), b, s_len,
                             basis.data_ptr(), nb, tile,
                             K.smem_bytes(nb, tile), out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                    _kernels.check(err, "mm_correlate")

                times[tile] = kernel_ms(launch)
                outs[tile] = out
            same = all(torch.equal(o.view(torch.int32),
                                   outs[rule].view(torch.int32))
                       for o in outs.values())
            print(json.dumps({"filter": name, "rows": b, "s_len": s_len,
                              "rule_tile": rule, "kernel_ms": times,
                              "bit_identical": same}), flush=True)
            if not same:
                return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
