"""K4, the loopback's synthesis kernel, timed on the card, to compare two
trees of the repository in one call (in turns: A, B, B, A).  Run from a
tree's root: it imports that tree's minimodem_tpu_torch.

    cd <tree> && python3 <this file>

Prints one JSON line: the card (nvidia-smi name and power limit); the
census of K4's kernels as that tree builds them (chip_smoke.py's
k4_census, from this file's tree: registers and each sample loop's
instructions a stored word by pipe, from the SASS); K4's flat entry at
the headline buffer (B = 128 streams of 64.3 s of Bell-202, the
loopback's [128, 3146168] buffer) alone (torch.profiler, its kernels
summed), queued behind a sleeping kernel (CUDA events), its wrapper's
host time a call and each pipe's floor; its frames entry at the frame-schedule
bench row's shape (rtty, tdd, Bell-202 at 1.5 stop bits; B = 8 streams
of a 15 s payload, the frames padded to a multiple of 512) alone and
queued; the batched loopback rows (synchronous, pipelined 8 deep) and
the host's dispatch time of one synchronous batch.  It calls only entry
points that K4's first version and its redesign both have.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def queued_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alone_ms(fn, reps=5, tries=5):
    """Device time a call of the kernels named tx_synth_* (torch.profiler),
    None when five windows saw none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if "tx_synth" in e.key)
        if us:
            return us / reps / 1e3
    return None


def host_ms(fn, reps=50):
    """The host's time a call (no synchronize between the calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import minimodem_tpu_torch
    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.codecs import Ascii8Codec, get_codec
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback, _sched_pad
    from minimodem_tpu_torch.ops.tx_device import (
        tx_bit_schedule, tx_frame_schedule)

    if not torch.cuda.is_available():
        print("E: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    res = {"tree": os.path.dirname(minimodem_tpu_torch.__file__),
           "card": card}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cen = smoke.k4_census()
    res["census"] = {k: {"registers": cen[k]["registers"],
                         **cen[k]["per_sample"]} for k in smoke.K4_KERNELS}

    cfg = FskModem("1200", device="cpu").cfg
    base = bench._bench_payload(cfg, 64.3)
    head = [tx_bit_schedule(bytes((b + i) % 94 + 33 for b in base), cfg,
                            Ascii8Codec()) for i in range(128)]
    lb = DeviceLoopback(cfg, device=dev)
    b_pad = _sched_pad(max(len(s) for s in head))
    bits = np.zeros((len(head), b_pad), np.uint8)
    for i, sch in enumerate(head):
        bits[i, :len(sch)] = sch
    packed = torch.from_numpy(np.packbits(bits, axis=1,
                                          bitorder="little")).to(dev)
    loop = lb.build_loop(b_pad)
    run = lambda: loop.synthesize(packed)               # noqa: E731
    res["flat"] = {
        "shape": [len(head), loop.t_total + lb.halo],
        "alone_ms": alone_ms(run), "queued_ms": queued_ms(run),
        "host_ms": host_ms(run, 20),
        "floors_ms": smoke.pipe_floors(
            cen["tx_synth_bits_kernel"]["per_sample"],
            len(head) * b_pad * lb.bit_ns, cen)}
    del loop, packed
    torch.cuda.empty_cache()

    res["frames"] = {}
    for mode in ("rtty", "tdd", "1200 --stopbits 1.5"):
        m = FskModem(mode.split()[0], device="cpu")
        if "stopbits" in mode:
            m.cfg.nstopbits = np.float32(1.5)
            m.cfg.finalize()
        enc = (get_codec(m.preset.encoder) if m.preset.encoder != "baudot"
               else get_codec("baudot", usos=True))
        fb, lead, trail = tx_frame_schedule(bench._mode_payload(m, 15.0),
                                            m.cfg, enc)
        f_pad = -(-fb.shape[0] // 512) * 512
        fbits = np.zeros((8, f_pad, m.cfg.n_data_bits), np.uint8)
        fbits[:, :fb.shape[0]] = fb
        fbits = torch.from_numpy(fbits).to(dev)
        nf = torch.full((8,), fb.shape[0], dtype=torch.int32, device=dev)
        floop = DeviceLoopback(m.cfg, device=dev).build_loop(
            f_pad, True, (lead, trail))
        frun = lambda: floop.synthesize(fbits, nf)      # noqa: E731
        res["frames"][mode] = {"alone_ms": alone_ms(frun),
                               "queued_ms": queued_ms(frun),
                               "host_ms": host_ms(frun)}

    rows = {}
    for name, pipe in (("synchronous", 1), ("pipeline 8", 8)):
        r = bench.batched_loopback_throughput("1200", 64.3, 128,
                                              pipeline=pipe, device=dev)
        rows[name] = {"wall_ms": r["wall_seconds"] * 1e3,
                      "real_time_factor": r["real_time_factor"],
                      "decode_exact": r["decode_exact"]}
    lb.run_events_batch(head)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = lb.dispatch_events_batch(head)
    rows["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
    lb.collect_events_batch(h)
    res["loopback"] = rows
    print(json.dumps(res), flush=True)
    return 0 if all(r["decode_exact"] for k, r in rows.items()
                    if k != "dispatch_ms") else 1


if __name__ == "__main__":
    sys.exit(main())
