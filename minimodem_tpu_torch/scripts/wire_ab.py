"""The staged wire's host fill and a streaming segment, timed, to compare
two trees of the repository in one call on the card (in turns: A, B, B,
A).  Run from a tree's root: it imports that tree's minimodem_tpu_torch.

    cd <tree> && python3 <this file> [--device cpu]

Prints one JSON line: the card (nvidia-smi name and power limit) and the
process's intra-op threads; the device's WireStager (ops/device_rx.py)
staging a streaming segment's wire ([1, 65976] float32; 500 calls): the
p50 of its host time (the fill and the DMAs it issues) and of the time
until the wire is on the device, with the fill's rate; the wall of a
2^16-sample DeviceStreamReceiver segment (its run_events_batch call,
the collect included) over 60 s of noisy Bell-202 fed in half-second
reads, three passes after a warm-up, p50 and p90; then the stager's
rows for a recorded cell's call (uic_train.batch16's 16 x 2,846,400
int16, rtty.skimmer32's 32 x 3,043,200; 20 calls each).  It calls only
entry points that both trees have.  `--device cpu` rehearses it without a
card (CPU numbers, not the card's).
"""

import json
import os
import subprocess
import sys
import time


def pct(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(q / 100 * len(s)))]


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage(dev, b, n, dtype="int16", reps=20):
    """The stager's host time and its time to the device, ms, p50."""
    import numpy as np

    from minimodem_tpu_torch.ops.device_rx import wire_stager

    x = np.random.default_rng(b).integers(-3000, 3000, (b, n)).astype(dtype)
    stager = wire_stager(dev)
    host, landed = [], []
    for i in range(reps + 2):                      # two warm-up calls
        sync(dev)
        t0 = time.perf_counter()
        out, chunks = stager.wire(x, n + 4096)
        t1 = time.perf_counter()
        stager.join(out)
        sync(dev)
        t2 = time.perf_counter()
        del out
        if i >= 2:
            host.append(t1 - t0)
            landed.append(t2 - t0)
    h = pct(host, 50)
    return {"shape": [b, n], "mb": x.nbytes / 1e6, "chunks": chunks,
            "host_p50_ms": h * 1e3, "landed_p50_ms": pct(landed, 50) * 1e3,
            "fill_gbps": x.nbytes / h / 1e9}


def segments(dev):
    """The walls of 2^16-sample streaming segments, ms."""
    import numpy as np

    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceStreamReceiver

    m = FskModem("1200", device="cpu")
    rng = np.random.default_rng(7)
    text = rng.integers(32, 127, 7200, dtype=np.uint8).tobytes()
    wav = m.modulate(text)
    wav = (wav + (rng.random(wav.size, dtype=np.float32) - 0.5)
           * np.float32(0.6)).astype(np.float32)
    half = m.cfg.sample_rate // 2
    reads = [wav[i:i + half] for i in range(0, len(wav), half)]
    walls = []
    for p in range(4):                             # a warm-up pass
        sr = DeviceStreamReceiver(m.cfg, segment_len=1 << 16, device=dev)
        run = sr.rx.run_events_batch

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return run(*a, **k)
            finally:
                if p:
                    walls.append(time.perf_counter() - t)

        sr.rx.run_events_batch = timed
        for r in reads:
            sr.feed(r)
        sr.finish()
        sync(dev)
    return {"segments": len(walls), "seg_p50_ms": pct(walls, 50) * 1e3,
            "seg_p90_ms": pct(walls, 90) * 1e3}


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import minimodem_tpu_torch

    dev = torch.device(sys.argv[sys.argv.index("--device") + 1]
                       if "--device" in sys.argv else "cuda")
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    # the streaming rows first: a streaming process runs no batch call
    res = {"tree": os.path.dirname(minimodem_tpu_torch.__file__),
           "card": card, "intra_op_threads": torch.get_num_threads(),
           "segment": stage(dev, 1, 65_976, "float32", reps=500),
           "stream": segments(dev),
           "batch16": stage(dev, 16, 2_846_400),
           "skimmer32": stage(dev, 32, 3_043_200)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
