#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (minimodem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  Phases,
one line each; any failure exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the nvcc build of the kernels in minimodem_tpu_torch/csrc;
  2. K1, the fused scorer, against its plain PyTorch version on the card
     at the main path's shape (one stream, one 1 << 21 segment of
     Bell-202 audio plus uniform noise of amplitude 0.3): bits plane
     equal, NaN/+inf at the same offsets, finite conf/ampl within
     rtol 2e-6, atol 1e-5;
  3. K2, the state machine, on K1's planes against its plain version on
     a CPU copy of the same planes: identical events, bytes and carry;
  4. end to end: ~60 s of Bell-202 text (two segments with a carried
     state) decoded by `minimodem-tpu-torch --rx --file f.wav 1200`,
     in process (launch counts and plain-version calls recorded) and as
     subprocesses with --device cuda and --device cpu;
  5. timings, each beside the card's name and power limit.

The next-to-last line is the kernels' JSON summary, preceded by the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1200
RTOL, ATOL = 2e-6, 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_cli_inprocess(argv):
    """minimodem_tpu_torch.cli.main in this process -> (rc, out, err)."""
    from minimodem_tpu_torch import cli

    class _Out:
        def __init__(self):
            self.buffer = io.BytesIO()

        def write(self, s):
            return len(s)

        def flush(self):
            pass

    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = _Out(), io.StringIO()
    try:
        rc = cli.main(list(argv))
        return rc, sys.stdout.buffer.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stderr = old


def run_cli_subprocess(argv, stdin: bytes = b""):
    r = subprocess.run([sys.executable, "-m", "minimodem_tpu_torch.cli",
                        *argv], input=stdin, capture_output=True, cwd=ROOT,
                       timeout=600)
    return r.returncode, r.stdout, r.stderr.decode()


def profile_decode(argv) -> str:
    """One warm in-process decode under torch.profiler: wall time, device
    busy time and the device kernels/copies that took it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli_inprocess(argv)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        return f"wall {wall_ms:.2f} ms, device time not measured"
    top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, k, n in rows[:6])
    return (f"wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%)"
            f"; {top}")


def host_split(wav: str, device) -> str:
    """Warm wall times of the file decode's two halves, as the CLI runs
    them: reading the WAV into host samples, and Receiver.run (upload, K1,
    K2, collect, render)."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.rx.engine import Receiver
    from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

    cfg = FskModem("1200").cfg
    t0 = time.perf_counter()
    stream = open_stream("file", None, Direction.RECORD, SampleFormat.FLOAT,
                         cfg.sample_rate, 1, "chip_smoke", wav)
    stream.format = SampleFormat.S16            # PCM16 ships raw, as the CLI
    chunks = []
    while (c := stream.read(1 << 20)).size:
        chunks.append(c)
    stream.close()
    samples = np.concatenate(chunks)
    t1 = time.perf_counter()
    rx = Receiver(cfg, RxOptions(), get_codec("ascii8"), lambda b: None,
                  lambda s: None, device=device)
    rx.run(samples)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (f"read WAV {1e3 * (t1 - t0):.2f} ms, Receiver.run "
            f"{1e3 * (t2 - t1):.2f} ms")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    try:
        import minimodem_tpu_torch
    except ImportError:
        fail("minimodem_tpu_torch is not importable: run from the "
             "repository root")
    if Path(minimodem_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported {minimodem_tpu_torch.__file__}, not this checkout's "
             "package")
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops import _kernels
    from minimodem_tpu_torch.ops.device_rx import (
        PipelinedReceiver, _collect, _round_up_pow2, device_rx_key,
        geo_from_key)
    from minimodem_tpu_torch.ops.fused_score import (
        FusedScorer, score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaReceiver, MegaRx, MegaStatics, mega_rx_plain)

    # plain versions run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card, versions, kernel build ----
    card = card_line()
    phase(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.load()
    phase(f"build: kernels loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds} s) from "
          f"{_kernels.SRC_DIR.relative_to(ROOT)}")

    # ---- inputs: ~60 s of printable Bell-202 text ----
    rng = np.random.default_rng(SEED)
    words = [rng.integers(97, 123, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(2, 9, size=1200)]
    text = b" ".join(words)[:6999] + b"\n"
    modem = FskModem("1200", device="cpu")
    cfg = modem.cfg
    audio = modem.modulate(text)                       # float32 host synth
    pr = PipelinedReceiver(cfg, device=dev)
    seg = pr.segment_len
    lookahead = pr._lookahead
    total_nf = seg - lookahead + cfg.expect_nsamples
    t_total = _round_up_pow2(total_nf + cfg.nsamples_overscan + 1)
    key = device_rx_key(cfg)
    scorer = FusedScorer(geo_from_key(key))
    halo = scorer.geo.halo
    x_np = np.zeros((1, t_total + halo), np.float32)
    m = min(len(audio), x_np.shape[1])
    x_np[0, :m] = audio[:m]
    noise = rng.random(x_np.shape, dtype=np.float32)
    x_np += (noise - np.float32(0.5)) * np.float32(0.6)
    x = torch.from_numpy(x_np).to(dev)

    # ---- 2. K1 against its plain version on the card ----
    planes = scorer(x, t_total)
    plain = score_planes_plain(x, scorer.geo, t_total)
    torch.cuda.synchronize()
    pk, pp = planes.cpu().numpy(), plain.cpu().numpy()
    bits_bad = int(np.count_nonzero(pk[0, 2] != pp[0, 2]))
    fk = pk[0, [0, 1]].view(np.float32)
    fp = pp[0, [0, 1]].view(np.float32)
    cls_bad = int(np.count_nonzero(
        (np.isnan(fk) != np.isnan(fp))
        | (np.isposinf(fk) != np.isposinf(fp))
        | (np.isneginf(fk) != np.isneginf(fp))))
    fin = np.isfinite(fk) & np.isfinite(fp)
    diff = np.abs(fk[fin].astype(np.float64) - fp[fin])
    k1_err = float(diff.max(initial=0.0))
    tol_bad = int(np.count_nonzero(diff > ATOL + RTOL * np.abs(fp[fin])))
    exact = int(np.count_nonzero(pk != pp))
    phase(f"K1 fused_score vs plain at [1, {t_total + halo}] -> "
          f"[1, {pk.shape[1]}, {t_total}]: bits mismatches {bits_bad}, "
          f"nan/inf class mismatches {cls_bad}, finite conf/ampl outside "
          f"rtol {RTOL} atol {ATOL}: {tol_bad}, max_abs_err {k1_err}, "
          f"bit-different words {exact}")
    if bits_bad or cls_bad or tol_bad:
        fail("K1 disagrees with its plain version")
    k1_ms = cuda_ms(lambda: scorer(x, t_total), 20)
    k1_plain_ms = cuda_ms(
        lambda: score_planes_plain(x, scorer.geo, t_total), 3)

    # ---- 3. K2 against its plain version on K1's planes ----
    st = MegaStatics.build(key, t_total, False)
    mega = MegaRx(st)
    totals = torch.tensor([total_nf], dtype=torch.int32, device=dev)
    ci_np, cf_np = MegaReceiver.carry_to_arrays(None, 1)
    ci, cf = torch.from_numpy(ci_np).to(dev), torch.from_numpy(cf_np).to(dev)
    thr = (1.5, 2.3)
    out_k = mega(planes, totals, thr, ci, cf, False)
    torch.cuda.synchronize()
    tp0 = time.perf_counter()
    out_p = mega_rx_plain(st, False, pk, np.asarray([total_nf], np.int32),
                          thr, ci_np, cf_np)
    k2_plain_ms = (time.perf_counter() - tp0) * 1e3
    k2_err = float(np.abs(out_k[5].cpu().numpy().astype(np.float64)
                          - out_p[5]).max())
    ev_k = _collect(out_k[:4], 1)[0]
    ev_p = _collect(tuple(torch.from_numpy(a) for a in out_p[:4]), 1)[0]
    same = (len(ev_k) == len(ev_p)
            and all(np.array_equal(a, b) for a, b in zip(ev_k, ev_p))
            and np.array_equal(out_k[4].cpu().numpy(), out_p[4])
            and np.array_equal(out_k[5].cpu().numpy().view(np.int32),
                               out_p[5].view(np.int32)))
    phase(f"K2 mega_rx vs plain on K1's planes: {len(ev_k[0])} events, "
          f"{len(ev_k[2])} bytes, identical events/bytes/carry: {same}")
    if not same:
        fail("K2 disagrees with its plain version")
    k2_ms = cuda_ms(lambda: mega(planes, totals, thr, ci, cf, False), 5)

    # ---- 4. end to end: a 60 s two-segment file decode ----
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "f.wav")
        rc, _, err = run_cli_subprocess(["--tx", "--file", wav, "1200"],
                                        text)
        if rc != 0:
            fail(f"tx: {err}")
        argv = ["--rx", "--file", wav, "1200", "--device", "cuda"]
        run_cli_inprocess(argv)                        # warm-up
        FusedScorer.launches = MegaRx.launches = 0
        score_planes_plain.calls = mega_rx_plain.calls = 0
        te0 = time.perf_counter()
        rc, out, err_cuda = run_cli_inprocess(argv)
        e2e_s = time.perf_counter() - te0
        launches = {"fused_score": FusedScorer.launches,
                    "mega_rx": MegaRx.launches}
        plain_calls = score_planes_plain.calls + mega_rx_plain.calls
        n_samples = len(audio)
        if rc != 0 or out != text:
            fail(f"in-process decode: rc {rc}, {len(out)} of {len(text)} "
                 f"bytes, match {out == text}\n{err_cuda}")
        if min(launches.values()) < 1 or plain_calls:
            fail(f"main path launches {launches}, plain calls {plain_calls}")
        rc_c, out_c, err_c = run_cli_subprocess(argv)
        rc_p, out_p2, err_p = run_cli_subprocess(argv[:-1] + ["cpu"])
        prof_line = profile_decode(argv)
        split_line = host_split(wav, dev)
    n_seg = -(-max(n_samples - seg, 0) // pr.step) + 1
    ok_e2e = (rc_c == 0 and out_c == text and rc_p == 0 and out_p2 == text
              and err_c == err_p == err_cuda)
    phase(f"end to end: {len(text)} bytes, {n_samples} samples "
          f"({n_samples / cfg.sample_rate:.1f} s audio, {n_seg} segments); "
          f"stdout byte-exact (cuda subprocess {out_c == text}, cpu "
          f"{out_p2 == text}), stderr cuda == cpu {err_c == err_p}; "
          f"launches {launches}, plain calls {plain_calls}; "
          f"stderr: {err_c.strip()!r}")
    if not ok_e2e:
        fail(f"end-to-end mismatch: rc {rc_c}/{rc_p}\n{err_c}\n{err_p}")

    # ---- 5. timings ----
    phase(f"time K1 fused_score [1, {t_total + halo}]: kernel {k1_ms:.4f} "
          f"ms, plain {k1_plain_ms:.4f} ms ({card})")
    phase(f"time K2 mega_rx [1, {pk.shape[1]}, {t_total}]: kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms (CPU loop) ({card})")
    phase(f"time end to end (in process, warm): {e2e_s * 1e3:.1f} ms for "
          f"{n_samples / cfg.sample_rate:.1f} s audio = "
          f"{n_samples / cfg.sample_rate / e2e_s:.1f} audio s per wall s "
          f"({card})")
    phase(f"profile of one warm decode (torch.profiler): {prof_line} "
          f"({card})")
    phase(f"host split of one warm decode: {split_line} ({card})")

    src = "minimodem_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "fused_score", "route": "cuda",
         "source": src + "fused_score.cu",
         "replaces": "minimodem_tpu/ops/pallas_score.py:417",
         "launches": launches["fused_score"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "mega_rx", "route": "cuda", "source": src + "mega_rx.cu",
         "replaces": "minimodem_tpu/ops/pallas_rx.py:1100",
         "launches": launches["mega_rx"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
