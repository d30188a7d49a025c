#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (minimodem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  Phases,
one line each; any failure exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the nvcc build of the kernels in minimodem_tpu_torch/csrc;
  2. K1, the fused scorer, against its plain PyTorch version on the card
     at the main path's shape (one stream, one 1 << 21 segment of
     Bell-202 audio plus uniform noise of amplitude 0.3): every word of
     the planes bit for bit (NaN/+inf classes and conf/ampl within
     rtol 2e-6, atol 1e-5 are reported beside);
  3. K2, the state machine, on K1's planes against its plain version on
     a CPU copy of the same planes: identical events, bytes and carry;
     then 160 streams of differing totals, a carried-in state at a pos
     off the ring's window grid, rtty, NOAA SAME (the dual layout) and
     4.5 baud (the ring of confidence planes only) in both layouts; and
     K2 with its ring against K2 reading global memory (the shared-memory
     budget patched to 0), in turns at B = 1 and B = 160;
  4. end to end: ~60 s of Bell-202 text (two segments with a carried
     state) decoded by `minimodem-tpu-torch --rx --file f.wav 1200`,
     in process (launch counts and plain-version calls recorded) and as
     subprocesses with --device cuda and --device cpu;
  5. timings, each beside the card's name and power limit;
  6. K3, the stage-1 correlation, against its plain version on the card
     at the host engines' shapes from the same audio (plus noise): one
     131072-sample chunk with its halo (the K3a form) and all of the
     stream's chunks as overlapping rows at a row stride (the K3b form),
     then rows at an odd stride (most start off the 16-byte grid) and
     rtty's 1056-tap filter, bit for bit;
  7. the host engines end to end on the same file: `--engine host` and
     `--engine host-native`, in process (K3 and K5 launch counts with the
     counts set to 0 just before and read just after, plain calls 0;
     K3's and K5's last launches held against their plain versions) and
     as --device cuda / --device cpu subprocesses: stdout byte-exact,
     stderr equal to the device engine's;
  8. the float64 route: `1200 --samplerate 24000 -M 1200 -S 2400 --engine
     host` prints confidence=inf and (rate perfect), cuda == cpu; K5
     launched on its float64 correlation, held against its plain version;
  9. `-a` on two bursts with a retune between them, --engine host (K3
     and K5) and --engine device (stop-on-overflow decodes through K1 and
     K2), cuda and cpu, all four byte for byte;
 10. K3 and host-engine timings (warm decode walls, the host engine's
     split between chunk scoring and the Python state machine, a
     torch.profiler breakdown; the host scorer's stage 1 and K5 timed
     apart at `score`'s one chunk row and `score_chunks`' rows, beside
     the plain channels and K5's bound, K5 bit for bit the plain
     version), each beside the card's name and power limit;
 11. device TX on the card against its CPU version: device_synthesize at
     B = 4 and at one 64.3 s stream, device_synthesize_frames at rtty,
     and `--synth-backend jax` (LUT 4096 and 16 bit-identical to the
     numpy backend in S16 and FLOAT, the direct sine within one ulp);
     then K4, the loopback's synthesis (csrc/tx_synth.cu), against its
     plain route into buffers filled with NaN: flat schedules bit for bit
     at 1200 B = 4 x 4096 bits, one 64.3 s stream, 300 and tdd (widths off
     the 16-byte grid, tiles ending inside a bit) and at the whole
     headline buffer [128, 3146168] (zero tail and halo included), frame
     schedules (rtty, tdd, Bell-202 with 1.5 stop bits; n_frames F_pad,
     partial, 0) within turns_atol of the plain route on the card, each
     also against the plain route on the CPU with its count of differing
     samples (frames: every word equal, or the run fails); K4's sine
     against CUDA's float64 sin on every float32 fraction of a turn in
     [0, 1), 1,065,353,216 inputs, 0 differing required; the census of
     K4's four kernels (registers, and each sample loop's instructions a
     sample by pipe from the library's SASS); K4 timed at the headline
     buffer and its frames entry at the frame-schedule bench row's shape
     (rtty, tdd, Bell-202 at 1.5 stop bits; B = 8 x 15 s), each alone,
     queued and per call beside its bound and each pipe's floor;
 12. the on-device loopback against device="cpu", event for event:
     1200 and SAME (flat schedules) and Bell-202 with 1.5 stop bits
     (frame schedules), two streams each;
 13. the loopback's main path, the bench rows on the card: K1 and K2
     held against their plain versions at the headline shape (B = 128
     streams of 64.3 s of Bell-202 synthesized on the card by K4), then
     with the launch counts set to 0, the batched row synchronous and
     pipelined 8 deep (every stream of every batch verified), the counts
     read (K1, K2 and K4 launched, no plain call, the synthesis' among
     them); then, the counts set to 0 again, rtty (K4's frames entry) and
     SAME (B = 8, 15 s), Caller-ID (B = 128, pipeline 4) and the
     --benchmarks decode rows (60 s);
 14. a torch.profiler stage split of one warm B = 128 batch in a child
     process of its own (K4's synthesis, K1, K2, upload, collect; the
     device idle share; how soon the host's dispatch returned), its
     peak device memory, and K1 / K2 timed at
     the loopback's shape beside their bounds;
 15. the geometries K1 does not serve, at their full width, each a ~60 s
     file decode by `minimodem-tpu-torch --rx --file` on the card (K5, K2
     and, where it is the route, K3 launched; plain calls 0; stdout exact,
     stderr equal to --device cpu's, within the stated tolerance of the
     printed scores on the FFT route) and one DeviceReceiver batch of 16
     streams with K2 held against its plain version on the card's own
     planes and K5's last launch against its own, bit for bit, then the
     batch scorer's tile split (stage 1, K5 and the plain channels timed
     apart, K5's bound): uic-train (wide records, the bits_hi plane,
     K3), the float64 geometry `1200 --samplerate 24000 -M 1200 -S
     2400`, 20 baud (K3 past K1's shared memory), 1 baud (the FFT stage
     1, no ring) and 2 baud with --sync-byte (the dual layout, no ring);
 16. streaming: the phase-4 audio read from its WAV in half-second FLOAT
     reads, as a live capture delivers it, decoded by DeviceStreamReceiver
     (segment_len 1 << 16) on the card: stdout and stderr equal to the
     phase-4 --device cpu decode's, K1 and K2 launched once a segment,
     plain calls 0; the segment count, the per-segment decode wall (p50,
     p99, max), the real-time factor, a torch.profiler device-busy share,
     and K1 and K2 at a non-final segment's shape against their plain
     versions, timed beside their bounds;
 17. live audio through StandInAudio, a stand-in client library defined
     here (the machine has no audio device): `--rx -A 1200` and `--rx -a
     -A -R 24000 300` on --device cuda, each equal to --device cpu;
     `--tx -sdev0 1200 --synth-backend jax` into a stand-in sndio device,
     cuda == cpu sample for sample and decoded back exactly, with the
     per-chunk synthesis time of the interactive loop; then the JAX
     package's live soak on the card (tests/test_soak_live.py: 2500 RX
     sessions and 208 -a bursts), every byte and stats line checked,
     the growth of the resident set and of torch.cuda.memory_allocated()
     bounded.  The ctypes calls into a real libasound / libpulse /
     libsndio are not exercised.
 18. the fleet service (minimodem_tpu_torch/parallel/) at world size 1 on
     NCCL (a localhost store; its init time printed as set-up), with the
     launch counts set to 0 just before: the two fleet bench rows at
     their full size (ShardedLoopback at B = 128 x 64.3 s Bell-202,
     ShardedReceiver on u-law at B = 8 x 30 s; every stream exact) and
     sharded_decode_step on 16 and on 1 Bell-202 streams of 2^21
     samples (K1, K2 and both K3 forms launched, plain calls 0); then
     each kernel at the last shape the fleet gave it (K1 and K2 at the
     ingest row's 8 streams, K3 at the step's 16 rows and one row)
     against its plain version on the same inputs, the step's channels
     against the plain chain bit for bit, the fleet's events against
     DeviceLoopback's / DeviceReceiver's on the same inputs, and each
     row's wall beside the single-card wall (in turns, best of 3);
 19. the decomposition on the one card: a world of 2 gloo ranks on
     cuda:0 (NCCL takes one rank per device) decodes ~30 s Bell-202
     streams at dp = 2 and at sp = 2 (float32 and u-law wires) and SAME
     at sp = 2, every rank's events equal to the world-size-1 decode,
     each rank's K1 and K2 launches counted and its device checked, and
     on each rank K1 at its block or time shard and K2 at its (on sp, the
     gathered) planes held against their plain versions;

 20. on a machine with N > 1 cards (only there), the fleet across them,
     one NCCL rank a card: the dry run on N ranks, then the two fleet
     rows at N times the one-card batch, and ShardedLoopback at dp = N /
     ShardedReceiver at (N / 2, 2), their events held against one card's;
 21. the delta-bitpack wire (ops/wirepack.py): the phase-4 file's int16
     samples packed on the host at k 0..5 and w 8 and 12 (and an escape
     pattern and silence), unpacked on the card, every float32 word equal
     to the CPU's unpack and to the raw int16 wire's normalization; then
     wire_pack=True against wire_pack=False on the card: the phase-4 file
     through Receiver.run (with the counts set to 0 just before: K1 and
     K2 once a segment, plain calls 0), one segment at a bucket-aligned
     and a mid-bucket length, a noise burst whose segment takes the raw
     int16 wire (the count printed), uic-train (make_score_packer and K3
     after the unpack) and "auto" with MINIMODEM_TPU_WIREPACK=1; the
     kernels' last launches held against their plain versions; then the
     split: the host pack of a 2^21-sample segment (MB/s), pinned uploads
     of the raw and the packed row, the device unpack (time and kernels),
     the warm decode walls raw and packed in turns (the phase-4 file and
     a 120 s stream) and the link rate below which the packed wire pays;
 22. the entry points beside the CLI: the headline runner `python -m
     minimodem_tpu_torch.bench` at its defaults in a child process
     (B = 128 x 64.3 s; rc 0, the root bench.py's key tree, decode_exact
     true; its JSON line printed), the sp scaling curve's main at sp = 1,
     2, 4 (NCCL where the machine has sp cards, else gloo ranks sharing
     cuda:0; every row decode-exact) and `live_soak --selfcheck`'s main;
     each with its launches (the counts set to 0 just before it and read
     just after; in the curve, on each rank: K1 and K2 launched, plain
     calls 0) and K1's and K2's last launches in it (K1 on each rank's
     time shard, K2 on the gathered planes) held against their plain
     versions on the same inputs.

The kernels' JSON summary (each entry with its launches on the device
engine's file decode, as loopback_launches on the loopback, and for K1
and K2 on the streaming, live and soak runs with their times at the
streaming shape), the
script's wall and the nvidia-smi line come before the last line, which
is {"ok": true, "device": {...}}.  Each entry also has fleet_launches,
its launches on phase 18's fleet, and K1's and K2's have
decomposition_launches, per rank and case of phase 19, and
cards_launches, per rank of phase 20 (empty on one card); K1's and K2's
have wirepack_launches, their launches on phase 21's packed decode of
the phase-4 file, and K2's and K3's wirepack_uic_launches on its packed
uic-train decode; every entry has runner_launches, its launches in
phase 22's runner, curve_launches, per sp and rank of its sp curve, and
selfcheck_launches, in its live_soak --selfcheck.  K4's entry
(tx_synth) has its launches on the batched loopback rows (launches,
loopback_launches), on phase 13's other rows (rows_launches, and
frames_launches of its frames entry), the fleet's, the cards', the
runner's (runner_frames_launches beside), and its numbers at the
headline buffer; phases 18, 20 and 22 require K4 launched and no plain
synthesis call, and hold its last launch against its plain route.  K5's
entry (frame_channels) has its launches on uic-train's file decode
(launches), on each geometry's file decode and batch, on the host
engines, the float64 route, -a --engine host, the fleet and the packed
uic-train decode, and its numbers at uic-train's tile of the batch of
16 streams, with every geometry's and both host forms' split beside.
"""

from __future__ import annotations

import contextlib
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
# published H100 SXM peaks (the bound of each kernel): HBM bytes/s and
# FP32 FLOP/s outside the tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
# an estimate, not a measurement, of one step of K2's chain of decisions:
# a shared-memory round trip and the warp's pick (~90 cycles at ~1.75 GHz)
K2_STEP_NS_ESTIMATE = 50.0
# the batched loopback's headline shape (the JAX package's bench.py)
HEAD_BATCH, HEAD_SECONDS = 128, 64.3
# the key tree of the headline runner's JSON line, with each value's JSON
# type: the root bench.py's (tests/test_torch_runner.py holds both
# runners to it on the CPU)
_MODE_KEYS = {"real_time_factor": "float", "decode_exact": "bool",
              "audio_seconds": "float"}
RUNNER_KEYS = {
    "metric": "str", "value": "float", "unit": "str", "vs_baseline": "float",
    "decode_exact": "bool", "batch": "int",
    "single_stream_realtime_factor": "float", "e2e_realtime_factor": "float",
    "e2e_ulaw_realtime_factor": "float", "e2e_audio_seconds": "float",
    "audio_seconds_total": "float",
    "single_call_batched_realtime_factor": "float",
    "pipelined_batches": "int", "pipelined_realtime_factor": "float",
    "fleet_realtime_factor": "float", "fleet_devices": "int",
    "fleet_ingest_realtime_factor": "float", "fleet_ingest_mega": "bool",
    "modes": {"rtty": _MODE_KEYS, "same": _MODE_KEYS,
              "callerid": {**_MODE_KEYS, "batch": "int",
                           "batch_latency_ms": "float",
                           "single_burst_latency_ms": "float"}},
}


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller that keeps only the end
    of standard error still sees why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def phase(msg: str) -> None:
    """One result line, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def fmt_us(v) -> str:
    return "not measured" if v is None else f"{v:.4f} us"


def bound(n_bytes: float, flop: float):
    """(least time in ms on the card, what sets it): the larger of the
    bytes over the HBM rate and the FLOPs over the FP32 peak."""
    t_b, t_f = n_bytes / HBM_BPS * 1e3, flop / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


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


def queued_ms(fn, reps: int) -> float:
    """Mean device time per call of fn() with its launches queued behind
    a sleeping kernel (torch.cuda._sleep), so the host's time between
    launches is off the clock: for a kernel shorter than its wrapper's
    host cost, where CUDA events around back-to-back calls time the
    host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)          # ~0.1 s: the queue fills first
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str):
    """Mean device time of the kernel named `kernel` over reps calls of
    fn(), from torch.profiler: the kernel alone, without the host time
    between launches that CUDA events around back-to-back calls include.
    None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if kernel in e.key and us > 0 and e.count:
            return us / e.count / 1e3
    return None


def device_ms_per_call(fn, reps: int):
    """(mean device time, device kernels and copies launched) per call of
    fn() over reps calls, every kernel and copy summed (torch.profiler);
    (None, None) when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    if not rows:
        return None, None
    us = sum(e.self_device_time_total for e in rows)
    return us / reps / 1e3, sum(e.count for e in rows) / reps


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


def k3_check(audio, dev):
    """K3 against its plain version at the host engines' shapes: the
    stream (plus uniform noise of amplitude 0.3) in chunk rows of
    chunk_len + halo samples at stride chunk_len, as
    DemodScorer.score_chunks hands them over.  -> (per form: shapes,
    tile, bit-different words, max_abs_err, kernel and plain ms; rows of
    the further exactness checks: 21 rows one sample off the chunk grid at
    an odd stride, so most start off the 16-byte grid, and rtty's nb 1056
    at the host chunk length)."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.correlate import (
        Correlator, correlate_plain, pick_tile)
    from minimodem_tpu_torch.ops.demod import DemodScorer, make_basis

    rng = np.random.default_rng(SEED + 3)

    def chunk_rows(samples, sc, offset=0, step=None):
        """The stream, zero-padded and noisy, in overlapping chunk rows
        of chunk_len + halo samples (-> rows, s_len, the Correlator)."""
        geo, t_len = sc.geo, sc.chunk_len
        n_chunks = -(-len(samples) // t_len)
        flat = np.zeros(n_chunks * t_len + geo.halo, np.float32)
        flat[:len(samples)] = samples
        flat += (rng.random(flat.size, dtype=np.float32) - np.float32(0.5)) \
            * np.float32(0.6)
        s_len = t_len + geo.max_begin
        rows = torch.from_numpy(flat).to(dev)[offset:].unfold(
            0, t_len + geo.halo, step or t_len)
        return rows, s_len, Correlator(make_basis(geo, np.float32))

    def words(k, p):
        return int(np.count_nonzero(k.cpu().numpy().view(np.uint32)
                                    != p.cpu().numpy().view(np.uint32)))

    sc = DemodScorer(FskModem("1200").cfg, device=dev)
    geo = sc.geo
    rows, s_len, corr = chunk_rows(audio, sc)
    basis = corr.basis(dev)
    weight = basis[:, None]                       # [4, 1, nb]
    out = {}
    for name, x in (("correlate", rows[:1]), ("correlate_batch", rows)):
        k = corr(x, s_len)
        p = correlate_plain(x, basis, s_len)
        xin = x[:, None, :s_len + geo.nb - 1]

        def lib(xin=xin):
            # the yardstick: one PyTorch call of the same function
            # (cuDNN, TF32 off); the port never calls it
            return torch.nn.functional.conv1d(xin, weight)

        c = lib()
        torch.cuda.synchronize()
        pn = p.cpu().numpy()
        b, n_out = x.shape[0], 4 * s_len
        out[name] = {
            "shape": f"{list(x.shape)} (row stride {x.stride(0)}) -> "
                     f"{list(k.shape)}",
            "tile": pick_tile(geo.nb, s_len, b),
            "words": words(k, p),
            "max_abs_err": float(np.abs(k.cpu().numpy().astype(np.float64)
                                        - pn).max()),
            "conv1d_err": float(np.abs(c.cpu().numpy().astype(np.float64)
                                       - pn).max()),
            "ms": cuda_ms(lambda: corr(x, s_len), 20),
            "kernel_ms": kernel_device_ms(lambda: corr(x, s_len), 20,
                                          "correlate_kernel"),
            "plain_ms": cuda_ms(lambda: correlate_plain(x, basis, s_len), 3),
            "library_ms": cuda_ms(lib, 20),
            "library_device_ms": device_ms_per_call(lib, 20)[0],
            # each input sample read once (the overlapping rows share
            # theirs), each output written once; 4 * nb FMAs (2 FLOP
            # each) per output offset and stream
            "bytes": 4 * ((b - 1) * x.stride(0) + s_len + geo.nb - 1
                          + b * n_out),
            "flop": 2 * geo.nb * b * n_out,
        }

    checks = []
    odd, _, _ = chunk_rows(audio, sc, offset=1, step=sc.chunk_len + 1)
    rtty = FskModem("rtty", device="cpu")
    rwav = rtty.modulate(b"RYRY THE QUICK BROWN FOX 73 " * 40)
    rsc = DemodScorer(rtty.cfg, device=dev)
    rrows, r_len, rcorr = chunk_rows(np.resize(rwav, 4 * rsc.chunk_len), rsc)
    for name, c, x, n in (("unaligned rows", corr, odd, s_len),
                          (f"rtty nb {rsc.geo.nb}", rcorr, rrows, r_len)):
        k = c(x, n)
        p = correlate_plain(x, c.basis(dev), n)
        checks.append({"name": name, "words": words(k, p),
                       "tile": pick_tile(c.nb, n, x.shape[0]),
                       "shape": f"{list(x.shape)} (row stride "
                                f"{x.stride(0)}) -> {list(k.shape)}"})
    return out, checks


def k2_compare(mega, planes, totals, thr, ci, cf, finalize):
    """K2 on the card against mega_rx_plain on a CPU copy of the same
    inputs -> (identical events, bytes and carry; the kernel's outputs;
    the plain version's outputs)."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.device_rx import _collect
    from minimodem_tpu_torch.ops.mega_rx import mega_rx_plain

    b = planes.shape[0]
    out_k = mega(planes, totals, thr, ci, cf, finalize)
    torch.cuda.synchronize()
    out_p = mega_rx_plain(mega.st, finalize, planes.cpu().numpy(),
                          totals.cpu().numpy(), thr, ci.cpu().numpy(),
                          cf.cpu().numpy())
    compact = mega.st.compact
    ev_k = _collect(out_k[:4], b, compact)
    ev_p = _collect(tuple(torch.from_numpy(a) for a in out_p[:4]), b,
                    compact)
    same = (all(len(u) == len(v) and all(np.array_equal(s, t)
                                         for s, t in zip(u, v))
                for u, v in zip(ev_k, ev_p))
            and np.array_equal(out_k[4].cpu().numpy(), out_p[4])
            and np.array_equal(out_k[5].cpu().numpy().view(np.int32),
                               out_p[5].view(np.int32)))
    return same, out_k, out_p


@contextlib.contextmanager
def no_ring():
    """K2 without its ring: the shared-memory budget patched to 0, so
    ops/mega_rx.py ring_geometry gives none and the warp reads its
    candidates from global memory (the mode slow bauds take)."""
    from minimodem_tpu_torch.ops import mega_rx

    old = mega_rx.SMEM_MAX
    mega_rx.SMEM_MAX = 0
    try:
        yield
    finally:
        mega_rx.SMEM_MAX = old


def ring_ab(key, planes, totals, finalize) -> dict:
    """K2 with its ring and without it, timed in turns (ring, none, ring,
    none; the kernel's device time alone, torch.profiler) on the same
    planes, and per wrapper call (CUDA events); the two runs' events,
    bytes and carry must be identical.  -> {"ring": [ms, ms], "none":
    [ms, ms], "ring_call", "none_call", stages}."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.device_rx import _collect
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, MegaStatics

    dev = planes.device
    b, _, t_total = planes.shape
    st = MegaStatics.build(key, t_total, False)
    with_ring = MegaRx(st)
    with no_ring():
        without = MegaRx(st)
    if without.ring.stages:
        fail("the patched budget left K2 a ring")
    tt = torch.tensor(totals, dtype=torch.int32, device=dev)
    ci = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    cf = torch.zeros((b, 4), dtype=torch.float32, device=dev)
    thr = (1.5, 2.3)
    outs = []
    for m in (with_ring, without):
        out = m(planes, tt, thr, ci, cf, finalize)
        outs.append([*(x for ev in _collect(out[:4], b, st.compact)
                       for x in ev), out[4].cpu().numpy(),
                     out[5].cpu().numpy().view(np.int32)])
    if not (len(outs[0]) == len(outs[1]) and all(
            np.array_equal(u, v) for u, v in zip(*outs))):
        fail("K2 without its ring disagrees with K2 with it")
    res = {"ring": [], "none": [], "ring_call": [], "none_call": [],
           "stages": with_ring.ring.stages}
    for _ in range(2):
        for name, m in (("ring", with_ring), ("none", without)):
            def call(m=m):
                return m(planes, tt, thr, ci, cf, finalize)

            res[name].append(kernel_device_ms(call, 5, "mega_rx_kernel"))
            res[name + "_call"].append(cuda_ms(call, 5))
    return res


def k2_cases(audio, main_planes, main_total, dev) -> list:
    """K2 against its plain version beyond the main path's B = 1 segment:
    160 streams of differing totals (more CTAs than SMs); a carried-in
    state whose pos is not window-aligned; rtty through K1; NOAA SAME (the
    dual layout, every plane in the ring); 4.5 baud at 48 kHz (planes
    from make_score_packer's FFT route; the ring holds the confidence
    plane only), in the single and the dual layout.  The B = 160 row also
    times K2 with and without its ring (ring_ab).  -> rows of the
    checks."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.device_rx import (
        _round_up_pow2, device_rx_key, geo_from_key, make_score_packer_planes)
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaReceiver, MegaRx, MegaStatics, mega_rx_plain)

    thr = (1.5, 2.3)
    rng = np.random.default_rng(SEED + 7)
    rows = []

    def zero_carry(b):
        ci, cf = MegaReceiver.carry_to_arrays(None, b)
        return torch.from_numpy(ci).to(dev), torch.from_numpy(cf).to(dev)

    def check(name, key, planes, totals, rx_one=False, carry=None,
              finalize=True, time_it=False):
        t_total = planes.shape[2]
        mega = MegaRx(MegaStatics.build(key, t_total, rx_one))
        tt = torch.tensor(totals, dtype=torch.int32, device=dev)
        ci, cf = carry if carry is not None else zero_carry(len(totals))
        same, out_k, _ = k2_compare(mega, planes, tt, thr, ci, cf, finalize)
        r = {"name": name, "shape": list(planes.shape), "same": same,
             "ring": mega.ring, "events": int(out_k[1].sum()),
             "bytes": int(out_k[3].sum()),
             "searches": mega_rx_plain.searches.copy(),
             "words": mega_rx_plain.words, "out": out_k}
        if time_it:
            r["ms"] = kernel_device_ms(
                lambda: mega(planes, tt, thr, ci, cf, finalize), 5,
                "mega_rx_kernel")
        rows.append(r)
        if not same:
            fail(f"K2 {name} disagrees with its plain version")
        return r

    def noisy(wav, amp=0.6):
        return (wav + (rng.random(wav.size, dtype=np.float32)
                       - np.float32(0.5)) * np.float32(amp)).astype(
                           np.float32)

    def planes_of(cfg, streams, t_total):
        key = device_rx_key(cfg)
        packer, _ = make_score_packer_planes(key, t_total, "float32")
        x = np.zeros((len(streams), t_total + geo_from_key(key).halo),
                     np.float32)
        for i, s in enumerate(streams):
            n = min(len(s), x.shape[1])
            x[i, :n] = s[:n]
        return key, packer(torch.from_numpy(x).to(dev))

    # 160 Bell-202 streams, each its own slice of the noisy audio
    cfg = FskModem("1200", device="cpu").cfg
    totals = [120000 - 311 * i for i in range(160)]
    t_total = _round_up_pow2(max(totals) + cfg.nsamples_overscan + 1)
    noisy_audio = noisy(audio)
    key, planes = planes_of(cfg, [noisy_audio[9973 * i:][:n]
                                  for i, n in enumerate(totals)], t_total)
    check("B=160 Bell-202", key, planes, totals, time_it=True)
    rows[-1]["ab"] = ring_ab(key, planes, totals, True)
    del planes

    # a carried-in state: the main segment in two calls, split where the
    # first call's exit pos is not a multiple of the ring's window
    key = device_rx_key(cfg)
    for cut in range(main_total // 2, main_total // 2 + 4000, 97):
        first = check("carry: first call", key, main_planes, [cut],
                      finalize=False)
        ci = first["out"][4]
        if int(ci[0, 0]) % first["ring"].window:
            break
        rows.pop()
    check(f"carry: resumed at pos {int(ci[0, 0])}", key, main_planes,
          [main_total], carry=(ci, first["out"][5]))

    # rtty and NOAA SAME (dual layout) through K1, two streams each
    for mode, text in (("rtty", b"RYRY THE QUICK BROWN FOX 73 " * 8),
                       ("same", b"ZCZC-WXR-RWT-020103+0015-1231200-KLOX/NWS-"
                                b" " * 4)):
        m = FskModem(mode, device="cpu")
        wav = noisy(m.modulate(text), 0.3)
        n = len(wav)
        t_total = _round_up_pow2(n + m.cfg.nsamples_overscan + 1)
        key, planes = planes_of(m.cfg, [wav, wav], t_total)
        check(mode, key, planes, [n, n * 2 // 3])

    # 4.5 baud at 48 kHz: a ring of the confidence plane(s) only
    for sync in (False, True):
        kw = {"do_rx_sync": True, "do_tx_sync_bytes": 2,
              "sync_byte": 0xAB} if sync else {}
        pre = bell_like(4.5, 48000, **kw)
        m = FskModem("1200", device="cpu")
        m.preset, m.cfg = pre, pre.cfg
        wav = noisy(m.modulate(b"slow 4.5 baud"), 0.3)
        n = len(wav)
        t_total = _round_up_pow2(n + pre.cfg.nsamples_overscan + 1)
        key, planes = planes_of(pre.cfg, [wav, wav], t_total)
        check(f"4.5 baud{' dual' if sync else ''} (scan window "
              f"{max(MegaStatics.build(key, t_total, False).try_max)})",
              key, planes, [n, n * 3 // 4])
    return rows


def host_engines(wav: str, text: bytes, err_device: str) -> dict:
    """The host engines on the file: in process on the card with the
    counts set to 0 just before and read just after (K3 and K5 launched,
    plain calls 0; K3's and K5's last launches held against their plain
    versions), then as --device cuda and --device cpu subprocesses."""
    res = {}
    for engine, count in (("host", "correlate"),
                          ("host-native", "correlate_batch")):
        argv = ["--rx", "--file", wav, "1200", "--engine", engine,
                "--device", "cuda"]
        run_cli_inprocess(argv)                        # warm-up
        with last_inputs() as seen:
            counts = reset_counts()
            t0 = time.perf_counter()
            rc, out, err = run_cli_inprocess(argv)
            wall_s = time.perf_counter() - t0
            lc = read_counts(counts)
        launches, k5, plain = lc[count], lc["frame_channels"], lc["plain"]
        if rc != 0 or out != text or err != err_device:
            fail(f"--engine {engine} in process: rc {rc}, stdout exact "
                 f"{out == text}, stderr == device engine's "
                 f"{err == err_device}\n{err}")
        if launches < 1 or k5 < 1 or plain:
            fail(f"--engine {engine}: K3 {count} {launches}, K5 {k5}, "
                 f"plain calls {plain}")
        held = hold_last(seen)
        del seen
        if "frame_channels" not in held or not all(
                r["ok"] for r in held.values()):
            fail(f"--engine {engine}: kernels against their plain versions "
                 f"{held}")
        rc_c, out_c, err_c = run_cli_subprocess(argv)
        rc_p, out_p, err_p = run_cli_subprocess(argv[:-1] + ["cpu"])
        ok = (rc_c == rc_p == 0 and out_c == out_p == text
              and err_c == err_p == err_device)
        phase(f"end to end --engine {engine}: in process stdout byte-exact, "
              f"stderr == device engine's; K3 {count} {launches}, K5 {k5}, "
              f"plain calls {plain}; last launches against their plain "
              f"versions: {held_line(held)}; subprocesses cuda/cpu stdout "
              f"exact {out_c == text}/{out_p == text}, stderr == device "
              f"engine's {err_c == err_device}/{err_p == err_device}")
        if not ok:
            fail(f"--engine {engine} subprocesses: rc {rc_c}/{rc_p}\n"
                 f"{err_c}\n{err_p}")
        res[engine] = {"launches": launches, "k5_launches": k5,
                       "held": held, "wall_s": wall_s,
                       "profile": profile_decode(argv)}
    return res


def perfect_check(tmp: str) -> dict:
    """The float64 route through the host engine on the card (the float64
    chain, then K5 on a float64 correlation; the counts set to 0 just
    before and read just after, K5's last launch held against its plain
    version), equal to the CPU's.  -> its launches."""
    args = ["1200", "--samplerate", "24000", "-M", "1200", "-S", "2400"]
    ptext = b"".join(b"perfect line %03d\n" % i for i in range(40))
    path = os.path.join(tmp, "perfect.wav")
    rc, _, err = run_cli_subprocess(["--tx", "--file", path, *args], ptext)
    if rc != 0:
        fail(f"perfect tx: {err}")
    argv = ["--rx", "--file", path, *args, "--engine", "host", "--device"]
    with last_inputs() as seen:
        counts = reset_counts()
        runs = [run_cli_inprocess(argv + ["cuda"])]
        lc = read_counts(counts)
    runs.append(run_cli_inprocess(argv + ["cpu"]))
    held = hold_last(seen)
    del seen
    rc, out, err = runs[0]
    ok = (rc == 0 and out == ptext and "confidence=inf" in err
          and "(rate perfect)" in err and runs[0] == runs[1]
          and lc["frame_channels"] >= 1 and not lc["plain"]
          and "frame_channels" in held
          and all(r["ok"] for r in held.values()))
    phase(f"float64 route ({' '.join(args)} --engine host): stdout exact "
          f"{out == ptext}, cuda == cpu {runs[0] == runs[1]}; launches {lc}; "
          f"{held_line(held)}; stderr: {err.strip()!r}")
    if not ok:
        fail("the float64 host-engine decode disagrees")
    return lc


def autodetect_check(dev) -> dict:
    """-a on two bursts with a retune between them (the signal of
    tests/test_autodetect_device.py::test_rearm_retune): --engine host
    (K3 and K5) and --engine device (each burst a stop-on-overflow decode
    through K1 and K2), on the card and on the CPU, all four byte for
    byte.  -> each engine's launches and warm wall on the card."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.rx.engine import Receiver
    from minimodem_tpu_torch.utils.cfloat import f32

    def burst(mark, space, text):
        m = FskModem("300", sample_rate=24000)
        m.preset = bell_like(300, 24000, mark_f=f32(mark),
                             space_f=f32(space))
        m.cfg = m.preset.cfg
        return m.modulate(text)

    stream = np.concatenate([burst(1200, 2400, b"AT 1200"),
                             np.zeros(24000, np.float32),
                             burst(1800, 3000, b"AT 1800")])

    def run(d, engine):
        sink, err = io.BytesIO(), io.StringIO()
        Receiver(bell_like(300, 24000).cfg,
                 RxOptions(carrier_autodetect_threshold=0.001),
                 get_codec("ascii8"), sink.write, err.write,
                 device=d).run(stream.copy(), engine=engine)
        return sink.getvalue(), err.getvalue()

    res = {}
    outs = {}
    for engine in ("host", "device"):
        run(dev, engine)                              # warm-up
        counts = reset_counts()
        t0 = time.perf_counter()
        outs[engine, "cuda"] = run(dev, engine)
        torch.cuda.synchronize()
        res[engine] = {"wall_s": time.perf_counter() - t0,
                       "launches": read_counts(counts)}
        outs[engine, "cpu"] = run("cpu", engine)
    ref = outs["host", "cuda"]
    ok = (ref[0] == b"AT 1200AT 1800" and "@ 1800.0 Hz" in ref[1]
          and all(o == ref for o in outs.values()))
    for engine, r in res.items():
        phase(f"-a --engine {engine}, retune between bursts: == --engine "
              f"host on the card {outs[engine, 'cuda'] == ref}, cuda == cpu "
              f"{outs[engine, 'cuda'] == outs[engine, 'cpu']}; launches "
              f"{r['launches']}; warm wall {r['wall_s'] * 1e3:.1f} ms; "
              f"stdout {outs[engine, 'cuda'][0]!r}, stderr "
              f"{outs[engine, 'cuda'][1]!r}")
    if not ok:
        fail("-a disagrees between engines or between cuda and cpu")
    lh = res["host"]["launches"]
    if lh["correlate"] < 1 or lh["frame_channels"] < 1 or lh["plain"]:
        fail(f"-a --engine host launches {lh}")
    lc = res["device"]["launches"]
    if lc["mega_rx"] < 1 or lc["fused_score"] < 1 or lc["plain"]:
        fail(f"-a --engine device launches {lc}")
    return res


KERNEL_COUNTS = ("fused_score", "mega_rx", "correlate", "correlate_batch",
                 "frame_channels")


def reset_counts():
    """Set every kernel's launch count and every plain version's call
    count to 0 (-> the classes and functions that hold them)."""
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain
    from minimodem_tpu_torch.ops.demod import score_frame_channels
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels
    from minimodem_tpu_torch.ops.fused_score import (
        FusedScorer, score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import MegaRx, mega_rx_plain
    from minimodem_tpu_torch.ops.tx_device import (
        TxSynth, device_synthesize, device_synthesize_frames)

    FusedScorer.launches = MegaRx.launches = 0
    Correlator.launches = Correlator.batch_launches = 0
    TxSynth.launches = TxSynth.frames_launches = 0
    FrameChannels.launches = 0
    score_planes_plain.calls = mega_rx_plain.calls = 0
    correlate_plain.calls = score_frame_channels.calls = 0
    device_synthesize.calls = device_synthesize_frames.calls = 0
    return FusedScorer, MegaRx, Correlator, TxSynth, FrameChannels, (
        score_planes_plain, mega_rx_plain, correlate_plain,
        score_frame_channels), (device_synthesize, device_synthesize_frames)


def read_counts(counts) -> dict:
    """The launches and plain calls since reset_counts; "plain" counts
    every plain version's calls, the synthesis' ("plain_synth") among
    them."""
    fused, mega, corr, synth, channels, plains, synth_plains = counts
    plain_synth = sum(p.calls for p in synth_plains)
    return {"fused_score": fused.launches, "mega_rx": mega.launches,
            "correlate": corr.launches, "correlate_batch": corr.batch_launches,
            "frame_channels": channels.launches,
            "tx_synth": synth.launches,
            "tx_synth_frames": synth.frames_launches,
            "plain": sum(p.calls for p in plains) + plain_synth,
            "plain_synth": plain_synth}


def write_wav16(path: str, samples, rate: int) -> None:
    """A mono PCM16 WAV of float samples."""
    import struct

    import numpy as np

    s16 = np.clip(np.rint(np.asarray(samples, np.float64) * 32767.0),
                  -32768, 32767).astype("<i2")
    data = s16.tobytes()
    fmt = struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, rate, 2 * rate, 2, 16)
    body = fmt + struct.pack("<4sI", b"data", len(data)) + data
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE") + body)


def stderr_close(a: str, b: str, fft: bool) -> bool:
    """Two runs' stderr: identical, or on the FFT route (stage-1
    transforms sum in another order on each device) the same lines with
    the NOCARRIER confidence= and ampl= values within rtol 5e-4 (plus the
    last printed digit)."""
    import re

    import numpy as np

    if a == b or not fft:
        return a == b
    num = re.compile(r"(confidence|ampl)=([0-9.]+|inf|nan)")
    if num.sub(r"\1=#", a) != num.sub(r"\1=#", b):
        return False
    x = [float(v) for _, v in num.findall(a)]
    y = [float(v) for _, v in num.findall(b)]
    return bool(np.allclose(x, y, rtol=5e-4, atol=2e-3, equal_nan=True))


def geometry_signal(name: str, rng):
    """A geometry K1 does not serve (or a dual slow baud), ~60 s of its
    audio and the text it carries.  -> (cfg, CLI args, float32 audio,
    the expected stdout, its stage-1 route)."""
    import numpy as np
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like, uic
    from minimodem_tpu_torch.ops.tx import ToneGenerator
    from minimodem_tpu_torch.sigio import SampleFormat
    from minimodem_tpu_torch.utils.cfloat import f32

    if name == "uic-train":
        # 12 bursts of 60 telegrams: the sync pattern 11110010, then 39
        # seeded data bits, keyed as raw frame bits between mark leaders
        cfg = uic("train").cfg
        codec = get_codec("uic-train")
        gen = ToneGenerator(cfg.sample_rate, SampleFormat.FLOAT)
        text = b""
        for _ in range(12):
            bits = [1] * 16
            for _ in range(60):
                data = int(rng.integers(0, 1 << 39))
                bits += [1, 1, 1, 1, 0, 0, 1, 0] + [(data >> i) & 1
                                                    for i in range(39)]
                text += codec.decode(data, 39)
            for v in bits + [1] * 8:
                gen.tone(float(cfg.mark_f if v else cfg.space_f),
                         cfg.bit_nsamples_tx)
            gen.tone(0.0, cfg.sample_rate // 5)            # silence
        return cfg, ["uic-train"], gen.synthesize(), text, "K3"
    kw, args, route = {}, [], "K3"
    if name == "float64":
        baud, rate = 1200, 24000
        kw = {"mark_f": f32(1200), "space_f": f32(2400)}
        args = ["--samplerate", "24000", "-M", "1200", "-S", "2400"]
        text = b"".join(b"perfect line %04d\n" % i for i in range(420))
        route = "float64 chain"
    elif name == "20 baud":
        baud, rate = 20, 48000
        text = b"".join(b"twenty baud, line %d\n" % i for i in range(5))
    elif name == "1 baud":
        baud, rate, text, route = 1, 48000, b"slow\n", "FFT"
    else:                                              # "2 baud dual"
        baud, rate, text, route = 2, 48000, b"dual 2bd\n", "FFT"
        kw = {"do_rx_sync": True, "do_tx_sync_bytes": 2, "sync_byte": 0xAB}
        args = ["--sync-byte", "0xAB"]
    pre = bell_like(baud, rate, **kw)
    m = FskModem("1200", sample_rate=rate, device="cpu")
    m.preset, m.cfg = pre, pre.cfg
    wav = m.modulate(text)
    if route == "FFT":
        # a clean tone's noise band holds only the transform's round-off,
        # so its confidence (an SNR) would be round-off's ratio, different
        # on each device: uniform noise of amplitude 0.3 makes it the
        # signal's
        wav = wav + (rng.random(wav.size, dtype=np.float32)
                     - np.float32(0.5)) * np.float32(0.3)
    return pre.cfg, [str(baud), *args], wav, text, route


GEOMETRIES = ("uic-train", "float64", "20 baud", "1 baud", "2 baud dual")


def geometry_phase(name: str, tmp: str, dev) -> dict:
    """One geometry the device engine serves since K2's wide, bits_hi and
    no-ring modes and the scorer for what K1 does not serve: a ~60 s file
    decode by `minimodem-tpu-torch --rx --file` on the card (launches
    counted: K5 and K2, K3 where it is the route; plain calls 0; stdout
    exact) and on --device cpu (stderr equal); then one DeviceReceiver
    batch of 16 streams, with K2 held against its plain version on the
    card's own planes and K5's last launch against its own, and the
    scorer's split at one tile (k5_split).  -> timings."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.device_rx import (
        SCORE_TILE, DeviceReceiver, _collect, _round_up_pow2, device_rx_key,
        geo_from_key, make_score_packer_planes, plane_names)
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaRx, MegaStatics, mega_rx_plain)

    rng = np.random.default_rng(SEED + 17 + GEOMETRIES.index(name))
    cfg, args, wav, text, route = geometry_signal(name, rng)
    fft = route == "FFT"
    path = os.path.join(tmp, name.replace(" ", "_") + ".wav")
    write_wav16(path, wav, cfg.sample_rate)
    argv = ["--rx", "--file", path, *args, "--device", "cuda"]
    run_cli_inprocess(argv)                            # warm-up
    counts = reset_counts()
    t0 = time.perf_counter()
    rc, out, err = run_cli_inprocess(argv)
    wall_s = time.perf_counter() - t0
    launches = read_counts(counts)
    rc_p, out_p, err_p = run_cli_subprocess(argv[:-1] + ["cpu"])
    key = device_rx_key(cfg)
    geo = geo_from_key(key)
    k3 = launches["correlate"] + launches["correlate_batch"]
    ok = (rc == rc_p == 0 and out == out_p == text
          and stderr_close(err, err_p, fft) and launches["mega_rx"] >= 1
          and launches["frame_channels"] >= 1
          and launches["plain"] == 0 and (k3 >= 1) == (route == "K3"))
    close = ("" if err == err_p else
             f" (scores within the FFT route's tolerance: "
             f"{stderr_close(err, err_p, fft)})")
    phase(f"{name} ({' '.join(args)}; nb {geo.nb}, {geo.n_bits} frame bits, "
          f"stage 1 {route}): {len(wav) / cfg.sample_rate:.1f} s file decode "
          f"on the card, stdout exact {out == text}, == --device cpu "
          f"{out == out_p}, stderr == --device cpu {err == err_p}{close}; "
          f"launches {launches}; warm wall {wall_s * 1e3:.1f} ms; "
          f"stderr: {err.strip()[:300]!r}")
    if not ok:
        fail(f"{name}: rc {rc}/{rc_p}, stdout {out[:80]!r} vs cpu "
             f"{out_p[:80]!r}\n{err}\n{err_p}")

    # one DeviceReceiver batch of 16 streams, each its own slice
    b = 16
    n = len(wav)
    totals = [n - 2003 * i for i in range(b)]
    x = np.zeros((b, n), np.float32)
    for i, t in enumerate(totals):
        x[i, :t] = wav[n - t:]
    noise = (rng.random(x.shape, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.2)
    x += noise
    rx = DeviceReceiver(cfg, device=dev)
    with last_inputs() as seen:
        counts = reset_counts()
        events, _ = rx.run_events_batch(x, totals, 1.5, 2.3)
        batch_launches = read_counts(counts)
    # K5's last launch (K2 is held below on the card's planes)
    held = hold_last({k: v for k, v in seen.items()
                      if k == "frame_channels"})
    del seen
    t_total = _round_up_pow2(max(totals) + cfg.nsamples_overscan + 1)
    packer, _ = make_score_packer_planes(key, t_total, "float32")
    xd = torch.zeros((b, t_total + geo.halo), dtype=torch.float32, device=dev)
    xd[:, :n] = torch.from_numpy(x).to(dev)
    planes = packer(xd)
    mega = MegaRx(MegaStatics.build(key, t_total, False, rx.compact))
    tt = torch.tensor(totals, dtype=torch.int32, device=dev)
    ci = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    cf = torch.zeros((b, 4), dtype=torch.float32, device=dev)
    same, out_k, _ = k2_compare(mega, planes, tt, (1.5, 2.3), ci, cf, True)
    recv_same = all(
        len(u) == len(v) and all(np.array_equal(s, t) for s, t in zip(u, v))
        for u, v in zip(events, _collect(out_k[:4], b, rx.compact)))
    tile = min(t_total, SCORE_TILE)
    r = {"name": name, "route": route, "wall_s": wall_s,
         "audio_s": len(wav) / cfg.sample_rate, "launches": launches,
         "batch_launches": batch_launches, "planes": list(planes.shape),
         "held": held, "tiles": -(-t_total // tile),
         "searches": int(mega_rx_plain.searches.max()),
         "score_ms": cuda_ms(lambda: packer(xd), 3),
         "k2_ms": cuda_ms(
             lambda: mega(planes, tt, (1.5, 2.3), ci, cf, True), 3)}
    del planes, out_k
    r["split"] = k5_split(geo, xd[:, :tile + geo.halo], tile,
                          plane_names(geo))
    phase(f"{name} DeviceReceiver batch of {b} streams (planes "
          f"{r['planes']}, {'compact' if rx.compact else 'wide records'}): "
          f"K2 == plain on the card's planes {same}, DeviceReceiver == "
          f"them {recv_same}; launches {batch_launches}; K5's last launch "
          f"against its plain version: {held_line(held)}; ring "
          f"{'none (global reads)' if not mega.ring.stages else str(mega.ring.stages) + ' stages'}"
          f"; score planes {r['score_ms']:.3f} ms ({r['tiles']} tiles), K2 "
          f"{r['k2_ms']:.3f} ms per call (CUDA events; {r['searches']} "
          f"searches in the longest stream); a tile: "
          f"{k5_split_line(r['split'])}")
    if not (same and recv_same) or batch_launches["mega_rx"] < 1 or \
            batch_launches["frame_channels"] < 1 or \
            batch_launches["plain"] or (route == "K3") != (
                batch_launches["correlate_batch"] >= 1) or \
            "frame_channels" not in held or r["split"]["words"] or \
            not all(v["ok"] for v in held.values()):
        fail(f"{name}: the batch of {b} disagrees or missed its kernels")
    del xd
    torch.cuda.empty_cache()
    return r


class StandInAudio:
    """A stand-in audio client library for a machine without audio
    devices, shaped like tests/test_soak_live.py's SessionAsound: the
    libasound and libsndio calls sigio/alsa.py and sigio/sndio.py make.
    Capture reads a lazy iterator of float32 blocks, so hours of virtual
    audio never sit in host memory; playback is kept per write.  Installed
    as `_lib` (with `_tried`) on the port's sigio modules (stand_in)."""

    def __init__(self, blocks=()):
        import numpy as np

        self._it = iter(blocks)
        self._buf = np.zeros(0, np.float32)
        self._off = 0
        self.itemsize = 4
        self.device = None
        self.written = []

    def _capture(self, ptr, count: int) -> int:
        import ctypes

        import numpy as np

        while len(self._buf) - self._off < count:
            nxt = next(self._it, None)
            if nxt is None:
                break
            self._buf = np.concatenate([self._buf[self._off:], nxt])
            self._off = 0
        n = min(count, len(self._buf) - self._off)
        raw = np.ascontiguousarray(self._buf[self._off:self._off + n],
                                   np.float32).tobytes()
        ctypes.memmove(ptr, raw, len(raw))
        self._off += n
        return n

    def _play(self, ptr, nbytes: int) -> None:
        import ctypes

        import numpy as np

        raw = ctypes.string_at(ptr, nbytes)
        self.written.append(np.frombuffer(
            raw, np.int16 if self.itemsize == 2 else np.float32).copy())

    def played(self):
        import numpy as np

        return np.concatenate(self.written)

    # libasound
    def snd_pcm_open(self, pcmref, device, direction, mode):
        self.device = device
        return 0

    def snd_pcm_set_params(self, pcm, fmt, access, ch, rate, resample,
                           latency):
        from minimodem_tpu_torch.sigio.alsa import SND_PCM_FORMAT_S16_LE

        self.itemsize = 2 if fmt == SND_PCM_FORMAT_S16_LE else 4
        return 0

    def snd_pcm_readi(self, pcm, ptr, count):
        return self._capture(ptr, count)

    def snd_pcm_writei(self, pcm, ptr, count):
        self._play(ptr, count * self.itemsize)
        return count

    def snd_pcm_drain(self, pcm):
        return 0

    def snd_pcm_close(self, pcm):
        return 0

    def snd_strerror(self, err):
        return b"stand-in error"

    # libsndio (S16 only)
    def sio_open(self, device, mode, nbio):
        self.device, self.itemsize = device, 2
        return 1

    def sio_initpar(self, parp):
        pass

    def sio_setpar(self, hdl, parp):
        return 1

    def sio_start(self, hdl):
        return 1

    def sio_write(self, hdl, ptr, nbytes):
        self._play(ptr, nbytes)
        return nbytes

    def sio_stop(self, hdl):
        return 1

    def sio_close(self, hdl):
        pass


@contextlib.contextmanager
def stand_in(name: str, lib):
    """The port's sigio.<name> loads `lib` as its client library."""
    import importlib

    mod = importlib.import_module(f"minimodem_tpu_torch.sigio.{name}")
    old = mod._lib, mod._tried
    mod._lib, mod._tried = lib, True
    try:
        yield lib
    finally:
        mod._lib, mod._tried = old


def run_cli_stdin(argv, stdin: bytes):
    """run_cli_inprocess with `stdin` on sys.stdin (a stream without a
    descriptor: the transmitter's bulk path)."""
    class _In:
        buffer = io.BytesIO(stdin)

    old = sys.stdin
    sys.stdin = _In()
    try:
        return run_cli_inprocess(argv)
    finally:
        sys.stdin = old


def percentile_ms(walls, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(walls) * 1e3, q))


def streaming_phase(wav: str, text: bytes, err_cpu: str, dev) -> dict:
    """Phase 16: the phase-4 audio read from its WAV in half-second FLOAT
    reads, as a live capture delivers it, fed to DeviceStreamReceiver
    (segment_len 1 << 16) and rendered: stdout and stderr equal to the
    phase-4 --device cpu file decode's, on the card and on the CPU; K1
    and K2 launched once a segment, plain calls 0; per-segment decode
    walls, the real-time factor, a torch.profiler device-busy share; K1
    and K2 at one non-final segment's shape against their plain versions,
    timed beside their bounds.  -> the numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import (
        DeviceStreamReceiver, _round_up_pow2, device_rx_key, geo_from_key)
    from minimodem_tpu_torch.ops.fused_score import (
        FusedScorer, score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaReceiver, MegaRx, MegaStatics, mega_rx_plain)
    from minimodem_tpu_torch.rx.engine import Receiver
    from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

    cfg = FskModem("1200", device="cpu").cfg
    stream = open_stream("file", None, Direction.RECORD, SampleFormat.FLOAT,
                         cfg.sample_rate, 1, "chip_smoke", wav)
    chunks = []
    while (c := stream.read(cfg.sample_rate // 2)).size:
        chunks.append(np.asarray(c, np.float32))
    stream.close()
    audio_s = sum(len(c) for c in chunks) / cfg.sample_rate

    def decode(device):
        out, err = io.BytesIO(), io.StringIO()
        rx = Receiver(cfg, RxOptions(), get_codec("ascii8"), out.write,
                      err.write, device=device)
        sr = DeviceStreamReceiver(cfg, segment_len=1 << 16, device=device)
        run, walls = sr.rx.run_events_batch, []

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return run(*a, **k)
            finally:
                walls.append(time.perf_counter() - t)

        sr.rx.run_events_batch = timed
        t0 = time.perf_counter()
        for c in chunks:
            rx.render_events(*sr.feed(c))
        rx.render_events(*sr.finish())
        torch.cuda.synchronize()
        return out.getvalue(), err.getvalue(), walls, time.perf_counter() - t0

    decode(dev)                                        # warm-up
    counts = reset_counts()
    out, err, walls, wall = decode(dev)
    launches = read_counts(counts)
    out_c, err_c, _, wall_cpu = decode("cpu")
    ok = (out == out_c == text and err == err_c == err_cpu
          and launches["fused_score"] == launches["mega_rx"] == len(walls)
          and launches["plain"] == 0)
    phase(f"streaming: {audio_s:.1f} s of audio in {len(chunks)} half-second "
          f"reads -> DeviceStreamReceiver(segment_len 65536) on the card: "
          f"{len(walls)} segments, stdout byte-exact {out == text}, == "
          f"--device cpu {out == out_c}, stderr == phase 4's --device cpu "
          f"decode {err == err_cpu} (stream on the CPU {err_c == err_cpu}); "
          f"launches {launches}")
    if not ok:
        fail(f"streaming decode disagrees or missed its kernels\n{err}\n"
             f"{err_c}\n{err_cpu}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(dev)
        wall_prof = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA) / 1e6

    # K1 and K2 at one non-final segment: [1, t_total + halo]
    key = device_rx_key(cfg)
    geo = geo_from_key(key)
    sr = DeviceStreamReceiver(cfg, segment_len=1 << 16, device=dev)
    total_nf = sr.segment_len - sr._lookahead + cfg.expect_nsamples
    t_total = _round_up_pow2(total_nf + cfg.nsamples_overscan + 1)
    seg = np.concatenate(chunks)[5 * sr.segment_len:][:sr.segment_len]
    x_np = np.zeros((1, t_total + geo.halo), np.float32)
    x_np[0, :len(seg)] = seg
    x = torch.from_numpy(x_np).to(dev)
    scorer = FusedScorer(geo)
    planes = scorer(x, t_total)
    k1_words = int(torch.count_nonzero(
        planes != score_planes_plain(x, geo, t_total)))
    if k1_words:
        fail(f"K1 at the streaming shape: {k1_words} bit-different words")
    st = MegaStatics.build(key, t_total, False)
    mega = MegaRx(st)
    tt = torch.tensor([total_nf], dtype=torch.int32, device=dev)
    ci_np, cf_np = MegaReceiver.carry_to_arrays(None, 1)
    ci, cf = torch.from_numpy(ci_np).to(dev), torch.from_numpy(cf_np).to(dev)
    thr = (1.5, 2.3)
    same, out_k, out_p = k2_compare(mega, planes, tt, thr, ci, cf, False)
    if not same:
        fail("K2 at the streaming shape disagrees with its plain version")
    k2_words, k2_search = mega_rx_plain.words, int(mega_rx_plain.searches[0])
    tp0 = time.perf_counter()
    mega_rx_plain(st, False, planes.cpu().numpy(),
                  np.asarray([total_nf], np.int32), thr, ci_np, cf_np)
    k2_plain_ms = (time.perf_counter() - tp0) * 1e3
    r = {
        "segments": len(walls), "audio_s": audio_s, "wall_s": wall,
        "wall_cpu_s": wall_cpu, "launches": launches,
        "seg_p50_ms": percentile_ms(walls, 50),
        "seg_p99_ms": percentile_ms(walls, 99),
        "seg_max_ms": max(walls) * 1e3, "busy_ms": busy * 1e3,
        "wall_prof_ms": wall_prof * 1e3,
        "shape": f"[1, {t_total + geo.halo}] -> [1, {planes.shape[1]}, "
                 f"{t_total}]", "t_total": t_total, "total_nf": total_nf,
        "k1_ms": cuda_ms(lambda: scorer(x, t_total), 20),
        "k1_kernel_ms": kernel_device_ms(lambda: scorer(x, t_total), 20,
                                         "fused_score_kernel"),
        "k1_queued_ms": queued_ms(lambda: scorer(x, t_total), 20),
        "k1_plain_ms": cuda_ms(lambda: score_planes_plain(x, geo, t_total),
                               3),
        "k1_bound": bound(4 * (t_total + geo.halo
                               + planes.shape[1] * t_total),
                          2 * 4 * geo.nb * t_total),
        "k2_ms": cuda_ms(lambda: mega(planes, tt, thr, ci, cf, False), 20),
        "k2_kernel_ms": kernel_device_ms(
            lambda: mega(planes, tt, thr, ci, cf, False), 20,
            "mega_rx_kernel"),
        "k2_queued_ms": queued_ms(
            lambda: mega(planes, tt, thr, ci, cf, False), 20),
        "k2_plain_ms": k2_plain_ms, "k2_search": k2_search,
        "k2_bound": bound(4 * k2_words + 32 * int(out_k[1][0])
                          + int(out_k[3][0]) + 48, 0),
        "k2_err": float(np.abs(out_k[5].cpu().numpy().astype(np.float64)
                               - out_p[5]).max()),
    }
    return r


def live_phase(audio, dev) -> dict:
    """Phase 17: the live CLI through StandInAudio on the port's sigio:
    `--rx -A 1200` and `--rx -a -A -R 24000 300` on --device cuda, each
    equal to --device cpu, with the launch counts of the card's run;
    `--tx -sdev0 1200 --synth-backend jax` played into the stand-in,
    cuda == cpu sample for sample and decoded back exactly, and the
    synthesis time of the interactive loop's chunks on the card.
    -> the numbers."""
    import numpy as np
    import torch

    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.config import TxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.tx import Transmitter
    from minimodem_tpu_torch.sigio import SampleFormat
    from minimodem_tpu_torch.utils.cfloat import f32

    res = {}
    dname = torch.device(dev).type
    # live RX: 20 s of the phase-4 audio, a gap, then its first 5 s again
    capture = np.concatenate([audio[:20 * 48000], np.zeros(30000, np.float32),
                              audio[:5 * 48000]])

    def burst(mark, space, payload):
        m = FskModem("300", sample_rate=24000, device="cpu")
        m.preset = bell_like(300, 24000, mark_f=f32(mark), space_f=f32(space))
        m.cfg = m.preset.cfg
        return m.modulate(payload)

    auto_capture = np.concatenate([
        np.zeros(30000, np.float32), burst(1200, 2400, b"LIVE AT 1200 "),
        np.zeros(26000, np.float32), burst(1800, 3000, b"LIVE AT 1800")])
    for name, argv, cap in (
            ("live", ["--rx", "-A", "1200"], capture),
            ("live_autodetect", ["--rx", "-a", "-A", "-R", "24000", "300"],
             auto_capture)):
        runs = {}
        with stand_in("alsa", StandInAudio([cap])):
            run_cli_inprocess(argv + ["--device", dname])      # warm-up
        counts = reset_counts()
        with stand_in("alsa", StandInAudio([cap])):
            t0 = time.perf_counter()
            runs["cuda"] = run_cli_inprocess(argv + ["--device", dname])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with stand_in("alsa", StandInAudio([cap])):
            runs["cpu"] = run_cli_inprocess(argv + ["--device", "cpu"])
        rc, out, err = runs["cuda"]
        ok = (runs["cuda"] == runs["cpu"] and rc == 0 and len(out) > 0
              and launches["mega_rx"] >= 1 and launches["fused_score"] >= 1
              and launches["plain"] == 0)
        phase(f"{name}: minimodem-tpu-torch {' '.join(argv)} through the "
              f"stand-in ALSA capture ({len(cap) / (24000 if '-a' in argv else 48000):.1f} s): "
              f"--device cuda == --device cpu {runs['cuda'] == runs['cpu']}; "
              f"launches {launches}; warm wall {wall * 1e3:.1f} ms; stdout "
              f"{out[:60]!r}, stderr {err.strip()[-160:]!r}")
        if not ok:
            fail(f"{name} disagrees or missed its kernels\n{runs}")
        res[name] = {"launches": launches, "wall_s": wall,
                     "audio_s": len(cap) / (24000 if "-a" in argv else 48000)}
    if b"LIVE AT 1200 LIVE AT 1800" != runs["cuda"][1]:
        fail(f"live -a decoded {runs['cuda'][1]!r}")

    # interactive TX into a stand-in sndio playback device
    payload = b"interactive tx on the card\n"
    played = {}
    for key, d in (("cuda", dname), ("cpu", "cpu")):
        with stand_in("sndio", StandInAudio()) as lib:
            rc, out, err = run_cli_stdin(["--tx", "-sdev0", "1200",
                                          "--synth-backend", "jax",
                                          "--device", d], payload)
            if rc != 0 or lib.device != b"dev0":
                fail(f"interactive tx --device {d}: rc {rc}, device "
                     f"{lib.device!r}\n{err}")
            played[key] = lib.played()
    m = FskModem("1200", device="cpu")
    back = m.demodulate(played["cuda"].astype(np.float32)
                        / np.float32(32768.0))
    same = np.array_equal(played["cuda"], played["cpu"])
    # the interactive loop's chunks: one byte, or 1/25 s of idle carrier,
    # each synthesized on the card and brought back (drain)
    tx = Transmitter(m.cfg, TxOptions(interactive=True), Ascii8Codec(),
                     SampleFormat.S16, "jax", dev)
    byte_walls, idle_walls = [], []
    for i in range(200):
        tx.send(65 + i % 26)
        t0 = time.perf_counter()
        tx.drain(None)
        byte_walls.append(time.perf_counter() - t0)
        tx.idle_tone(m.cfg.sample_rate // 25)
        t0 = time.perf_counter()
        tx.drain(None)
        idle_walls.append(time.perf_counter() - t0)
    res["tx"] = {"samples": int(played["cuda"].size), "same": same,
                 "byte_p50_ms": percentile_ms(byte_walls[10:], 50),
                 "byte_max_ms": max(byte_walls[10:]) * 1e3,
                 "idle_p50_ms": percentile_ms(idle_walls[10:], 50),
                 "idle_max_ms": max(idle_walls[10:]) * 1e3}
    t = res["tx"]
    phase(f"interactive tx: --tx -sdev0 1200 --synth-backend jax into the "
          f"stand-in sndio device: {t['samples']} S16 samples, --device cuda "
          f"== --device cpu {same}, decoded back exact {back == payload}; "
          f"per chunk on the card (synthesis + copy back, after 10 warm): "
          f"one byte p50 {t['byte_p50_ms']:.3f} ms, max "
          f"{t['byte_max_ms']:.3f} ms; 1/25 s idle carrier p50 "
          f"{t['idle_p50_ms']:.3f} ms, max {t['idle_max_ms']:.3f} ms "
          f"(the idle tick is 40 ms)")
    if not (same and back == payload):
        fail("interactive tx disagrees between cuda and cpu or does not "
             "decode back")
    return res


# the JAX package's live soak (tests/test_soak_live.py) on the card
SOAK_SESSIONS = 2500
SOAK_RSS_BOUND_MB = 256.0
SOAK_DEVICE_BOUND_MB = 16.0


def soak_phase(dev) -> dict:
    """Phase 17's soak: tests/test_soak_live.py's two soaks on the card,
    through StandInAudio: SOAK_SESSIONS RX sessions (0.4-1.8 s of silence,
    then one payload line, ~1.4 h of virtual audio) by `--rx -A 1200`, and
    SOAK_SESSIONS // 12 bursts by `--rx -a -A -R 24000 300`; every byte in
    order, one CARRIER and one NOCARRIER per session with the ndata= sum,
    and the growth of the resident set and of
    torch.cuda.memory_allocated() between the 10% point and the end
    bounded.  -> per soak its wall, audio and growths."""
    import re

    import numpy as np
    import torch

    from minimodem_tpu_torch.models.modem import FskModem

    def rss_mb() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6

    def payload(i: int) -> bytes:
        return b"SOAK %06d THE QUICK BROWN FOX JUMPS 0123456789\n" % i

    res = {}
    for name, n, mode, rate, gap, seed, argv in (
            ("rx", SOAK_SESSIONS, "1200", 48000, (0.4, 1.8), 0x50AC,
             ["--rx", "-A", "1200"]),
            ("autodetect", max(10, SOAK_SESSIONS // 12), "300", 24000,
             (1.0, 2.5), 0xA07D, ["--rx", "-a", "-A", "-R", "24000", "300"])):
        m = FskModem(mode, sample_rate=rate, device="cpu")
        rng = np.random.default_rng(seed)
        mark = {"audio": 0}

        def blocks():
            for i in range(n):
                if i == max(1, n // 10):
                    mark["rss"] = rss_mb()
                    mark["dev"] = torch.cuda.memory_allocated() / 2**20
                g = np.zeros(int(rng.uniform(*gap) * rate), np.float32)
                w = m.modulate(payload(i))
                mark["audio"] += len(g) + len(w)
                yield g
                yield w
            yield np.zeros(48000, np.float32)
            mark["audio"] += 48000
            mark["rss_end"] = rss_mb()
            mark["dev_end"] = torch.cuda.memory_allocated() / 2**20

        counts = reset_counts()
        with stand_in("alsa", StandInAudio(blocks())):
            t0 = time.perf_counter()
            rc, out, err = run_cli_inprocess(
                argv + ["--device", torch.device(dev).type])
            wall = time.perf_counter() - t0
        launches = read_counts(counts)
        expected = b"".join(payload(i) for i in range(n))
        ndata = [int(x) for x in re.findall(r"### NOCARRIER ndata=(\d+)", err)]
        r = {"sessions": n, "wall_s": wall, "audio_s": mark["audio"] / rate,
             "rss_growth_mb": mark["rss_end"] - mark["rss"],
             "dev_growth_mb": mark["dev_end"] - mark["dev"],
             "dev_end_mb": mark["dev_end"], "launches": launches}
        ok = (rc == 0 and out == expected
              and err.count("### CARRIER") == n and len(ndata) == n
              and sum(ndata) == len(expected)
              and r["rss_growth_mb"] < SOAK_RSS_BOUND_MB
              and r["dev_growth_mb"] < SOAK_DEVICE_BOUND_MB
              and launches["plain"] == 0 and launches["mega_rx"] >= n)
        phase(f"soak {name}: {n} sessions, {r['audio_s']:.0f} s of virtual "
              f"audio through {' '.join(argv)} --device cuda in "
              f"{wall:.1f} s ({r['audio_s'] / wall:.0f}x real time); every "
              f"byte {out == expected}, CARRIER lines "
              f"{err.count('### CARRIER')}, NOCARRIER ndata= lines "
              f"{len(ndata)} summing to {sum(ndata)} of {len(expected)}; RSS "
              f"growth {r['rss_growth_mb']:.1f} MB (bound "
              f"{SOAK_RSS_BOUND_MB:.0f}), torch.cuda.memory_allocated growth "
              f"{r['dev_growth_mb']:.2f} MiB (bound {SOAK_DEVICE_BOUND_MB:.0f}"
              f", {r['dev_end_mb']:.2f} MiB at the end); launches {launches}")
        if not ok:
            fail(f"soak {name} failed: rc {rc}\n{err[-2000:]}")
        res[name] = r
    return res


def stream_keys(strm, live, soak, k: str, name: str) -> dict:
    """A kernel's numbers on the streaming and live paths, for the
    kernels' JSON line."""
    return {
        "stream_launches": strm["launches"][name],
        "live_launches": live["live"]["launches"][name],
        "live_autodetect_launches": live["live_autodetect"]["launches"][name],
        "soak_launches": {n: r["launches"][name] for n, r in soak.items()},
        "stream_ms": strm[k + "_ms"],
        "stream_kernel_ms": (strm[k + "_queued_ms"]
                             if strm[k + "_kernel_ms"] is None
                             else strm[k + "_kernel_ms"]),
        "stream_queued_ms": strm[k + "_queued_ms"],
        "stream_plain_ms": strm[k + "_plain_ms"],
        "stream_bound_ms": strm[k + "_bound"][0],
        "stream_bound_by": strm[k + "_bound"][1],
    }


def host_engine_split(wav: str, device):
    """One warm host-engine decode of the file, its wall split between
    chunk scoring (DemodScorer.score: upload, K3, K5 and the one
    synchronising D2H copy per chunk) and the rest (the Python state
    machine and rendering); then the scorer's two stages (k5_split) at
    `score`'s one chunk row and at `score_chunks`' batch of overlapping
    rows.  -> (the line, {form: k5_split})."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.demod import CHANNELS, DemodScorer
    from minimodem_tpu_torch.rx.engine import Receiver
    from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

    cfg = FskModem("1200").cfg
    stream = open_stream("file", None, Direction.RECORD, SampleFormat.FLOAT,
                         cfg.sample_rate, 1, "chip_smoke", wav)
    stream.format = SampleFormat.S16
    chunks = []
    while (c := stream.read(1 << 20)).size:
        chunks.append(c)
    stream.close()
    samples = np.concatenate(chunks)
    spent = [0, 0.0]
    orig = DemodScorer.score

    def timed(self, x):
        t = time.perf_counter()
        try:
            return orig(self, x)
        finally:
            spent[0] += 1
            spent[1] += time.perf_counter() - t

    DemodScorer.score = timed
    try:
        rx = Receiver(cfg, RxOptions(), get_codec("ascii8"), lambda b: None,
                      lambda s: None, device=device)
        t0 = time.perf_counter()
        rx.run(samples, engine="host")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DemodScorer.score = orig
    sc = DemodScorer(cfg, device=device)
    t_len, halo = sc.chunk_len, sc.geo.halo
    n_chunks = -(-len(samples) // t_len)
    flat = np.zeros(n_chunks * t_len + halo, np.float32)
    flat[:len(samples)] = samples.astype(np.float32) / np.float32(32768.0)
    rows = torch.from_numpy(flat).to(device).unfold(0, t_len + halo, t_len)
    splits = {f"score [1, {t_len + halo}]": k5_split(
                  sc.geo, rows[:1], t_len, CHANNELS),
              f"score_chunks [{n_chunks}, {t_len + halo}]": k5_split(
                  sc.geo, rows, t_len, CHANNELS)}
    return (f"wall {1e3 * wall:.2f} ms (after the WAV read): chunk scoring "
            f"{1e3 * spent[1]:.2f} ms in {spent[0]} calls "
            f"({100 * spent[1] / wall:.1f}%), Python state machine and "
            f"render {1e3 * (wall - spent[1]):.2f} ms"), splits


def turns_atol(seg_len: int, cfg) -> float:
    """Tolerance of device synthesis between two devices: one float32 ulp
    of the largest per-sample turns of a seg_len-sample tone segment,
    times 2pi, plus one ulp of a phase and of the sine (a float64 prefix
    sum of non-integers, summed in another order, can move a phase to the
    neighbouring float32)."""
    import numpy as np

    turns = seg_len * max(float(cfg.mark_f), float(cfg.space_f)) \
        / cfg.sample_rate + 1.0
    return 2 * np.pi * (float(np.spacing(np.float32(turns))) + 2.0 ** -24) \
        + 2.0 ** -24


def device_tx_check(dev) -> list:
    """Device TX on the card against its CPU version: device_synthesize
    at B = 4 and at one 64.3 s stream (exact phase, so at most one float32
    ulp of the float64 sine apart), device_synthesize_frames at rtty
    (within turns_atol), and `--synth-backend jax` (ops/tx_synth.py): LUT
    4096 and 16 in S16 and FLOAT bit-identical to the numpy backend, the
    direct sine within one float32 ulp (S16: one step).  -> rows."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.config import TxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.tx import Transmitter
    from minimodem_tpu_torch.ops.tx_device import (
        device_synthesize, device_synthesize_frames, frame_synth_params)
    from minimodem_tpu_torch.sigio import SampleFormat

    rng = np.random.default_rng(SEED + 11)
    rows = []

    def row(name, got, ref, atol):
        diff = np.abs(got.astype(np.float64) - ref)
        r = {"name": name, "max_abs_err": float(diff.max()),
             "differ": int(np.count_nonzero(diff)), "n": int(diff.size),
             "atol": atol}
        rows.append(r)
        if r["max_abs_err"] > atol:
            fail(f"device TX {name}: max_abs_err {r['max_abs_err']} > {atol}")

    cfg = FskModem("1200", device="cpu").cfg
    for name, shape in (("B=4 x 4096 bits", (4, 4096)),
                        ("one 64.3 s stream (77824 bits)", (1, 77824))):
        bits = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.uint8))
        got = device_synthesize(bits.to(dev), cfg).cpu().numpy()
        row(f"device_synthesize {name}", got,
            device_synthesize(bits, cfg).numpy(), 2.0 ** -23)
    rcfg = FskModem("rtty", device="cpu").cfg
    bits = torch.from_numpy(rng.integers(0, 2, (3, 512, 5), dtype=np.uint8))
    nf = torch.tensor([512, 300, 0], dtype=torch.int32)
    got = device_synthesize_frames(bits.to(dev), nf.to(dev), rcfg, 2,
                                   2).cpu().numpy()
    row("device_synthesize_frames rtty [3, 512, 5]", got,
        device_synthesize_frames(bits, nf, rcfg, 2, 2).numpy(),
        turns_atol(max(frame_synth_params(rcfg)["seg_len"]), rcfg))
    payload = bytes(33 + i % 94 for i in range(600))
    for lut in (4096, 16, 0):
        for fmt in (SampleFormat.S16, SampleFormat.FLOAT):
            outs = []
            for backend, d in (("jax", dev), ("numpy", "cpu")):
                tx = Transmitter(cfg, TxOptions(sin_table_len=lut),
                                 Ascii8Codec(), fmt, backend, d)
                for b in payload:
                    tx.send(b)
                tx.finish()
                outs.append(tx.drain(None))
            if outs[0].dtype != outs[1].dtype:
                fail(f"device TX LUT {lut} {fmt.name}: dtype differs")
            row(f"--synth-backend jax LUT {lut} {fmt.name} vs numpy",
                outs[0], outs[1],
                0.0 if lut else (1.0 if fmt is SampleFormat.S16
                                 else 2.0 ** -24))
    return rows


K4_FRAME_MODES = ("rtty", "tdd", "1200 --stopbits 1.5")
# K4's kernels, by the name each has in csrc/tx_synth.cu
K4_KERNELS = ("tx_synth_prefix_kernel", "tx_synth_bits_kernel",
              "tx_synth_frames_prep_kernel", "tx_synth_frames_kernel")
# results a clock an SM of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): float32 add / multiply / FMA;
# float64; integer, logic, compare, select and move; conversions, MUFU,
# popc, frnd; and the issue slots (4 schedulers of one warp instruction)
PIPE_RATES = {"fp32": 128, "fp64": 64, "alu": 64, "quarter": 16,
              "issue": 128}
_SASS_FP64 = {"DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET"}
_SASS_QUARTER = {"F2F", "F2I", "I2F", "FRND", "MUFU", "POPC", "FLO", "BREV"}
_SASS_FP32 = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"}
_SASS_CONTROL = {"BRA", "BAR", "EXIT", "BSSY", "BSYNC", "CALL", "RET",
                 "WARPSYNC", "NOP", "BPT", "YIELD", "JMP", "BREAK", "RPCMOV"}
_STG_BYTES = {"128": 16, "64": 8, "U8": 1, "S8": 1, "U16": 2, "S16": 2}


def sass_functions(sass: str) -> dict:
    """cuobjdump -sass text -> {function name: [(address, opcode,
    modifiers, branch target address or None)]}, one an instruction."""
    import re

    funcs, cur = {}, None
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = ins.search(line) if cur is not None else None
        if m:
            t = re.match(r"\s*(0x[0-9a-f]+)", m.group(4))
            cur.append((int(m.group(1), 16), m.group(2), m.group(3),
                        int(t.group(1), 16) if t and m.group(2) == "BRA"
                        else None))
    return funcs


def sass_class(op: str) -> str:
    if op in _SASS_FP64:
        return "fp64"
    if op in _SASS_QUARTER:
        return "quarter"
    if op in _SASS_FP32:
        return "fp32"
    if op == "STG":
        return "stg"
    if op.startswith(("LD", "ST", "ATOM", "RED", "UBLKCP", "SYNCS")):
        return "mem"
    if op in _SASS_CONTROL:
        return "control"
    if op.startswith("U") or op in ("S2UR", "R2UR"):
        return "uniform"
    return "alu"


def sample_loop_census(code) -> dict:
    """The per-sample census of one kernel's SASS: the loop that stores
    the samples on the main path (of the regions a backward branch
    closes that hold an STG, the first by: a 16-byte STG in it, a float64
    operation in it, the fewest instructions), its instructions by class
    divided by the samples one pass stores (its STG bytes / 4).  Static
    counts: a branch not taken in the loop counts as if it were."""
    at = {e[0]: i for i, e in enumerate(code)}
    best = None
    for j, (_, op, _, tgt) in enumerate(code):
        if op != "BRA" or tgt not in at or at[tgt] > j:
            continue
        body = code[at[tgt]:j + 1]
        stg = sum(_STG_BYTES.get(next((w for w in mods.split(".")
                                       if w in _STG_BYTES), ""), 4)
                  for _, o, mods, _ in body if o == "STG")
        key = (any(o == "STG" and ".128" in m for _, o, m, _ in body),
               any(sass_class(o) == "fp64" for _, o, _, _ in body),
               -len(body))
        if stg and (best is None or key > best[0]):
            best = (key, body, stg)
    if best is None:
        return {}
    _, body, stg = best
    per = stg / 4
    cls = {}
    for _, op, _, _ in body:
        if op != "NOP":
            c = sass_class(op)
            cls[c] = cls.get(c, 0) + 1
    out = {c: n / per for c, n in sorted(cls.items())}
    out["issue"] = sum(cls.values()) / per
    out["samples_a_pass"] = per
    return out


def k4_census() -> dict:
    """K4's kernels as built: SASS of the loaded kernel library
    (cuobjdump -sass), the per-sample census of each kernel's sample loop
    (sample_loop_census), and the registers nvcc -Xptxas -v reports for
    csrc/tx_synth.cu at the library's flags.  -> {kernel: {...}}, plus
    "clock_mhz" / "sms" for the pipe floors."""
    import re

    import torch
    from minimodem_tpu_torch.ops import _kernels

    nvcc = _kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    lib = _kernels.load()._name
    res = {}
    r = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                       text=True, timeout=300)
    funcs = sass_functions(r.stdout) if r.returncode == 0 else {}
    with tempfile.TemporaryDirectory() as tmp:
        v = subprocess.run(
            [nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "k4.o"), str(_kernels.SRC_DIR / "tx_synth.cu")],
            capture_output=True, text=True, timeout=300)
    regs, cur = {}, None
    for line in (v.stdout + v.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    for k in K4_KERNELS:
        name = next((f for f in funcs if k + "E" in f or f.endswith(k)), None)
        reg = next((n for f, n in regs.items() if k + "E" in f), None)
        c = sample_loop_census(funcs[name]) if name else {}
        res[k] = {"registers": reg, "sass_lines": len(funcs.get(name, [])),
                  "per_sample": c}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    clk = [float(x) for x in smi.stdout.strip().splitlines()[0].split(",")]
    res["clock_mhz"], res["clock_now_mhz"] = clk
    res["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    res["cuobjdump"] = r.returncode == 0
    return res


def pipe_floors(per_sample: dict, n_samples: int, census: dict) -> dict:
    """Each pipe's least time (ms) for n_samples at the per-sample counts,
    the card's SM count and top clock."""
    hz = census["sms"] * census["clock_mhz"] * 1e6
    return {p: n_samples * per_sample.get(p, 0.0) / (rate * hz) * 1e3
            for p, rate in PIPE_RATES.items()}


def floors_text(floors: dict) -> str:
    return ", ".join(f"{p} {ms:.4f} ms" for p, ms in floors.items())


def census_line(census: dict, kernel: str) -> str:
    c = census[kernel]
    ps = c["per_sample"]
    if not ps:
        return f"{kernel}: {c['registers']} registers, no sample loop"
    return (f"{kernel}: {c['registers']} registers; per word stored: "
            + ", ".join(f"{k} {ps.get(k, 0.0):.2f}" for k in (
                "fp64", "quarter", "fp32", "alu", "uniform", "mem", "stg",
                "control", "issue"))
            + f" ({ps['samples_a_pass']:g} words a pass of its loop)")


def k4_check(dev, head) -> dict:
    """K4 (csrc/tx_synth.cu, TxSynth) against its plain route
    (synth_bits_plain / synth_frames_plain) on the same inputs on the
    card, each buffer filled with NaN first so that every sample must be
    written: flat mode bit for bit at B = 4 x 4096 bits, at one 64.3 s
    stream and at the whole headline buffer (the loopback's build_loop on
    the B = 128 headline schedules, zero tail and halo included); frames
    mode (rtty, tdd, Bell-202 with 1.5 stop bits, n_frames F_pad, partial
    and 0) within turns_atol; and each against the plain route on the CPU
    with its count of differing samples.  Then K4 timed at the headline
    buffer: per call (CUDA events), its kernels alone (torch.profiler),
    the plain route, and the bound.  -> {"rows", "head"}."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback, _sched_pad
    from minimodem_tpu_torch.ops.tx_device import (
        TxSynth, frame_synth_params, frames_len, synth_bits_plain,
        synth_frames_plain)

    rng = np.random.default_rng(SEED + 4)
    rows = []

    def row(name, got, ref, atol, exact=False):
        """exact: every word equal, whatever atol allows."""
        diff = (got.double() - ref.to(got.device).double()).abs()
        r = {"name": name, "max_abs_err": float(diff.max()),
             "differ": int(torch.count_nonzero(diff)), "n": diff.numel(),
             "words": int(torch.count_nonzero(
                 got.view(torch.int32) != ref.to(got.device).view(
                     torch.int32))),
             "atol": atol, "exact": exact or atol == 0.0}
        del diff
        rows.append(r)
        if r["max_abs_err"] > atol or (r["exact"] and r["words"]):
            fail(f"K4 {name}: max_abs_err {r['max_abs_err']}, "
                 f"{r['words']} bit-different words (tolerance {atol}"
                 f"{', every word required equal' if r['exact'] else ''})")

    def nan_buffer(b, width):
        return torch.full((b, width), float("nan"), device=dev)

    cfg = FskModem("1200", device="cpu").cfg
    synth = TxSynth(cfg)
    # widths off the 16-byte grid (rows past the first start off it) and
    # 8192-sample tiles that end inside a bit (40, 160 and 1056 samples)
    for mode, (b, n_bits) in (("1200", (4, 4096)), ("1200", (1, 77824)),
                              ("300", (3, 1536)), ("tdd", (2, 520))):
        mcfg = FskModem(mode, device="cpu").cfg
        name = f"{mode} B={b} x {n_bits} bits"
        packed = torch.from_numpy(np.packbits(
            rng.integers(0, 2, (b, n_bits), dtype=np.uint8), axis=1,
            bitorder="little"))
        width = n_bits * mcfg.bit_nsamples_tx + 7001
        got = TxSynth(mcfg).bits(packed.to(dev), width,
                                 out=nan_buffer(b, width))
        row(f"flat {name} [{b}, {width}] vs plain on the card", got,
            synth_bits_plain(packed.to(dev), mcfg, width), 0.0)
        row(f"flat {name} vs plain on the CPU", got,
            synth_bits_plain(packed, mcfg, width), 2.0 ** -23)
    for mode in K4_FRAME_MODES:
        fcfg = FskModem(mode.split()[0], device="cpu").cfg
        if "stopbits" in mode:
            fcfg.nstopbits = np.float32(1.5)
            fcfg.finalize()
        n_pad = 512
        bits = torch.from_numpy(rng.integers(
            0, 2, (3, n_pad, fcfg.n_data_bits), dtype=np.uint8))
        nf = torch.tensor([n_pad, 300, 0], dtype=torch.int32)
        width = frames_len(fcfg, n_pad, (2, 2)) + 5003
        atol = turns_atol(max(frame_synth_params(fcfg)["seg_len"]), fcfg)
        got = TxSynth(fcfg).frames(bits.to(dev), nf.to(dev), (2, 2), width,
                                   out=nan_buffer(3, width))
        row(f"frames {mode} [3, {n_pad}, {fcfg.n_data_bits}] (n_frames "
            f"{nf.tolist()}) vs plain on the card", got,
            synth_frames_plain(bits.to(dev), nf.to(dev), fcfg, (2, 2),
                               width), atol)
        row(f"frames {mode} vs plain on the CPU", got,
            synth_frames_plain(bits, nf, fcfg, (2, 2), width), atol,
            exact=True)
        del got
    # the headline buffer, as the loopback's build_loop makes it
    lb = DeviceLoopback(cfg, device=dev)
    b_pad = _sched_pad(max(len(s) for s in head))
    bits = np.zeros((len(head), b_pad), np.uint8)
    for i, sch in enumerate(head):
        bits[i, :len(sch)] = sch
    packed = torch.from_numpy(np.packbits(bits, axis=1,
                                          bitorder="little")).to(dev)
    loop = lb.build_loop(b_pad)
    width = loop.t_total + lb.halo
    got = synth.bits(packed, width, out=nan_buffer(len(head), width))
    row(f"flat, the headline buffer [{len(head)}, {width}] vs plain on the "
        f"card (zero tail from sample {b_pad * lb.bit_ns})", got,
        loop.synthesize_plain(packed), 0.0)
    del got
    torch.cuda.empty_cache()
    n_samples = len(head) * b_pad * lb.bit_ns
    # K4's two kernels alone: torch.profiler (a window that missed some
    # of them profiled again), and CUDA events behind a sleeping kernel
    seen = []
    for tries in range(1, PROFILE_TRIES + 1):
        kernel_ms, kernels = device_ms_per_call(
            lambda: loop.synthesize(packed), 5)
        seen.append(kernels)
        if kernels == 2:
            break
    else:
        kernel_ms = None
    res = {"shape": f"{list(packed.shape)} -> [{len(head)}, {width}]",
           "ms": cuda_ms(lambda: loop.synthesize(packed), 5),
           "kernel_ms": kernel_ms, "profile_tries": tries,
           "profile_seen": seen,
           "queued_ms": queued_ms(lambda: loop.synthesize(packed), 20),
           "plain_ms": cuda_ms(lambda: loop.synthesize_plain(packed), 1),
           "loaded_mhz": loaded_clock_mhz(lambda: loop.synthesize(packed)),
           "bytes": packed.numel() + 4 * len(head) * width,
           # float32 operations a sample: the FMA (2), floor, subtract
           # and two multiplies; the float64 sine beside them
           "flop": 6 * n_samples, "sines": n_samples}
    res["bound"] = bound(res["bytes"], res["flop"])
    del lb, loop, packed
    torch.cuda.empty_cache()
    return {"rows": rows, "head": res, "frames": k4_frames_times(dev),
            "sine": k4_sine_check(dev)}


def loaded_clock_mhz(fn, reps: int = 400) -> float:
    """The card's SM clock (nvidia-smi clocks.sm) read while reps calls
    of fn() queued behind a sleeping kernel run."""
    import torch

    torch.cuda._sleep(20_000_000)
    for _ in range(reps):
        fn()
    time.sleep(0.05)
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return float(r.stdout.strip().splitlines()[0])


# every float32 in [0, 1): the bit patterns 0x00000000 to 0x3F7FFFFF
SINE_TOP = 0x3F7FFFFF


def k4_sine_check(dev) -> dict:
    """K4's sine (sin_2pi in csrc/tx_synth.cu) against CUDA's float64 sin
    rounded to float32 on every float32 fraction of a turn in [0, 1),
    1,065,353,216 inputs (ops/tx_device.py sin_check), timed with CUDA
    events; any input whose result differs in a bit fails the run."""
    import torch
    from minimodem_tpu_torch.ops.tx_device import sin_check

    sin_check(0, 1 << 20, 1, dev)                       # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    bad, first = sin_check(0, SINE_TOP, 1, dev)
    end.record()
    torch.cuda.synchronize()
    r = {"inputs": SINE_TOP + 1, "mismatches": bad, "first": first,
         "ms": start.elapsed_time(end)}
    if bad:
        fail(f"K4's sine differs from CUDA's sin on {bad} of "
             f"{r['inputs']} inputs, the first at "
             f"{first:#010x}")
    return r


def k4_frames_times(dev) -> list:
    """K4's frames entry timed at the frame-schedule bench row's shape
    (bench.mode_loopback_throughput: B = 8 streams of a 15 s payload, the
    frames padded to a multiple of 512, the loopback's buffer) for rtty,
    tdd and Bell-202 with 1.5 stop bits: alone (torch.profiler, its two
    kernels), queued behind a sleep and per call (CUDA events), the plain
    route on the card, and the bound (the buffer written once, the frame
    bits read once).  -> rows."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.bench import _mode_payload
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import tx_frame_schedule

    rows = []
    for mode in K4_FRAME_MODES:
        m = FskModem(mode.split()[0], device="cpu")
        if "stopbits" in mode:
            m.cfg.nstopbits = np.float32(1.5)
            m.cfg.finalize()
        enc = (get_codec(m.preset.encoder) if m.preset.encoder != "baudot"
               else get_codec("baudot", usos=True))
        fb, lead, trail = tx_frame_schedule(_mode_payload(m, 15.0), m.cfg,
                                            enc)
        b, f_real = 8, fb.shape[0]
        f_pad = -(-f_real // 512) * 512
        bits = np.zeros((b, f_pad, m.cfg.n_data_bits), np.uint8)
        bits[:, :f_real] = fb
        bits = torch.from_numpy(bits).to(dev)
        nf = torch.full((b,), f_real, dtype=torch.int32, device=dev)
        lb = DeviceLoopback(m.cfg, device=dev)
        loop = lb.build_loop(f_pad, True, (lead, trail))
        width = loop.t_total + lb.halo
        run = lambda: loop.synthesize(bits, nf)        # noqa: E731
        seen = []
        for tries in range(1, PROFILE_TRIES + 1):
            kernel_ms, kernels = device_ms_per_call(run, 5)
            seen.append(kernels)
            if kernels == 2:
                break
        else:
            kernel_ms = None
        n = b * (loop.t_total)
        r = {"mode": mode, "shape": f"[{b}, {f_pad}, {m.cfg.n_data_bits}] "
             f"(n_frames {f_real}) -> [{b}, {width}]",
             "kernel_ms": kernel_ms, "profile_tries": tries,
             "profile_seen": seen,
             "queued_ms": queued_ms(run, 20), "ms": cuda_ms(run, 5),
             "plain_ms": cuda_ms(lambda: loop.synthesize_plain(bits, nf), 1),
             "bytes": bits.numel() + 4 * nf.numel() + 4 * b * width,
             "flop": 6 * n, "samples": n}
        r["bound"] = bound(r["bytes"], r["flop"])
        rows.append(r)
        del bits, lb, loop
        torch.cuda.empty_cache()
    return rows


def events_close(got, ref) -> bool:
    """Event types, integer lanes and bytes equal; NOCARRIER confidence
    and amplitude totals within RTOL / ATOL."""
    import numpy as np

    if len(got) != len(ref):
        return False
    for (tt, tp, tb), (rt, rp, rb) in zip(got, ref):
        if not (np.array_equal(tt, rt) and np.array_equal(tb, rb)):
            return False
        nc = tt == 2
        if not (np.array_equal(tp[:, [0, 3, 4, 5]], rp[:, [0, 3, 4, 5]])
                and np.array_equal(tp[~nc], rp[~nc])):
            return False
        if not np.allclose(tp[nc][:, 1:3].view(np.float32),
                           rp[nc][:, 1:3].view(np.float32),
                           rtol=RTOL, atol=ATOL):
            return False
    return True


def loopback_cuda_vs_cpu(dev) -> list:
    """DeviceLoopback on the card against device="cpu" (the kernels' plain
    versions), two streams, flat (1200, SAME; 300 bytes) and frames mode
    (Bell-202 with 1.5 stop bits; 120 bytes, a length the receiver decodes
    clean at that framing, as the JAX package's does): event for event,
    each stream decoding its payload.  -> rows."""
    import numpy as np
    from minimodem_tpu_torch.bench import _render_ok
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.ops.tx_device import (
        tx_bit_schedule, tx_frame_schedule)

    rows = []
    for mode in ("1200", "same", "1200 --stopbits 1.5"):
        cfg = FskModem(mode.split()[0], device="cpu").cfg
        n = 300
        if "stopbits" in mode:
            cfg.nstopbits = np.float32(1.5)
            cfg.finalize()
            n = 120
        texts = [bytes(33 + (i * 7 + 13 * j) % 94 for i in range(n))
                 for j in range(2)]
        runs = []
        for d in (dev, "cpu"):
            lb = DeviceLoopback(cfg, device=d)
            if "stopbits" in mode:
                sch = [tx_frame_schedule(t, cfg, Ascii8Codec()) for t in texts]
                runs.append(lb.run_events_frames_batch(
                    [s[0] for s in sch], sch[0][1:]))
            else:
                runs.append(lb.run_events_batch(
                    [tx_bit_schedule(t, cfg, Ascii8Codec()) for t in texts]))
        r = {"mode": mode, "same": events_close(runs[0], runs[1]),
             "exact": _render_ok(cfg, "ascii8", texts, runs[0]),
             "events": [e[0].tolist() for e in runs[0]]}
        rows.append(r)
        if not (r["same"] and r["exact"]):
            fail(f"loopback {mode}: cuda == cpu {r['same']}, decode exact "
                 f"{r['exact']}")
    return rows


def headline_sets(cfg, batch: int, pipeline: int, audio_seconds: float):
    """The batched bench row's payloads and bit schedules (distinct per
    stream and per pipelined batch; bench.batched_loopback_throughput
    makes the same ones)."""
    from minimodem_tpu_torch.bench import _bench_payload
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule

    base = _bench_payload(cfg, audio_seconds)
    sets = []
    for j in range(pipeline):
        payloads = [bytes((b + i + 7 * j) % 94 + 33 for b in base)
                    for i in range(batch)]
        sets.append((payloads, [tx_bit_schedule(p, cfg, Ascii8Codec())
                                for p in payloads]))
    return sets


def loopback_kernels(lb, scheds, dev) -> dict:
    """K1 and K2 at the loopback's shape (the B = 128 headline batch,
    synthesized on the card): K1's planes bit for bit against its plain
    version (eight rows at a time), K2's events, bytes and carry against
    its plain version on a CPU copy of every stream; times per call (CUDA
    events; stage_split has them alone), plain times, and the inputs'
    bytes for the bounds."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.device_rx import (
        _sched_pad, geo_from_key, make_score_packer_planes)
    from minimodem_tpu_torch.ops.fused_score import score_planes_plain
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaRx, MegaStatics, mega_rx_plain)

    b = len(scheds)
    b_pad = _sched_pad(max(len(s) for s in scheds))
    bits = np.zeros((b, b_pad), np.uint8)
    for i, s in enumerate(scheds):
        bits[i, :len(s)] = s
    loop = lb.build_loop(b_pad)
    t_total = loop.t_total
    x = loop.synthesize(torch.from_numpy(
        np.packbits(bits, axis=1, bitorder="little")).to(dev))
    packer, n_planes = make_score_packer_planes(lb.key, t_total, "float32")
    planes = packer(x)
    geo = geo_from_key(lb.key)
    words = 0
    plain_ms = 0.0
    for r in range(0, b, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = score_planes_plain(x[r:r + 8], geo, t_total)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        words += int(torch.count_nonzero(p != planes[r:r + 8]))
        del p
    if words:
        fail(f"K1 at the loopback's shape: {words} bit-different words")
    totals = torch.tensor([len(s) * lb.bit_ns for s in scheds],
                          dtype=torch.int32, device=dev)
    mega = MegaRx(MegaStatics.build(lb.key, t_total, False))
    ci = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    cf = torch.zeros((b, 4), dtype=torch.float32, device=dev)
    thr = (1.5, 2.3)
    tp0 = time.perf_counter()
    same, out_k, _ = k2_compare(mega, planes, totals, thr, ci, cf, True)
    k2_plain_ms = (time.perf_counter() - tp0) * 1e3   # incl. the plain copy
    if not same:
        fail("K2 at the loopback's shape disagrees with its plain version")
    res = {
        "shape_k1": f"{list(x.shape)} -> {list(planes.shape)}",
        "shape_k2": f"{list(planes.shape)}, {b} streams",
        "k1_ms": cuda_ms(lambda: packer(x), 3),
        "k1_plain_ms": plain_ms,
        "k1_bytes": 4 * (x.numel() + planes.numel()),
        "k1_flop": 2 * 4 * geo.nb * t_total * b,
        "k2_ms": cuda_ms(lambda: mega(planes, totals, thr, ci, cf, True), 3),
        "k2_plain_ms": k2_plain_ms,
        "k2_bytes": 4 * mega_rx_plain.words + 32 * int(out_k[1].sum())
        + int(out_k[3].sum()) + 48 * b,
        "k2_searches": mega_rx_plain.searches.copy(),
        "k1_words": words, "k2_same": same,
    }
    del x, planes, out_k
    torch.cuda.empty_cache()
    return res


STAGES = (("K1", "fused_score_kernel"), ("K2", "mega_rx_kernel"),
          ("K4 synthesis", "tx_synth_"), ("upload", "Memcpy HtoD"),
          ("collect", "Memcpy DtoH"))


# profiled windows tried before a stage split or a kernel's time alone is
# given up: on the card torch.profiler now and then drops the device
# records of a whole window, or some of them (seen on an H100 late in
# this script's run)
PROFILE_TRIES = 5

# the stage split in a child process of its own: late in this script's
# run, after the live and soak phases, torch.profiler on an H100 records
# no device activity at all in one to five windows in a row, while a
# fresh process records every one
STAGE_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
print(json.dumps(chip_smoke.stage_split_main()))
"""


def stage_split_main() -> dict:
    """stage_split of the headline batch (B = HEAD_BATCH x HEAD_SECONDS
    of Bell-202 on a DeviceLoopback of its own), for STAGE_CHILD."""
    import torch
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    cfg = FskModem("1200", device="cpu").cfg
    head = headline_sets(cfg, HEAD_BATCH, 1, HEAD_SECONDS)[0][1]
    return stage_split(DeviceLoopback(cfg, device=torch.device("cuda", 0)),
                       head)


def stage_split(lb, scheds) -> dict:
    """One warm synchronous batch under torch.profiler: device time by
    stage (K1, K2, K4's kernels, the bit upload, the result copies; every
    other device kernel or copy is "other": the carry's zero fills), the
    device busy and idle share of the call's wall, and how long the host
    took to dispatch the batch (dispatch returns without waiting).  A
    window whose records miss any of the batch's K1, K2 and K4 kernels
    (by the launch counts) is profiled again, up to PROFILE_TRIES times;
    "tries" says how many it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lb.run_events_batch(scheds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = lb.dispatch_events_batch(scheds)
    t_disp_plain = time.perf_counter() - t0
    lb.collect_events_batch(h)
    wall_plain = time.perf_counter() - t0
    missed = []
    for tries in range(1, PROFILE_TRIES + 1):
        counts = reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            h = lb.dispatch_events_batch(scheds)
            t_disp = time.perf_counter() - t0
            lb.collect_events_batch(h)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lc = read_counts(counts)
        # K4 launches two kernels a call (the prefix, the samples)
        want = {"K1": lc["fused_score"], "K2": lc["mega_rx"],
                "K4 synthesis": 2 * lc["tx_synth"]}
        split = {name: 0.0 for name, _ in STAGES}
        split["other"] = 0.0
        got = dict.fromkeys(want, 0)
        for e in prof.key_averages():
            if (getattr(e, "device_type", None)
                    != torch.autograd.DeviceType.CUDA):
                continue
            ms = getattr(e, "self_device_time_total", 0) / 1e3
            if ms <= 0:
                continue
            name = next((n for n, k in STAGES if k in e.key), "other")
            split[name] += ms
            if name in got:
                got[name] += e.count
        if got == want:
            break
        missed.append({"got": got, "want": want, "rows": [
            (e.key[:48], str(getattr(e, "device_type", "")), e.count)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]})
    else:
        fail(f"torch.profiler missed kernels of the stage split in "
             f"{PROFILE_TRIES} windows: {missed}")
    busy = sum(split.values())
    return {"split": split, "busy_ms": busy, "wall_ms": wall * 1e3,
            "dispatch_ms": t_disp * 1e3, "wall_plain_ms": wall_plain * 1e3,
            "dispatch_plain_ms": t_disp_plain * 1e3, "tries": tries,
            "missed": missed}


# ======================================================================
# 18-19. the fleet service (parallel/)
# ======================================================================

INGEST_BATCH, INGEST_SECONDS = 8, 30.0      # the root bench.py's fleet ingest
STEP_BATCH, STEP_LEN = 16, 1 << 21
DECOMP_BYTES = 3600                         # ~30 s of Bell-202 a stream


def cpu_modem(mode: str = "1200"):
    from minimodem_tpu_torch.models.modem import FskModem

    return FskModem(mode, device="cpu")


def best_walls(fns, reps: int) -> list:
    """Each fn's best wall in seconds over reps rounds, the fns run in
    turns within a round."""
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def same_events(a, b) -> bool:
    """Every part of every stream's event tuple equal."""
    import numpy as np

    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
        for x, y in zip(a, b))


@contextlib.contextmanager
def last_inputs():
    """While the block runs, record the arguments of each kernel's last
    launch on the card, by wrapper (K1, K2, K3 one-row / rows, K4's flat
    and frames entries, K5), so that each kernel can be held against its
    plain version at the shapes the path gave it once the path's counts
    are read (hold_last).
    -> {kernel name: (wrapper, its bound arguments)}."""
    import inspect

    from minimodem_tpu_torch.ops.correlate import Correlator
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels
    from minimodem_tpu_torch.ops.fused_score import FusedScorer
    from minimodem_tpu_torch.ops.mega_rx import MegaRx
    from minimodem_tpu_torch.ops.tx_device import TxSynth

    seen, olds = {}, {}

    def wrap(cls, name_of, method="__call__"):
        old = olds[cls, method] = getattr(cls, method)
        sig = inspect.signature(old)

        def call(self, x, *a, **k):
            if x.device.type == "cuda":
                args = sig.bind(self, x, *a, **k).arguments
                seen[name_of(x)] = (self, {n: v for n, v in args.items()
                                           if n not in ("self", "out")})
            return old(self, x, *a, **k)

        setattr(cls, method, call)

    wrap(FusedScorer, lambda x: "fused_score")
    wrap(MegaRx, lambda x: "mega_rx")
    wrap(Correlator, lambda x: ("correlate" if x.shape[0] == 1
                                else "correlate_batch"))
    wrap(TxSynth, lambda x: "tx_synth", "bits")
    wrap(TxSynth, lambda x: "tx_synth_frames", "frames")
    wrap(FrameChannels, lambda x: "frame_channels")
    try:
        yield seen
    finally:
        for (cls, method), old in olds.items():
            setattr(cls, method, old)


def hold_last(seen) -> dict:
    """Each kernel of `seen` (last_inputs) launched again on its recorded
    inputs and held against its plain version on the same inputs on the
    card: K1 and K3 bit for bit (bit-different words; K3's max_abs_err),
    K2's events, bytes and carry identical (k2_compare, the plain version
    on a CPU copy), K4 as hold_tx_synth says, K5 as hold_frame_channels
    says.  Call it after the path's
    counts are read: these launches are not the path's.
    -> {name: {"shape", "ok", ...}}."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.correlate import correlate_plain
    from minimodem_tpu_torch.ops.fused_score import score_planes_plain

    out = {}
    for name, (w, a) in sorted(seen.items()):
        if name.startswith("tx_synth"):
            out[name] = hold_tx_synth(name, w, a)
            continue
        if name == "frame_channels":
            out[name] = hold_frame_channels(w, a)
            continue
        if name == "mega_rx":
            planes = a["planes"]
            same = k2_compare(w, planes, a["totals"], a["thr"], a["carry_i"],
                              a["carry_f"], a["finalize"])[0]
            out[name] = {"shape": list(planes.shape), "ok": bool(same)}
            continue
        x = a["x"]
        if name == "fused_score":
            k, p = w(x, a["t_len"]), score_planes_plain(x, w.geo, a["t_len"])
        else:
            k = w(x, a["s_len"])
            p = correlate_plain(x, w.basis(x.device), a["s_len"])
        words = int(torch.count_nonzero(k.view(torch.int32)
                                        != p.view(torch.int32)))
        r = {"shape": f"{list(x.shape)} -> {list(k.shape)}",
             "words": words, "ok": words == 0}
        if name != "fused_score":
            r["max_abs_err"] = float((k.double() - p.double()).abs().max())
        out[name] = r
        del k, p
    torch.cuda.empty_cache()
    return out


def hold_tx_synth(name: str, w, a: dict) -> dict:
    """K4 launched again on a path's recorded inputs against its plain
    route on the same inputs on the card: flat mode bit for bit (every
    word of the buffer, zero tail and halo included), frames mode within
    turns_atol (with the count of differing words)."""
    import torch
    from minimodem_tpu_torch.ops.tx_device import (
        frame_synth_params, synth_bits_plain, synth_frames_plain)

    width = a["width"]
    if name == "tx_synth":
        x = a["packed"]
        k = w.bits(x, width)
        p = synth_bits_plain(x, w.cfg, width, w.amp)
        atol = 0.0
    else:
        x = a["frame_bits"]
        k = w.frames(x, a["n_frames"], a["lead_trail"], width)
        p = synth_frames_plain(x, a["n_frames"], w.cfg, a["lead_trail"],
                               width, w.amp)
        atol = turns_atol(max(frame_synth_params(w.cfg)["seg_len"]), w.cfg)
    words = int(torch.count_nonzero(k.view(torch.int32)
                                    != p.view(torch.int32)))
    err = float((k.double() - p.double()).abs().max())
    del k, p
    torch.cuda.empty_cache()
    return {"shape": f"{list(x.shape)} -> [{x.shape[0]}, {width}]",
            "words": words, "max_abs_err": err,
            "ok": words == 0 if atol == 0.0 else err <= atol}


def k5_against_plain(w, corr, n: int, rows) -> dict:
    """K5 (FrameChannels w) on corr against the plain
    score_frame_channels on the same correlation on the card: every word
    of the rows, NaN and inf included (bit-different words; max_abs_err
    over the finite float channels; the frame bits' marks, for the
    bound)."""
    import torch
    from minimodem_tpu_torch.ops.demod import score_frame_channels

    out = torch.full((corr.shape[0], len(rows), n), -7, dtype=torch.int32,
                     device=corr.device)
    w(corr, n, out, rows)
    ch = score_frame_channels(corr, w.geo, n)
    p = torch.stack([ch[r].view(torch.int32) for r in rows], dim=1)
    words = int(torch.count_nonzero(out != p))
    fl = [i for i, r in enumerate(rows) if not r.startswith("bits")]
    kf, pf = out[:, fl].view(torch.float32), p[:, fl].view(torch.float32)
    fin = kf.isfinite() & pf.isfinite()
    err = float((kf[fin].double() - pf[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    marks = popcount_sum(ch["bits_lo"]) + popcount_sum(ch["bits_hi"])
    del out, ch, p, kf, pf, fin
    return {"shape": f"{list(corr.shape)} -> [{corr.shape[0]}, "
                     f"{len(rows)}, {n}]",
            "words": words, "max_abs_err": err, "marks": marks,
            "ok": words == 0}


def hold_frame_channels(w, a: dict) -> dict:
    """K5 launched again on a path's recorded correlation against the
    plain score_frame_channels (k5_against_plain)."""
    import torch
    from minimodem_tpu_torch.ops.demod import CHANNELS

    r = k5_against_plain(w, a["corr"], a["n"], a.get("rows", CHANNELS))
    del r["marks"]
    torch.cuda.empty_cache()
    return r


def popcount_sum(t) -> int:
    """The set bits of an int32 tensor's words, summed."""
    import torch

    v = t.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return int((((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def k5_bound(geo, batch: int, n: int, n_rows: int, elem: int,
             marks: int):
    """K5's least time for one call: the correlation read once (4 rows of
    n + max_begin offsets of elem bytes) and the rows written once,
    against its float operations: 10 an offset for the magnitudes (two
    squares, a sum, a square root and a scaling a band), 5 a tap and
    offset for the comb sums and the divergence (two sums; a difference,
    a division and a sum), one a mark, 10 an offset for the averages,
    the SNR, conf and ampl.  -> (ms, what sets it, bytes, operations)."""
    s_cnt = n + geo.max_begin
    n_bytes = batch * (4 * s_cnt * elem + 4 * n_rows * n)
    flop = (10 * batch * s_cnt + (5 * geo.n_bits + 10) * batch * n
            + marks)
    t, by = bound(n_bytes, flop)
    return t, by, n_bytes, flop


K5_KERNELS = ("magnitudes_kernel", "channels_kernel")


def k5_split(geo, x, t_len: int, rows) -> dict:
    """One scorer call's two stages at its shape, on the card: stage 1
    (correlator_for, the route the geometry takes) on x [B, t_len + halo]
    and K5 on its correlation into `rows`, each timed (CUDA events a
    call; K5 also queued behind a sleep and alone by torch.profiler),
    beside the plain channels on the same correlation (the eager PyTorch
    chain K5 replaces); K5 held against it bit for bit; K5's bound."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.demod import (
        correlator_for, make_basis, score_frame_channels)
    from minimodem_tpu_torch.ops.frame_channels import FrameChannels

    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    s_len = t_len + geo.max_begin
    corr = stage1(x, s_len)
    fc = FrameChannels(geo)
    r = k5_against_plain(fc, corr, t_len, rows)
    out = torch.empty((x.shape[0], len(rows), t_len), dtype=torch.int32,
                      device=x.device)

    def k5():
        fc(corr, t_len, out, rows)

    r["stage1_ms"] = cuda_ms(lambda: stage1(x, s_len), 5)
    r["ms"] = cuda_ms(k5, 10)
    r["queued_ms"] = queued_ms(k5, 10)
    # each kernel's mean over the launches the profiler recorded (a window
    # can miss some records)
    alone = [kernel_device_ms(k5, 10, k) for k in K5_KERNELS]
    r["kernel_ms"] = None if None in alone else sum(alone)
    r["plain_ms"] = cuda_ms(lambda: score_frame_channels(corr, geo, t_len),
                            2)
    r["bound"] = k5_bound(geo, x.shape[0], t_len, len(rows),
                          corr.element_size(), r.pop("marks"))
    del corr, out
    torch.cuda.empty_cache()
    return r


def k5_split_line(r: dict) -> str:
    """k5_split's numbers, one clause."""
    t, by, n_bytes, flop = r["bound"]
    return (f"stage 1 {r['stage1_ms']:.4f} ms, K5 {r['ms']:.4f} ms per "
            f"call ({fmt_ms(r['kernel_ms'])} alone, its two kernels by "
            f"torch.profiler; {r['queued_ms']:.4f} ms queued behind a "
            f"sleep), the plain channels "
            f"{r['plain_ms']:.3f} ms; K5 bound {t:.4f} ms ({by}: "
            f"{n_bytes / 1e6:.1f} MB, {flop / 1e6:.1f} MFLOP); K5 == plain "
            f"at {r['shape']}: {r['words']} bit-different words")


def held_line(held: dict) -> str:
    """hold_last's results, one clause a kernel."""
    return "; ".join(
        f"{n} at {r['shape']} == plain {r['ok']}"
        + (f" ({r['words']} bit-different words"
           + (f", max_abs_err {r['max_abs_err']}" if "max_abs_err" in r
              else "") + ")" if "words" in r else "")
        for n, r in held.items())


def fleet_phase(cfg, audio, dev) -> dict:
    """Phase 18: the fleet at world size 1 on NCCL (a localhost store),
    through the entry points a user calls: the two fleet bench rows at
    their full size and sharded_decode_step on 16 and on 1 Bell-202
    streams of 2^21 samples, with the launch counts set to 0 just before
    and read just after.  Then each kernel at the last shape the fleet
    gave it against its plain version on the same inputs (hold_last), the
    step's channels against the plain chain (correlate_plain, then the
    channel math) bit for bit, the rows' events against the single-card
    path's on the same inputs, and the rows' walls beside the single-card
    walls, in turns, best of 3."""
    import numpy as np
    import torch
    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.correlate import correlate_plain
    from minimodem_tpu_torch.ops.demod import (
        CHANNELS, geometry_from_config, make_basis, score_frame_channels)
    from minimodem_tpu_torch.ops.device_rx import (
        DeviceLoopback, DeviceReceiver)
    from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule
    from minimodem_tpu_torch.parallel.service import (
        ShardedLoopback, ShardedReceiver)
    from minimodem_tpu_torch.parallel.sharding import (
        make_mesh, sharded_decode_step)

    t0 = time.perf_counter()
    mesh = make_mesh(device=dev)
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED + 18)
    x16 = np.resize(audio, (STEP_BATCH, STEP_LEN)).astype(np.float32)
    x16 += (rng.random(x16.shape, dtype=np.float32)
            - np.float32(0.5)) * np.float32(0.6)

    counts = reset_counts()
    with last_inputs() as seen:
        rows = {"fleet loopback": bench.fleet_loopback_throughput(
                    "1200", HEAD_SECONDS, HEAD_BATCH, device=dev),
                "fleet ingest": bench.fleet_ingest_throughput(
                    "1200", INGEST_SECONDS, INGEST_BATCH, encoding="ulaw",
                    repeats=3, device=dev)}
        steps, step_s = {}, {}
        for b in (STEP_BATCH, 1):
            t0 = time.perf_counter()
            steps[b] = sharded_decode_step(cfg, mesh, x16[:b], STEP_LEN)
            step_s[b] = time.perf_counter() - t0
    launches = read_counts(counts)
    if (min(launches[k] for k in (*KERNEL_COUNTS, "tx_synth")) < 1
            or launches["plain"]):
        fail(f"fleet launches {launches}")
    for name, r in rows.items():
        if not r["decode_exact"]:
            fail(f"bench {name} does not decode exact")
    # each kernel at the last shape the fleet gave it (K1 and K2: the
    # ingest row's u-law batch; K3 rows / one-row: the step at 16 / 1
    # streams) against its plain version on the same inputs
    held = hold_last(seen)
    del seen
    if set(held) != {*KERNEL_COUNTS, "tx_synth"} or not all(
            r["ok"] for r in held.values()):
        fail(f"fleet kernels against their plain versions: {held}")

    # the step's channels against the plain chain on the same rows: the
    # plain correlation (K3's plain version), then the channel math
    geo = geometry_from_config(cfg)
    basis = torch.from_numpy(make_basis(geo, np.float32)).to(dev)
    step_words = 0
    for b, out in steps.items():
        xs = torch.zeros((b, STEP_LEN + geo.halo), device=dev)
        xs[:, :STEP_LEN] = torch.from_numpy(x16[:b]).to(dev)
        ch = score_frame_channels(
            correlate_plain(xs, basis, STEP_LEN + geo.max_begin), geo,
            STEP_LEN)
        step_words += sum(
            int(np.count_nonzero(out[k].view(np.int32)
                                 != ch[k].view(torch.int32).cpu().numpy()))
            for k in CHANNELS)
        del xs, ch
    torch.cuda.empty_cache()
    if step_words:
        fail(f"sharded_decode_step: {step_words} words differ from the "
             "plain chain's")

    # the rows' inputs again (bench.py makes them so), each row's events
    # against the single-card path's, and the walls in turns
    base = bench._bench_payload(cfg, HEAD_SECONDS)
    scheds = [tx_bit_schedule(bytes((b + 3 * i) % 94 + 33 for b in base),
                              cfg, Ascii8Codec()) for i in range(HEAD_BATCH)]
    flb = ShardedLoopback(cfg, mesh, device=dev)
    lb = DeviceLoopback(cfg, device=dev)
    lb_same = same_events(flb.run_events_batch(scheds),
                          lb.run_events_batch(scheds))
    lb_walls = best_walls([lambda: flb.run_events_batch(scheds),
                           lambda: lb.run_events_batch(scheds)], 3)

    modem = cpu_modem()
    base = bench._bench_payload(cfg, INGEST_SECONDS)
    waves = [bench._encode_wire(modem.modulate(
        bytes((b + 5 * i) % 94 + 33 for b in base)), "ulaw")
        for i in range(INGEST_BATCH)]
    xu = np.zeros((INGEST_BATCH, max(map(len, waves))), np.uint8)
    for i, w in enumerate(waves):
        xu[i, :len(w)] = w
    totals = [len(w) for w in waves]
    svc = ShardedReceiver(cfg, mesh, device=dev)
    dr = DeviceReceiver(cfg, device=dev)
    ev_f, stats = svc.run_events_batch(xu, totals, 1.5, 2.3, "ulaw")
    ev_1, _ = dr.run_events_batch(xu, totals, 1.5, 2.3, in_encoding="ulaw")
    in_same = same_events(ev_f, ev_1)
    in_walls = best_walls(
        [lambda: svc.run_events_batch(xu, totals, 1.5, 2.3, "ulaw"),
         lambda: dr.run_events_batch(xu, totals, 1.5, 2.3,
                                     in_encoding="ulaw")], 3)
    if not (lb_same and in_same):
        fail(f"fleet events differ from the single card's: loopback "
             f"{lb_same}, ingest {in_same}")
    return {"init_s": init_s, "rows": rows, "launches": launches,
            "held": held, "step_words": step_words, "step_s": step_s, "stats": stats,
            "lb_audio_s": rows["fleet loopback"]["audio_seconds"],
            "in_audio_s": rows["fleet ingest"]["audio_seconds"],
            "lb_walls": lb_walls, "in_walls": in_walls}


def decomposition_rank(dev_type, xs, totals, xu, same_x,
                       same_totals) -> dict:
    """Phase 19's work on one rank of a 2-rank gloo world on cuda:0: the
    ShardedReceiver decodes at dp = 2 and at sp = 2 (float32 and u-law
    wires, and SAME's dual layout at sp = 2), each with the rank's K1 and
    K2 launches and plain calls (counts set to 0 just before, read just
    after), then K1 on the rank's block or time shard and K2 on its (on
    sp, the gathered) planes held against their plain versions on the
    same inputs (hold_last)."""
    import torch
    from minimodem_tpu_torch.parallel.service import ShardedReceiver
    from minimodem_tpu_torch.parallel.sharding import make_mesh

    cases = (("dp=2", 2, 1, "1200", xs, totals, None),
             ("sp=2", 1, 2, "1200", xs, totals, None),
             ("sp=2 u-law", 1, 2, "1200", xu, totals, "ulaw"),
             ("SAME sp=2", 1, 2, "same", same_x, same_totals, None))
    out = {}
    for name, dp, sp, mode, x, tot, enc in cases:
        mesh = make_mesh(dp=dp, sp=sp, device=dev_type)
        svc = ShardedReceiver(cpu_modem(mode).cfg, mesh, device=dev_type)
        counts = reset_counts()
        with last_inputs() as seen:
            t0 = time.perf_counter()
            events, stats = svc.run_events_batch(x, tot, 1.5, 2.3, enc)
            dt = time.perf_counter() - t0
        n = read_counts(counts)
        out[name] = (events, stats, dt, n, hold_last(seen))
        del seen
    # the rank's device, as make_mesh set it (cuda:{LOCAL_RANK})
    out["device"] = (str(torch.device("cuda", torch.cuda.current_device()))
                     if dev_type == "cuda" else dev_type)
    return out


def decomposition_phase(dev) -> dict:
    """Phase 19: the dp and sp decompositions on the one card, in a world
    of 2 gloo ranks on cuda:0 (NCCL takes one rank per device), against
    the world-size-1 decode of phase 18's NCCL world."""
    import numpy as np
    from minimodem_tpu_torch.bench import _encode_wire
    from minimodem_tpu_torch.parallel.launch import spawn_world
    from minimodem_tpu_torch.parallel.service import ShardedReceiver
    from minimodem_tpu_torch.parallel.sharding import make_mesh

    def batch(waves, dtype):
        x = np.zeros((len(waves), max(map(len, waves))), dtype)
        for i, w in enumerate(waves):
            x[i, :len(w)] = w
        return x, [len(w) for w in waves]

    m = cpu_modem()
    rng = np.random.default_rng(SEED + 19)
    texts = [rng.integers(33, 127, size=DECOMP_BYTES,
                          dtype=np.uint8).tobytes()
             for _ in range(4)]
    waves = [m.modulate(t) for t in texts]
    xs, totals = batch(waves, np.float32)
    xu, _ = batch([_encode_wire(w, "ulaw") for w in waves], np.uint8)
    same = cpu_modem("same")
    same_texts = [b"ZCZC-WXR-RWT-020103+0015-", b"ZCZC-EAS-RMT-000000+0100-",
                  b"NNNN"]
    same_x, same_totals = batch([same.modulate(t) for t in same_texts],
                                np.float32)

    mesh = make_mesh(device=dev)
    ref = {"dp=2": ShardedReceiver(m.cfg, mesh, device=dev)
           .run_events_batch(xs, totals)[0]}
    ref["sp=2"] = ref["dp=2"]
    ref["sp=2 u-law"] = ShardedReceiver(m.cfg, mesh, device=dev) \
        .run_events_batch(xu, totals, in_encoding="ulaw")[0]
    ref["SAME sp=2"] = ShardedReceiver(same.cfg, mesh, device=dev) \
        .run_events_batch(same_x, same_totals)[0]
    for name, want in (("dp=2", texts), ("SAME sp=2", same_texts)):
        if [e[2].tobytes() for e in ref[name]] != want:
            fail(f"world-size-1 {name} decode is not exact")

    # both ranks on this card (cuda:0) on any machine: the children see
    # only it, so spawn_world gives both local rank 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    t0 = time.perf_counter()
    try:
        ranks = spawn_world(decomposition_rank, 2,
                            (dev.type, xs, totals, xu, same_x, same_totals),
                            "gloo", timeout=300)
    finally:
        if visible is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    wall = time.perf_counter() - t0
    rows = []
    for name in ref:
        for r, res in enumerate(ranks):
            events, stats, dt, n, held = res[name]
            rows.append({"name": name, "rank": r, "device": res["device"],
                         "same": same_events(events, ref[name]),
                         "stats": stats, "wall_s": dt, "launches": n,
                         "held": held})
    for row in rows:
        n, held = row["launches"], row["held"]
        if (not row["same"] or row["device"] != str(dev)
                or min(n["fused_score"], n["mega_rx"]) < 1 or n["plain"]
                or set(held) != {"fused_score", "mega_rx"}
                or not all(h["ok"] for h in held.values())):
            fail(f"decomposition {row['name']} rank {row['rank']}: {row}")
    return {"rows": rows, "spawn_s": wall,
            "audio_s": sum(totals) / m.cfg.sample_rate}


def cards_rank(n, scheds, xs, totals, sizes) -> dict:
    """One rank of phase 20 (one NCCL rank a card): the two fleet rows
    at n times the one-card batch (B / n streams a rank: the one-card
    shape on each card, where phases 13 and 18 held K1 and K2 against
    their plain versions), with the rank's launches (counts set to 0 just
    before, read just after); then ShardedLoopback on the headline
    schedules at dp = n and ShardedReceiver at (n / 2, 2) on ~30 s
    Bell-202 streams, for the parent to hold against one card.  sizes:
    the one-card rows' (audio seconds, batch) of the loopback and of the
    ingest."""
    import torch
    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.parallel.service import (
        ShardedLoopback, ShardedReceiver)
    from minimodem_tpu_torch.parallel.sharding import make_mesh

    cfg = cpu_modem().cfg
    (lb_s, lb_b), (in_s, in_b) = sizes
    counts = reset_counts()
    rows = {"fleet loopback": bench.fleet_loopback_throughput(
                "1200", lb_s, lb_b * n, device="cuda"),
            "fleet ingest": bench.fleet_ingest_throughput(
                "1200", in_s, in_b * n, encoding="ulaw", repeats=3,
                device="cuda")}
    launches = read_counts(counts)
    lb = ShardedLoopback(cfg, make_mesh(dp=n, sp=1, device="cuda"),
                         device="cuda").run_events_batch(scheds)
    sp = 2 if n % 2 == 0 else 1
    rx, stats = ShardedReceiver(
        cfg, make_mesh(dp=n // sp, sp=sp, device="cuda"),
        device="cuda").run_events_batch(xs, totals)
    return {"rows": rows, "launches": launches, "loopback": lb, "sp": rx,
            "stats": stats, "mesh_sp": (n // sp, sp),
            "device": str(torch.device("cuda", torch.cuda.current_device()))}


def cards_phase(n: int, card: str, dev) -> dict:
    """Phase 20, on a machine with n > 1 cards: the fleet across them,
    one NCCL rank a card.  The dry run (parallel/dryrun.py) on n ranks;
    then a world of n ranks (parallel/launch.py) runs the two fleet rows
    at n times the one-card batch, and ShardedLoopback / ShardedReceiver
    (dp = n; (n / 2, 2)) whose events are held against DeviceLoopback /
    DeviceReceiver on one card; every rank's device is checked to be
    cuda:{rank}.  -> each rank's launches."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.ops.device_rx import (
        DeviceLoopback, DeviceReceiver)
    from minimodem_tpu_torch.parallel.dryrun import dryrun_multichip
    from minimodem_tpu_torch.parallel.launch import spawn_world

    cfg = cpu_modem().cfg
    scheds = headline_sets(cfg, HEAD_BATCH, 1, HEAD_SECONDS)[0][1]
    ref_lb = DeviceLoopback(cfg, device=dev).run_events_batch(scheds)
    rng = np.random.default_rng(SEED + 20)
    waves = [cpu_modem().modulate(rng.integers(
        33, 127, size=DECOMP_BYTES, dtype=np.uint8).tobytes())
        for _ in range(2 * n)]
    xs = np.zeros((len(waves), max(map(len, waves))), np.float32)
    for i, w in enumerate(waves):
        xs[i, :len(w)] = w
    totals = [len(w) for w in waves]
    ref_rx = DeviceReceiver(cfg, device=dev).run_events_batch(
        xs, totals, 1.5, 2.3)[0]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        line = dryrun_multichip(n, device="cuda")
    phase(f"dry run on {n} cards, one NCCL rank each "
          f"({time.perf_counter() - t0:.1f} s): {line}")
    t0 = time.perf_counter()
    sizes = ((HEAD_SECONDS, HEAD_BATCH), (INGEST_SECONDS, INGEST_BATCH))
    ranks = spawn_world(cards_rank, n, (n, scheds, xs, totals, sizes),
                        "nccl", timeout=600)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        lc = res["launches"]
        ok = (same_events(res["loopback"], ref_lb)
              and same_events(res["sp"], ref_rx)
              and res["device"] == f"cuda:{r}"
              and all(row["decode_exact"] for row in res["rows"].values()))
        phase(f"rank {r} on {res['device']}: fleet events == one card's "
              f"(ShardedLoopback dp = {n} on {len(scheds)} streams, "
              f"ShardedReceiver {res['mesh_sp']} on {len(totals)} x "
              f"{DECOMP_BYTES} bytes) {ok}; launches {lc}")
        if not ok or min(lc["fused_score"], lc["mega_rx"],
                         lc["tx_synth"]) < 1 or lc["plain"]:
            fail(f"rank {r} of the {n}-card fleet")
        for name, row in res["rows"].items():
            extra = {k: v for k, v in row.items() if k not in (
                "mode", "audio_seconds", "wall_seconds", "real_time_factor",
                "decode_exact")}
            phase(f"rank {r} bench {name} ({row['mode']}, {extra}): "
                  f"{row['audio_seconds']:.1f} audio s in "
                  f"{row['wall_seconds'] * 1e3:.1f} ms = "
                  f"{row['real_time_factor']:.1f}x real time, decode exact "
                  f"{row['decode_exact']} ({card})")
    phase(f"the {n}-card world's start and run {wall:.1f} s")
    return {"launches": [res["launches"] for res in ranks]}


def read_s16(wav: str):
    """A PCM16 WAV's samples as int16, as the CLI reads them for the
    device engine (int16 ships raw)."""
    import numpy as np
    from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

    stream = open_stream("file", None, Direction.RECORD, SampleFormat.FLOAT,
                         48000, 1, "chip_smoke", wav)
    stream.format = SampleFormat.S16
    chunks = []
    while (c := stream.read(1 << 20)).size:
        chunks.append(c)
    stream.close()
    return np.concatenate(chunks).astype(np.int16)


def wirepack_phase(s16, text: bytes, card: str, dev) -> dict:
    """Phase 21: the delta-bitpack wire (ops/wirepack.py) on the card.

    The round trip: the phase-4 file's int16 samples (and a full-scale
    escape pattern and silence) packed on the host for k 0..5 and w 8 and
    12, unpacked on the card: every float32 word equal to unpack_expand on
    a CPU copy and to normalize_input(raw, "int16") on the card.  Then
    decodes with wire_pack=True against wire_pack=False on the card: the
    phase-4 file through Receiver.run (the slice's main path: the counts
    set to 0 just before it and read just after; K1 and K2 once a
    segment, plain calls 0), one segment through FskModem.demodulate at a
    bucket-aligned and a mid-bucket length, a stream with a noise burst
    whose segment takes the raw int16 wire, uic-train at ~60 s (K3 and
    make_score_packer) and "auto" with MINIMODEM_TPU_WIREPACK=1; K1, K2
    and K3 held against their plain versions on their last launches
    (hold_last).  Then the split: the host pack of a 2^21-sample segment,
    pinned uploads raw and packed, the device unpack, the decode walls
    raw and packed in turns, and the link rate below which the packed
    wire pays.  -> the numbers."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops import wirepack as wp
    from minimodem_tpu_torch.ops.device_rx import (
        PipelinedReceiver, _round_up_pow2, normalize_input)
    from minimodem_tpu_torch.rx.engine import Receiver

    modem = FskModem("1200", device=dev)
    cfg = modem.cfg
    n = len(s16)
    pr = PipelinedReceiver(cfg, device=dev)
    n_seg = -(-max(n - pr.segment_len, 0) // pr.step) + 1

    def words(a):
        return a.view(np.uint32)

    # ---- the round trip, bit for bit ----
    esc = np.resize(np.array([0, 0, 0, 0, 32767, -32768, 32767, -32768],
                             np.int16), 1 << 16)
    cases = [("phase-4 audio", s16, k, w) for k in range(wp.MAX_ORDER + 1)
             for w in (8, 12)]
    cases += [("escape", esc, 3, 8), ("silence", np.zeros(1 << 16, np.int16),
                                      2, 12)]
    bad = []
    for name, x, k, w in cases:
        e_cap = wp.exc_capacity(wp.count_exceptions(x, k, w))
        n_target = len(x) + 777
        wire = torch.from_numpy(
            wp.pack(x, len(x), k, w, e_cap).view(np.int16)[None])
        tot = torch.tensor([len(x) - 99], dtype=torch.int32)
        got = wp.unpack_expand(wire.to(dev), tot.to(dev), k, w, len(x),
                               e_cap, n_target).cpu().numpy()
        ref = wp.unpack_expand(wire, tot, k, w, len(x), e_cap,
                               n_target).numpy()
        raw = np.zeros((1, n_target), np.int16)
        raw[0, :len(x) - 99] = x[:len(x) - 99]
        norm = normalize_input(torch.from_numpy(raw).to(dev),
                               "int16").cpu().numpy()
        if not (np.array_equal(words(got), words(ref))
                and np.array_equal(words(got), words(norm))):
            bad.append((name, k, w))
    phase(f"wirepack round trip on the card: {len(cases)} cases (the phase-4 "
          f"audio, {n} samples, at k 0..5 x w 8, 12; a full-scale escape "
          f"pattern; silence), each row of float32 words == unpack_expand on "
          f"the CPU and == normalize_input(raw, int16) on the card, the "
          f"masked tail included: {'all' if not bad else bad}")
    if bad:
        fail(f"wirepack round trip differs: {bad}")

    def receive(samples, wire_pack, mode=None):
        """Receiver.run on the card -> (stdout, stderr)."""
        m = modem if mode is None else FskModem(mode, device=dev)
        out, err = io.BytesIO(), io.StringIO()
        Receiver(m.cfg, RxOptions(), get_codec(m.preset.decoder), out.write,
                 err.write, device=dev).run(samples, wire_pack=wire_pack)
        torch.cuda.synchronize()
        return out.getvalue(), err.getvalue()

    res = {}
    with last_inputs() as seen:
        # ---- the slice's main path: the phase-4 file on the packed wire
        raw = receive(s16, False)
        receive(s16, True)                             # warm-up
        counts = reset_counts()
        packed = receive(s16, True)
        res["launches"] = lc = read_counts(counts)
        ok = (packed == raw and packed[0] == text
              and lc["fused_score"] == lc["mega_rx"] == n_seg
              and lc["plain"] == 0)
        phase(f"wirepack decode of the phase-4 file (Receiver.run, "
              f"wire_pack=True, {n_seg} segments with a carried state): "
              f"stdout and stderr == wire_pack=False {packed == raw}, stdout "
              f"exact {packed[0] == text}; launches with the counts set to 0 "
              f"just before {lc}")
        if not ok:
            fail(f"wirepack main path: {lc}\n{packed[1]}\n{raw[1]}")

        # ---- one segment at a bucket-aligned and a mid-bucket length
        one = []
        for cut in ((1 << 20) - cfg.nsamples_overscan - 1, 1_500_000):
            x = s16[:cut]
            a = modem.demodulate(x, return_events=True, wire_pack=False)
            b = modem.demodulate(x, return_events=True, wire_pack=True)
            one.append((cut, _round_up_pow2(cut + cfg.nsamples_overscan + 1),
                        a == b))
        phase("wirepack one segment (FskModem.demodulate): " + "; ".join(
            f"{c} samples (packed at the {b}-sample bucket) == raw {ok1}"
            for c, b, ok1 in one))
        if not all(r[2] for r in one):
            fail(f"wirepack one-segment decodes differ: {one}")

        # ---- a noise burst whose segment overflows segment 0's capacity
        rng = np.random.default_rng(SEED + 21)
        gap = np.zeros(1 << 20, np.int16)
        burst = np.concatenate([
            s16, gap, rng.integers(-32768, 32768, 140_000).astype(np.int16),
            gap, s16])
        per, n_raw = {}, {}
        for wpk in (False, True):
            pr = PipelinedReceiver(cfg, device=dev)
            per[wpk] = [tuple(np.asarray(a).tobytes() for a in o)
                        for o in pr.run(burst, 1.5, 2.3, wire_pack=wpk)]
            n_raw[wpk] = pr.raw_segments
        res["burst_raw_segments"] = n_raw[True]
        phase(f"wirepack noise burst ({len(burst)} samples, 140000 of "
              f"full-scale noise between 2^20-sample silences): "
              f"{len(per[True])} segments, {n_raw[True]} of them on the raw "
              f"int16 wire (exception overflow); per-segment events == "
              f"wire_pack=False {per[True] == per[False]}")
        if per[True] != per[False] or n_raw[True] < 1 or n_raw[False]:
            fail(f"wirepack noise burst: raw segments {n_raw}")

        # ---- uic-train: make_score_packer and K3 after the unpack
        gcfg, _, wav_u, text_u, _ = geometry_signal(
            "uic-train", np.random.default_rng(SEED + 17))
        u16 = np.clip(np.rint(np.asarray(wav_u, np.float64) * 32767.0),
                      -32768, 32767).astype(np.int16)
        ru = receive(u16, False, "uic-train")
        counts = reset_counts()
        pu = receive(u16, True, "uic-train")
        res["uic_launches"] = lu = read_counts(counts)
        k3 = lu["correlate"] + lu["correlate_batch"]
        phase(f"wirepack uic-train ({len(u16) / gcfg.sample_rate:.1f} s, "
              f"packed {wp.choose_params(u16)}): stdout and stderr == "
              f"wire_pack=False {pu == ru}, stdout exact {pu[0] == text_u}; "
              f"launches {lu}")
        if pu != ru or pu[0] != text_u or k3 < 1 or lu["mega_rx"] < 1 \
                or lu["plain"]:
            fail(f"wirepack uic-train: {lu}")

        # ---- "auto" with MINIMODEM_TPU_WIREPACK=1
        calls, real_pack = [], wp.pack

        def counted_pack(*a, **k):
            calls.append(len(a[0]))
            return real_pack(*a, **k)

        wp.pack = counted_pack
        os.environ["MINIMODEM_TPU_WIREPACK"] = "1"
        try:
            auto = receive(s16, "auto")
        finally:
            wp.pack = real_pack
            del os.environ["MINIMODEM_TPU_WIREPACK"]
        phase(f"wirepack \"auto\" with MINIMODEM_TPU_WIREPACK=1: "
              f"{len(calls)} segments packed, stdout and stderr == raw "
              f"{auto == raw}")
        if auto != raw or len(calls) != n_seg:
            fail(f"wirepack auto: {len(calls)} packs")
    res["held"] = held = hold_last(seen)
    phase(f"wirepack kernels on their last launches against their plain "
          f"versions on the same inputs: {held_line(held)}")
    if not all(r["ok"] for r in held.values()) or not {
            "fused_score", "mega_rx"} <= set(held):
        fail("a kernel of the wirepack phase disagrees with its plain version")

    # ---- the split of one 2^21-sample Bell-202 segment ----
    seg = s16[:pr.segment_len]
    seg_b = 2 * len(seg)

    def best_s(fn, reps=5):
        return min(best_walls([fn], reps))

    choose_s = best_s(lambda: wp.choose_params(seg))
    k, w = wp.choose_params(seg)
    count_s = best_s(lambda: wp.count_exceptions(seg, k, w))
    e_cap = wp.exc_capacity(wp.count_exceptions(seg, k, w))
    row_b = wp.row_bytes(len(seg), k, w, e_cap)
    host = torch.empty(row_b // 2, dtype=torch.int16, pin_memory=True)
    pack_s = best_s(lambda: wp.pack(seg, len(seg), k, w, e_cap,
                                    out=host.numpy().view(np.uint8)))
    total_nf = pr.segment_len - pr._lookahead + cfg.expect_nsamples
    t_total = _round_up_pow2(total_nf + cfg.nsamples_overscan + 1)
    n_x = t_total + pr.geo.halo
    # the raw wire's row is the segment zero-filled to the scored length
    raw_h = torch.zeros(n_x, dtype=torch.int16, pin_memory=True)
    raw_h[:len(seg)] = torch.from_numpy(seg)
    raw_d = torch.empty_like(raw_h, device=dev)
    pk_d = torch.empty_like(host, device=dev)
    h2d_raw = cuda_ms(lambda: raw_d.copy_(raw_h, non_blocking=True), 20)
    h2d_pk = cuda_ms(lambda: pk_d.copy_(host, non_blocking=True), 20)
    tot = torch.tensor([total_nf], dtype=torch.int32, device=dev)
    wire_d = pk_d[None]

    def unpack():
        return wp.unpack_expand(wire_d, tot, k, w, len(seg), e_cap, n_x,
                                len(seg) - total_nf)

    unpack_ms = cuda_ms(unpack, 20)
    unpack_dev_ms, unpack_kernels = device_ms_per_call(unpack, 5)
    # the packed wire pays on a link that moves the bytes it saves slower
    # than the host packs and the card unpacks a segment
    saved_b = 2 * n_x - row_b
    even_mbps = saved_b / (pack_s + unpack_ms * 1e-3) / 1e6
    res.update(k=k, w=w, e_cap=e_cap, ratio=row_b / (2 * n_x),
               choose_ms=choose_s * 1e3, count_ms=count_s * 1e3,
               pack_ms=pack_s * 1e3, pack_mbps=seg_b / pack_s / 1e6,
               h2d_raw_ms=h2d_raw, h2d_packed_ms=h2d_pk, unpack_ms=unpack_ms,
               unpack_device_ms=unpack_dev_ms, unpack_kernels=unpack_kernels,
               break_even_mbps=even_mbps)
    phase(f"wirepack split of one 2^21-sample Bell-202 segment ({seg_b} B "
          f"of samples, a {2 * n_x} B raw row, {row_b} B packed at k {k}, w {w}, e_cap {e_cap}: "
          f"{row_b / (2 * n_x):.4f}x the row): host choose_params {choose_s * 1e3:.3f} "
          f"ms, count_exceptions {count_s * 1e3:.3f} ms, pack "
          f"{pack_s * 1e3:.3f} ms = {seg_b / pack_s / 1e6:.1f} MB/s of "
          f"samples (one thread, best of 5); pinned H2D raw row "
          f"{h2d_raw:.4f} ms ({2 * n_x / h2d_raw / 1e3:.0f} MB/s), packed "
          f"{h2d_pk:.4f} ms; "
          f"device unpack_expand to [1, {n_x}] {unpack_ms:.4f} ms per call "
          f"(CUDA events), {fmt_ms(unpack_dev_ms)} device time in "
          f"{'not measured' if unpack_kernels is None else f'{unpack_kernels:.0f}'}"
          f" kernels (torch.profiler); the packed wire pays "
          f"below a link of {even_mbps:.1f} MB/s ({card})")

    # ---- decode walls, raw against packed, in turns ----
    long16 = np.resize(s16, 120 * cfg.sample_rate)
    walls = {}
    for name, x in (("phase-4 file", s16), ("120 s stream", long16)):
        same = receive(x, True) == receive(x, False)
        best = best_walls([lambda x=x: receive(x, False),
                           lambda x=x: receive(x, True)], 3)
        audio_s = len(x) / cfg.sample_rate
        walls[name] = {"audio_s": audio_s, "raw_s": best[0],
                       "packed_s": best[1], "same": same}
        phase(f"wirepack time {name} ({audio_s:.1f} s audio), warm, best of "
              f"3 in turns: raw wire {best[0] * 1e3:.2f} ms = "
              f"{audio_s / best[0]:.0f}x real time, packed "
              f"{best[1] * 1e3:.2f} ms = {audio_s / best[1]:.0f}x "
              f"({100 * (best[1] / best[0] - 1):+.1f}%); packed == raw "
              f"{same} ({card})")
        if not same:
            fail(f"wirepack {name}: packed decode differs from raw")
    res["walls"] = walls
    return res


# ======================================================================
# 22. the entry points beside the CLI: the runner, the sp curve, the soak
# ======================================================================

# the runner in a child process of its own, as a user starts it, with
# the launch counts set to 0 just before its main and read just after,
# then each kernel's last launch in it held against its plain version
RUNNER_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from minimodem_tpu_torch import bench
counts = chip_smoke.reset_counts()
with chip_smoke.last_inputs() as seen:
    rc = bench.main([])
n = chip_smoke.read_counts(counts)
print(json.dumps({{"launches": n, "held": chip_smoke.hold_last(seen)}}),
      file=sys.stderr)
sys.exit(rc)
"""
# the sp curve at the JAX script's defaults (30 s, one stream)
CURVE_SP, CURVE_SECONDS = "1,2,4", "30"


def key_tree(obj):
    """{key: key tree} for a dict, else the JSON type's name."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return type(obj).__name__


def module_run(argv, timeout: float):
    """python -m <argv> from the checkout -> (rc, stdout, stderr, wall)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, cwd=ROOT, timeout=timeout)
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def curve_rank(sp, device, waves, payloads) -> dict:
    """One rank of phase 22's sp curve: the script's own rank
    (_rank_curve: a warm call, the decode check, the best of 3 walls)
    with the rank's launches (counts set to 0 just before, read just
    after), then K1 on the rank's time shard and K2 on its (at sp > 1,
    the gathered) planes held against their plain versions
    (hold_last)."""
    from minimodem_tpu_torch.scripts.sp_scaling_curve import _rank_curve

    counts = reset_counts()
    with last_inputs() as seen:
        r = _rank_curve(sp, device, waves, payloads)
    r["launches"] = read_counts(counts)
    r["held"] = hold_last(seen)
    return r


def held_ok(n: dict, held: dict) -> bool:
    """K1 and K2 launched, no plain call, and both held equal to their
    plain versions."""
    return (min(n["fused_score"], n["mega_rx"]) >= 1 and not n["plain"]
            and {"fused_score", "mega_rx"} <= set(held)
            and all(h["ok"] for h in held.values()))


def entry_points_phase(card: str) -> dict:
    """Phase 22: `python -m minimodem_tpu_torch.bench` at its defaults
    in a child process (rc 0, the root bench.py's key tree, decode_exact
    true), the sp scaling curve's main at sp = 1, 2, 4 (every row
    decode-exact, naming its backend and cards) and the live soak's
    --selfcheck main on the card.  Each path with its launches (counts
    set to 0 just before it, read just after; in the curve, per rank)
    and K1's and K2's last launches in it held against their plain
    versions: K1 and K2 launched, plain calls 0, both equal."""
    import torch
    from minimodem_tpu_torch.parallel import launch
    from minimodem_tpu_torch.scripts import live_soak, sp_scaling_curve

    rc, out, err, wall = module_run(
        ["-c", RUNNER_CHILD.format(root=str(ROOT))], 900)
    lines = out.strip().splitlines()
    if rc != 0 or not lines:
        fail(f"the runner exited {rc}: {err[-2000:]}")
    line = json.loads(lines[-1])
    child = json.loads(err.strip().splitlines()[-1])
    counts, held = child["launches"], child["held"]
    if key_tree(line) != RUNNER_KEYS or line["decode_exact"] is not True:
        fail(f"the runner's JSON line: {lines[-1]}")
    if (not held_ok(counts, held)
            or min(counts["tx_synth"], counts["tx_synth_frames"]) < 1
            or not {"tx_synth", "tx_synth_frames"} <= set(held)):
        fail(f"the runner's launches: {counts}; held: {held}")
    for s in lines[:-1]:
        phase(f"runner: {s}")
    phase(f"runner JSON line ({card}): {lines[-1]}")
    phase(f"runner: rc {rc}, wall {wall:.1f} s (the process's start and "
          f"the rows' set-up included); launches with the counts set to 0 "
          f"just before its main: K1 {counts['fused_score']}, K2 "
          f"{counts['mega_rx']}, K3 one-row {counts['correlate']}, K3 rows "
          f"{counts['correlate_batch']}, K4 flat {counts['tx_synth']}, K4 "
          f"frames {counts['tx_synth_frames']}, plain calls "
          f"{counts['plain']} (synthesis {counts['plain_synth']}); "
          f"its last launches: {held_line(held)} ({card})")

    # the script's main as a user calls it, its worlds' ranks each
    # wrapped by curve_rank
    ranks, spawn = {}, launch.spawn_world

    def counted_world(fn, n, args=(), backend="gloo", **kw):
        if fn is not sp_scaling_curve._rank_curve:
            raise RuntimeError(f"the sp curve spawned {fn}")
        ranks[n] = spawn(curve_rank, n, args, backend, **kw)
        return ranks[n]

    buf = io.StringIO()
    launch.spawn_world = counted_world
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = sp_scaling_curve.main([CURVE_SECONDS, "1", "--sp", CURVE_SP])
    finally:
        launch.spawn_world = spawn
    curve_wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        fail(f"the sp curve exited {rc}: {buf.getvalue()[-2000:]}")
    curve = json.loads(lines[-1])["curve"]
    sps = [int(v) for v in CURVE_SP.split(",")]
    if ([r["sp"] for r in curve] != sps or sorted(ranks) != sps
            or not all(r["decode_exact"] and r["backend"] in ("nccl", "gloo")
                       and r["cards"] >= 1 for r in curve)):
        fail(f"the sp curve: {lines[-1]}")
    for r in curve:
        phase(f"sp curve ({r['backend']}, {r['cards']} card(s)): "
              f"{json.dumps(r)} ({card})")
        for i, res in enumerate(ranks[r["sp"]]):
            n = res["launches"]
            if not held_ok(n, res["held"]):
                fail(f"sp curve sp {r['sp']} rank {i}: {n}; {res['held']}")
            phase(f"sp curve sp {r['sp']} rank {i} ({res['device']}): K1 "
                  f"{n['fused_score']}, K2 {n['mega_rx']}, plain "
                  f"{n['plain']}; {held_line(res['held'])}")
    phase(f"sp curve: {json.loads(lines[-1])['audio_seconds']:.2f} audio s "
          f"a decode; wall {curve_wall:.1f} s for the three worlds")

    buf = io.StringIO()
    sc = reset_counts()
    with last_inputs() as seen, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        rc = live_soak.main(["--selfcheck"])
        soak_wall = time.perf_counter() - t0
    soak_n = read_counts(sc)
    soak_held = hold_last(seen)
    del seen
    torch.cuda.empty_cache()
    out = buf.getvalue()
    if (rc != 0 or not out.startswith("selfcheck: PASS")
            or not held_ok(soak_n, soak_held)):
        fail(f"live_soak --selfcheck exited {rc}: {out} {soak_n} "
             f"{soak_held}")
    phase(f"live_soak --selfcheck on the card: {out.strip()} "
          f"({soak_wall:.1f} s); K1 {soak_n['fused_score']}, K2 "
          f"{soak_n['mega_rx']}, plain {soak_n['plain']}; "
          f"{held_line(soak_held)} ({card})")
    return {"launches": counts, "line": line, "curve": curve,
            "curve_launches": {f"sp={sp}": [r["launches"] for r in ranks[sp]]
                               for sp in sps},
            "selfcheck_launches": soak_n}


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
        PipelinedReceiver, _round_up_pow2, device_rx_key,
        geo_from_key)
    from minimodem_tpu_torch.ops.fused_score import (
        FusedScorer, score_planes_plain)
    from minimodem_tpu_torch.ops.mega_rx import (
        MegaReceiver, MegaRx, MegaStatics, mega_rx_plain)

    t_start = time.perf_counter()
    # plain versions run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card, versions, kernel build ----
    card = card_line()
    phase(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}; "
          f"host CPU kernels {torch.backends.cpu.get_cpu_capability()} "
          f"(the plain versions on the CPU)")
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
    if bits_bad or cls_bad or tol_bad or exact:
        fail("K1 disagrees with its plain version")
    k1_ms = cuda_ms(lambda: scorer(x, t_total), 20)
    k1_kernel_ms = kernel_device_ms(lambda: scorer(x, t_total), 20,
                                    "fused_score_kernel")
    k1_plain_ms = cuda_ms(
        lambda: score_planes_plain(x, scorer.geo, t_total), 3)

    # ---- 3. K2 against its plain version on K1's planes ----
    st = MegaStatics.build(key, t_total, False)
    mega = MegaRx(st)
    totals = torch.tensor([total_nf], dtype=torch.int32, device=dev)
    ci_np, cf_np = MegaReceiver.carry_to_arrays(None, 1)
    ci, cf = torch.from_numpy(ci_np).to(dev), torch.from_numpy(cf_np).to(dev)
    thr = (1.5, 2.3)
    same, out_k, out_p = k2_compare(mega, planes, totals, thr, ci, cf, False)
    k2_search = int(mega_rx_plain.searches[0])
    k2_words = mega_rx_plain.words
    k2_err = float(np.abs(out_k[5].cpu().numpy().astype(np.float64)
                          - out_p[5]).max())
    tp0 = time.perf_counter()
    mega_rx_plain(st, False, pk, np.asarray([total_nf], np.int32), thr,
                  ci_np, cf_np)
    k2_plain_ms = (time.perf_counter() - tp0) * 1e3
    ring = mega.ring
    phase(f"K2 mega_rx vs plain on K1's planes: {int(out_k[1][0])} events, "
          f"{int(out_k[3][0])} bytes, {k2_search} frame searches, "
          f"identical events/bytes/carry: {same}; ring G {ring.window} x S "
          f"{ring.stages}, {ring.n_held} planes held, {ring.smem_bytes} B "
          f"shared memory")
    if not same:
        fail("K2 disagrees with its plain version")
    k2_ms = cuda_ms(lambda: mega(planes, totals, thr, ci, cf, False), 5)
    k2_kernel_ms = kernel_device_ms(
        lambda: mega(planes, totals, thr, ci, cf, False), 5, "mega_rx_kernel")
    k2_rows = k2_cases(audio, planes, total_nf, dev)
    ab1 = ring_ab(key, planes, [total_nf], False)
    for r in k2_rows:
        rg = r["ring"]
        phase(f"K2 {r['name']} vs plain at {r['shape']}: identical "
              f"events/bytes/carry {r['same']}; {r['events']} events, "
              f"{r['bytes']} bytes, frame searches per stream max "
              f"{int(r['searches'].max())}; ring G {rg.window} x S "
              f"{rg.stages}, {'every plane' if rg.hold_all else 'confidence only'}"
              f" ({rg.n_held}), {rg.smem_bytes} B")

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
        ok_e2e = (rc_c == 0 and out_c == text and rc_p == 0
                  and out_p2 == text and err_c == err_p == err_cuda)
        phase(f"end to end: {len(text)} bytes, {n_samples} samples "
              f"({n_samples / cfg.sample_rate:.1f} s audio, {n_seg} "
              f"segments); stdout byte-exact (cuda subprocess "
              f"{out_c == text}, cpu {out_p2 == text}), stderr cuda == cpu "
              f"{err_c == err_p}; launches {launches}, plain calls "
              f"{plain_calls}; stderr: {err_c.strip()!r}")
        if not ok_e2e:
            fail(f"end-to-end mismatch: rc {rc_c}/{rc_p}\n{err_c}\n{err_p}")
        s16_file = read_s16(wav)

        # ---- 6-9. K3 and the host engines ----
        k3, k3_more = k3_check(audio, dev)
        for name, r in k3.items():
            phase(f"K3 {name} vs plain at {r['shape']} (tile {r['tile']}): "
                  f"bit-different words {r['words']}, max_abs_err "
                  f"{r['max_abs_err']}")
            if r["words"]:
                fail(f"K3 {name} disagrees with its plain version")
        for r in k3_more:
            phase(f"K3 {r['name']} vs plain at {r['shape']} (tile "
                  f"{r['tile']}): bit-different words {r['words']}")
            if r["words"]:
                fail(f"K3 {r['name']} disagrees with its plain version")
        host = host_engines(wav, text, err_cuda)
        host_split_line, host_k5 = host_engine_split(wav, dev)
        perfect = perfect_check(tmp)
        auto_all = autodetect_check(dev)
        auto = auto_all["device"]

        # ---- 15. the geometries K1 does not serve, and K2's new modes ----
        geo_rows = [geometry_phase(g, tmp, dev) for g in GEOMETRIES]

        # ---- 16. streaming: the phase-4 audio in half-second reads ----
        strm = streaming_phase(wav, text, err_p, dev)

    # ---- 17. live RX, live -a, interactive TX, the soak ----
    live = live_phase(audio, dev)
    soak = soak_phase(dev)

    # ---- 5. timings ----
    phase(f"time K1 fused_score [1, {t_total + halo}] (tile "
          f"{scorer.tile}, {-(-t_total // scorer.tile)} CTAs): "
          f"{k1_ms:.4f} ms per wrapper call (CUDA events), "
          f"{fmt_ms(k1_kernel_ms)} device time of the kernel alone "
          f"(torch.profiler), plain {k1_plain_ms:.4f} ms ({card})")
    k2_us_frame = None if k2_kernel_ms is None else \
        1e3 * k2_kernel_ms / k2_search
    phase(f"time K2 mega_rx [1, {pk.shape[1]}, {t_total}]: {k2_ms:.4f} ms "
          f"per wrapper call (CUDA events), {fmt_ms(k2_kernel_ms)} device "
          f"time of the kernel alone (torch.profiler) = "
          f"{fmt_us(k2_us_frame)} per frame search ({k2_search} searches), "
          f"plain {k2_plain_ms:.4f} ms (CPU loop) ({card})")
    b160 = k2_rows[0]
    n160 = int(b160["searches"].sum())
    phase(f"time K2 {b160['name']} {b160['shape']}: {fmt_ms(b160['ms'])} "
          f"device time of the kernel alone (torch.profiler) for {n160} "
          f"frame searches in 160 streams (longest {int(b160['searches'].max())}"
          f") ({card})")
    phase(f"time end to end (in process, warm): {e2e_s * 1e3:.1f} ms for "
          f"{n_samples / cfg.sample_rate:.1f} s audio = "
          f"{n_samples / cfg.sample_rate / e2e_s:.1f} audio s per wall s "
          f"({card})")
    phase(f"profile of one warm decode (torch.profiler): {prof_line} "
          f"({card})")
    phase(f"host split of one warm decode: {split_line} ({card})")
    ab160 = k2_rows[0]["ab"]
    for name, ab in (("B=1 Bell-202 segment", ab1), ("B=160 Bell-202", ab160)):
        phase(f"time K2 with its ring ({ab['stages']} stages) against the "
              f"read from global memory, {name}, in turns: ring "
              f"{', '.join(fmt_ms(v) for v in ab['ring'])}; no ring "
              f"{', '.join(fmt_ms(v) for v in ab['none'])} (the kernel alone, "
              f"torch.profiler); per call (CUDA events) ring "
              f"{', '.join(fmt_ms(v) for v in ab['ring_call'])}, no ring "
              f"{', '.join(fmt_ms(v) for v in ab['none_call'])} ({card})")

    # ---- 10. K3 and host-engine timings ----
    for name, r in k3.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flop"])
        phase(f"time K3 {name} {r['shape']} (tile {r['tile']}): kernel "
              f"{r['ms']:.4f} ms per "
              f"wrapper call (CUDA events), {fmt_ms(r['kernel_ms'])} device "
              f"time of the kernel alone (torch.profiler), plain "
              f"{r['plain_ms']:.4f} ms; library F.conv1d (TF32 off) "
              f"{r['library_ms']:.4f} ms per call (CUDA events), "
              f"{fmt_ms(r['library_device_ms'])} device time per call "
              f"(torch.profiler), max_abs_err vs plain {r['conv1d_err']}; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['bytes'] / 1e6:.1f} MB, {r['flop'] / 1e6:.1f} MFLOP) "
              f"({card})")
    for engine, r in host.items():
        phase(f"time --engine {engine} end to end (in process, warm): "
              f"{r['wall_s'] * 1e3:.1f} ms for "
              f"{n_samples / cfg.sample_rate:.1f} s audio = "
              f"{n_samples / cfg.sample_rate / r['wall_s']:.1f} audio s per "
              f"wall s ({card})")
        phase(f"profile of one warm --engine {engine} decode "
              f"(torch.profiler): {r['profile']} ({card})")
    phase(f"host engine split of one warm decode: {host_split_line} "
          f"({card})")
    for form, r in host_k5.items():
        phase(f"time the host scorer's stages at {form} -> 131072 offsets: "
              f"{k5_split_line(r)} ({card})")
        if r["words"]:
            fail(f"K5 at the host scorer's {form} disagrees with its plain "
                 "version")
    for r in geo_rows:
        sp = r["split"]
        phase(f"time {r['name']} (stage 1 {r['route']}): file decode warm "
              f"wall {r['wall_s'] * 1e3:.1f} ms for {r['audio_s']:.1f} s "
              f"audio = {r['audio_s'] / r['wall_s']:.1f} audio s per wall s; "
              f"batch of 16 {r['planes']}: score planes {r['score_ms']:.3f} "
              f"ms per call in {r['tiles']} tiles, a tile stage 1 "
              f"{sp['stage1_ms']:.4f} ms + K5 {sp['ms']:.4f} ms (the plain "
              f"channels {sp['plain_ms']:.3f} ms), K2 {r['k2_ms']:.3f} ms per "
              f"call ({card})")
    phase(f"time -a --engine device, retune between bursts: warm wall "
          f"{auto['wall_s'] * 1e3:.1f} ms ({card})")
    idle = 100 - 100 * strm["busy_ms"] / strm["wall_prof_ms"]
    phase(f"time streaming, {strm['segments']} segments of 65536 samples "
          f"({strm['audio_s']:.1f} s audio): decode wall per segment (upload, "
          f"K1, K2, collect) p50 {strm['seg_p50_ms']:.3f} ms, p99 "
          f"{strm['seg_p99_ms']:.3f} ms, max {strm['seg_max_ms']:.3f} ms; "
          f"end to end {strm['wall_s'] * 1e3:.1f} ms = "
          f"{strm['audio_s'] / strm['wall_s']:.1f}x real time (--device cpu "
          f"{strm['wall_cpu_s'] * 1e3:.1f} ms); under torch.profiler device "
          f"busy {strm['busy_ms']:.3f} ms of {strm['wall_prof_ms']:.1f} ms "
          f"wall (idle {idle:.1f}%) ({card})")
    phase(f"time at the streaming shape {strm['shape']} (a non-final "
          f"segment scores {strm['t_total']} offsets for {strm['total_nf']} "
          f"needed): K1 {fmt_ms(strm['k1_kernel_ms'])} alone "
          f"(torch.profiler), {strm['k1_queued_ms']:.4f} ms queued behind a "
          f"sleep (CUDA events, the launches' host time off the clock), "
          f"{strm['k1_ms']:.4f} ms per call, plain {strm['k1_plain_ms']:.4f} "
          f"ms, bound {strm['k1_bound'][0]:.4f} ms ({strm['k1_bound'][1]}); "
          f"K2 {fmt_ms(strm['k2_kernel_ms'])} alone, "
          f"{strm['k2_queued_ms']:.4f} ms queued, {strm['k2_ms']:.4f} ms "
          f"per call ({strm['k2_search']} frame searches), plain "
          f"{strm['k2_plain_ms']:.4f} ms (CPU loop), roofline "
          f"{strm['k2_bound'][0]:.6f} ms ({strm['k2_bound'][1]}) ({card})")
    for name in ("live", "live_autodetect"):
        r = live[name]
        phase(f"time {name} (warm, in process, stand-in capture): "
              f"{r['wall_s'] * 1e3:.1f} ms for {r['audio_s']:.1f} s audio = "
              f"{r['audio_s'] / r['wall_s']:.1f}x real time ({card})")
    for name, r in soak.items():
        phase(f"time soak {name}: {r['wall_s']:.1f} s wall for "
              f"{r['audio_s']:.0f} s of virtual audio ({card})")

    # ---- 11. device TX on the card ----
    for r in device_tx_check(dev):
        phase(f"device TX {r['name']} (cuda vs cpu): max_abs_err "
              f"{r['max_abs_err']} (tolerance {r['atol']}), {r['differ']} of "
              f"{r['n']} samples differ")
    head = headline_sets(cfg, HEAD_BATCH, 1, HEAD_SECONDS)[0][1]
    k4 = k4_check(dev, head)
    for r in k4["rows"]:
        phase(f"K4 {r['name']}: max_abs_err {r['max_abs_err']} (tolerance "
              f"{r['atol']}), {r['differ']} of {r['n']} samples differ "
              f"({r['words']} bit-different words)")
    sn = k4["sine"]
    phase(f"K4 sine (sin_2pi) against CUDA's float64 sin rounded to float32 "
          f"on every float32 fraction of a turn in [0, 1): {sn['mismatches']} "
          f"of {sn['inputs']:,} differ, {sn['ms']:.3f} ms ({card})")
    cen = k4_census()
    if not cen["cuobjdump"]:
        fail("K4 census: cuobjdump -sass of the kernel library failed")
    phase(f"K4 census (SASS of the loaded library by cuobjdump -sass, "
          f"registers from nvcc -Xptxas -v; the instructions of each "
          f"kernel's sample loop over the 4-byte words a pass stores, by "
          f"pipe; {cen['sms']} SMs, clocks.max.sm {cen['clock_mhz']:.0f} "
          f"MHz, clocks.sm {k4['head']['loaded_mhz']:.0f} MHz under K4 at the "
          f"headline buffer; pipe floors at clocks.max.sm and the rates a "
          f"clock an SM {PIPE_RATES})")
    for k in K4_KERNELS:
        phase(f"K4 census {census_line(cen, k)}")
    k4h = k4["head"]
    k4h["floors"] = pipe_floors(
        cen["tx_synth_bits_kernel"]["per_sample"], k4h["sines"], cen)
    phase(f"time K4 at the headline buffer {k4h['shape']}: "
          f"{fmt_ms(k4h['kernel_ms'])} alone (its 2 kernels, torch.profiler, "
          f"{k4h['profile_tries']} window(s), device records a call "
          f"{k4h['profile_seen']}), {k4h['queued_ms']:.4f} ms "
          f"queued behind a sleep (CUDA events), {k4h['ms']:.4f} ms per call, "
          f"plain route {k4h['plain_ms']:.3f} ms, bound "
          f"{k4h['bound'][0]:.4f} ms ({k4h['bound'][1]}: "
          f"{k4h['bytes'] / 1e9:.3f} GB, {k4h['flop'] / 1e9:.2f} GFLOP "
          f"float32) beside {k4h['sines'] / 1e6:.1f} M float64 sines; pipe "
          f"floors {floors_text(k4h['floors'])} ({card})")
    for r in k4["frames"]:
        r["floors"] = pipe_floors(
            cen["tx_synth_frames_kernel"]["per_sample"], r["samples"], cen)
        phase(f"time K4 frames {r['mode']} at {r['shape']}: "
              f"{fmt_ms(r['kernel_ms'])} alone (its 2 kernels, "
              f"torch.profiler, {r['profile_tries']} window(s), device "
              f"records a call {r['profile_seen']}), "
              f"{r['queued_ms']:.4f} ms queued, {r['ms']:.4f} ms per call, "
              f"plain route {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); pipe floors "
              f"{floors_text(r['floors'])} ({card})")

    # ---- 12. the loopback on the card against device="cpu" ----
    for r in loopback_cuda_vs_cpu(dev):
        phase(f"loopback {r['mode']}, 2 streams: cuda == cpu "
              f"event for event {r['same']}, decode exact {r['exact']}, "
              f"event types {r['events']}")

    # ---- 13. the loopback's main path: the bench rows on the card ----
    from minimodem_tpu_torch import bench
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    lb = DeviceLoopback(cfg, device=dev)
    lk = loopback_kernels(lb, head, dev)
    phase(f"K1 at the loopback's shape {lk['shape_k1']}: bit-different "
          f"words {lk['k1_words']}; K2 at {lk['shape_k2']}: identical "
          f"events/bytes/carry {lk['k2_same']}, frame searches per stream "
          f"max {int(lk['k2_searches'].max())}")
    counts = reset_counts()
    rows = {"batched": bench.batched_loopback_throughput(
                "1200", HEAD_SECONDS, HEAD_BATCH, device=dev),
            "batched, pipeline 8": bench.batched_loopback_throughput(
                "1200", HEAD_SECONDS, HEAD_BATCH, pipeline=8, device=dev)}
    lb_launches = read_counts(counts)
    lb_plain = lb_launches["plain"]
    if min(lb_launches[k] for k in ("fused_score", "mega_rx",
                                    "tx_synth")) < 1 or lb_plain:
        fail(f"loopback launches {lb_launches}, plain calls {lb_plain}")
    counts = reset_counts()
    rows["rtty"] = bench.mode_loopback_throughput("rtty", device=dev)
    rows["same"] = bench.mode_loopback_throughput("same", device=dev)
    rows["callerid"] = bench.callerid_throughput(device=dev)
    rows["decode pcm16"] = bench.decode_throughput(device=dev)
    rows["decode ulaw"] = bench.decode_throughput(encoding="ulaw",
                                                  device=dev)
    rows["loopback one stream"] = bench.loopback_throughput(device=dev)
    rows_launches = read_counts(counts)
    if (min(rows_launches[k] for k in ("tx_synth", "tx_synth_frames")) < 1
            or rows_launches["plain"]):
        fail(f"the other bench rows' launches {rows_launches}")
    for name, r in rows.items():
        extra = {k: v for k, v in r.items() if k not in (
            "mode", "audio_seconds", "wall_seconds", "real_time_factor",
            "decode_exact")}
        phase(f"bench {name} ({r['mode']}, {extra}): "
              f"{r['audio_seconds']:.1f} audio s in "
              f"{r['wall_seconds'] * 1e3:.1f} ms = {r['real_time_factor']:.1f}"
              f"x real time, decode exact {r['decode_exact']} ({card})")
        if not r["decode_exact"]:
            fail(f"bench {name} does not decode exact")
    phase(f"loopback launches in the two batched rows (counts set to 0 "
          f"before them): {lb_launches}, plain calls {lb_plain}; in the "
          f"other rows (set to 0 again): {rows_launches}")

    # ---- 14. stage split and peak memory of one warm B = 128 batch ----
    rc, out, err, _ = module_run(
        ["-c", STAGE_CHILD.format(root=str(ROOT))], 600)
    if rc != 0:
        fail(f"the stage split's process exited {rc}: {err[-2000:]}")
    ss = json.loads(out.strip().splitlines()[-1])
    if not ss["busy_ms"]:
        fail("torch.profiler saw no device time in the stage split")
    parts = "; ".join(f"{k} {v:.3f} ms ({100 * v / ss['busy_ms']:.1f}%)"
                      for k, v in ss["split"].items())
    phase(f"stage split of one warm B = {HEAD_BATCH} x {HEAD_SECONDS} s batch "
          f"(torch.profiler): {parts}; device busy {ss['busy_ms']:.3f} ms of "
          f"{ss['wall_ms']:.2f} ms wall (idle "
          f"{100 - 100 * ss['busy_ms'] / ss['wall_ms']:.1f}%; "
          f"{ss['tries']} profiled window(s)); the host's "
          f"dispatch returned after {ss['dispatch_ms']:.2f} ms; unprofiled: "
          f"wall {ss['wall_plain_ms']:.2f} ms, dispatch returned after "
          f"{ss['dispatch_plain_ms']:.2f} ms ({card})")
    if ss["missed"]:
        phase(f"stage split: the profiled windows before the last missed "
              f"device records: {ss['missed']}")
    lk["k1_kernel_ms"] = ss["split"]["K1"]
    lk["k2_kernel_ms"] = ss["split"]["K2"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lb.run_events_batch(head)
    peak = torch.cuda.max_memory_allocated()
    phase(f"peak device memory of one B = {HEAD_BATCH} x {HEAD_SECONDS} s "
          f"batch: {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    lk["k1_bound"] = bound(lk["k1_bytes"], lk["k1_flop"])
    lk["k2_bound"] = bound(lk["k2_bytes"], 0)
    phase(f"time at the loopback's shape: K1 {fmt_ms(lk['k1_kernel_ms'])} "
          f"alone, {lk['k1_ms']:.4f} ms per call, plain {lk['k1_plain_ms']:.1f}"
          f" ms, bound {lk['k1_bound'][0]:.4f} ms ({lk['k1_bound'][1]}); K2 "
          f"{fmt_ms(lk['k2_kernel_ms'])} alone, {lk['k2_ms']:.4f} ms per call, "
          f"plain {lk['k2_plain_ms']:.1f} ms (CPU loop), roofline "
          f"{lk['k2_bound'][0]:.4f} ms ({lk['k2_bound'][1]}) ({card})")

    # ---- 18-19. the fleet service at world size 1, then on two ranks ----
    fleet = fleet_phase(cfg, audio, dev)
    fl = fleet["launches"]
    phase(f"fleet at world size 1 (NCCL, a localhost store; init "
          f"{fleet['init_s']:.2f} s, set-up): launches with the counts set "
          f"to 0 before the two fleet rows and sharded_decode_step: K1 "
          f"{fl['fused_score']}, K2 {fl['mega_rx']}, K3 one-row "
          f"{fl['correlate']}, K3 rows {fl['correlate_batch']}, K4 "
          f"{fl['tx_synth']}, K5 {fl['frame_channels']}, plain calls "
          f"{fl['plain']} (synthesis "
          f"{fl['plain_synth']}); sharded_decode_step [{STEP_BATCH}, {STEP_LEN}] "
          f"and [1, {STEP_LEN}] (walls {fleet['step_s'][STEP_BATCH]:.3f} "
          f"and {fleet['step_s'][1]:.3f} s, the first call's scorer "
          f"set-up included): {fleet['step_words']} words differ from the "
          f"plain chain's (correlate_plain, then the channel math); fleet "
          f"events == the single card's (loopback, ingest): True")
    phase(f"fleet kernels at the fleet's shapes against their plain "
          f"versions on the same inputs: {held_line(fleet['held'])}")
    for name, r in fleet["rows"].items():
        extra = {k: v for k, v in r.items() if k not in (
            "mode", "audio_seconds", "wall_seconds", "real_time_factor",
            "decode_exact")}
        phase(f"bench {name} ({r['mode']}, {extra}): "
              f"{r['audio_seconds']:.1f} audio s in "
              f"{r['wall_seconds'] * 1e3:.1f} ms = {r['real_time_factor']:.1f}"
              f"x real time, decode exact {r['decode_exact']} ({card})")
    for name, walls, audio_s, single in (
            ("loopback", fleet["lb_walls"], fleet["lb_audio_s"],
             "DeviceLoopback"),
            ("ingest", fleet["in_walls"], fleet["in_audio_s"],
             "DeviceReceiver")):
        phase(f"time fleet {name} against the single-card {single} on the "
              f"same inputs, in turns, best of 3: fleet {walls[0] * 1e3:.2f} "
              f"ms = {audio_s / walls[0]:.1f}x real time, single card "
              f"{walls[1] * 1e3:.2f} ms = {audio_s / walls[1]:.1f}x; the "
              f"service layer's overhead at world size 1 "
              f"{100 * (walls[0] / walls[1] - 1):+.1f}% ({card})")
    dec = decomposition_phase(dev)
    parts = "; ".join(
        f"{r['name']} rank {r['rank']} ({r['device']}): == world size 1 "
        f"{r['same']}, K1 {r['launches']['fused_score']}, K2 "
        f"{r['launches']['mega_rx']}, plain {r['launches']['plain']}, "
        f"{r['wall_s'] * 1e3:.1f} ms" for r in dec["rows"])
    phase(f"decomposition on the one card: worlds of 2 gloo ranks on cuda:0 "
          f"(gloo, because NCCL takes one rank per device), "
          f"{dec['audio_s']:.1f} s of Bell-202 in 4 streams and SAME in 3; "
          f"{parts}; the world's start and run {dec['spawn_s']:.1f} s "
          f"({card})")
    phase("decomposition kernels on each rank's block or shard against "
          "their plain versions on the same inputs: " + " | ".join(
              f"{r['name']} rank {r['rank']}: {held_line(r['held'])}"
              for r in dec["rows"]))
    import torch.distributed as dist

    dist.destroy_process_group()
    # ---- 20. the fleet across the cards, where the machine has several ----
    n_cards = torch.cuda.device_count()
    cards = (cards_phase(n_cards, card, dev) if n_cards > 1
             else {"launches": []})

    # ---- 21. the delta-bitpack wire ----
    wpk = wirepack_phase(s16_file, text, card, dev)

    # ---- 22. the runner, the sp curve and the soak ----
    ent = entry_points_phase(card)
    rl, sl = ent["launches"], ent["selfcheck_launches"]

    def curve_launches(k: str) -> dict:
        return {sp: [n[k] for n in per_rank]
                for sp, per_rank in ent["curve_launches"].items()}

    # K1: the audio row read and the planes written once; 4 * nb FMAs per
    # scored offset (stage 2's comb sums are a few percent more)
    geo1 = scorer.geo
    k1_bound = bound(4 * (t_total + halo + pk.shape[1] * t_total),
                     2 * 4 * geo1.nb * t_total)
    # K2: the plane words its decisions read, the events, bytes and carry
    # written; its FLOPs are a handful per frame.  The chain estimate: one
    # step per frame search, each waiting on the one before
    k2_bound = bound(4 * k2_words + 32 * int(out_k[1][0])
                     + int(out_k[3][0]) + 48, 0)
    k2_chain_ms = k2_search * K2_STEP_NS_ESTIMATE * 1e-6
    phase(f"bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}); K2 roofline "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]}: {k2_words} plane words "
          f"read); K2 chain estimate, not measured: {k2_chain_ms:.4f} ms "
          f"({k2_search} searches x an estimated "
          f"{K2_STEP_NS_ESTIMATE:.0f} ns) ({card})")
    src = "minimodem_tpu_torch/csrc/"
    k3a, k3b = k3["correlate"], k3["correlate_batch"]
    # K5: its numbers at uic-train's tile (the batch of 16 streams), its
    # launches on uic-train's file decode; every check it was held to
    k5_uic = next(r for r in geo_rows if r["name"] == "uic-train")
    k5_tile = k5_uic["split"]
    k5_checks = ([r["split"] for r in geo_rows] + list(host_k5.values())
                 + [r["held"]["frame_channels"] for r in geo_rows]
                 + [r["held"]["frame_channels"] for r in host.values()]
                 + [fleet["held"]["frame_channels"]])
    print(json.dumps({"kernels": [
        {"name": "fused_score", "route": "cuda",
         "source": src + "fused_score.cu",
         "replaces": "minimodem_tpu/ops/pallas_score.py:417",
         "launches": launches["fused_score"], "max_abs_err": k1_err,
         "ms": k1_ms, "kernel_ms": k1_kernel_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "loopback_launches": lb_launches["fused_score"],
         "autodetect_launches": auto["launches"]["fused_score"],
         "fleet_launches": fl["fused_score"],
         "decomposition_launches": [
             r["launches"]["fused_score"] for r in dec["rows"]],
         "cards_launches": [r["fused_score"] for r in cards["launches"]],
         "wirepack_launches": wpk["launches"]["fused_score"],
         "runner_launches": rl["fused_score"],
         "curve_launches": curve_launches("fused_score"),
         "selfcheck_launches": sl["fused_score"],
         "loopback_ms": lk["k1_ms"], "loopback_kernel_ms": lk["k1_kernel_ms"],
         "loopback_plain_ms": lk["k1_plain_ms"],
         "loopback_bound_ms": lk["k1_bound"][0],
         "loopback_bound_by": lk["k1_bound"][1],
         **stream_keys(strm, live, soak, "k1", "fused_score")},
        {"name": "mega_rx", "route": "cuda", "source": src + "mega_rx.cu",
         "replaces": "minimodem_tpu/ops/pallas_rx.py:1100",
         "launches": launches["mega_rx"], "max_abs_err": k2_err,
         "ms": k2_ms, "kernel_ms": k2_kernel_ms, "us_per_frame": k2_us_frame,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "loopback_launches": lb_launches["mega_rx"],
         "autodetect_launches": auto["launches"]["mega_rx"],
         "fleet_launches": fl["mega_rx"],
         "decomposition_launches": [
             r["launches"]["mega_rx"] for r in dec["rows"]],
         "cards_launches": [r["mega_rx"] for r in cards["launches"]],
         "wirepack_launches": wpk["launches"]["mega_rx"],
         "wirepack_uic_launches": wpk["uic_launches"]["mega_rx"],
         "runner_launches": rl["mega_rx"],
         "curve_launches": curve_launches("mega_rx"),
         "selfcheck_launches": sl["mega_rx"],
         "geometry_launches": {r["name"]: r["launches"]["mega_rx"]
                               for r in geo_rows},
         "geometry_batch_launches": {r["name"]: r["batch_launches"]["mega_rx"]
                                     for r in geo_rows},
         "no_ring_ms": {"B=1": ab1["none"], "B=160": ab160["none"]},
         "ring_ms": {"B=1": ab1["ring"], "B=160": ab160["ring"]},
         "loopback_ms": lk["k2_ms"], "loopback_kernel_ms": lk["k2_kernel_ms"],
         "loopback_plain_ms": lk["k2_plain_ms"],
         "loopback_bound_ms": lk["k2_bound"][0],
         "loopback_bound_by": lk["k2_bound"][1],
         **stream_keys(strm, live, soak, "k2", "mega_rx")},
        {"name": "correlate", "route": "cuda", "source": src + "correlate.cu",
         "replaces": "minimodem_tpu/ops/pallas_demod.py:84",
         "launches": host["host"]["launches"],
         "max_abs_err": k3a["max_abs_err"], "ms": k3a["ms"],
         "kernel_ms": k3a["kernel_ms"], "plain_ms": k3a["plain_ms"],
         "bound_ms": k3a["bound_ms"], "bound_by": k3a["bound_by"],
         "library_ms": k3a["library_ms"],
         "library_device_ms": k3a["library_device_ms"],
         "loopback_launches": 0, "fleet_launches": fl["correlate"],
         "wirepack_uic_launches": wpk["uic_launches"]["correlate"],
         "runner_launches": rl["correlate"],
         "curve_launches": curve_launches("correlate"),
         "selfcheck_launches": sl["correlate"],
         "geometry_launches": {r["name"]: r["launches"]["correlate"]
                               for r in geo_rows if r["route"] == "K3"}},
        {"name": "correlate_batch", "route": "cuda",
         "source": src + "correlate.cu",
         "replaces": "minimodem_tpu/ops/pallas_demod.py:138",
         "launches": host["host-native"]["launches"],
         "max_abs_err": k3b["max_abs_err"], "ms": k3b["ms"],
         "kernel_ms": k3b["kernel_ms"], "plain_ms": k3b["plain_ms"],
         "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"],
         "library_ms": k3b["library_ms"],
         "library_device_ms": k3b["library_device_ms"],
         "loopback_launches": 0,
         "fleet_launches": fl["correlate_batch"],
         "wirepack_uic_launches": wpk["uic_launches"]["correlate_batch"],
         "runner_launches": rl["correlate_batch"],
         "curve_launches": curve_launches("correlate_batch"),
         "selfcheck_launches": sl["correlate_batch"],
         "geometry_batch_launches": {
             r["name"]: r["batch_launches"]["correlate_batch"]
             for r in geo_rows if r["route"] == "K3"}},
        {"name": "tx_synth", "route": "cuda", "source": src + "tx_synth.cu",
         "replaces": "minimodem_tpu/ops/tx_device.py:179-288 traced into "
                     "minimodem_tpu/ops/device_rx.py:1108-1186 (an XLA "
                     "fusion; no pallas_call)",
         "launches": lb_launches["tx_synth"],
         "max_abs_err": max(r["max_abs_err"] for r in k4["rows"]
                            if r["atol"] == 0.0),
         "frames_max_abs_err": max(r["max_abs_err"] for r in k4["rows"]
                                   if r["name"].startswith("frames")),
         "differ_vs_cpu": {r["name"]: r["differ"] for r in k4["rows"]
                           if r["name"].endswith("on the CPU")},
         "ms": k4h["ms"], "kernel_ms": k4h["kernel_ms"],
         "queued_ms": k4h["queued_ms"], "plain_ms": k4h["plain_ms"],
         "bound_ms": k4h["bound"][0], "bound_by": k4h["bound"][1],
         "library_ms": None, "fp64_sines": k4h["sines"],
         "pipe_floors_ms": k4h["floors"],
         "clock_under_load_mhz": k4h["loaded_mhz"],
         "per_sample": {k: cen[k]["per_sample"] for k in K4_KERNELS},
         "registers": {k: cen[k]["registers"] for k in K4_KERNELS},
         "sine_check": k4["sine"],
         "frames": {r["mode"]: {
             "kernel_ms": r["kernel_ms"], "queued_ms": r["queued_ms"],
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "pipe_floors_ms": r["floors"]} for r in k4["frames"]},
         "loopback_launches": lb_launches["tx_synth"],
         "loopback_kernel_ms": ss["split"]["K4 synthesis"],
         "rows_launches": rows_launches["tx_synth"],
         "frames_launches": rows_launches["tx_synth_frames"],
         "fleet_launches": fl["tx_synth"],
         "cards_launches": [r["tx_synth"] for r in cards["launches"]],
         "runner_launches": rl["tx_synth"],
         "runner_frames_launches": rl["tx_synth_frames"]},
        {"name": "frame_channels", "route": "cuda",
         "source": src + "frame_channels.cu",
         "replaces": "minimodem_tpu/ops/demod.py:215 traced into "
                     "minimodem_tpu/ops/demod.py:299-325 and "
                     "minimodem_tpu/ops/device_rx.py:244-309 (jitted at "
                     ":998; an XLA fusion, no pallas_call)",
         "launches": k5_uic["launches"]["frame_channels"],
         "max_abs_err": max(r["max_abs_err"] for r in k5_checks),
         "ms": k5_tile["ms"], "kernel_ms": k5_tile["kernel_ms"],
         "queued_ms": k5_tile["queued_ms"], "plain_ms": k5_tile["plain_ms"],
         "bound_ms": k5_tile["bound"][0], "bound_by": k5_tile["bound"][1],
         "library_ms": None, "shape": k5_tile["shape"],
         "stage1_ms": k5_tile["stage1_ms"],
         "geometry_launches": {r["name"]: r["launches"]["frame_channels"]
                               for r in geo_rows},
         "geometry_batch_launches": {
             r["name"]: r["batch_launches"]["frame_channels"]
             for r in geo_rows},
         "geometry_tiles": {r["name"]: {
             "shape": r["split"]["shape"], "tiles": r["tiles"],
             "stage1_ms": r["split"]["stage1_ms"], "ms": r["split"]["ms"],
             "kernel_ms": r["split"]["kernel_ms"],
             "queued_ms": r["split"]["queued_ms"],
             "plain_ms": r["split"]["plain_ms"],
             "bound_ms": r["split"]["bound"][0],
             "bound_by": r["split"]["bound"][1],
             "score_planes_ms": r["score_ms"]} for r in geo_rows},
         "host_launches": {e: r["k5_launches"] for e, r in host.items()},
         "host_forms": {f: {
             "shape": r["shape"], "stage1_ms": r["stage1_ms"],
             "ms": r["ms"], "kernel_ms": r["kernel_ms"],
             "queued_ms": r["queued_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
             for f, r in host_k5.items()},
         "perfect_launches": perfect["frame_channels"],
         "autodetect_host_launches":
             auto_all["host"]["launches"]["frame_channels"],
         "fleet_launches": fl["frame_channels"],
         "wirepack_uic_launches": wpk["uic_launches"]["frame_channels"],
         "runner_launches": rl["frame_channels"],
         "curve_launches": curve_launches("frame_channels"),
         "selfcheck_launches": sl["frame_channels"]},
    ]}), flush=True)
    phase(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
