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
  5. timings, each beside the card's name and power limit;
  6. K3, the stage-1 correlation, against its plain version on the card
     at the host engines' shapes from the same audio (plus noise): one
     131072-sample chunk with its halo (the K3a form) and all of the
     stream's chunks as overlapping rows at a row stride (the K3b form),
     bit for bit;
  7. the host engines end to end on the same file: `--engine host` and
     `--engine host-native`, in process (K3 launch counts, plain calls 0)
     and as --device cuda / --device cpu subprocesses: stdout byte-exact,
     stderr equal to the device engine's;
  8. the float64 route: `1200 --samplerate 24000 -M 1200 -S 2400 --engine
     host` prints confidence=inf and (rate perfect), cuda == cpu;
  9. `-a --engine host` on two bursts with a retune between them, cuda ==
     cpu byte for byte;
 10. K3 and host-engine timings (warm decode walls, the host engine's
     split between chunk scoring and the Python state machine, a
     torch.profiler breakdown), each beside the card's name and power
     limit.

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


def k3_check(audio, dev) -> dict:
    """K3 against its plain version at the host engines' shapes: the
    stream (plus uniform noise of amplitude 0.3) in chunk rows of
    chunk_len + halo samples at stride chunk_len, as
    DemodScorer.score_chunks hands them over.  -> per form: shapes,
    bit-different words, max_abs_err, kernel and plain ms."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain
    from minimodem_tpu_torch.ops.demod import DemodScorer, make_basis

    sc = DemodScorer(FskModem("1200").cfg, device=dev)
    geo, t_len = sc.geo, sc.chunk_len
    s_len = t_len + geo.max_begin
    n_chunks = -(-len(audio) // t_len)
    flat = np.zeros(n_chunks * t_len + geo.halo, np.float32)
    flat[:len(audio)] = audio
    rng = np.random.default_rng(SEED + 3)
    flat += (rng.random(flat.size, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.6)
    rows = torch.from_numpy(flat).to(dev).unfold(0, t_len + geo.halo, t_len)
    corr = Correlator(make_basis(geo, np.float32))
    basis = corr.basis(dev)
    out = {}
    for name, x in (("correlate", rows[:1]), ("correlate_batch", rows)):
        k = corr(x, s_len)
        p = correlate_plain(x, basis, s_len)
        torch.cuda.synchronize()
        kn, pn = k.cpu().numpy(), p.cpu().numpy()
        out[name] = {
            "shape": f"{list(x.shape)} (row stride {x.stride(0)}) -> "
                     f"{list(kn.shape)}",
            "words": int(np.count_nonzero(kn.view(np.uint32)
                                          != pn.view(np.uint32))),
            "max_abs_err": float(np.abs(kn.astype(np.float64) - pn).max()),
            "ms": cuda_ms(lambda: corr(x, s_len), 20),
            "kernel_ms": kernel_device_ms(lambda: corr(x, s_len), 20,
                                          "correlate_kernel"),
            "plain_ms": cuda_ms(lambda: correlate_plain(x, basis, s_len), 3),
        }
    return out


def host_engines(wav: str, text: bytes, err_device: str) -> dict:
    """The host engines on the file: in process on the card with the
    counts set to 0 just before and read just after, then as --device
    cuda and --device cpu subprocesses."""
    from minimodem_tpu_torch.ops.correlate import Correlator, correlate_plain
    from minimodem_tpu_torch.ops.fused_score import score_planes_plain
    from minimodem_tpu_torch.ops.mega_rx import mega_rx_plain

    res = {}
    for engine, count in (("host", "launches"),
                          ("host-native", "batch_launches")):
        argv = ["--rx", "--file", wav, "1200", "--engine", engine,
                "--device", "cuda"]
        run_cli_inprocess(argv)                        # warm-up
        Correlator.launches = Correlator.batch_launches = 0
        correlate_plain.calls = score_planes_plain.calls = 0
        mega_rx_plain.calls = 0
        t0 = time.perf_counter()
        rc, out, err = run_cli_inprocess(argv)
        wall_s = time.perf_counter() - t0
        launches = getattr(Correlator, count)
        plain = (correlate_plain.calls + score_planes_plain.calls
                 + mega_rx_plain.calls)
        if rc != 0 or out != text or err != err_device:
            fail(f"--engine {engine} in process: rc {rc}, stdout exact "
                 f"{out == text}, stderr == device engine's "
                 f"{err == err_device}\n{err}")
        if launches < 1 or plain:
            fail(f"--engine {engine}: K3 {count} {launches}, plain calls "
                 f"{plain}")
        rc_c, out_c, err_c = run_cli_subprocess(argv)
        rc_p, out_p, err_p = run_cli_subprocess(argv[:-1] + ["cpu"])
        ok = (rc_c == rc_p == 0 and out_c == out_p == text
              and err_c == err_p == err_device)
        phase(f"end to end --engine {engine}: in process stdout byte-exact, "
              f"stderr == device engine's; K3 {count} {launches}, plain "
              f"calls {plain}; subprocesses cuda/cpu stdout exact "
              f"{out_c == text}/{out_p == text}, stderr == device engine's "
              f"{err_c == err_device}/{err_p == err_device}")
        if not ok:
            fail(f"--engine {engine} subprocesses: rc {rc_c}/{rc_p}\n"
                 f"{err_c}\n{err_p}")
        res[engine] = {"launches": launches, "wall_s": wall_s,
                       "profile": profile_decode(argv)}
    return res


def perfect_check(tmp: str) -> None:
    """The float64 route through the host engine on the card."""
    args = ["1200", "--samplerate", "24000", "-M", "1200", "-S", "2400"]
    ptext = b"".join(b"perfect line %03d\n" % i for i in range(40))
    path = os.path.join(tmp, "perfect.wav")
    rc, _, err = run_cli_subprocess(["--tx", "--file", path, *args], ptext)
    if rc != 0:
        fail(f"perfect tx: {err}")
    runs = [run_cli_inprocess(["--rx", "--file", path, *args, "--engine",
                               "host", "--device", d])
            for d in ("cuda", "cpu")]
    rc, out, err = runs[0]
    ok = (rc == 0 and out == ptext and "confidence=inf" in err
          and "(rate perfect)" in err and runs[0] == runs[1])
    phase(f"float64 route ({' '.join(args)} --engine host): stdout exact "
          f"{out == ptext}, cuda == cpu {runs[0] == runs[1]}; stderr: "
          f"{err.strip()!r}")
    if not ok:
        fail("the float64 host-engine decode disagrees")


def autodetect_check(dev) -> None:
    """-a --engine host on two bursts with a retune between them (the
    signal of tests/test_autodetect_device.py::test_rearm_retune)."""
    import numpy as np
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.correlate import Correlator
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
    outs = []
    for d in (dev, "cpu"):
        sink, err = io.BytesIO(), io.StringIO()
        launches = Correlator.launches
        Receiver(bell_like(300, 24000).cfg,
                 RxOptions(carrier_autodetect_threshold=0.001),
                 get_codec("ascii8"), sink.write, err.write,
                 device=d).run(stream.copy(), engine="host")
        outs.append((sink.getvalue(), err.getvalue(),
                     Correlator.launches - launches))
    ok = outs[0][:2] == outs[1][:2] and outs[0][0] == b"AT 1200AT 1800"
    phase(f"-a --engine host, retune between bursts: cuda == cpu "
          f"{outs[0][:2] == outs[1][:2]}, stdout {outs[0][0]!r}, K3 "
          f"launches on the card {outs[0][2]}; stderr: {outs[0][1]!r}")
    if not ok or outs[0][2] < 1:
        fail("-a --engine host disagrees between cuda and cpu")


def host_engine_split(wav: str, device) -> str:
    """One warm host-engine decode of the file, its wall split between
    chunk scoring (DemodScorer.score: upload, K3, channel math and the
    one synchronising D2H copy per chunk) and the rest (the Python state
    machine and rendering)."""
    import numpy as np
    import torch
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops.demod import DemodScorer
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
    return (f"wall {1e3 * wall:.2f} ms (after the WAV read): chunk scoring "
            f"{1e3 * spent[1]:.2f} ms in {spent[0]} calls "
            f"({100 * spent[1] / wall:.1f}%), Python state machine and "
            f"render {1e3 * (wall - spent[1]):.2f} ms")


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

        # ---- 6-9. K3 and the host engines ----
        k3 = k3_check(audio, dev)
        for name, r in k3.items():
            phase(f"K3 {name} vs plain at {r['shape']}: bit-different "
                  f"words {r['words']}, max_abs_err {r['max_abs_err']}")
            if r["words"]:
                fail(f"K3 {name} disagrees with its plain version")
        host = host_engines(wav, text, err_cuda)
        host_split_line = host_engine_split(wav, dev)
        perfect_check(tmp)
        autodetect_check(dev)

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

    # ---- 10. K3 and host-engine timings ----
    for name, r in k3.items():
        dev_ms = ("not measured" if r["kernel_ms"] is None
                  else f"{r['kernel_ms']:.4f} ms")
        phase(f"time K3 {name} {r['shape']}: kernel {r['ms']:.4f} ms per "
              f"wrapper call (CUDA events), {dev_ms} device time of the "
              f"kernel alone (torch.profiler), plain {r['plain_ms']:.4f} ms "
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
        {"name": "correlate", "route": "cuda", "source": src + "correlate.cu",
         "replaces": "minimodem_tpu/ops/pallas_demod.py:84",
         "launches": host["host"]["launches"],
         "max_abs_err": k3["correlate"]["max_abs_err"],
         "ms": k3["correlate"]["ms"],
         "plain_ms": k3["correlate"]["plain_ms"]},
        {"name": "correlate_batch", "route": "cuda",
         "source": src + "correlate.cu",
         "replaces": "minimodem_tpu/ops/pallas_demod.py:138",
         "launches": host["host-native"]["launches"],
         "max_abs_err": k3["correlate_batch"]["max_abs_err"],
         "ms": k3["correlate_batch"]["ms"],
         "plain_ms": k3["correlate_batch"]["plain_ms"]},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
