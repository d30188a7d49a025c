"""--benchmarks mode: tone-generator throughput in 4 configurations
(reference: src/minimodem.c:305-365), plus the decode throughput rows that
the device engine and the on-device loopback serve, and `main`, the
headline runner:

    python -m minimodem_tpu_torch.bench [audio_seconds] [batch] [--device cuda|cpu]

Counterpart of minimodem_tpu/bench.py: the same rows and result keys, run
on an explicit `device` (default "cuda"; "cpu" runs the kernels' plain
versions).  The fleet rows run the fleet service (parallel/) on the
world of ranks the process belongs to, a world of one without a
launcher.  Without a card a "cuda" row raises; nothing falls back to the
CPU.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import __version__
from .sigio import Direction, SampleFormat, open_stream
from .ops.tx import ToneGenerator
from .utils import device as _device


def _encode_wire(samples: np.ndarray, encoding: str) -> np.ndarray:
    """float [-1, 1) samples -> 1-byte/sample telephony wire (u-law,
    A-law, or offset-binary PCM8), via the container codecs so the
    bench wire matches file ingest byte-exactly."""
    from .sigio.containers import _alaw_encode, _ulaw_encode

    s16 = np.clip(np.rint(samples * 32768.0), -32768,
                  32767).astype(np.int16)
    enc_fn = {"ulaw": _ulaw_encode, "alaw": _alaw_encode,
              "pcm8": lambda v: ((v.astype(np.int32) >> 8) + 128)
              .astype(np.uint8)}[encoding]
    return enc_fn(s16)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "cpu model")):
                    return line.strip()
    except OSError:
        pass
    return "cpu model\t: unknown"


def _power_limit(index: int) -> str:
    """The card's power limit as nvidia-smi reports it."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
        return r.stdout.strip() if r.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _device_model(device=_device.DEFAULT) -> str:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "accelerator\t: none"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (f"accelerator\t: {torch.cuda.get_device_name(index)}, "
            f"{_power_limit(index)} (cuda)")


def generate_test_tones(gen: ToneGenerator, stream, duration_sec: int,
                        synth_backend: str) -> None:
    """Alternating 1000/1777 Hz tones (reference: src/minimodem.c:293-303)."""
    rate = stream.rate
    nframes = rate // 10
    for _ in range(rate // nframes * duration_sec):
        gen.tone(1000, nframes // 2)
        gen.tone(1777, nframes // 2)
        stream.write(gen.synthesize(synth_backend))


def run_tx_benchmarks(duration_sec: int = 10,
                      synth_backend: str = "numpy",
                      device=_device.DEFAULT) -> None:
    print(f"minimodem-tpu-torch {__version__} benchmarks")
    print(_cpu_model())
    print(_device_model(device))
    sys.stdout.flush()

    sample_rate = 48000
    configs = [
        (1024, SampleFormat.S16, "generate-tones-lut1024-S16-mono"),
        (1024, SampleFormat.FLOAT, "generate-tones-lut1024-FLOAT-mono"),
        (0, SampleFormat.S16, "generate-tones-nolut-S16-mono"),
        (0, SampleFormat.FLOAT, "generate-tones-nolut-FLOAT-mono"),
    ]
    for lut, fmt, name in configs:
        stream = open_stream("benchmark", None, Direction.PLAYBACK, fmt,
                             sample_rate, 1, "minimodem-tpu", name)
        gen = ToneGenerator(sample_rate, fmt, lut, 1.0, device)
        generate_test_tones(gen, stream, duration_sec, synth_backend)
        stream.close()


def run_decode_benchmarks(audio_seconds: float = 10.0,
                          device=_device.DEFAULT) -> None:
    """Decode-throughput section of `--benchmarks`: end-to-end and
    on-device real-time factors in the reference's `name   rate
    samples/sec` layout.  A missing device raises (no row is hidden)."""
    rows = [
        ("decode-Bell202-e2e-host",
         decode_throughput("1200", audio_seconds=audio_seconds,
                           device=device)),
        ("decode-Bell202-e2e-ulaw",
         decode_throughput("1200", audio_seconds=audio_seconds,
                           encoding="ulaw", device=device)),
        ("decode-Bell202-on-device",
         loopback_throughput("1200", audio_seconds=audio_seconds,
                             device=device)),
    ]
    for name, r in rows:
        sps = r["real_time_factor"] * 48000
        flag = "" if r["decode_exact"] else "  (DECODE MISMATCH)"
        print(f"  {name:<40} {r['real_time_factor']:10.1f}x realtime "
              f"{sps:14.0f} samples/sec{flag}")
        sys.stdout.flush()


def _bench_payload(cfg, audio_seconds: float) -> bytes:
    rate = float(cfg.data_rate)
    nbytes = max(16, int(audio_seconds * rate / cfg.frame_n_bits))
    return bytes((33 + (i % 94)) for i in range(nbytes))


def decode_throughput(mode: str = "1200", audio_seconds: float = 60.0,
                      sample_rate: int = 48000, warmup: bool = True,
                      precision: str = "auto", s16: bool = True,
                      repeats: int = 1, encoding: str = None,
                      device=_device.DEFAULT) -> dict:
    """End-to-end RX decode throughput (host audio -> decoded bytes) as a
    real-time factor (audio-seconds decoded per wall-clock second).

    The full sample stream crosses the host link; repeats > 1 re-times
    the same call and keeps the best wall.  encoding="ulaw"/"alaw"/"pcm8"
    measures the 1-byte-per-sample telephony ingest (raw bytes up, G.711
    expansion on the device, bit-identical to a host-expanded read)."""
    from .models.modem import FskModem

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    payload = _bench_payload(m.cfg, audio_seconds)
    samples = m.modulate(payload)
    if encoding is not None:
        samples = _encode_wire(samples, encoding)
    elif s16:
        samples = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
    audio_sec = len(samples) / sample_rate

    if warmup:
        m.demodulate(samples, in_encoding=encoding)  # kernel build

    dt = float("inf")
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        out = m.demodulate(samples, in_encoding=encoding)
        dt = min(dt, time.perf_counter() - t0)

    ok = out == payload
    return {
        "mode": mode,
        "encoding": encoding or ("pcm16" if s16 else "float32"),
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
        "decoded_bytes": len(out),
        "expected_bytes": len(payload),
    }


def _pipelined(batches, dispatch, prefetch, collect):
    """Depth-2 serving loop with async result prefetch: while the device
    runs batch j, batch j-1's results copy and batch j-2 unpacks on the
    host.  -> (results per batch, wall seconds)."""
    results, handles = [], []
    t0 = time.perf_counter()
    for j, b in enumerate(batches):
        handles.append(dispatch(b))
        if j >= 1:
            prefetch(handles[j - 1])
        if j >= 2:
            results.append(collect(handles[j - 2]))
    for h in handles[-2:]:
        results.append(collect(h))
    return results, time.perf_counter() - t0


def batched_loopback_throughput(mode: str = "1200",
                                audio_seconds: float = 60.0,
                                batch: int = 16,
                                sample_rate: int = 48000,
                                precision: str = "auto",
                                pipeline: int = 1,
                                chain: int = 1,
                                device=_device.DEFAULT) -> dict:
    """Aggregate decode throughput with `batch` concurrent streams in one
    device program (the serving configuration): audio-seconds decoded per
    wall-clock second per card.

    pipeline=1 times one synchronous call (upload, synthesis, K1, K2, the
    result copy and the host's unpack, serialized).  pipeline=K>1 times
    the steady-state loop: batch j+1 is dispatched before batch j's
    results are collected; the wall still covers every dispatch, every
    collected result and the pipeline fill.  Every decoded byte of every
    batch is verified (decode_exact covers all K * batch streams).

    chain=C>1 (pipeline % C == 0, pipeline / C >= 2) groups the batches
    into chains of C enqueued back to back and collected together
    (DeviceLoopback.dispatch_events_chain), pipelined across chains."""
    from .codecs import Ascii8Codec
    from .models.modem import FskModem
    from .ops.device_rx import DeviceLoopback
    from .ops.tx_device import tx_bit_schedule

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    base = _bench_payload(m.cfg, audio_seconds)
    pipeline = max(1, int(pipeline))
    # distinct payloads per stream AND per pipelined batch (same frame
    # count -> same schedule length, so audio seconds are uniform)
    sets = []
    for j in range(pipeline):
        payloads = [
            bytes((b + i + 7 * j) % 94 + 33 for b in base)
            for i in range(batch)
        ]
        scheds = [tx_bit_schedule(p, m.cfg, Ascii8Codec())
                  for p in payloads]
        sets.append((payloads, scheds))
    audio_one = (sum(len(s) for s in sets[0][1])
                 * m.cfg.bit_nsamples_tx / sample_rate)

    def render_ok(payloads, events) -> bool:
        return _render_ok(m.cfg, "ascii8", payloads, events)

    lb = DeviceLoopback(m.cfg, precision, device=device)
    events = lb.run_events_batch(sets[0][1])  # kernel build + correctness
    ok = render_ok(sets[0][0], events)

    if chain > 1 and (pipeline % chain != 0 or pipeline // chain < 2):
        raise ValueError(
            f"chain={chain} requires pipeline % chain == 0 and "
            f"pipeline // chain >= 2 (got pipeline={pipeline}); the "
            "result record must not mislabel the measured configuration")
    if pipeline == 1:
        t0 = time.perf_counter()
        lb.run_events_batch(sets[0][1])
        dt = time.perf_counter() - t0
        audio_sec = audio_one
    elif chain > 1:
        groups = [[sets[g * chain + j][1] for j in range(chain)]
                  for g in range(pipeline // chain)]
        lb.run_events_chain(groups[0])
        results, dt = _pipelined(groups, lb.dispatch_events_chain,
                                 lb.prefetch_events_chain,
                                 lb.collect_events_chain)
        flat = [r for res in results for r in res]
        audio_sec = audio_one * pipeline
        for j in range(pipeline):
            ok = ok and render_ok(sets[j][0],
                                  flat[j * batch:(j + 1) * batch])
    else:
        results, dt = _pipelined([s[1] for s in sets],
                                 lb.dispatch_events_batch,
                                 lb.prefetch_events_batch,
                                 lb.collect_events_batch)
        audio_sec = audio_one * pipeline
        for j, res in enumerate(results):
            ok = ok and render_ok(sets[j][0], res)

    return {
        "mode": mode,
        "batch": batch,
        "pipeline": pipeline,
        "chain": chain,
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
    }


def fleet_loopback_throughput(mode: str = "1200",
                              audio_seconds: float = 64.3,
                              batch: int = 128, sample_rate: int = 48000,
                              precision: str = "auto",
                              device=_device.DEFAULT) -> dict:
    """The deployment-shape fleet path: ShardedLoopback runs
    DeviceLoopback's exact per-device program on each rank of a
    dp = world mesh (parallel/service.py), B / world streams a rank.  At
    world size 1 it gives the service layer's overhead over the
    single-card loopback; on a fleet it is the per-device number times
    the world.  The wall covers the whole call, the result assembly on
    every rank included."""
    import torch.distributed as dist

    from .codecs import Ascii8Codec
    from .models.modem import FskModem
    from .ops.tx_device import tx_bit_schedule
    from .parallel.service import ShardedLoopback
    from .parallel.sharding import make_mesh

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    base = _bench_payload(m.cfg, audio_seconds)
    payloads = [bytes((b + 3 * i) % 94 + 33 for b in base)
                for i in range(batch)]
    scheds = [tx_bit_schedule(p, m.cfg, Ascii8Codec()) for p in payloads]
    audio_sec = (sum(len(s) for s in scheds)
                 * m.cfg.bit_nsamples_tx / sample_rate)

    mesh = make_mesh(sp=1, device=device)
    flb = ShardedLoopback(m.cfg, mesh, precision, device=device)
    events = flb.run_events_batch(scheds)    # kernel build + correctness
    ok = _render_ok(m.cfg, "ascii8", payloads, events)

    t0 = time.perf_counter()
    flb.run_events_batch(scheds)
    dt = time.perf_counter() - t0
    return {
        "mode": mode,
        "batch": batch,
        "devices": dist.get_world_size(),
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
    }


def fleet_ingest_throughput(mode: str = "1200",
                            audio_seconds: float = 30.0,
                            batch: int = 8, sample_rate: int = 48000,
                            precision: str = "auto",
                            encoding: str = "ulaw",
                            repeats: int = 3,
                            device=_device.DEFAULT) -> dict:
    """The fleet INGEST path: host audio in (u8 telephony wire by
    default: 1 byte a sample, G.711-expanded on the device), decoded by
    ShardedReceiver's per-device program (the wire expansion, K1 and K2)
    on each rank of a dp = world mesh.  Every call uploads each rank's
    block of batch * audio_seconds * sample_rate wire bytes; repeats keep
    the best wall.  `mega` is True: K2, the megakernel's port, serves
    every geometry here."""
    import torch.distributed as dist

    from .models.modem import FskModem
    from .parallel.service import ShardedReceiver
    from .parallel.sharding import make_mesh

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    base = _bench_payload(m.cfg, audio_seconds)
    payloads = [bytes((b + 5 * i) % 94 + 33 for b in base)
                for i in range(batch)]
    waves = [m.modulate(p) for p in payloads]
    if encoding is not None:
        waves = [_encode_wire(w, encoding) for w in waves]
    L = max(len(w) for w in waves)
    x = np.zeros((batch, L), np.uint8 if encoding else np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    totals = [len(w) for w in waves]
    audio_sec = sum(totals) / sample_rate

    mesh = make_mesh(sp=1, device=device)
    svc = ShardedReceiver(m.cfg, mesh, precision, device=device)
    events, _ = svc.run_events_batch(x, totals, 1.5, 2.3,
                                     in_encoding=encoding)
    ok = _render_ok(m.cfg, "ascii8", payloads, events)

    dt = float("inf")
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        svc.run_events_batch(x, totals, 1.5, 2.3, in_encoding=encoding)
        dt = min(dt, time.perf_counter() - t0)
    return {
        "mode": mode,
        "encoding": encoding or "float32",
        "batch": batch,
        "devices": dist.get_world_size(),
        "mega": True,
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
    }


_BAUDOT_CHARS = b"THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789 "


def _mode_payload(m, audio_seconds: float) -> bytes:
    """A payload the mode's own codec can represent, sized to roughly
    audio_seconds of transmit time."""
    if m.preset.encoder == "baudot":
        # ~7.5 bit-times per character frame (5N1.5) + shift frames
        nchars = max(8, int(audio_seconds * float(m.cfg.data_rate)
                            / (m.cfg.nstartbits + m.cfg.n_data_bits + 2)))
        reps = -(-nchars // len(_BAUDOT_CHARS))
        return (_BAUDOT_CHARS * reps)[:nchars]
    return _bench_payload(m.cfg, audio_seconds)


def mode_loopback_throughput(mode: str, audio_seconds: float = 15.0,
                             batch: int = 8, sample_rate: int = 48000,
                             precision: str = "auto",
                             device=_device.DEFAULT) -> dict:
    """Batched on-device loopback for any TX-capable preset: uniform
    framings ride the flat bit schedule, fractional stop bits (rtty 1.5)
    the frame-schedule synthesis path.  Returns the same row shape as
    batched_loopback_throughput."""
    from .codecs import get_codec
    from .models.modem import FskModem
    from .ops.device_rx import DeviceLoopback
    from .ops.tx_device import (
        tx_bit_schedule, tx_frame_schedule, uniform_bits_supported)

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    base = _mode_payload(m, audio_seconds)
    enc = get_codec(m.preset.encoder) if m.preset.encoder != "baudot" \
        else get_codec("baudot", usos=True)
    dec_name = m.preset.decoder
    payloads = [base for _ in range(batch)]

    lb = DeviceLoopback(m.cfg, precision, device=device)
    if uniform_bits_supported(m.cfg):
        scheds = [tx_bit_schedule(p, m.cfg, enc) for p in payloads]
        audio_sec = (sum(len(s) for s in scheds)
                     * m.cfg.bit_nsamples_tx / sample_rate)
        run = lambda: lb.run_events_batch(scheds)  # noqa: E731
    else:
        fscheds = []
        lead_trail = None
        for p in payloads:
            fb, lead, trail = tx_frame_schedule(p, m.cfg, enc)
            fscheds.append(fb)
            lead_trail = (lead, trail)
        audio_sec = sum(
            lead_trail[0] * m.cfg.bit_nsamples_tx
            + fb.shape[0] * lb.frame_len
            + lead_trail[1] * m.cfg.bit_nsamples_tx
            for fb in fscheds) / sample_rate
        run = lambda: lb.run_events_frames_batch(  # noqa: E731
            fscheds, lead_trail)

    events = run()  # kernel build + correctness
    ok = _render_ok(m.cfg, dec_name, payloads, events)

    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    return {
        "mode": mode,
        "batch": batch,
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
    }


def _render_ok(cfg, dec_name: str, payloads, events) -> bool:
    """Render per-stream event tuples through the mode's decoder and
    compare against the expected loopback output (the shared
    decode-exact check every throughput row uses)."""
    import io

    from .codecs import get_codec
    from .config import RxOptions
    from .rx.engine import Receiver

    ok = True
    for i, p in enumerate(payloads):
        sink = io.BytesIO()
        kw = {"usos": True} if dec_name == "baudot" else {}
        rx = Receiver(cfg, RxOptions(), get_codec(dec_name, **kw),
                      sink.write, lambda s: None)
        rx.render_events(*events[i])
        ok = ok and sink.getvalue() == _expected_rendering(dec_name, p)
    return ok


def _expected_rendering(dec_name: str, payload: bytes) -> bytes:
    """What the mode's decoder should print for a clean loopback of
    `payload` (identity for ascii/baudot round trips; the callerid
    formatter output for CID byte vectors)."""
    if dec_name == "callerid":
        from .codecs import get_codec

        c = get_codec("callerid")
        out = b"".join(c.decode(b, 8) for b in payload)
        return out
    return payload


def _cid_message(i: int) -> bytes:
    """A distinct, constant-length MDMF message (the reference's own
    test-fixture shape, tests/70-callerid-mdmf.test)."""
    body = (b"\x01\x08" + b"07040831"
            + b"\x07\x09" + b"ADA LOVE%c" % (65 + i % 26)
            + b"\x02\x0a" + b"41555%05d" % (i % 100000))
    return bytes([0x80, len(body)]) + body + b"\x11"


def callerid_throughput(batch: int = 128, sample_rate: int = 48000,
                        precision: str = "auto",
                        pipeline: int = 4,
                        device=_device.DEFAULT) -> dict:
    """Caller-ID decode: the short-burst serving shape — each stream is
    one ~0.3 s MDMF burst (a ring's worth of Bell-202 bytes, like the
    reference's fixtures, tests/70-callerid-mdmf.test).

    Short bursts are fixed-cost-bound, so the serving configuration
    batches many bursts per program on a small t_total bucket
    (device_rx._sched_pad) and pipelines programs depth-2 with async
    result prefetch, like the Bell-202 loop.  Reports steady-state
    throughput plus the two latency numbers a caller sees: one
    synchronous batched call and a single-burst call."""
    from .codecs import Ascii8Codec
    from .models.modem import FskModem
    from .ops.device_rx import DeviceLoopback
    from .ops.tx_device import tx_bit_schedule

    m = FskModem("callerid", sample_rate=sample_rate, precision=precision,
                 device=device)
    pipeline = max(1, int(pipeline))
    sets = []
    for j in range(pipeline):
        msgs = [_cid_message(j * batch + i) for i in range(batch)]
        scheds = [tx_bit_schedule(p, m.cfg, Ascii8Codec()) for p in msgs]
        sets.append((msgs, scheds))
    audio_one = (sum(len(s) for s in sets[0][1])
                 * m.cfg.bit_nsamples_tx / sample_rate)

    def render_ok(msgs, events) -> bool:
        return _render_ok(m.cfg, "callerid", msgs, events)

    lb = DeviceLoopback(m.cfg, precision, device=device)
    events = lb.run_events_batch(sets[0][1])   # kernel build + correctness
    ok = render_ok(sets[0][0], events)

    # one synchronous batched call: what a just-arrived burst waits for
    t0 = time.perf_counter()
    lb.run_events_batch(sets[0][1])
    batch_latency = time.perf_counter() - t0

    # single-burst call latency
    lb.run_events_batch(sets[0][1][:1])
    t0 = time.perf_counter()
    lb.run_events_batch(sets[0][1][:1])
    single_latency = time.perf_counter() - t0

    if pipeline == 1:
        dt, audio_sec = batch_latency, audio_one
    else:
        results, dt = _pipelined([s[1] for s in sets],
                                 lb.dispatch_events_batch,
                                 lb.prefetch_events_batch,
                                 lb.collect_events_batch)
        audio_sec = audio_one * pipeline
        for j, res in enumerate(results):
            ok = ok and render_ok(sets[j][0], res)

    return {
        "mode": "callerid",
        "batch": batch,
        "pipeline": pipeline,
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
        "batch_latency_ms": batch_latency * 1000.0,
        "single_burst_latency_ms": single_latency * 1000.0,
    }


def loopback_throughput(mode: str = "1200", audio_seconds: float = 60.0,
                        sample_rate: int = 48000,
                        precision: str = "auto",
                        repeats: int = 1,
                        device=_device.DEFAULT) -> dict:
    """Pure on-device decode throughput: the TX bit schedule is synthesized
    and decoded on the device; only frame events cross the host link.
    repeats > 1 keeps the best wall."""
    import io

    from .codecs import Ascii8Codec, get_codec
    from .config import RxOptions
    from .models.modem import FskModem
    from .ops.device_rx import DeviceLoopback
    from .ops.tx_device import tx_bit_schedule
    from .rx.engine import Receiver

    m = FskModem(mode, sample_rate=sample_rate, precision=precision,
                 device=device)
    payload = _bench_payload(m.cfg, audio_seconds)
    sched = tx_bit_schedule(payload, m.cfg, Ascii8Codec())
    audio_sec = len(sched) * m.cfg.bit_nsamples_tx / sample_rate

    lb = DeviceLoopback(m.cfg, precision, device=device)
    result = lb.run_events(sched)  # kernel build + correctness
    sink = io.BytesIO()
    rx = Receiver(m.cfg, RxOptions(), get_codec("ascii8"),
                  sink.write, lambda s: None)
    rx.render_events(*result)
    ok = sink.getvalue() == payload

    dt = float("inf")
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        lb.run_events(sched)
        dt = min(dt, time.perf_counter() - t0)

    return {
        "mode": mode,
        "audio_seconds": audio_sec,
        "wall_seconds": dt,
        "real_time_factor": audio_sec / dt,
        "decode_exact": bool(ok),
    }


def main(argv=None) -> int:
    """The headline runner, the counterpart of the repository's root
    bench.py: the same rows at the same sizes in the same order, and as
    the last line of stdout one JSON object with exactly that runner's
    keys.  Exit code 0 only when every row decoded exact.

    value is the best of the synchronous and the pipelined batched
    loopback; vs_baseline is value / 1000, where 1000x real time is the
    target figure of BASELINE.json, not a measurement.  Before the JSON
    line: the card's name and power limit, the torch and CUDA versions,
    and each row's wall on a line of its own.  Under torchrun every rank
    runs the rows on its own card (cuda:LOCAL_RANK), the fleet rows on
    the whole world, and rank 0 prints.  Without a card a "cuda" run
    exits 1 after one E: line; nothing falls back to the CPU."""
    import argparse

    import torch
    import torch.distributed as dist

    from .cli import _card_ready
    from .parallel.sharding import rank_device

    ap = argparse.ArgumentParser(
        prog="python -m minimodem_tpu_torch.bench",
        description="the headline runner: batched, single-stream, fleet, "
                    "e2e and per-mode real-time factors as one JSON line")
    ap.add_argument("audio_seconds", type=float, nargs="?", default=64.3,
                    help="seconds of audio a stream (default 64.3)")
    ap.add_argument("batch", type=int, nargs="?", default=128,
                    help="streams a batch (default 128)")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=_device.DEFAULT)
    args = ap.parse_args(argv)
    if not _card_ready(args.device):
        return 1
    dev = rank_device(args.device)
    audio_seconds, batch = args.audio_seconds, args.batch
    talk = int(os.environ.get("RANK", "0")) == 0
    if talk:
        print(_device_model(dev), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}",
              flush=True)

    def row(name: str, fn, *a, **kw) -> dict:
        # each row warms itself; its buffers go before the next row starts
        r = fn(*a, device=dev, **kw)
        if talk:
            print(f"row {name}: {r['audio_seconds']:.2f} audio s in "
                  f"{r['wall_seconds'] * 1e3:.2f} ms = "
                  f"{r['real_time_factor']:.2f}x real time, decode exact "
                  f"{r['decode_exact']}", flush=True)
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
        return r

    blb = row("batched", batched_loopback_throughput, "1200",
              audio_seconds=audio_seconds, batch=batch)
    blb2 = row("batched pipelined", batched_loopback_throughput, "1200",
               audio_seconds=audio_seconds, batch=batch, pipeline=8)
    best = max(blb["real_time_factor"], blb2["real_time_factor"])
    lb = row("single stream", loopback_throughput, "1200",
             audio_seconds=audio_seconds, repeats=3)
    fleet = row("fleet loopback", fleet_loopback_throughput, "1200",
                audio_seconds=audio_seconds, batch=batch)
    fleet_in = row("fleet ingest u-law", fleet_ingest_throughput, "1200",
                   audio_seconds=30.0, batch=8, repeats=3)
    e2e = row("e2e pcm16", decode_throughput, "1200",
              audio_seconds=2 * audio_seconds, repeats=3)
    e2e_u = row("e2e u-law", decode_throughput, "1200",
                audio_seconds=2 * audio_seconds, repeats=3, encoding="ulaw")

    modes = {}
    for mode_name in ("rtty", "same"):
        r = row(mode_name, mode_loopback_throughput, mode_name,
                audio_seconds=15.0, batch=8)
        modes[mode_name] = {
            "real_time_factor": round(r["real_time_factor"], 2),
            "decode_exact": r["decode_exact"],
            "audio_seconds": round(r["audio_seconds"], 2),
        }
    r = row("callerid", callerid_throughput, batch=128, pipeline=4)
    modes["callerid"] = {
        "real_time_factor": round(r["real_time_factor"], 2),
        "decode_exact": r["decode_exact"],
        "audio_seconds": round(r["audio_seconds"], 2),
        "batch": r["batch"],
        "batch_latency_ms": round(r["batch_latency_ms"], 1),
        "single_burst_latency_ms": round(r["single_burst_latency_ms"], 1),
    }
    if dist.is_initialized():
        dist.destroy_process_group()

    ok = all(r["decode_exact"]
             for r in (blb, blb2, lb, e2e, e2e_u, fleet, fleet_in)) \
        and all(m["decode_exact"] for m in modes.values())
    out = {
        "metric": "bell202_48k_decode_realtime_factor",
        "value": round(best, 2),
        "unit": "x_realtime_per_chip",
        "vs_baseline": round(best / 1000.0, 4),
        "decode_exact": ok,
        "batch": batch,
        "single_stream_realtime_factor": round(lb["real_time_factor"], 2),
        "e2e_realtime_factor": round(e2e["real_time_factor"], 2),
        "e2e_ulaw_realtime_factor": round(e2e_u["real_time_factor"], 2),
        "e2e_audio_seconds": round(e2e["audio_seconds"], 2),
        "audio_seconds_total": round(blb["audio_seconds"], 2),
        "single_call_batched_realtime_factor": round(
            blb["real_time_factor"], 2),
        "pipelined_batches": blb2["pipeline"],
        "pipelined_realtime_factor": round(blb2["real_time_factor"], 2),
        "fleet_realtime_factor": round(fleet["real_time_factor"], 2),
        "fleet_devices": fleet["devices"],
        "fleet_ingest_realtime_factor": round(
            fleet_in["real_time_factor"], 2),
        "fleet_ingest_mega": fleet_in["mega"],
        "modes": modes,
    }
    if talk:
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
