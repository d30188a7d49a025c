"""Live-audio soak: TX through a real system audio backend into RX, with
a pass/fail byte check.

The counterpart of the repository's scripts/live_soak.py on the port.
The live pulse/alsa/sndio backends (sigio/{pulse,alsa,sndio}.py) are
tested through stand-in client libraries, since neither the test host
nor the card's machine has an audio device.  This script is the
one-command validation for a host that HAS audio hardware: it plays an
FSK burst out of the default playback device while recording from the
default capture device (patch them together with a loopback cable, or a
software loopback like `pactl load-module module-loopback` / snd-aloop),
decodes the capture live with DeviceStreamReceiver on --torch-device (K1
and K2 once a 2^16-sample segment on a card), and requires the decoded
bytes to match.

Usage:
    python -m minimodem_tpu_torch.scripts.live_soak            # pulse>alsa>sndio
    python -m minimodem_tpu_torch.scripts.live_soak --backend alsa --device plughw:1,0
    python -m minimodem_tpu_torch.scripts.live_soak --mode rtty --seconds 10
    python -m minimodem_tpu_torch.scripts.live_soak --selfcheck   # no audio HW needed

--device names the audio device, as in the JAX script; the PyTorch
device is --torch-device (cuda, the default, or cpu).

Exit status: 0 = byte-exact decode, 1 = mismatch/timeout (or
--torch-device cuda without a card), 2 = no backend.

Reference behavior being validated: the blocking read/write loops of
src/simpleaudio-{pulse,alsa,sndio}.c (e.g. simpleaudio-alsa.c:41-99 —
EPIPE recover on both directions, drain on close).
"""

import argparse
import sys
import threading
import time

import numpy as np


def build_payload(seconds: float, mode: str) -> bytes:
    base = b"LIVE SOAK %04d THE QUICK BROWN FOX 0123456789 "
    # rough sizing: bytes/sec from the preset's data rate
    rates = {"1200": 120, "300": 30, "rtty": 6, "tdd": 5}
    nper = rates.get(mode, 30)
    n = max(3, int(seconds * nper))
    out = bytearray()
    i = 0
    while len(out) < n:
        out += base % i
        i += 1
    return bytes(out[:n]) + b"\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minimodem_tpu_torch.scripts.live_soak",
        description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="sysdefault",
                    choices=["sysdefault", "pulseaudio", "alsa", "sndio"])
    ap.add_argument("--device", default=None,
                    help="playback+capture device (backend syntax)")
    ap.add_argument("--capture-device", default=None,
                    help="capture device when different from playback")
    ap.add_argument("--mode", default="300",
                    help="baudmode preset (300, 1200, rtty, tdd)")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="approximate burst length")
    ap.add_argument("--samplerate", type=int, default=48000)
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="give up after this many seconds of capture")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run the same TX->RX loop through an in-memory "
                         "stream instead of audio hardware (CI lane)")
    ap.add_argument("--torch-device", default="cuda", choices=["cuda", "cpu"],
                    help="the PyTorch device of the decode (default cuda)")
    args = ap.parse_args(argv)

    from ..cli import _card_ready
    from ..codecs import get_codec
    from ..config import RxOptions, TxOptions
    from ..models.modem import FskModem
    from ..ops.device_rx import DeviceStreamReceiver
    from ..ops.tx import Transmitter
    from ..rx.engine import Receiver
    from ..sigio import Direction, SampleFormat, open_stream, system_backend

    if not _card_ready(args.torch_device, "--torch-device"):
        return 1
    payload = build_payload(args.seconds, args.mode)
    m = FskModem(args.mode, sample_rate=args.samplerate,
                 device=args.torch_device)
    cfg = m.cfg

    if args.selfcheck:
        audio = m.modulate(payload)
        got = m.demodulate(audio)
        ok = got == payload
        print(f"selfcheck: {'PASS' if ok else 'FAIL'} "
              f"({len(audio)} samples, {len(payload)} bytes)")
        return 0 if ok else 1

    backend = args.backend
    if backend == "sysdefault":
        backend = system_backend()
        if backend is None:
            print("E: no system audio client library found "
                  "(libpulse-simple / libasound / libsndio)", file=sys.stderr)
            return 2
    print(f"backend: {backend}  mode: {args.mode}  "
          f"rate: {args.samplerate}  payload: {len(payload)} bytes")

    cap_dev = args.capture_device or args.device
    try:
        rec = open_stream(backend, cap_dev, Direction.RECORD,
                          SampleFormat.FLOAT, args.samplerate, 1,
                          "minimodem-soak", "capture")
    except (OSError, RuntimeError) as e:
        print(f"E: cannot open capture stream: {e}", file=sys.stderr)
        return 2

    # --- decoded-byte sink -------------------------------------------
    decoded = bytearray()
    decoded_lock = threading.Lock()

    def sink(b: bytes) -> None:
        with decoded_lock:
            decoded.extend(b)

    rxer = Receiver(cfg, RxOptions(), get_codec("ascii8"), sink)
    sr = DeviceStreamReceiver(cfg, segment_len=1 << 16,
                              device=args.torch_device)

    stop_rx = threading.Event()

    def rx_loop():
        while not stop_rx.is_set():
            chunk = rec.read(args.samplerate // 4)
            if chunk.size == 0:
                break
            rxer.render_events(*sr.feed(np.asarray(chunk, np.float32)))
        rxer.render_events(*sr.finish())

    rx_thread = threading.Thread(target=rx_loop, daemon=True)
    rx_thread.start()

    # --- transmit -----------------------------------------------------
    try:
        play = open_stream(backend, args.device, Direction.PLAYBACK,
                           SampleFormat.FLOAT, args.samplerate, 1,
                           "minimodem-soak", "playback")
    except (OSError, RuntimeError) as e:
        print(f"E: cannot open playback stream: {e}", file=sys.stderr)
        stop_rx.set()
        return 2
    txer = Transmitter(cfg, TxOptions(), get_codec("ascii8"),
                       SampleFormat.FLOAT, device=args.torch_device)
    t0 = time.time()
    txer.transmit_bytes(payload, play)
    play.close()
    print(f"TX done in {time.time() - t0:.1f}s; waiting for decode ...")

    # --- wait for the payload to come back ---------------------------
    deadline = time.time() + args.timeout
    ok = False
    while time.time() < deadline:
        with decoded_lock:
            if payload in bytes(decoded):
                ok = True
                break
        time.sleep(0.25)
    stop_rx.set()
    # the receiving thread ends at its next read: it holds torch state
    rx_thread.join(timeout=5.0)
    try:
        rec.close()
    except (OSError, RuntimeError):
        pass
    with decoded_lock:
        got = bytes(decoded)
    if ok:
        print(f"PASS: payload decoded byte-exact ({len(got)} bytes captured)")
        return 0
    print(f"FAIL: payload not decoded within {args.timeout}s; "
          f"got {len(got)} bytes: {got[:120]!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
