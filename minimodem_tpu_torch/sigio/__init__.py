"""sigio: audio stream abstraction (the reference's "simpleaudio" layer).

Re-designs the reference's backend-vtable stream API
(reference: src/simpleaudio.h:56-91, src/simpleaudio_internal.h:41-60) as a
small Python protocol with a backend registry.  Data moves as NumPy arrays
(int16 or float32) instead of raw byte buffers; everything else — formats,
channel checks, the rxnoise fault-injection knob, rate getters — keeps the
reference's semantics.

A copy of minimodem_tpu/sigio/__init__.py.  Backends:
- ``file``      : 19 containers (WAV/FLAC/OGG/AU/RAW/AIFF/CAF/W64/RF64/
                  WAVEX/NIST/IRCAM/PVF/HTK/AVR/VOC/SVX/MAT4/MAT5),
                  deterministic output (tests depend on byte-identical
                  TX, reference: tests/16-verify-tx-consistent)
- ``benchmark`` : null device that reports samples/sec
                  (reference: src/simpleaudio-benchmark.c)
- ``pulseaudio`` / ``alsa`` / ``sndio`` : live system audio via
  runtime-loaded libpulse-simple / libasound / libsndio (the reference's
  configure-time USE_* backends, src/simpleaudio-{pulse,alsa,sndio}.c).
  ``sysdefault`` picks the first available in the reference's priority
  order pulse > alsa > sndio (src/simpleaudio.c:83-93).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np


class SampleFormat(enum.Enum):
    S16 = "s16"
    FLOAT = "float"

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.int16 if self is SampleFormat.S16 else np.float32)

    @property
    def samplesize(self) -> int:
        return self.dtype.itemsize


class Direction(enum.Enum):
    PLAYBACK = "playback"
    RECORD = "record"


class Stream:
    """Base stream: subclasses implement _read/_write/_close."""

    def __init__(self, fmt: SampleFormat, rate: int, channels: int):
        self.format = fmt
        self.rate = rate
        self.channels = channels
        self.rxnoise: float = 0.0
        self._rng: Optional[np.random.Generator] = None

    # -- getters (reference: src/simpleaudio.c:140-175) -----------------
    @property
    def samplesize(self) -> int:
        return self.format.samplesize

    @property
    def framesize(self) -> int:
        return self.channels * self.samplesize

    def set_rxnoise(self, factor: float, seed: int = 0) -> None:
        """Enable white-noise fault injection on reads (the hidden
        ``--Xrxnoise`` knob, reference: src/minimodem.c:770-772).

        Unlike the reference (whose ``rand()/RAND_MAX`` integer division
        collapses to a DC offset, reference: src/simpleaudio-sndfile.c:68),
        this injects genuine uniform noise in [-factor, +factor), from a
        deterministic seeded generator so tests stay reproducible.
        """
        self.rxnoise = float(factor)
        self._rng = np.random.default_rng(seed)

    # -- I/O -------------------------------------------------------------
    def read(self, nframes: int) -> np.ndarray:
        buf = self._read(nframes)
        if self.rxnoise != 0.0 and buf.dtype == np.float32 and buf.size:
            noise = self._rng.random(buf.shape, dtype=np.float32)
            buf = buf + (noise - np.float32(0.5)) * np.float32(self.rxnoise * 2)
        return buf

    def write(self, buf: np.ndarray) -> int:
        return self._write(buf)

    def close(self) -> None:
        self._close()

    # subclass hooks
    def _read(self, nframes: int) -> np.ndarray:
        raise NotImplementedError

    def _write(self, buf: np.ndarray) -> int:
        raise NotImplementedError

    def _close(self) -> None:
        pass


def open_stream(
    backend: str,
    device: Optional[str],
    direction: Direction,
    fmt: SampleFormat,
    rate: int,
    channels: int,
    app_name: str = "minimodem_tpu",
    stream_name: str = "",
) -> Stream:
    """Open an audio stream on the named backend.

    Mirrors reference src/simpleaudio.c:36-138 dispatch.
    """
    if backend == "file":
        from .wavfile import FileStream
        return FileStream(stream_name, direction, fmt, rate, channels)
    if backend == "benchmark":
        from .benchmark import BenchmarkStream
        return BenchmarkStream(stream_name, direction, fmt, rate, channels)
    if backend == "sysdefault":
        # reference priority: pulse > alsa > sndio (src/simpleaudio.c:83-93);
        # the reference picks at configure time, we pick at runtime by
        # which client library is actually present
        backend = system_backend()
        if backend is None:
            raise RuntimeError(
                "E: no system audio available on this host (no "
                "libpulse-simple, libasound, or libsndio); use --file mode.")
    if backend == "pulseaudio":
        from .pulse import PulseStream, load_libpulse
        if load_libpulse() is None:
            raise RuntimeError(
                "E: no system audio available on this host (libpulse-simple "
                "not found); use --file mode.")
        return PulseStream(device, direction, fmt, rate, channels,
                           app_name, stream_name)
    if backend == "alsa":
        from .alsa import AlsaStream, load_libasound
        if load_libasound() is None:
            raise RuntimeError(
                "E: no system audio available on this host (libasound not "
                "found); use --file mode.")
        return AlsaStream(device, direction, fmt, rate, channels)
    if backend == "sndio":
        from .sndio import SndioStream, load_libsndio
        if load_libsndio() is None:
            raise RuntimeError(
                "E: no system audio available on this host (libsndio not "
                "found); use --file mode.")
        return SndioStream(device, direction, fmt, rate, channels)
    raise ValueError(f"no such backend: {backend!r}")


def system_backend() -> Optional[str]:
    """First available live-audio backend in the reference's priority
    order (src/simpleaudio.c:83-93), or None when the host has none."""
    from .alsa import load_libasound
    from .pulse import load_libpulse
    from .sndio import load_libsndio
    if load_libpulse() is not None:
        return "pulseaudio"
    if load_libasound() is not None:
        return "alsa"
    if load_libsndio() is not None:
        return "sndio"
    return None
