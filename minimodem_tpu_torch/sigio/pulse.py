"""PulseAudio backend via ctypes (reference: src/simpleaudio-pulse.c).

Loads libpulse-simple at runtime (no compile-time dependency, unlike
the reference's USE_PULSEAUDIO build flag) and mirrors the reference
backend's behavior exactly:

- blocking pa_simple streams; the server and source/sink device are
  left as the Pulse defaults (the reference ignores backend_device too,
  src/simpleaudio-pulse.c:93-94,131-134)
- buffer attr: everything -1 except fragsize=0 (lowest capture
  latency) and tlength=0 (lowest playback latency); prebuf is NOT
  touched — the reference found that setting it corrupts TX sessions
  (src/simpleaudio-pulse.c:116-127)
- S16LE / FLOAT32LE sample formats (src/simpleaudio-pulse.c:98-107)
- read/write return frame counts (pa_simple_* return only 0/-1;
  the reference translates to nframes, src/simpleaudio-pulse.c:43-72)
- close: drain then free (src/simpleaudio-pulse.c:75-80)

Tests exercise this through a mock libpulse-simple (tests/test_pulse.py);
on hosts with a Pulse (or pipewire-pulse) server the CLI reaches it by
omitting --file — Pulse is first in the sysdefault chain, matching the
reference's configure-time priority (src/simpleaudio.c:83-93).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
from typing import Optional

import numpy as np

from . import Direction, SampleFormat, Stream

# pulse/sample.h pa_sample_format_t
PA_SAMPLE_S16LE = 3
PA_SAMPLE_FLOAT32LE = 5
# pulse/def.h pa_stream_direction_t
PA_STREAM_PLAYBACK = 1
PA_STREAM_RECORD = 2


class PaSampleSpec(ctypes.Structure):
    """pulse/sample.h struct pa_sample_spec."""
    _fields_ = [("format", ctypes.c_int),
                ("rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint8)]


class PaBufferAttr(ctypes.Structure):
    """pulse/def.h struct pa_buffer_attr."""
    _fields_ = [("maxlength", ctypes.c_uint32),
                ("tlength", ctypes.c_uint32),
                ("prebuf", ctypes.c_uint32),
                ("minreq", ctypes.c_uint32),
                ("fragsize", ctypes.c_uint32)]


_lib = None
_tried = False


def _prototypes(lib) -> None:
    c = ctypes
    lib.pa_simple_new.restype = c.c_void_p
    lib.pa_simple_new.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int, c.c_char_p, c.c_char_p,
        c.POINTER(PaSampleSpec), c.c_void_p, c.POINTER(PaBufferAttr),
        c.POINTER(c.c_int)]
    lib.pa_simple_read.restype = c.c_int
    lib.pa_simple_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t,
                                   c.POINTER(c.c_int)]
    lib.pa_simple_write.restype = c.c_int
    lib.pa_simple_write.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t,
                                    c.POINTER(c.c_int)]
    lib.pa_simple_drain.restype = c.c_int
    lib.pa_simple_drain.argtypes = [c.c_void_p, c.POINTER(c.c_int)]
    lib.pa_simple_free.restype = None
    lib.pa_simple_free.argtypes = [c.c_void_p]
    # pa_strerror lives in libpulse proper; dlsym on the pulse-simple
    # handle searches its dependency tree, so it normally resolves here
    try:
        lib.pa_strerror.restype = c.c_char_p
        lib.pa_strerror.argtypes = [c.c_int]
    except AttributeError:
        pass


def load_libpulse():
    """Load libpulse-simple once; None when Pulse isn't on this host."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    name = ctypes.util.find_library("pulse-simple")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        _prototypes(lib)
    except OSError:
        return None
    _lib = lib
    return _lib


class PulseStream(Stream):
    def __init__(self, device: Optional[str], direction: Direction,
                 fmt: SampleFormat, rate: int, channels: int,
                 app_name: str = "minimodem_tpu", stream_name: str = "",
                 lib=None):
        super().__init__(fmt, rate, channels)
        self.direction = direction
        self._lib = lib if lib is not None else load_libpulse()
        if self._lib is None:
            raise RuntimeError("PulseAudio (libpulse-simple) is not available")
        lib = self._lib

        pa_format = (PA_SAMPLE_FLOAT32LE if fmt is SampleFormat.FLOAT
                     else PA_SAMPLE_S16LE)
        ss = PaSampleSpec(format=pa_format, rate=rate, channels=channels)
        # src/simpleaudio-pulse.c:116-127 — lowest-latency fragsize and
        # tlength; do NOT set prebuf (corrupts some --tx sessions)
        attr = PaBufferAttr(
            maxlength=0xFFFFFFFF, tlength=0, prebuf=0xFFFFFFFF,
            minreq=0xFFFFFFFF, fragsize=0)
        err = ctypes.c_int(0)
        # server and device stay NULL: the reference takes the Pulse
        # defaults (src/simpleaudio-pulse.c:93-94,131)
        s = lib.pa_simple_new(
            None, app_name.encode(),
            PA_STREAM_RECORD if direction is Direction.RECORD
            else PA_STREAM_PLAYBACK,
            None, (stream_name or "stream").encode(),
            ctypes.byref(ss), None, ctypes.byref(attr), ctypes.byref(err))
        if not s:
            raise RuntimeError(
                "E: Cannot create PulseAudio stream: %s"
                % self._strerror(err.value))
        self._s = s

    def _strerror(self, err: int) -> str:
        try:
            return self._lib.pa_strerror(err).decode()
        except Exception:
            return f"pulse error {err}"

    # ---- read (reference: src/simpleaudio-pulse.c:43-56) ----
    def _read(self, nframes: int) -> np.ndarray:
        buf = np.zeros(nframes * self.channels, self.format.dtype)
        err = ctypes.c_int(0)
        r = self._lib.pa_simple_read(
            self._s, buf.ctypes.data_as(ctypes.c_void_p),
            buf.nbytes, ctypes.byref(err))
        if r < 0:
            sys.stderr.write("pa_simple_read: %s\n"
                             % self._strerror(err.value))
            return buf[:0]
        return buf

    # ---- write (reference: src/simpleaudio-pulse.c:59-72) ----
    def _write(self, samples: np.ndarray) -> int:
        buf = np.ascontiguousarray(samples, self.format.dtype)
        err = ctypes.c_int(0)
        r = self._lib.pa_simple_write(
            self._s, buf.ctypes.data_as(ctypes.c_void_p),
            buf.nbytes, ctypes.byref(err))
        if r < 0:
            sys.stderr.write("pa_simple_write: %s\n"
                             % self._strerror(err.value))
            return -1
        return buf.size // self.channels

    # ---- close (reference: src/simpleaudio-pulse.c:75-80) ----
    def _close(self) -> None:
        err = ctypes.c_int(0)
        self._lib.pa_simple_drain(self._s, ctypes.byref(err))
        self._lib.pa_simple_free(self._s)
