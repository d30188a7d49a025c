"""ALSA backend via ctypes (reference: src/simpleaudio-alsa.c).

Loads libasound at runtime (no compile-time dependency, unlike the
reference's USE_ALSA build flag) and mirrors the reference backend's
behavior exactly:

- device aliasing: None -> "default", "X,Y" -> "plughw:X,Y",
  bare "X" -> "plughw:X,0", anything with ':' passed through
  (reference: src/simpleaudio-alsa.c:116-127)
- hw params via snd_pcm_set_params: interleaved R/W, soft resample
  allowed, 100 ms latency (reference: :150-157)
- read loop: on -EPIPE (overrun) print "#" and snd_pcm_prepare; on
  -EAGAIN/-ESTRPIPE wait up to 1 s; short reads report "#short+N#"
  (reference: :41-66)
- write loop: on error snd_pcm_recover then retry once
  (reference: :71-90)
- close: drain then close (reference: :95-99)

Tests exercise this through a mock libasound (tests/test_alsa.py); on
hosts with real hardware the CLI reaches it by omitting --file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
from typing import Optional

import numpy as np

from . import Direction, SampleFormat, Stream

# alsa/pcm.h constants
SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_S16_LE = 2
SND_PCM_FORMAT_FLOAT_LE = 14
SND_PCM_ACCESS_RW_INTERLEAVED = 3

EPIPE = 32
EAGAIN = 11
ESTRPIPE = 86

_lib = None
_tried = False


def _prototypes(lib) -> None:
    c = ctypes
    lib.snd_pcm_open.restype = c.c_int
    lib.snd_pcm_open.argtypes = [c.POINTER(c.c_void_p), c.c_char_p,
                                 c.c_int, c.c_int]
    lib.snd_pcm_set_params.restype = c.c_int
    lib.snd_pcm_set_params.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                       c.c_uint, c.c_uint, c.c_int, c.c_uint]
    lib.snd_pcm_readi.restype = c.c_long
    lib.snd_pcm_readi.argtypes = [c.c_void_p, c.c_void_p, c.c_ulong]
    lib.snd_pcm_writei.restype = c.c_long
    lib.snd_pcm_writei.argtypes = [c.c_void_p, c.c_void_p, c.c_ulong]
    lib.snd_pcm_prepare.restype = c.c_int
    lib.snd_pcm_prepare.argtypes = [c.c_void_p]
    lib.snd_pcm_recover.restype = c.c_int
    lib.snd_pcm_recover.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.snd_pcm_wait.restype = c.c_int
    lib.snd_pcm_wait.argtypes = [c.c_void_p, c.c_int]
    lib.snd_pcm_drain.restype = c.c_int
    lib.snd_pcm_drain.argtypes = [c.c_void_p]
    lib.snd_pcm_close.restype = c.c_int
    lib.snd_pcm_close.argtypes = [c.c_void_p]
    lib.snd_strerror.restype = ctypes.c_char_p
    lib.snd_strerror.argtypes = [c.c_int]


def load_libasound():
    """Load libasound once; None when ALSA isn't on this host."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    name = ctypes.util.find_library("asound")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        _prototypes(lib)
    except OSError:
        return None
    _lib = lib
    return _lib


def resolve_device(backend_device: Optional[str]) -> bytes:
    """Reference device aliasing (src/simpleaudio-alsa.c:116-127)."""
    if not backend_device:
        return b"default"
    if ":" in backend_device:
        return backend_device.encode()
    if "," in backend_device:
        return f"plughw:{backend_device}".encode()
    return f"plughw:{backend_device},0".encode()


class AlsaStream(Stream):
    def __init__(self, device: Optional[str], direction: Direction,
                 fmt: SampleFormat, rate: int, channels: int,
                 lib=None):
        super().__init__(fmt, rate, channels)
        self.direction = direction
        self._lib = lib if lib is not None else load_libasound()
        if self._lib is None:
            raise RuntimeError("ALSA (libasound) is not available")
        lib = self._lib

        pcm = ctypes.c_void_p()
        err = lib.snd_pcm_open(
            ctypes.byref(pcm), resolve_device(device),
            SND_PCM_STREAM_CAPTURE if direction is Direction.RECORD
            else SND_PCM_STREAM_PLAYBACK, 0)
        if err:
            raise RuntimeError(
                "E: Cannot create ALSA stream: %s" % self._strerror(err))
        pcm_format = (SND_PCM_FORMAT_FLOAT_LE
                      if fmt is SampleFormat.FLOAT else SND_PCM_FORMAT_S16_LE)
        err = lib.snd_pcm_set_params(
            pcm, pcm_format, SND_PCM_ACCESS_RW_INTERLEAVED, channels, rate,
            1, 100000)
        if err:
            lib.snd_pcm_close(pcm)
            raise RuntimeError("E: %s" % self._strerror(err))
        self._pcm = pcm

    def _strerror(self, err: int) -> str:
        try:
            return self._lib.snd_strerror(err).decode()
        except Exception:
            return f"alsa error {err}"

    # ---- read (reference: src/simpleaudio-alsa.c:41-66) ----
    def _read(self, nframes: int) -> np.ndarray:
        lib = self._lib
        buf = np.zeros(nframes * self.channels, self.format.dtype)
        frames_read = 0
        while frames_read < nframes:
            count = nframes - frames_read
            data = buf[frames_read * self.channels:]
            r = lib.snd_pcm_readi(
                self._pcm, data.ctypes.data_as(ctypes.c_void_p), count)
            if r >= 0:
                if r == 0:      # genuine end of stream (mock/test hook)
                    break
                frames_read += r
                if r != count:
                    sys.stderr.write("#short+%d#\n" % r)
                continue
            if r == -EPIPE:     # overrun
                sys.stderr.write("#")
                lib.snd_pcm_prepare(self._pcm)
            else:
                sys.stderr.write("snd_pcm_readi: %s\n" % self._strerror(r))
                if r in (-EAGAIN, -ESTRPIPE):
                    lib.snd_pcm_wait(self._pcm, 1000)
                else:
                    break
        return buf[: frames_read * self.channels]

    # ---- write (reference: src/simpleaudio-alsa.c:71-90) ----
    def _write(self, samples: np.ndarray) -> int:
        lib = self._lib
        buf = np.ascontiguousarray(samples, self.format.dtype)
        nframes = buf.size // self.channels
        frames_written = 0
        while frames_written < nframes:
            data = buf[frames_written * self.channels:]
            ptr = data.ctypes.data_as(ctypes.c_void_p)
            r = lib.snd_pcm_writei(self._pcm, ptr,
                                   nframes - frames_written)
            if r < 0:
                # recover from e.g. underruns, and try once more
                lib.snd_pcm_recover(self._pcm, int(r), 0)
                r = lib.snd_pcm_writei(self._pcm, ptr,
                                       nframes - frames_written)
            if r < 0:
                sys.stderr.write("E: %s\n" % self._strerror(int(r)))
                return -1
            frames_written += r
        return frames_written

    def _close(self) -> None:
        self._lib.snd_pcm_drain(self._pcm)
        self._lib.snd_pcm_close(self._pcm)
