"""sndio backend via ctypes (reference: src/simpleaudio-sndio.c).

Loads libsndio at runtime (no compile-time dependency, unlike the
reference's USE_SNDIO build flag) and mirrors the reference backend's
behavior:

- device None -> SIO_DEVANY ("default"), otherwise passed through
  (src/simpleaudio-sndio.c:78-82)
- S16 native-endian only; FLOAT is unimplemented, exactly like the
  reference (src/simpleaudio-sndio.c:90-99 "FIXME: Add support for
  SA_SAMPLE_FORMAT_FLOAT" + assert(0)) — we raise a clear error
  instead of aborting
- par: bits=16, sig=1, le=native, bps=SIO_BPS(16), xrun=SIO_IGNORE
  (src/simpleaudio-sndio.c:88-110).  NB the reference sets only rchan
  because of an always-true `if (SA_STREAM_RECORD)` (line 105); with
  the modem's mono streams the outcome is identical — we set both
  rchan and pchan to the requested channel count
- read/write move nframes*framesize bytes through sio_read/sio_write
  and report nframes (src/simpleaudio-sndio.c:41-56)
- close: sio_stop (src/simpleaudio-sndio.c:59-63), plus sio_close to
  release the handle the reference leaks

Tests exercise this through a mock libsndio (tests/test_sndio.py); on
BSD-style hosts with sndiod the CLI reaches it via -s/--sndio or as the
last sysdefault fallback (reference chain: src/simpleaudio.c:83-93).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
from typing import Optional

import numpy as np

from . import Direction, SampleFormat, Stream

# sndio.h
SIO_PLAY = 1
SIO_REC = 2
SIO_DEVANY = b"default"
SIO_IGNORE = 0  # xrun: pause during overruns/underruns
SIO_LE_NATIVE = 1 if sys.byteorder == "little" else 0


def sio_bps(bits: int) -> int:
    """sndio.h SIO_BPS macro."""
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


class SioPar(ctypes.Structure):
    """sndio.h struct sio_par."""
    _fields_ = [("bits", ctypes.c_uint),
                ("bps", ctypes.c_uint),
                ("sig", ctypes.c_uint),
                ("le", ctypes.c_uint),
                ("msb", ctypes.c_uint),
                ("rchan", ctypes.c_uint),
                ("pchan", ctypes.c_uint),
                ("rate", ctypes.c_uint),
                ("bufsz", ctypes.c_uint),
                ("xrun", ctypes.c_uint),
                ("round", ctypes.c_uint),
                ("appbufsz", ctypes.c_uint),
                ("_pad", ctypes.c_int * 3),
                ("_magic", ctypes.c_uint)]


_lib = None
_tried = False


def _prototypes(lib) -> None:
    c = ctypes
    lib.sio_open.restype = c.c_void_p
    lib.sio_open.argtypes = [c.c_char_p, c.c_uint, c.c_int]
    lib.sio_initpar.restype = None
    lib.sio_initpar.argtypes = [c.POINTER(SioPar)]
    lib.sio_setpar.restype = c.c_int
    lib.sio_setpar.argtypes = [c.c_void_p, c.POINTER(SioPar)]
    lib.sio_start.restype = c.c_int
    lib.sio_start.argtypes = [c.c_void_p]
    lib.sio_read.restype = c.c_size_t
    lib.sio_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.sio_write.restype = c.c_size_t
    lib.sio_write.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.sio_stop.restype = c.c_int
    lib.sio_stop.argtypes = [c.c_void_p]
    lib.sio_close.restype = None
    lib.sio_close.argtypes = [c.c_void_p]
    lib.sio_eof.restype = c.c_int
    lib.sio_eof.argtypes = [c.c_void_p]


def load_libsndio():
    """Load libsndio once; None when sndio isn't on this host."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    name = ctypes.util.find_library("sndio")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        _prototypes(lib)
    except OSError:
        return None
    _lib = lib
    return _lib


class SndioStream(Stream):
    def __init__(self, device: Optional[str], direction: Direction,
                 fmt: SampleFormat, rate: int, channels: int,
                 lib=None):
        super().__init__(fmt, rate, channels)
        self.direction = direction
        self._lib = lib if lib is not None else load_libsndio()
        if self._lib is None:
            raise RuntimeError("sndio (libsndio) is not available")
        lib = self._lib

        if fmt is not SampleFormat.FLOAT and fmt is not SampleFormat.S16:
            raise ValueError(f"unsupported format {fmt}")
        if fmt is SampleFormat.FLOAT:
            # src/simpleaudio-sndio.c:96-98: FLOAT unimplemented
            raise RuntimeError(
                "E: the sndio backend supports S16 samples only; drop "
                "--float-samples.")

        hdl = lib.sio_open(
            device.encode() if device else SIO_DEVANY,
            SIO_REC if direction is Direction.RECORD else SIO_PLAY,
            0)  # blocking I/O, like the reference
        if not hdl:
            raise RuntimeError("E: Cannot open sndio device")

        par = SioPar()
        lib.sio_initpar(ctypes.byref(par))
        # src/simpleaudio-sndio.c:90-110
        par.bits = 16
        par.sig = 1
        par.le = SIO_LE_NATIVE
        par.bps = sio_bps(par.bits)
        par.rate = rate
        par.xrun = SIO_IGNORE
        par.rchan = channels
        par.pchan = channels
        if not lib.sio_setpar(hdl, ctypes.byref(par)):
            lib.sio_close(hdl)
            raise RuntimeError("E: sio_setpar failed")
        if not lib.sio_start(hdl):
            lib.sio_close(hdl)
            raise RuntimeError("E: sio_start failed")
        self._hdl = hdl

    # ---- read (reference: src/simpleaudio-sndio.c:41-47) ----
    def _read(self, nframes: int) -> np.ndarray:
        buf = np.zeros(nframes * self.channels, self.format.dtype)
        nread = self._lib.sio_read(
            self._hdl, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
        # blocking sio_read returns short only on error/EOF
        nread_frames = int(nread) // self.framesize
        return buf[: nread_frames * self.channels]

    # ---- write (reference: src/simpleaudio-sndio.c:50-56) ----
    def _write(self, samples: np.ndarray) -> int:
        buf = np.ascontiguousarray(samples, self.format.dtype)
        n = self._lib.sio_write(
            self._hdl, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
        if int(n) != buf.nbytes:
            sys.stderr.write("E: sio_write: short write\n")
            return -1
        return buf.size // self.channels

    # ---- close (reference: src/simpleaudio-sndio.c:59-63) ----
    def _close(self) -> None:
        self._lib.sio_stop(self._hdl)
        self._lib.sio_close(self._hdl)
