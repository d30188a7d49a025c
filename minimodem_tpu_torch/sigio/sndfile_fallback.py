"""Runtime ctypes fallback onto a host libsndfile for read subformats
the native reader does not decode (G.72x ADPCM, DWVW, and anything
else exotic; GSM 6.10 now decodes natively via native/gsm610.cpp).

This mirrors the reference's own architecture: its entire file layer IS
libsndfile (reference: src/simpleaudio-sndfile.c:46-70 reads any
subformat transparently through sf_readf_float), so deferring to a real
libsndfile for the formats we don't decode natively gives exact parity
by construction.  Hosts without the library keep the native reader's
clear one-line error.

The library is located via ctypes.util.find_library and, failing that,
the copy bundled inside the pygame wheel (this image ships libsndfile
1.1.0 there).  Everything degrades to None when absent — callers must
re-raise their original error then.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os

import numpy as np

_SFM_READ = 0x10


class _SF_INFO(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.c_int64),
        ("samplerate", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("format", ctypes.c_int),
        ("sections", ctypes.c_int),
        ("seekable", ctypes.c_int),
    ]


_lib = None
_lib_probed = False


def _candidates():
    name = ctypes.util.find_library("sndfile")
    if name:
        yield name, None
    for base in ("libsndfile.so.1", "libsndfile.so", "libsndfile.dylib"):
        yield base, None
    # the pygame wheel bundles libsndfile + its codec deps
    try:
        import site

        sps = list(site.getsitepackages())
        usp = site.getusersitepackages()
        if usp:
            sps.append(usp)
    except Exception:
        sps = []
    for sp in sps:
        d = os.path.join(sp, "pygame.libs")
        for p in sorted(glob.glob(os.path.join(d, "libsndfile*"))):
            yield p, d


def load():
    """-> libsndfile CDLL or None (cached)."""
    global _lib, _lib_probed
    if _lib_probed:
        return _lib
    _lib_probed = True
    for cand, depdir in _candidates():
        try:
            if depdir is not None:
                # bundled copies link their codec deps by relative name
                for dep in ("libogg*", "libopus-*", "libvorbis-*",
                            "libvorbisenc*", "libFLAC-*"):
                    for p in glob.glob(os.path.join(depdir, dep)):
                        ctypes.CDLL(p, mode=ctypes.RTLD_GLOBAL)
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            lib.sf_open.restype = ctypes.c_void_p
            lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(_SF_INFO)]
            lib.sf_readf_float.restype = ctypes.c_int64
            lib.sf_readf_float.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64]
            lib.sf_readf_short.restype = ctypes.c_int64
            lib.sf_readf_short.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
                ctypes.c_int64]
            lib.sf_close.argtypes = [ctypes.c_void_p]
        except AttributeError:
            continue
        _lib = lib
        return _lib
    return None


def read_file(path: str, want_float: bool):
    """Read a whole file through libsndfile.

    -> (samples [frames*channels] float32 or int16, rate, channels),
    or None when no libsndfile is available on this host or it cannot
    open the file either (caller re-raises its original error)."""
    lib = load()
    if lib is None:
        return None
    info = _SF_INFO()
    h = lib.sf_open(os.fspath(path).encode(), _SFM_READ,
                    ctypes.byref(info))
    if not h:
        return None
    try:
        n = max(int(info.frames) * info.channels, 0)
        if want_float:
            buf = np.empty(n, np.float32)
            got = lib.sf_readf_float(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.frames)
        else:
            buf = np.empty(n, np.int16)
            got = lib.sf_readf_short(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                info.frames)
        return (buf[: max(got, 0) * info.channels],
                info.samplerate, info.channels)
    finally:
        lib.sf_close(h)
