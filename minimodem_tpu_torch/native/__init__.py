"""Native (C++) runtime components, loaded via ctypes.

- wavio:   WAV codec (the data-loader path)
- hostrx:  host-side RX carrier state machine over score arrays
- flacdec: FLAC decoder
- gsm610:  GSM 06.10 (RPE-LTP) decoder, sample-exact vs libsndfile
- wirepack: delta-bitpack wire packer (opt-in slow-link e2e format)

Everything has a pure-Python fallback; `load()` returns None when the
shared library is missing or unbuildable.  Build with:

    make -C minimodem_tpu_torch/native        # or: python -m minimodem_tpu_torch.native
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libmm_native.so")

_lib = None
_tried = False


class MmRxConfig(ctypes.Structure):
    _pack_ = 1
    _fields_ = [
        ("total", ctypes.c_int64),
        ("t_scored", ctypes.c_int64),
        ("expect_nsamples", ctypes.c_int32),
        ("frame_nsamples", ctypes.c_int32),
        ("overscan", ctypes.c_int32),
        ("try_max_carrier", ctypes.c_int32),
        ("try_max_nocarrier", ctypes.c_int32),
        ("rx_one", ctypes.c_int32),
        ("conf_threshold", ctypes.c_float),
        ("conf_search_limit", ctypes.c_float),
    ]


def build(quiet: bool = True) -> bool:
    """Compile the shared library in-tree.  Returns success."""
    try:
        r = subprocess.run(
            ["make", "-C", _DIR],
            capture_output=quiet, text=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_SO)
    except Exception:
        return False


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if auto_build:
        build()          # no-op when the .so is newer than the sources
    if not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.mm_wav_write.restype = ctypes.c_longlong
    lib.mm_wav_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong]
    lib.mm_wav_read_info.restype = ctypes.c_int
    lib.mm_wav_read_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.mm_wav_read_data.restype = ctypes.c_longlong
    lib.mm_wav_read_data.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong]
    if hasattr(lib, "mm_flac_info"):
        lib.mm_flac_info.restype = ctypes.c_int
        lib.mm_flac_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.mm_flac_read.restype = ctypes.c_longlong
        lib.mm_flac_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong]
    if hasattr(lib, "mm_gsm610_decode"):
        lib.mm_gsm610_decode.restype = ctypes.c_longlong
        lib.mm_gsm610_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong]
    if hasattr(lib, "mm_wirepack_pack"):
        lib.mm_wirepack_count.restype = ctypes.c_longlong
        lib.mm_wirepack_count.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int]
        lib.mm_wirepack_scan.restype = None
        lib.mm_wirepack_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.mm_wirepack_pack.restype = ctypes.c_longlong
        lib.mm_wirepack_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong]
    lib.mm_hostrx_run.restype = ctypes.c_longlong
    lib.mm_hostrx_run.argtypes = [
        ctypes.POINTER(MmRxConfig),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    _lib = lib
    return lib


if __name__ == "__main__":
    ok = build(quiet=False)
    print("native build:", "ok" if ok else "FAILED", file=sys.stderr)
    sys.exit(0 if ok else 1)
