"""Build and load the CUDA kernels of csrc/ as one shared library with a
plain C interface:

    K1  fused_score.cu  mm_fused_score  the fused scorer (ops/fused_score.py)
    K2  mega_rx.cu      mm_mega_rx      the state machine (ops/mega_rx.py)
    K3  correlate.cu    mm_correlate    the stage-1 correlation
                                        (ops/correlate.py)
    K4  tx_synth.cu     mm_tx_synth_bits, mm_tx_synth_frames
                                        the loopback's synthesis
                                        (ops/tx_device.py TxSynth);
                        mm_tx_sin_check its sine against CUDA's
                                        (ops/tx_device.py sin_check)
    K5  frame_channels.cu
                        mm_frame_channels
                                        the frame channels
                                        (ops/frame_channels.py)

At first use each source is compiled by its own nvcc, all started
together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c

and the objects are linked with `nvcc -shared` into
minimodem_tpu_torch/build/, keyed by a hash of the sources, the shared
headers (sm90.cuh: mbarriers, 1-D TMA; correlate.cuh: the
register-blocked correlation of K1 and K3) and the flags, and loaded with
ctypes.  There is no --use_fast_math: the scorer
relies on IEEE x/0 = inf, 0/0 = nan and correctly rounded sqrtf and
division, and -fmad=false keeps every multiply-add two rounded ops, as in
the plain PyTorch versions (K4 and K5 spell each rounding out as an _rn
intrinsic besides).  Every C entry returns cudaGetLastError();
check() raises on anything but 0.  nvcc is found through CUDA_HOME,
/usr/local/cuda or PATH.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the last nvcc build, None if cached

_P, _I, _LL, _U, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_uint, ctypes.c_float, ctypes.c_double)
_ULL = ctypes.c_ulonglong
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "mm_fused_score": [_P, _LL, _I, _I, _P, _I, _P, _I, _I, _F, _U, _U, _U,
                       _U, _I, _I, _I, _P, _P],
    "mm_mega_rx": [_P] * 12,
    "mm_correlate": [_P, _LL, _I, _I, _P, _I, _I, _I, _P, _P],
    "mm_tx_synth_bits": [_P, _I, _I, _I, _U, _I, _D, _D, _F, _F, _F, _P, _P,
                         _I, _P],
    "mm_tx_synth_frames": [_P, _P, _I, _I, _I, _I, _IP, _IP, _I, _I, _D, _D,
                           _F, _F, _I, _I, _D, _F, _I, _I, _I, _I, _U, _I,
                           _U, _I, _P, _P, _P, _I, _P],
    "mm_tx_sin_check": [_U, _U, _U, _P, _P, _P],
    "mm_frame_channels": [_P, _I, _LL, _LL, _I, _I, _P, _I, _I, _F, _ULL,
                          _ULL, _ULL, _ULL, _IP, _P, _P, _LL, _LL, _I, _P],
}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of minimodem_tpu_torch/csrc cannot be built")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the first failure's
    stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for p, c, err in zip(procs, cmds, errs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{err}")


def _build(nvcc: str, srcs, out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                  for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)          # atomic: concurrent loaders see a
    build_seconds = time.perf_counter() - t0      # whole library or none


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises when it cannot be
    built or loaded: there is no fallback for CUDA tensors."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = nvcc_path()
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in sorted(SRC_DIR.glob("*.cu*")):      # sources and headers
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"libmm_kernels-{h.hexdigest()[:16]}.so"
        if not out.exists():
            _build(nvcc, srcs, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
