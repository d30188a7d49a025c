"""Build and load the CUDA kernels of csrc/ (K1 fused_score.cu, K2
mega_rx.cu) as one shared library with a plain C interface.

At first use the sources are compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC

into minimodem_tpu_torch/build/, keyed by a hash of the sources and the
flags, and loaded with ctypes.  There is no --use_fast_math: the scorer
relies on IEEE x/0 = inf, 0/0 = nan and correctly rounded sqrtf and
division, and -fmad=false keeps every multiply-add two rounded ops, as in
the plain PyTorch versions.  Every C entry returns cudaGetLastError();
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
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the last nvcc build, None if cached

_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)
_SIGNATURES = {
    "mm_fused_score": [_P, _LL, _I, _I, _P, _I, _P, _I, _I, _F, _U, _U, _U,
                       _U, _I, _I, _I, _P, _P],
    "mm_mega_rx": [_P] * 12,
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


def _build(nvcc: str, srcs, out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                            *(str(s) for s in srcs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)          # atomic: concurrent loaders see a
    finally:                          # whole library or none
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


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
        for s in srcs:
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
