"""K3: the stage-1 sliding correlation on its own, one kernel for both forms.

Replaces minimodem_tpu/ops/pallas_demod.py::_build (K3a, one stream) and
::_build_batch (K3b, streams on the grid), which the JAX package reaches
through correlate_pallas / _make_correlator (:174-226):

    corr[b, c, s] = sum_{j < nb} basis[c, j] * x[b, s + j],  s < s_len

The host engines' scorer (ops/demod.py DemodScorer) calls it with one
chunk row (`score`, the K3a form) or up to 64 overlapping chunk rows of
one stream (`score_chunks`, the K3b form).

`Correlator` is the wrapper for one basis: a CUDA tensor launches
csrc/correlate.cu, a CPU tensor runs `correlate_plain` (ops/demod.py
correlate, the exact FMA-chain emulation the kernel matches bit for bit),
and anything else raises.  The TPU kernel's MAX_NB VMEM gate, banded W and
1024-aligned flat layout are TPU lowering detail and are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .demod import _DIRECT_CONV_MAX_NB as MAX_NB  # longer: the FFT route
from .demod import correlate


def correlate_plain(x: torch.Tensor, basis: torch.Tensor,
                    s_len: int) -> torch.Tensor:
    """Plain PyTorch version of K3.  x: [B, >= s_len + nb - 1] float32."""
    correlate_plain.calls += 1
    return correlate(x[:, :s_len + basis.shape[1] - 1], basis, s_len)


correlate_plain.calls = 0


class Correlator:
    """K3 for one [4, nb] float32 basis; the basis is put on each device
    once.  `launches` counts single-stream launches (the K3a form),
    `batch_launches` launches of several streams (the K3b form)."""

    launches = 0
    batch_launches = 0

    def __init__(self, basis: np.ndarray):
        basis = np.array(basis, np.float32)
        if basis.ndim != 2 or basis.shape[0] != 4 or not (
                1 <= basis.shape[1] <= MAX_NB):
            raise ValueError(f"expected a [4, nb <= {MAX_NB}] basis, got "
                             f"{basis.shape}")
        self.nb = basis.shape[1]
        self._basis = torch.from_numpy(basis)
        self._on_device = {}

    def basis(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = self._basis.to(device)
        return self._on_device[key]

    def __call__(self, x: torch.Tensor, s_len: int) -> torch.Tensor:
        """x: [B, >= s_len + nb - 1] float32 with unit column stride (any
        row stride, e.g. overlapping windows from Tensor.unfold)
        -> corr [B, 4, s_len] float32."""
        if x.dim() != 2 or x.dtype != torch.float32:
            raise ValueError(f"expected [B, L] float32 audio, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"audio rows must be contiguous, got strides "
                             f"{x.stride()}")
        if x.shape[1] < s_len + self.nb - 1:
            raise ValueError(f"audio rows of {x.shape[1]} samples are "
                             f"shorter than s_len + nb - 1 = "
                             f"{s_len + self.nb - 1}")
        if x.device.type == "cpu":
            return correlate_plain(x, self.basis(x.device), s_len)
        if x.device.type != "cuda":
            raise ValueError(f"no correlation kernel for device {x.device}")
        return self._launch(x, s_len)

    def _launch(self, x: torch.Tensor, s_len: int) -> torch.Tensor:
        from . import _kernels

        batch = x.shape[0]
        out = torch.empty((batch, 4, s_len), dtype=torch.float32,
                          device=x.device)
        if s_len == 0 or batch == 0:
            return out
        lib = _kernels.load()
        err = lib.mm_correlate(
            x.data_ptr(), x.stride(0), batch, s_len,
            self.basis(x.device).data_ptr(), self.nb, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        _kernels.check(err, "mm_correlate")
        if batch == 1:
            Correlator.launches += 1
        else:
            Correlator.batch_launches += 1
        return out


@functools.lru_cache(maxsize=64)
def _correlator(basis_bytes: bytes, nb: int) -> Correlator:
    return Correlator(np.frombuffer(basis_bytes, np.float32).reshape(4, nb))


def correlate_kernel(x: torch.Tensor, basis_np: np.ndarray,
                     s_len: int) -> torch.Tensor:
    """The counterpart of correlate_pallas: K3 for a host basis constant,
    one cached Correlator per basis.  x: [B, L] -> [B, 4, s_len]."""
    basis32 = np.ascontiguousarray(basis_np, np.float32)
    return _correlator(basis32.tobytes(), basis32.shape[1])(x, s_len)
