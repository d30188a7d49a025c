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

TILE_MIN = 256           # one warp, 8 offsets a thread (csrc/correlate.cu)
TILE_MAX = 2048          # a CTA of 256 threads
SMS = 132                # the H100's streaming multiprocessors
# a tile of at least this many times nb - 1 stages at most 1/8 of its
# samples twice (the halo it shares with the next tile)
HALO_RATIO = 8
# the least average share of the SMs a grid's rounds of SMS CTAs may keep
# busy
ROUND_FILL = 0.8


def smem_bytes(nb: int, tile: int) -> int:
    """Shared memory of K3's CTA (csrc/correlate.cu): the basis as [nb8]
    float4 and the audio [tile + nb8], nb8 = nb rounded up to 8."""
    nb8 = -(-nb // 8) * 8
    return 16 * nb8 + 4 * (tile + nb8)


def fills_the_card(ctas: int) -> bool:
    """Whether a grid of equal CTAs keeps the SMs busy: every SM gets one,
    and its ceil(ctas / SMS) rounds are on average ROUND_FILL full."""
    return ctas >= SMS and ctas >= ROUND_FILL * SMS * -(-ctas // SMS)


@functools.lru_cache(maxsize=256)
def pick_tile(nb: int, s_len: int, batch: int) -> int:
    """Offsets per CTA: the smallest power of two from TILE_MIN that is
    at least HALO_RATIO * (nb - 1), at most TILE_MAX, halved while its
    grid does not fill the card.  The halo costs only its staging (no
    offset is computed twice), so the SMs come first, and past nb = 257
    a filter's 4 * nb FMAs per offset dwarf the staging of its halo,
    while CTAs of more than TILE_MAX offsets beside a large basis leave
    an SM too few warps (they ran slower on the card).  Bell-202 (nb 40)
    at the host chunk, s_len 131472: 512 offsets, 257 CTAs at B = 1."""
    tile = TILE_MIN
    while tile < min(HALO_RATIO * (nb - 1), TILE_MAX):
        tile *= 2
    while tile > TILE_MIN and not fills_the_card(batch * -(-s_len // tile)):
        tile //= 2
    return tile


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
        self._fn = None              # the kernel's C entry, once loaded

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
        device = x.device
        if device.type == "cpu":
            return correlate_plain(x, self.basis(device), s_len)
        if device.type != "cuda":
            raise ValueError(f"no correlation kernel for device {device}")
        return self._launch(x, s_len, device)

    def _launch(self, x: torch.Tensor, s_len: int, device) -> torch.Tensor:
        from . import _kernels

        batch = x.shape[0]
        out = x.new_empty((batch, 4, s_len))
        if s_len == 0 or batch == 0:
            return out
        if self._fn is None:
            self._fn = _kernels.load().mm_correlate
        tile = pick_tile(self.nb, s_len, batch)
        # the current stream's handle without building a torch.cuda.Stream
        err = self._fn(
            x.data_ptr(), x.stride(0), batch, s_len,
            self.basis(device).data_ptr(), self.nb, tile,
            smem_bytes(self.nb, tile), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(device.index))
        _kernels.check(err, "mm_correlate")
        if batch == 1:
            Correlator.launches += 1
        else:
            Correlator.batch_launches += 1
        return out
