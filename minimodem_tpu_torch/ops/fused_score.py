"""K1: the fused scorer — stages 1 and 2 in one CUDA kernel.

Replaces minimodem_tpu/ops/pallas_score.py::_build (the fused Pallas
scorer, reached through make_fused_packer and
device_rx.make_score_packer_planes).  It turns audio [B, L] into the
per-offset score planes the state machine (K2, ops/mega_rx.py) reads:

    planes [B, P, t_len] int32, rows (floats bit-cast to int32):
      0 conf_data   1 ampl_data   2 bits_lo
      3 conf_sync   4 ampl_sync   (only when the sync expect string differs
                                   from the data one, e.g. NOAA SAME)

The TPU kernel's layout tricks (4-row plane pad, overlapped plane slabs,
MXP1 comb matmuls, VMEM gates) are not carried over; the layout is the
port's own and parity is held at the channel values.

`score_planes` is the wrapper: a CUDA tensor launches csrc/fused_score.cu,
a CPU tensor runs `score_planes_plain` (correlate + score_frame_channels
from ops/demod.py), and anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace as _trace
from .demod import DemodGeometry, correlate, make_basis, score_frame_channels

# candidate offsets per CTA, largest first; the kernel stages the tile's
# audio plus its halo and two float planes of (tile + max_begin) in shared
# memory, so long-bit geometries take smaller tiles
_TILES = (4096, 2048, 1024, 512, 256)
_SMEM_MAX = 227 * 1024
# a tile of at least this many times max_begin recomputes at most 1/8 of
# its offsets as halo
_HALO_RATIO = 8


def plane_rows(geo: DemodGeometry) -> int:
    """Number of score planes: 3, or 5 when sync and data expect differ."""
    return 5 if tuple(geo.req_sync) != tuple(geo.req_data) else 3


def _req_masks(req) -> tuple:
    """Per-bit requirements as (mask, value) uint32 words."""
    mask = val = 0
    for k, r in enumerate(req):
        if r >= 0:
            mask |= 1 << k
            val |= r << k
    return mask, val


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def smem_bytes(geo: DemodGeometry, tile: int) -> int:
    """Shared memory of K1's CTA (csrc/fused_score.cu): the basis as
    [nb8][4], the audio [span8 + nb8], the signal and noise planes
    [span8] each and the four phase-major offsets of each frame bit
    [n_bits][4], with nb8 and span8 = tile + max_begin rounded up to 8."""
    nb8, span8 = _round8(geo.nb), _round8(tile + geo.max_begin)
    return 4 * (4 * nb8 + span8 + nb8 + 2 * span8 + 4 * geo.n_bits)


def pick_tile(geo: DemodGeometry):
    """The smallest tile of _TILES that is at least _HALO_RATIO *
    max_begin (the largest where none is), stepped down until the CTA
    fits its shared memory; None where no tile fits (bit spans of
    thousands of samples).  Bell-202 at 48 kHz: 4096, a 10% halo, 512
    CTAs per 2^21-sample segment."""
    fits = [t for t in _TILES if t >= _HALO_RATIO * geo.max_begin]
    start = _TILES.index(fits[-1]) if fits else 0
    for tile in _TILES[start:]:
        if smem_bytes(geo, tile) <= _SMEM_MAX:
            return tile
    return None


def launch_counts(geo: DemodGeometry, rows: int, t_len: int) -> dict:
    """The work of one K1 launch over `rows` streams of `t_len` scored
    offsets, as csrc/fused_score.cu does it: `k1_offsets`, the offsets
    scored (rows x t_len), and `k1_correlated`, the offsets stage 1
    correlates (each CTA its n_t <= tile offsets plus max_begin of halo,
    in whole tasks of 8: rows x the sum over CTAs of round8(n_t +
    max_begin)).  RTTY at 48 kHz: tile 4096, max_begin 7392, 2.80
    correlated a scored offset; Bell-202: 4096, 400, 1.10."""
    tile = pick_tile(geo)
    full, last = divmod(t_len, tile)
    per_row = full * _round8(tile + geo.max_begin)
    if last:
        per_row += _round8(last + geo.max_begin)
    return {"k1_offsets": rows * t_len, "k1_correlated": rows * per_row}


def serves(geo: DemodGeometry) -> bool:
    """Whether K1 serves the geometry: float32 scoring, at most 32 frame
    bits (one bits word), and a tile whose CTA fits its shared memory.
    Elsewhere the planes come from ops/device_rx.py make_score_packer."""
    return (not geo.use_f64 and geo.n_bits <= 32
            and pick_tile(geo) is not None)


def score_planes_plain(x: torch.Tensor, geo: DemodGeometry,
                       t_len: int) -> torch.Tensor:
    """Plain PyTorch version of K1.  x: [B, >= t_len + halo] float32."""
    score_planes_plain.calls += 1
    basis = torch.from_numpy(make_basis(geo, np.float32)).to(x.device)
    corr = correlate(x[:, :t_len + geo.halo], basis, t_len + geo.max_begin)
    ch = score_frame_channels(corr, geo, t_len)
    rows = [ch["conf_data"].view(torch.int32),
            ch["ampl_data"].view(torch.int32), ch["bits_lo"]]
    if plane_rows(geo) == 5:
        rows += [ch["conf_sync"].view(torch.int32),
                 ch["ampl_sync"].view(torch.int32)]
    return torch.stack(rows, dim=1)


score_planes_plain.calls = 0


class FusedScorer:
    """K1 for one geometry: device constants are made once per device."""

    def __init__(self, geo: DemodGeometry):
        if not serves(geo):
            raise ValueError(
                "the fused scorer serves float32 geometries of <= 32 frame "
                "bits whose bit span fits one CTA (fused_score.serves)")
        self.geo = geo
        self.n_planes = plane_rows(geo)
        self.tile = pick_tile(geo)
        self.d_mask, self.d_val = _req_masks(geo.req_data)
        self.s_mask, self.s_val = _req_masks(geo.req_sync)
        self._consts = {}

    def _device_consts(self, device):
        key = str(device)
        if key not in self._consts:
            basis = torch.from_numpy(
                np.ascontiguousarray(make_basis(self.geo, np.float32)))
            begin = torch.tensor(self.geo.bit_begin, dtype=torch.int32)
            self._consts[key] = (basis.to(device), begin.to(device))
        return self._consts[key]

    def __call__(self, x: torch.Tensor, t_len: int) -> torch.Tensor:
        """x: [B, >= t_len + halo] float32 -> planes [B, P, t_len] int32."""
        geo = self.geo
        if x.dim() != 2 or x.dtype != torch.float32:
            raise ValueError(f"expected [B, L] float32 audio, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.shape[1] < t_len + geo.halo:
            raise ValueError(f"audio rows of {x.shape[1]} samples are "
                             f"shorter than t_len + halo = {t_len + geo.halo}")
        if x.device.type == "cpu":
            return score_planes_plain(x, geo, t_len)
        if x.device.type != "cuda":
            raise ValueError(f"no fused scorer for device {x.device}")
        return self._launch(x.contiguous(), t_len)

    def _launch(self, x: torch.Tensor, t_len: int) -> torch.Tensor:
        from . import _kernels

        geo = self.geo
        basis, begin = self._device_consts(x.device)
        out = torch.empty((x.shape[0], self.n_planes, t_len),
                          dtype=torch.int32, device=x.device)
        if t_len == 0 or x.shape[0] == 0:
            return out
        lib = _kernels.load()
        err = lib.mm_fused_score(
            x.data_ptr(), x.stride(0), x.shape[0], t_len,
            basis.data_ptr(), geo.nb, begin.data_ptr(), geo.n_bits,
            geo.max_begin, float(np.float32(geo.magscalar)),
            self.d_mask, self.d_val, self.s_mask, self.s_val,
            self.n_planes, self.tile, smem_bytes(geo, self.tile),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        _kernels.check(err, "mm_fused_score")
        FusedScorer.launches += 1
        if _trace.enabled():
            _trace.add(**launch_counts(geo, x.shape[0], t_len))
        return out


FusedScorer.launches = 0
