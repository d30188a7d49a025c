"""K5: the frame channels — band magnitudes -> the six per-offset frame
channels — as a CUDA kernel.

Replaces the XLA fusion of minimodem_tpu/ops/demod.py::score_frame_channels
(:215), which jax.jit compiles into the host engines' scorer
(_build_score_fn, demod.py:299-325) and into the device receiver's scorer
for the geometries the fused Pallas scorer does not take
(make_score_packer, device_rx.py:244-309); it has no pallas_call.  Here
it serves ops/demod.py::_build_score_fn (DemodScorer, so the host
engines, and the fleet's sharded_score_fn) and ops/device_rx.py::
make_score_packer (every geometry fused_score.serves rejects).  K1
(ops/fused_score.py) keeps its own copy of the math, and its plain
version keeps calling the plain score_frame_channels.

`FrameChannels` is the wrapper for one geometry: a CUDA correlation
launches csrc/frame_channels.cu, a CPU one runs the plain
score_frame_channels (ops/demod.py, its yardstick bit for bit), and
anything else raises.  It writes the channels straight into the caller's
int32 rows, so the packer fills a tile's columns of its planes and the
host scorer its [B, 6, t_len] block without a copy per channel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .demod import CHANNELS, DemodGeometry, score_frame_channels
from .fused_score import _req_masks

MAX_BITS = 64                      # the frame bits' two words


def row_map(rows) -> tuple:
    """Each of CHANNELS' destination row in `rows` (channel names in row
    order), -1 where it has none."""
    return tuple(rows.index(c) if c in rows else -1 for c in CHANNELS)


class FrameChannels:
    """K5 for one geometry; the bit offsets are put on each device once.
    `launches` counts the kernel's launches."""

    launches = 0

    def __init__(self, geo: DemodGeometry):
        if not 1 <= geo.n_bits <= MAX_BITS:
            raise ValueError(f"the frame channels take 1 to {MAX_BITS} "
                             f"frame bits, not {geo.n_bits}")
        self.geo = geo
        self.d_mask, self.d_val = _req_masks(geo.req_data)
        self.s_mask, self.s_val = _req_masks(geo.req_sync)
        self.scal = float(np.float32(geo.magscalar))
        self._begin = torch.tensor(geo.bit_begin, dtype=torch.int32)
        self._on_device = {}
        self._fn = None              # the kernel's C entry, once loaded

    def begin(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = self._begin.to(device)
        return self._on_device[key]

    def __call__(self, corr: torch.Tensor, n: int, out: torch.Tensor,
                 rows=CHANNELS, t0: int = 0) -> torch.Tensor:
        """The channels of offsets [0, n) into out[:, r, t0:t0 + n], r the
        row of each channel named in `rows` (channel names in row order;
        the other rows are left as they are).
        corr: [B, 4, >= n + max_begin] float32 or float64, any strides
        (the kernel takes the stream and row strides; a column stride
        other than 1 is copied first); out: [B, >= len(rows), >= t0 + n]
        int32 on corr's device with unit column stride -> out."""
        geo = self.geo
        if corr.dim() != 3 or corr.shape[1] != 4 or corr.dtype not in (
                torch.float32, torch.float64):
            raise ValueError(f"expected a [B, 4, L] float32 or float64 "
                             f"correlation, got {tuple(corr.shape)} "
                             f"{corr.dtype}")
        if corr.shape[2] < n + geo.max_begin:
            raise ValueError(f"a correlation of {corr.shape[2]} offsets is "
                             f"shorter than n + max_begin = "
                             f"{n + geo.max_begin}")
        if (out.dim() != 3 or out.dtype != torch.int32
                or out.device != corr.device or out.shape[0] != corr.shape[0]
                or out.shape[1] < len(rows) or out.shape[2] < t0 + n
                or t0 < 0 or (out.shape[2] > 1 and out.stride(2) != 1)):
            raise ValueError(f"expected int32 rows [{corr.shape[0]}, >= "
                             f"{len(rows)}, >= {t0 + n}] with unit column "
                             f"stride on {corr.device}, got "
                             f"{tuple(out.shape)} {out.dtype} {out.device} "
                             f"strides {out.stride()}")
        unknown = set(rows) - set(CHANNELS)
        if unknown:
            raise ValueError(f"no channels named {sorted(unknown)}")
        if corr.device.type == "cpu":
            ch = score_frame_channels(corr, geo, n)
            for r, name in enumerate(rows):
                out[:, r, t0:t0 + n] = ch[name].view(torch.int32)
            return out
        if corr.device.type != "cuda":
            raise ValueError(f"no frame-channel kernel for device "
                             f"{corr.device}")
        return self._launch(corr, n, out, rows, t0)

    def _launch(self, corr, n, out, rows, t0) -> torch.Tensor:
        from . import _kernels

        geo = self.geo
        batch = corr.shape[0]
        if n == 0 or batch == 0:
            return out
        if corr.stride(2) != 1:
            corr = corr.contiguous()
        if self._fn is None:
            self._fn = _kernels.load().mm_frame_channels
        device = corr.device
        scratch = torch.empty((batch, n + geo.max_begin, 2),
                              dtype=torch.float32, device=device)
        err = self._fn(
            corr.data_ptr(), int(corr.dtype == torch.float64),
            corr.stride(0), corr.stride(1), batch, n,
            self.begin(device).data_ptr(), geo.n_bits, geo.max_begin,
            self.scal, self.d_mask, self.d_val, self.s_mask, self.s_val,
            (ctypes.c_int * len(CHANNELS))(*row_map(rows)),
            scratch.data_ptr(), out.data_ptr(), out.stride(0),
            out.stride(1), t0, torch._C._cuda_getCurrentRawStream(
                device.index))
        _kernels.check(err, "mm_frame_channels")
        FrameChannels.launches += 1
        return out
