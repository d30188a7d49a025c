"""Device-side tone synthesis: LUT gather or sine, scaling and rounding.

Counterpart of minimodem_tpu/ops/tx_jax.py::synthesize_device (the
`--synth-backend jax` TX path), in plain PyTorch on an explicit device.
The host supplies the per-sample phase ("turns") array and the silence
mask (ops/tx.py::ToneGenerator._per_sample_turns); the device does the
rest of the reference's per-sample loop
(reference: src/simple-tone-generator.c:77-94, 124-160):

- LUT: index = trunc(len * turns + 0.5) as two separately rounded float32
  ops (a multiply, then an add: no fused multiply-add), to int64, mod len,
  then a gather from the S16 or float table.  Bit-identical to the numpy
  backend.
- direct sine: sin(float32(2pi) * turns) evaluated in float64 and rounded
  to float32, as the numpy backend does (ops/tx.py::_sin_f32), then the
  S16 magnitude (with the reference's clamp, ops/tx.py::_mag_s16) and
  lroundf, or the float magnitude.  The same samples as the numpy
  backend; within one float32 ulp of the JAX backend's sinf.
"""

from __future__ import annotations

import numpy as np
import torch

from .tx import _TWO_PI_F32, _mag_s16


def _lroundf(x: torch.Tensor) -> torch.Tensor:
    """lroundf over a float32 tensor, as utils/cfloat.py::lroundf_arr."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def synthesize_device(turns: np.ndarray, silent: np.ndarray, table_short,
                      table_float, sin_table_len: int, tone_mag: float,
                      is_s16: bool, device) -> torch.Tensor:
    """turns [N] float32, silent [N] bool -> samples [N] int16 (is_s16)
    or float32, as a tensor on `device`."""
    turns = torch.from_numpy(np.asarray(turns, np.float32)).to(device)
    silent = torch.from_numpy(np.asarray(silent, bool)).to(device)
    if sin_table_len:
        tf = turns * float(np.float32(sin_table_len))
        tf = tf + 0.5
        # int64 like the numpy path: int32 would wrap for very long
        # single-tone segments
        idx = torch.trunc(tf).to(torch.int64) % sin_table_len
        table = torch.from_numpy(table_short if is_s16 else table_float)
        out = table.to(device)[idx]
    else:
        s = torch.sin((turns * float(_TWO_PI_F32)).to(torch.float64)).to(
            torch.float32)
        if is_s16:
            mag_s = float(np.float32(_mag_s16(np.float32(tone_mag))))
            out = _lroundf(s * mag_s).to(torch.int16)
        else:
            out = s * float(np.float32(tone_mag))
    return torch.where(silent, torch.zeros((), dtype=out.dtype,
                                           device=out.device), out)
