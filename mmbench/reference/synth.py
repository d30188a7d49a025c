"""The loopback's transmit side in plain NumPy and PyTorch: bytes ->
keyed bit schedule (minimodem's src/minimodem.c:81-250: two leader mark
bits, start / data LSB first / stop per byte, two trailer mark bits) ->
continuous-phase audio, the per-bit phase in closed form from exclusive
prefix counts (float64), the per-sample phase one fused multiply-add in
float32 and the sine taken in float64 and rounded once.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.  The schedule maker is also what the benchmark hands
the loopback.
"""

from __future__ import annotations

import numpy as np
import torch

from .modem import Geometry

_TWO_PI = float(np.float32(2.0 * np.pi))


def bit_schedules(payloads: np.ndarray, g: Geometry, leader: int = 2,
                  trailer: int = 2) -> np.ndarray:
    """payloads [B, n] uint8 (ASCII 8-N-1 frames, one stop bit) ->
    schedules [B, leader + n * frame_bits + trailer] uint8 (1 = mark)."""
    assert g.nstartbits == 1 and float(g.nstopbits) == 1.0
    b, n = payloads.shape
    data = (payloads[:, :, None] >> np.arange(g.n_data_bits)) & 1
    frames = np.concatenate([np.zeros((b, n, 1), np.uint8),
                             data.astype(np.uint8),
                             np.ones((b, n, 1), np.uint8)], axis=2)
    return np.concatenate([np.ones((b, leader), np.uint8),
                           frames.reshape(b, -1),
                           np.ones((b, trailer), np.uint8)], axis=1)


def _fma_f32(a, b, c):
    """float32 a * b + c rounded once: the float64 sum rounded to odd,
    then to float32."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.full_like(s, torch.inf).copysign(err))
    return torch.where((err != 0) & even, away, s).to(torch.float32)


def audio(bits: torch.Tensor, g: Geometry) -> torch.Tensor:
    """bits [B, n_bits] uint8 on any device -> samples [B, n_bits *
    bit_ns] float32, amplitude 1."""
    bit_ns = g.bit_nsamples_tx
    rate = float(g.sample_rate)
    wave_mark, wave_space = rate / float(g.mark_f), rate / float(g.space_f)
    dev = bits.device
    b = bits.to(torch.float64)
    n_mark = torch.cumsum(b, dim=1) - b
    idx = torch.arange(bits.shape[1], dtype=torch.float64, device=dev)
    phase = (n_mark * float(bit_ns / wave_mark)
             + (idx - n_mark) * float(bit_ns / wave_space))
    phase = (phase - torch.floor(phase)).to(torch.float32)
    inv_wave = torch.full(bits.shape, float(np.float32(1.0 / wave_space)),
                          dtype=torch.float32, device=dev).masked_fill_(
        bits == 1, float(np.float32(1.0 / wave_mark)))
    i = torch.arange(bit_ns, dtype=torch.float32, device=dev)
    turns = _fma_f32(i, inv_wave[:, :, None], phase[:, :, None])
    arg = (turns - torch.floor(turns)) * _TWO_PI
    samples = torch.sin(arg.to(torch.float64)).to(torch.float32)
    return (samples * 1.0).reshape(bits.shape[0], -1)
