"""Keyed whole frames of any configuration's framing, a fractional stop
included: the start bits and the data bits LSB first of `bit_nsamples_tx`
samples each, then a stop tone of trunc(bit_nsamples_tx * nstopbits)
samples (minimodem's TX: 7,920 samples a 5-N-1.5 RTTY frame at 48 kHz,
of which 1,584 the stop).  The phase is continuous across every segment,
in float64, as `tones.keyed_audio` keys it; where nstopbits is whole the
audio equals `tones.keyed_audio` of the frame bits with that many stop
bits, sample for sample.

Plain NumPy and PyTorch, the audio made on the run's device.
"""

from __future__ import annotations

import numpy as np

from . import tones
from .reference.modem import Geometry


def stop_nsamples(g: Geometry) -> int:
    """The transmitted stop tone's samples (0 without a stop bit)."""
    return int(np.trunc(np.float64(g.bit_nsamples_tx) * float(g.nstopbits)))


def frame_segments(g: Geometry) -> tuple:
    """One frame's keyed segments: (template index [m] of the bit each
    keys, samples [m]).  The stop is cut into whole bits and a remainder,
    so a whole stop keys exactly as `tones.keyed_audio` keys its bits."""
    ns = g.bit_nsamples_tx
    n_tpl = len(tones.frame_template(g))
    if float(g.nstopbits) == 0.0:
        return np.arange(n_tpl), np.full(n_tpl, ns)
    whole, rest = divmod(stop_nsamples(g), ns)
    stop = [ns] * whole + ([rest] if rest else [])
    idx = np.concatenate([np.arange(n_tpl - 1),
                          np.full(len(stop), n_tpl - 1)])
    return idx, np.array([ns] * (n_tpl - 1) + stop)


def frame_nsamples_tx(g: Geometry) -> int:
    """Samples of one transmitted frame."""
    return int(frame_segments(g)[1].sum())


def keyed_segments(bits: np.ndarray, lens: np.ndarray, g: Geometry,
                   device) -> "torch.Tensor":
    """Continuous-phase tones, segment k of lens[k] samples keyed by
    bits[:, k] (1 = mark), amplitude 1: bits [R, m] -> float64 samples
    [R, lens.sum()] on `device`.  With every segment bit_nsamples_tx long
    it is `tones.keyed_audio`, bit for bit."""
    import torch

    b = torch.from_numpy(np.ascontiguousarray(bits)).to(device)
    n = torch.from_numpy(np.asarray(lens, np.int64)).to(device)
    step = torch.where(b == 1, float(g.mark_f), float(g.space_f)).to(
        torch.float64) / g.sample_rate
    span = step * n.to(torch.float64)
    start = torch.cumsum(span, dim=1) - span
    seg = torch.repeat_interleave(torch.arange(len(n), device=device), n)
    first = torch.cumsum(n, 0) - n
    off = torch.arange(len(seg), device=device) - first[seg]
    ph = start[:, seg] + step[:, seg] * off.to(torch.float64)
    return torch.sin(2.0 * np.pi * torch.frac(ph))


def keyed_burst(words: np.ndarray, g: Geometry, leader_bits: int,
                trailer_bits: int, device) -> "torch.Tensor":
    """words [R, F] (data words) -> one burst a row: `leader_bits` mark
    bits, the F frames, `trailer_bits` mark bits, as float64 samples
    [R, (leader_bits + trailer_bits) * bit_nsamples_tx + F *
    frame_nsamples_tx] on `device`."""
    ns = g.bit_nsamples_tx
    rows, frames = words.shape
    idx, lens = frame_segments(g)
    tpl = np.stack([tones.frame_bits(w, g).reshape(frames, -1)
                    for w in words])                     # [R, F, tpl]
    body = tpl[:, :, idx].reshape(rows, -1)
    bits = np.concatenate([np.ones((rows, leader_bits), np.uint8), body,
                           np.ones((rows, trailer_bits), np.uint8)], axis=1)
    seg_lens = np.concatenate([np.full(leader_bits, ns), np.tile(lens, frames),
                               np.full(trailer_bits, ns)])
    return keyed_segments(bits, seg_lens, g, device)
