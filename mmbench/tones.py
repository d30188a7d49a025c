"""The benchmark's own frozen tone generator for recorded traffic: keyed
FSK frames of a configuration's framing, continuous phase (float64), with
seeded uniform noise, as PCM16 or 8-bit u-law, and a PCM16 WAV writer.

Plain NumPy and PyTorch, the audio made on the run's device in a few
large calls.  The program is handed only what this makes.
"""

from __future__ import annotations

import struct

import numpy as np

from .reference.modem import Geometry


def frame_template(g: Geometry) -> str:
    """One frame's keyed bits: the frame pattern without the previous
    stop bit ('d' marks a data bit, LSB first)."""
    pattern = "".join("d" if r < 0 else str(r) for r in g.req)
    return pattern[1:] if float(g.nstopbits) != 0.0 else pattern


def frame_bits(words: np.ndarray, g: Geometry) -> np.ndarray:
    """words [n] (data words) -> keyed bits [n * frame_len] uint8."""
    tpl = frame_template(g)
    fixed = np.array([0 if c == "d" else int(c) for c in tpl], np.uint8)
    slots = np.array([c == "d" for c in tpl])
    out = np.tile(fixed, (len(words), 1))
    data = (np.asarray(words, np.uint64)[:, None]
            >> np.arange(g.n_data_bits, dtype=np.uint64)) & np.uint64(1)
    out[:, slots] = data.astype(np.uint8)
    return out.reshape(-1)


def keyed_audio(bits: np.ndarray, g: Geometry, device) -> "torch.Tensor":
    """Continuous-phase tones, one bit_nsamples_tx segment a bit (1 =
    mark), amplitude 1: bits [R, n] -> float64 samples [R, n * ns] on
    `device`."""
    import torch

    ns = g.bit_nsamples_tx
    b = torch.from_numpy(np.ascontiguousarray(bits)).to(device)
    step = torch.where(b == 1, float(g.mark_f), float(g.space_f)).to(
        torch.float64) / g.sample_rate
    start = torch.cumsum(step * ns, dim=1) - step * ns
    ph = start[..., None] + step[..., None] * torch.arange(
        ns, dtype=torch.float64, device=device)
    return torch.sin(2.0 * np.pi * torch.frac(ph)).reshape(b.shape[0], -1)


def silence(rows: int, seconds: float, g: Geometry, device):
    import torch

    return torch.zeros((rows, int(round(seconds * g.sample_rate))),
                       dtype=torch.float64, device=device)


def noisy_pcm16(x, gen, amplitude: float, host: bool = True):
    """x [R, n] float64 plus uniform noise in [-amplitude / 2, amplitude /
    2) from the torch generator `gen`, as PCM16: on the host (numpy), or
    where x is (a tensor) with host=False."""
    import torch

    u = torch.rand(x.shape, generator=gen, device=x.device,
                   dtype=torch.float32)
    x = x + (u.to(torch.float64) - 0.5) * amplitude
    s16 = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(
        torch.int16)
    return s16.cpu().numpy() if host else s16


def generator(seed: int, device):
    """The torch generator of a run's noise, seeded from --seed."""
    import torch

    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def ulaw_encode(s16) -> np.ndarray:
    """G.711 u-law, 8 bits a sample, of an int16 tensor -> numpy uint8
    on the host."""
    import torch

    x = s16.to(torch.int32)
    sign = torch.where(x < 0, 0x80, 0)
    mag = torch.clamp(x.abs(), max=32635) + 0x84
    exp = torch.floor(torch.log2(mag.to(torch.float64))).to(torch.int32) - 7
    mant = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | mant) & 0xFF).to(torch.uint8).cpu().numpy()


def write_wav(path: str, s16: np.ndarray, rate: int) -> None:
    """A mono PCM16 WAV file."""
    data = np.ascontiguousarray(s16, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, 2 * rate,
                                      2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
