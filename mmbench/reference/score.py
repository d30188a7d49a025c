"""Score planes in plain PyTorch: the sliding correlation against the
mark and space tones, then the per-offset frame confidence, amplitude and
bits (minimodem's src/fsk.c:117-446, CONFIDENCE_ALGO 6).

The correlation is a float32 chain of fused multiply-adds in ascending
tap order, each rounded once; every later step is one IEEE-rounded
multiply, add, divide or square root, sums in ascending bit order.  That
is the arithmetic the configuration states (float32, no TF32), so any
correct implementation gives these planes bit for bit.

`precision="tf32"` is the control: the samples and the basis are rounded
to TF32's 10-bit significand before the same chain, the step below
float32 that a faster scorer might take.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.  Runs on any device; on the card, in blocks of
streams.
"""

from __future__ import annotations

import numpy as np
import torch

from .modem import F32_EPSILON, Geometry

_LOW29 = (1 << 29) - 1
_F32_TIE = 1 << 28
_F32_TINY = 2.0 ** -125


def basis(g: Geometry) -> np.ndarray:
    """[4, nb] float32 rows cos/sin of the mark band, then of the space
    band, from the reduced index (b * n mod fftsize)."""
    n = np.arange(g.nb, dtype=np.int64)
    out = np.empty((4, g.nb), np.float64)
    for row, band in ((0, g.b_mark), (2, g.b_space)):
        ang = 2.0 * np.pi * (((band * n) % g.fftsize).astype(np.float64)
                             / g.fftsize)
        out[row], out[row + 1] = np.cos(ang), np.sin(ang)
    return out.astype(np.float32)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at 10 significand bits."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _round_once(s, p, c, idx):
    """Make s = p + c (float64) round to float32 correctly at idx: round
    the sum to odd (TwoSum's exact error moves an inexact even result one
    ulp toward the exact value)."""
    sh = s[idx]
    bb = sh - p
    err = (p - (sh - bb)) + (c - bb)
    even = (sh.view(torch.int64) & 1) == 0
    away = torch.nextafter(sh, torch.where(err > 0, torch.inf, -torch.inf))
    s[idx] = torch.where((err != 0) & even, away, sh)


def _has_tiny(t: torch.Tensor) -> bool:
    """Whether some nonzero |t| is below 2^-40 (then partial sums may
    fall in float32's subnormal range)."""
    a = t.abs()
    a = a[a > 0]
    return a.numel() > 0 and float(a.min()) < 2.0 ** -40


def correlate(x: torch.Tensor, b: torch.Tensor, s_len: int) -> torch.Tensor:
    """corr[..., c, s] = fma chain over j of b[c, j] * x[..., s + j].
    x [..., >= s_len + nb - 1] float32, b [4, nb] float32
    -> [..., 4, s_len] float32."""
    nb = b.shape[1]
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    shape = x.shape[:-1] + (4, s_len)
    dev = x.device
    acc = torch.zeros(shape, dtype=torch.float64, device=dev)
    acc32 = torch.empty(shape, dtype=torch.float32, device=dev)
    s = torch.empty(shape, dtype=torch.float64, device=dev)
    low = s.view(torch.int32)[..., ::2]
    low29 = torch.empty(shape, dtype=torch.int32, device=dev)
    hard = torch.empty(shape, dtype=torch.bool, device=dev)
    check_tiny = _has_tiny(x) or _has_tiny(b)
    for j in range(nb):
        xj, bj = x64[..., None, j:j + s_len], b64[:, j, None]
        torch.addcmul(acc, xj, bj, out=s)        # exact product, one rounding
        torch.bitwise_and(low, _LOW29, out=low29)
        torch.eq(low29, _F32_TIE, out=hard)
        if check_tiny:
            hard |= (s.abs() < _F32_TINY) & (s != 0)
        idx = hard.nonzero(as_tuple=True)
        if idx[0].numel():
            _round_once(s, xj.expand(shape)[idx] * bj.expand(shape)[idx],
                        acc[idx], idx)
        acc32.copy_(s)
        acc.copy_(acc32)
    return acc32


def channels(corr: torch.Tensor, g: Geometry, t_len: int) -> list:
    """Band magnitudes -> [conf, ampl, bits_lo, bits_hi] per offset
    (conf, ampl float32; bits int32 words, frame bits LSB first)."""
    scal = float(np.float32(g.magscalar))
    eps = float(F32_EPSILON)

    def magnitude(re, im):
        # float32 sqrt, correctly rounded through float64
        return torch.sqrt((re * re + im * im).to(torch.float64)).to(
            torch.float32) * scal

    mark = magnitude(corr[..., 0, :], corr[..., 1, :])
    space = magnitude(corr[..., 2, :], corr[..., 3, :])
    bit = mark > space
    sig = torch.where(bit, mark, space)
    noise = torch.where(bit, space, mark)
    noise = torch.where(noise > eps, noise, torch.zeros_like(noise))

    def at(arr, k):
        off = int(g.bit_begin[k])
        return arr[..., off:off + t_len]

    zero = torch.zeros(corr.shape[:-2] + (t_len,), dtype=torch.float32,
                       device=corr.device)
    izero = torch.zeros(zero.shape, dtype=torch.int32, device=corr.device)
    total_sig = total_noise = mark_sig = zero
    n_mark = bits_lo = bits_hi = izero
    ok = torch.ones(zero.shape, dtype=torch.bool, device=corr.device)
    for k in range(g.n_bits):
        sk, bk = at(sig, k), at(bit, k)
        total_sig = total_sig + sk
        total_noise = total_noise + at(noise, k)
        mark_sig = mark_sig + torch.where(bk, sk, zero)
        n_mark = n_mark + bk.to(torch.int32)
        if g.req[k] >= 0:
            ok = ok & (bk == bool(g.req[k]))
        w = int(np.uint32(1 << (k % 32)).view(np.int32))
        w = torch.where(bk, w, 0).to(torch.int32)
        if k < 32:
            bits_lo = bits_lo | w
        else:
            bits_hi = bits_hi | w
    # tensor divisors: true IEEE division on every device
    n_bits = torch.full_like(zero, float(g.n_bits))
    n_mark_f = n_mark.to(torch.float32)
    n_space_f = n_bits - n_mark_f
    avg_mark = torch.where(n_mark_f > 0, mark_sig / n_mark_f, zero)
    avg_space = torch.where(n_space_f > 0, (total_sig - mark_sig) / n_space_f,
                            zero)
    div = zero
    for k in range(g.n_bits):
        own = torch.where(at(bit, k), avg_mark, avg_space)
        div = div + torch.abs(at(sig, k) - own) / own
    div = div * 2.0 / n_bits
    conf = (total_sig / total_noise) * (1.0 - div)
    ampl = total_sig / n_bits
    return [torch.where(ok, conf, zero).view(torch.int32),
            torch.where(ok, ampl, zero).view(torch.int32), bits_lo, bits_hi]


def planes(x: torch.Tensor, g: Geometry, t_len: int,
           precision: str = "float32") -> torch.Tensor:
    """x [B, >= t_len + halo] float32 -> planes [B, n_planes, t_len] int32
    (conf, ampl, bits_lo[, bits_hi])."""
    b = torch.from_numpy(basis(g)).to(x.device)
    x = x[:, :t_len + g.halo]
    if precision == "tf32":
        x, b = to_tf32(x), to_tf32(b)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    rows = channels(correlate(x, b, t_len + g.max_begin), g, t_len)
    return torch.stack(rows[:g.n_planes], dim=1)
