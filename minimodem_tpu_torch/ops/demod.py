"""FSK demodulation geometry and the plain PyTorch scoring math.

Counterpart of minimodem_tpu/ops/demod.py.  The geometry (DemodGeometry,
geometry_from_config, make_basis, _is_perfect_capable) is the same numpy
code, so both packages derive identical bit windows, bands and bases from
one ModemConfig.

The scoring runs in two passes over a whole audio chunk (reference:
src/fsk.c:117-174 bit analysis, :178-446 frame analysis):

  pass 1 (per sample):  correlate the audio against 4 basis vectors
      (mark/space x cos/sin) -> band magnitudes, the bit decision and the
      signal / noise magnitudes at every sample offset.

  pass 2 (per offset):  frame confidence (CONFIDENCE_ALGO 6 = frame SNR x
      (1 - divergence), reference: src/fsk.c:265-341) for every candidate
      frame start, from shifted slices of the pass-1 planes.

`correlate` and `score_frame_channels` are the plain version of the fused
CUDA scorer (ops/fused_score.py, csrc/fused_score.cu);
`score_frame_channels` is also the plain version of the frame-channel
kernel K5 (ops/frame_channels.py, csrc/frame_channels.cu), which the host
engines' chunked scorer `DemodScorer` runs after the stage-1 correlation
kernel (ops/correlate.py, csrc/correlate.cu).  Every op is one
IEEE-rounded multiply, add, divide or sqrt, and every sum runs in
ascending tap order, so the kernel reproduces them bit for bit.  The
correlation is the float32 fused-multiply-add chain that XLA compiles the
JAX package's _correlate_direct into on the CPU (bit-identical there); a
chain of separately rounded products drifted up to 4e-6 relative from
both JAX scorers on NOAA SAME, whose clean-tone noise bands are
near-cancelling sums.  Two deliberate choices differ from the JAX XLA
path and are held by tolerance in the tests instead:
magnitudes are sqrt(c*c + s*s) * scal (the fused TPU kernel's formula,
minimodem_tpu/ops/pallas_score.py:228-231) where the XLA path uses hypot,
and the comb sums add the taps in ascending order where XLA picks its own
reduction tree.

`correlator_for` picks the stage-1 route as the JAX package's does
(minimodem_tpu/ops/demod.py:202-212): float32 filters of up to 4096 taps
go to the CUDA kernel (its plain version on the CPU), longer float32
filters to an FFT correlation, and float64 ("perfect-capable") geometries
to a plain float64 chain.  Magnitudes are rounded to float32 right after
the scaling, so every channel is float32 whatever the correlation's type.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ModemConfig
from ..utils import device as _device
from ..utils.cfloat import F32_EPSILON, f32_div

# direct correlation above this filter length would waste FLOPs; use FFT
_DIRECT_CONV_MAX_NB = 4096
# float64 scoring only pays off when confidence=inf is reachable and the
# filter is short
_F64_MAX_NB = 4096


def _is_perfect_capable(cfg: ModemConfig) -> bool:
    """True when both tones complete integer cycles inside one bit window
    and land exactly on their DFT bins — the precondition for the
    reference's confidence=inf ("rate perfect") decodes."""
    nb = cfg.bit_nsamples_rx
    n = cfg.fftsize
    rate = float(cfg.sample_rate)

    def near_int(x):
        return abs(x - round(x)) < 1e-9

    return all(
        near_int(v)
        for v in (
            nb * float(cfg.mark_f) / rate,
            nb * float(cfg.space_f) / rate,
            nb * cfg.b_mark / n,
            nb * cfg.b_space / n,
        )
    )


@dataclass(frozen=True)
class DemodGeometry:
    """Static scoring geometry extracted from a ModemConfig."""

    nb: int                       # bit window length (DFT input length)
    fftsize: int
    b_mark: int
    b_space: int
    magscalar: float              # 2.0f / bit_nsamples (f32)
    bit_begin: tuple              # per-bit window start offsets
    n_bits: int
    req_data: tuple               # per-bit: -1 dontcare, 0/1 required value
    req_sync: tuple
    use_f64: bool

    @property
    def max_begin(self) -> int:
        return self.bit_begin[-1]

    @property
    def halo(self) -> int:
        """Extra samples needed past the last scored offset."""
        return self.max_begin + self.nb


def geometry_from_config(cfg: ModemConfig, precision: str = "auto") -> DemodGeometry:
    def reqs(expect: str):
        return tuple(-1 if c == "d" else int(c) for c in expect)

    if precision == "float64":
        use_f64 = True
    elif precision == "float32":
        use_f64 = False
    else:
        use_f64 = _is_perfect_capable(cfg) and cfg.bit_nsamples_rx <= _F64_MAX_NB

    return DemodGeometry(
        nb=cfg.bit_nsamples_rx,
        fftsize=cfg.fftsize,
        b_mark=cfg.b_mark,
        b_space=cfg.b_space,
        magscalar=float(f32_div(2.0, cfg.bit_nsamples_rx)),
        bit_begin=tuple(cfg.bit_begin_samples),
        n_bits=cfg.expect_n_bits,
        req_data=reqs(cfg.expect_data_string),
        req_sync=reqs(cfg.expect_sync_string),
        use_f64=use_f64,
    )


def make_basis(geo: DemodGeometry, dtype=np.float64) -> np.ndarray:
    """[4, nb] correlation basis: rows = (cos_m, sin_m, cos_s, sin_s).

    Angles are computed from the *reduced* index (b*n mod fftsize), so that
    windows of periodic signals cancel bit-exactly (this is what lets
    integer-ratio signals reach confidence=inf)."""
    n = np.arange(geo.nb, dtype=np.int64)
    out = np.empty((4, geo.nb), dtype=np.float64)
    for row, band in ((0, geo.b_mark), (2, geo.b_space)):
        k = (band * n) % geo.fftsize
        ang = 2.0 * np.pi * (k.astype(np.float64) / geo.fftsize)
        out[row] = np.cos(ang)
        out[row + 1] = np.sin(ang)
    return out.astype(dtype)


# ======================================================================
# pass 1: sliding correlation
# ======================================================================

# float64 significand bits below float32's: a value whose low 29 bits are
# exactly 1 << 28 lies on a float32 rounding tie
_LOW29 = (1 << 29) - 1
_F32_TIE = 1 << 28
_F32_TINY = 2.0 ** -125          # below it float32 keeps fewer bits


def _round_once(s, p, c, idx):
    """Repair s = p + c (float64) at the indices idx so that its float32
    rounding is the correctly rounded p + c: the sum rounded to odd
    (TwoSum gives its exact error; an inexact even result moves one ulp
    toward the exact value)."""
    sh = s[idx]
    bb = sh - p
    err = (p - (sh - bb)) + (c - bb)                # sh + err == p + c
    even = (sh.view(torch.int64) & 1) == 0
    away = torch.nextafter(sh, torch.where(err > 0, torch.inf, -torch.inf))
    s[idx] = torch.where((err != 0) & even, away, sh)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add a * b + c, elementwise.

    Inputs are float64 tensors holding float32 values, so a * b is exact
    in float64 and s = a * b + c rounds once there.  Rounding s to float32
    is then correct unless s landed exactly on a float32 tie (float64
    rounding never carries the sum across one) or in float32's subnormal
    range.  Those few elements are redone with the sum rounded to odd,
    whose float32 rounding is correct (53 >= 24 + 2 bits): the same bits
    as CUDA's __fmaf_rn."""
    p = a * b
    s = p + c
    hard = ((s.view(torch.int64) & _LOW29) == _F32_TIE) | (
        (s.abs() < _F32_TINY) & (s != 0))
    idx = hard.nonzero(as_tuple=True)
    if idx[0].numel():
        _round_once(s, p.expand_as(s)[idx], c.expand_as(s)[idx], idx)
    return s.to(torch.float32)


def _no_tiny(t: torch.Tensor) -> bool:
    """Whether every nonzero |t| is at least 2^-40."""
    a = t.abs()
    a = a[a > 0]
    return a.numel() == 0 or float(a.min()) >= 2.0 ** -40


def correlate(x: torch.Tensor, basis: torch.Tensor, s_len: int) -> torch.Tensor:
    """corr[..., c, s] = sum_j basis[c, j] * x[..., s + j], s in [0, s_len).

    A float32 chain of fused multiply-adds in ascending j, the order of
    the JAX package's _correlate_direct (minimodem_tpu/ops/demod.py:
    165-183), which XLA compiles to exactly this chain on the CPU.  Each
    step is fma_f32 done in place in preallocated buffers (the product of
    two float32 values is exact in float64, so addcmul rounds once, fused
    or not).  Where no
    nonzero input is below 2^-40 in magnitude, every product and partial
    sum is a multiple of 2^-126, so no sum is a float32 subnormal and only
    the tie test remains.
    x: [..., >= s_len + nb - 1] float32, basis: [4, nb] float32
    -> [..., 4, s_len] float32."""
    nb = basis.shape[1]
    x64 = x.to(torch.float64)
    b64 = basis.to(torch.float64)
    shape = x.shape[:-1] + (4, s_len)
    dev = x.device
    acc = torch.zeros(shape, dtype=torch.float64, device=dev)  # f32 values
    acc32 = torch.empty(shape, dtype=torch.float32, device=dev)
    s = torch.empty(shape, dtype=torch.float64, device=dev)
    low = s.view(torch.int32)[..., ::2]          # low words (little-endian)
    low29 = torch.empty(shape, dtype=torch.int32, device=dev)
    hard = torch.empty(shape, dtype=torch.bool, device=dev)
    check_tiny = not (_no_tiny(x) and _no_tiny(basis))
    for j in range(nb):
        xj, bj = x64[..., None, j:j + s_len], b64[:, j, None]
        # exact product, one float64 rounding of the sum
        torch.addcmul(acc, xj, bj, out=s)
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


def correlate_direct(x: torch.Tensor, basis: torch.Tensor,
                     s_len: int) -> torch.Tensor:
    """The float64 route: corr[..., c, s] = sum_j basis[c, j] * x[..., s + j]
    as a plain chain of products and sums in ascending j, in x's dtype
    (the JAX package's _correlate_direct, minimodem_tpu/ops/demod.py:
    165-183, run in float64).  Each step rounds twice where XLA may
    contract it into one FMA; the difference stays below float64's last
    bits and vanishes when the magnitudes are rounded to float32, except
    on double-rounding ties.  x: [..., >= s_len + nb - 1],
    basis: [4, nb] -> [..., 4, s_len]."""
    nb = basis.shape[1]
    acc = torch.zeros(x.shape[:-1] + (4, s_len), dtype=x.dtype,
                      device=x.device)
    for j in range(nb):
        acc = acc + basis[:, j, None] * x[..., None, j:j + s_len]
    return acc


def correlate_fft(x: torch.Tensor, basis: torch.Tensor,
                  s_len: int) -> torch.Tensor:
    """FFT cross-correlation for long float32 filters (the JAX package's
    _correlate_fft, minimodem_tpu/ops/demod.py:186-195): the same
    power-of-two transform length from the row length.  The transforms sum
    in another order than XLA's, so the results agree within FFT
    round-off, not bit for bit.  x: [..., L] -> [..., 4, s_len]."""
    length = int(x.shape[-1])
    fft_len = 1 << (length - 1).bit_length()
    xf = torch.fft.rfft(x, fft_len)
    bf = torch.fft.rfft(basis, fft_len)
    corr = torch.fft.irfft(xf[..., None, :] * torch.conj(bf), fft_len)
    return corr[..., :s_len]


def correlator_for(geo: DemodGeometry, basis_np: np.ndarray):
    """Stage 1 by the route the geometry needs (the JAX package's
    correlate_any), resolved once: a function (x, s_len) -> corr.  Float64
    chain, FFT for nb > 4096, else the CUDA kernel's wrapper
    (ops/correlate.py Correlator).  x: [B, s_len + halo - max_begin]
    float32 rows; basis_np: make_basis(geo) in float64 for float64
    geometries, else float32 -> corr [B, 4, s_len] in float64 or
    float32."""
    if geo.use_f64:
        b64 = torch.from_numpy(np.asarray(basis_np, np.float64))
        return lambda x, s_len: correlate_direct(
            x.to(torch.float64), b64.to(x.device), s_len)
    if geo.nb > _DIRECT_CONV_MAX_NB:
        b32 = torch.from_numpy(np.asarray(basis_np, np.float32))
        return lambda x, s_len: correlate_fft(x, b32.to(x.device), s_len)
    from .correlate import Correlator

    return Correlator(basis_np)


# ======================================================================
# pass 1b + 2: band magnitudes -> per-offset frame channels
# ======================================================================

def _bit_weight(k: int) -> int:
    """LSB-first packing weight of bit k (< 32) as an int32 value."""
    return int(np.uint32(1 << k).view(np.int32))


def score_frame_channels(corr: torch.Tensor, geo: DemodGeometry,
                         t_len: int) -> dict:
    """Band magnitudes -> the six per-offset frame channels.

    corr: [..., 4, >= t_len + max_begin] float32, or float64 for the
    float64 geometries.  Returns a dict of [..., t_len] tensors:
    conf_data, conf_sync, ampl_data, ampl_sync (float32) and bits_lo,
    bits_hi (int32 holding the uint32 bit patterns, frame bits packed
    LSB-first, reference: src/fsk.c:439-441).  The plain version of K5
    (ops/frame_channels.py, csrc/frame_channels.cu) and part of K1's.
    """
    score_frame_channels.calls += 1
    eps = float(F32_EPSILON)
    scal = float(np.float32(geo.magscalar))
    c = corr
    # band magnitudes (reference: src/fsk.c:107-114,130-159), rounded to
    # float32 after the scaling as the JAX package does
    # (minimodem_tpu/ops/demod.py:227-229): every later decision and sum
    # is float32 whatever the correlation's type
    def magnitude(re, im):
        sq = re * re + im * im
        if sq.dtype == torch.float32:
            # float32: the square root in float64 rounded once, which is
            # the correctly rounded sqrtf on any device (a vectorized CPU
            # sqrtf of a PyTorch build may be an ulp off it)
            return torch.sqrt(sq.to(torch.float64)).to(torch.float32) * scal
        return (torch.sqrt(sq) * scal).to(torch.float32)

    mag_mark = magnitude(c[..., 0, :], c[..., 1, :])
    mag_space = magnitude(c[..., 2, :], c[..., 3, :])
    bit = mag_mark > mag_space                       # fsk.c:161 strict
    sig = torch.where(bit, mag_mark, mag_space)
    noise = torch.where(bit, mag_space, mag_mark)
    noise_gated = torch.where(noise > eps, noise, torch.zeros_like(noise))

    def sl(arr, k):
        off = int(geo.bit_begin[k])
        return arr[..., off:off + t_len]

    zero = torch.zeros(c.shape[:-2] + (t_len,), dtype=torch.float32,
                       device=c.device)
    izero = torch.zeros(zero.shape, dtype=torch.int32, device=c.device)
    total_sig, total_noise, mark_sig = zero, zero, zero
    n_mark = izero
    bits_lo, bits_hi = izero, izero
    ok_data = torch.ones(zero.shape, dtype=torch.bool, device=c.device)
    ok_sync = ok_data
    # ---- pass 2a: comb sums over the frame's bit windows, ascending k ----
    for k in range(geo.n_bits):
        sk, bk = sl(sig, k), sl(bit, k)
        total_sig = total_sig + sk
        total_noise = total_noise + sl(noise_gated, k)
        mark_sig = mark_sig + torch.where(bk, sk, zero)
        n_mark = n_mark + bk.to(torch.int32)
        if geo.req_data[k] >= 0:
            ok_data = ok_data & (bk == bool(geo.req_data[k]))
        if geo.req_sync[k] >= 0:
            ok_sync = ok_sync & (bk == bool(geo.req_sync[k]))
        w = torch.where(bk, _bit_weight(k % 32), 0).to(torch.int32)
        if k < 32:
            bits_lo = bits_lo | w
        else:
            bits_hi = bits_hi | w

    # divisors stay tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and the reference's) true division
    n_bits_f = torch.full_like(zero, float(geo.n_bits))
    n_mark_f = n_mark.to(torch.float32)
    n_space_f = n_bits_f - n_mark_f
    space_sig = total_sig - mark_sig
    # averages guarded like C (division skipped when count==0,
    # reference: src/fsk.c:298-301)
    avg_mark = torch.where(n_mark_f > 0, mark_sig / n_mark_f, zero)
    avg_space = torch.where(n_space_f > 0, space_sig / n_space_f, zero)

    # ---- pass 2b: divergence (reference CONFIDENCE_ALGO 6) ----
    divergence = zero
    for k in range(geo.n_bits):
        avg_own = torch.where(sl(bit, k), avg_mark, avg_space)
        divergence = divergence + torch.abs(sl(sig, k) - avg_own) / avg_own
    divergence = divergence * 2.0 / n_bits_f

    snr = total_sig / total_noise            # IEEE: x/0 = inf, 0/0 = nan
    conf = snr * (1.0 - divergence)
    ampl = total_sig / n_bits_f
    # when the frame is rejected the reference leaves ampl at 0
    # (reference: src/fsk.c:211-212, minimodem.c:1253 init)
    return {
        "conf_data": torch.where(ok_data, conf, zero),
        "conf_sync": torch.where(ok_sync, conf, zero),
        "ampl_data": torch.where(ok_data, ampl, zero),
        "ampl_sync": torch.where(ok_sync, ampl, zero),
        "bits_lo": bits_lo,
        "bits_hi": bits_hi,
    }


score_frame_channels.calls = 0


# ======================================================================
# the host engines' chunked scorer
# ======================================================================

CHANNELS = ("conf_data", "conf_sync", "ampl_data", "ampl_sync", "bits_lo",
            "bits_hi")


@functools.lru_cache(maxsize=64)
def _build_score_fn(geo: DemodGeometry, t_len: int, device: str):
    """The scoring function for a fixed chunk length on one device (the
    JAX package's _build_score_fn, minimodem_tpu/ops/demod.py:301-325).

    Input:  x [B, t_len + halo] float32 rows (any row stride), moved to
            `device` if they lie elsewhere
    Output: [B, 6, t_len] int32 on `device`, the CHANNELS in order (floats
            bit-cast), so one copy brings a batch of chunks to the host.

    Stage 1 by correlator_for, then the channels by K5
    (ops/frame_channels.py) straight into the output.
    """
    from .frame_channels import FrameChannels

    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    channels = FrameChannels(geo)
    s_len = t_len + geo.max_begin  # offsets where bit windows may start

    def score(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device)
        out = torch.empty((x.shape[0], len(CHANNELS), t_len),
                          dtype=torch.int32, device=x.device)
        return channels(stage1(x, s_len), t_len, out)

    return score


def _unstack(planes: np.ndarray) -> dict:
    """[..., 6, T] int32 host planes -> the channel dict the host state
    machines read: float32 conf/ampl and uint32 bits, as the JAX scorer
    returns them."""
    return {k: np.ascontiguousarray(planes[..., i, :]).view(
                np.uint32 if k.startswith("bits") else np.float32)
            for i, k in enumerate(CHANNELS)}


class DemodScorer:
    """Chunked scoring driver on one device: feed absolute-position sample
    data, get per-offset score arrays on the host (the JAX package's
    DemodScorer, minimodem_tpu/ops/demod.py:328-348)."""

    BATCH = 64                   # chunks per score_chunks launch

    def __init__(self, cfg: ModemConfig, precision: str = "auto",
                 chunk_len: int = 1 << 17, device=_device.DEFAULT):
        self.geo = geometry_from_config(cfg, precision)
        # amortize huge halos (very low baud rates) with bigger chunks
        self.chunk_len = max(chunk_len, self.geo.halo // 2)
        self.device = torch.device(device)
        self._fn = _build_score_fn(self.geo, self.chunk_len,
                                   str(self.device))

    def score(self, samples: np.ndarray) -> dict:
        """Score offsets [0, chunk_len) of ``samples`` (one chunk, the
        K3a form); the array is zero-padded/truncated to chunk_len +
        halo."""
        _device.require(self.device)
        need = self.chunk_len + self.geo.halo
        x = np.zeros((1, need), dtype=np.float32)
        n = min(len(samples), need)
        x[0, :n] = samples[:n]
        planes = self._fn(torch.from_numpy(x))
        return _unstack(planes[0].cpu().numpy())

    def score_chunks(self, samples: np.ndarray) -> dict:
        """Score every chunk of a whole stream (at least one) in batched
        calls of up to BATCH overlapping chunk rows (the K3b form).
        Returns [n_chunks * chunk_len] arrays; chunk i's slice is
        bit-identical with score(samples[i * chunk_len:])."""
        _device.require(self.device)
        t_len, halo = self.chunk_len, self.geo.halo
        n_chunks = -(-max(len(samples), 1) // t_len)
        x = np.zeros(n_chunks * t_len + halo, np.float32)
        x[:len(samples)] = samples
        rows = torch.from_numpy(x).to(self.device).unfold(
            0, t_len + halo, t_len)                  # views, no copy
        parts = [self._fn(rows[i:i + self.BATCH]).cpu()
                 for i in range(0, n_chunks, self.BATCH)]
        planes = torch.cat(parts).permute(1, 0, 2).reshape(6, -1)
        return _unstack(planes.numpy())
