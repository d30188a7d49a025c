"""K1's stage-2 division step (csrc/fused_score.cu div_rcp), on the CPU.

The kernel divides a stage-2 numerator a by a divisor b (a tap's average,
or a bit count) through y = RN(1 / b), hoisted once an offset or a launch:

    q = RN(a * y),  r = fma(-q, b, a),  q' = fma(r, y, q)

By Markstein's theorem q' is the correctly rounded a / b (what __fdiv_rn
gives and the plain version's true division) where no step under- or
overflows.  The kernel takes the step only inside its window
[kRcpLo, kRcpHi]: a tap's divisor in it and its numerator 0 or at least
2^-25 of the divisor and at most kRcpHi; a bit count's numerator 0 or in
it.  Elsewhere its guard takes the IEEE division.  Here the step is
emulated in float32 with the repo's exact FMA (ops/tx_device.py
fma_f32_exact) and held to NumPy's float32 division bit for bit on seeded
pairs, the window's edges and pairs whose quotient lies next to a
rounding tie; the guard is held to refuse what lies outside the window.
"""

import re
from pathlib import Path

import numpy as np
import torch

from minimodem_tpu_torch.ops.fused_score import RCP_WINDOW
from minimodem_tpu_torch.ops.tx_device import fma_f32_exact

LO, HI = RCP_WINDOW
CU = (Path(__file__).resolve().parents[1] / "minimodem_tpu_torch" / "csrc"
      / "fused_score.cu")


def _fma(a, b, c):
    return fma_f32_exact(*(torch.from_numpy(np.ascontiguousarray(v))
                           for v in (a, b, c))).numpy()


def step(a, b):
    """The kernel's div_rcp(a, b, RN(1 / b)), elementwise on float32."""
    a, b = np.float32(a), np.float32(b)
    with np.errstate(all="ignore"):
        y = np.float32(1.0) / b
        q = a * y
    q = np.asarray(q, np.float32)
    return _fma(_fma(-q, b, a), y, q)


def in_window(x):
    """csrc/fused_score.cu in_window: kRcpLo <= x <= kRcpHi."""
    x = np.asarray(x, np.float32)
    return (x >= np.float32(LO)) & (x <= np.float32(HI))


def count_takes_step(a):
    """div_count: the step for a / (bit count) where a is 0 or in the
    window."""
    return (np.asarray(a, np.float32) == 0) | in_window(a)


def taps_take_step(tsig, avg_mark, avg_space, n_mark, n_bits):
    """averages()'s `fast`: every |v| <= tsig <= kRcpHi, and each average
    that a tap divides by in the window."""
    tsig = np.asarray(tsig, np.float32)
    n_mark = np.asarray(n_mark)
    return ((tsig <= np.float32(HI)) & ((n_mark == 0) | in_window(avg_mark))
            & ((n_mark == n_bits) | in_window(avg_space)))


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


def _floats(rng, n, lo_exp, hi_exp):
    """n float32 values with a uniform exponent in [lo_exp, hi_exp) and a
    uniform significand."""
    e = rng.integers(lo_exp, hi_exp, n)
    m = rng.integers(1 << 23, 1 << 24, n)
    return np.ldexp(m.astype(np.float64), e - 23).astype(np.float32)


def _near_ties(rng, n_b, n_max=8):
    """Significand pairs (A, B) in [2^23, 2^24) whose quotient lies within
    |N| / (B 2^k) of a float32 rounding tie M / 2^k (M odd), N = A 2^k - B M
    for 0 < |N| <= n_max: k = 24 where A >= B, 25 where A < B.  Only these
    can round otherwise than a / b after the step's error (< 2^-22 ulp)."""
    b = rng.integers(1 << 22, 1 << 23, n_b).astype(np.uint64) * 2 + 1
    inv = b.copy()
    for _ in range(6):                      # B^-1 mod 2^64 by Newton
        inv = inv * (np.uint64(2) - b * inv)
    pairs = []
    for k in (24, 25):
        mask = np.uint64((1 << k) - 1)
        for n in [i for i in range(-n_max, n_max + 1) if i]:
            m0 = (np.uint64(-n % (1 << k)) * inv) & mask
            for m in (m0, m0 + np.uint64(1 << k)):
                ok = (m >= np.uint64(1 << 24)) & (m < np.uint64(1 << 25)) & (
                    (m & np.uint64(1)) == 1)
                tot = (b[ok] * m[ok]).astype(np.int64) + n
                a = tot >> k
                keep = ((a << k) == tot) & (a >= 1 << 23) & (a < 1 << 24)
                bb = b[ok][keep].astype(np.int64)
                a = a[keep]
                keep = (a >= bb) if k == 24 else (a < bb)
                pairs.append((a[keep], bb[keep]))
    a = np.concatenate([p[0] for p in pairs]).astype(np.float32)
    b = np.concatenate([p[1] for p in pairs]).astype(np.float32)
    return a, b


def test_window_is_the_kernels():
    """The bounds here (fused_score.RCP_WINDOW) are the kernel's kRcpLo and
    kRcpHi, and 2^-60 and 2^60."""
    src = CU.read_text()
    got = {name: float.fromhex(val[:-1]) for name, val in re.findall(
        r"constexpr float (kRcpLo|kRcpHi) = (0x[0-9a-fp+-]+f);", src)}
    assert got == {"kRcpLo": LO, "kRcpHi": HI}
    assert (LO, HI) == (2.0 ** -60, 2.0 ** 60)


def test_step_equals_division_for_tap_pairs():
    """A tap's pair: b an average in the window, a = ||v| - own| either 0 or
    in [b 2^-25, kRcpHi] (Sterbenz below 2 own, so nothing smaller but 0):
    a million seeded pairs and the window's corners, bit for bit."""
    rng = np.random.default_rng(22)
    n = 1 << 20
    b = _floats(rng, n, -60, 60)
    a = np.ldexp(_floats(rng, n, 0, 1), rng.integers(-25, 60, n)) * b
    a = np.minimum(a.astype(np.float32), np.float32(HI))
    a[rng.random(n) < 0.01] = 0.0
    corners_b = np.array([LO, np.nextafter(np.float32(LO), np.float32(1)),
                          HI, np.nextafter(np.float32(HI), np.float32(0)),
                          1.0, 3.0, 0.75], np.float32)
    ca = np.concatenate([np.float32([0.0, HI, np.nextafter(
        np.float32(HI), np.float32(0))]), corners_b * np.float32(2.0 ** -25),
        corners_b, corners_b * np.float32(3.0)])
    cb = np.repeat(corners_b[None], ca.size, 0).ravel()
    ca = np.repeat(ca, corners_b.size)
    keep = (ca == 0) | ((ca >= cb * np.float32(2.0 ** -25))
                        & (ca <= np.float32(HI)))
    a = np.concatenate([a, ca[keep]])
    b = np.concatenate([b, cb[keep]])
    assert in_window(b).all()
    np.testing.assert_array_equal(_bits(step(a, b)), _bits(a / b))


def test_step_equals_division_for_bit_counts():
    """A division by a bit count (the averages, dv, ampl): b in 1..32, a 0
    or in the window, a million seeded pairs and the edges."""
    rng = np.random.default_rng(23)
    n = 1 << 20
    b = rng.integers(1, 33, n).astype(np.float32)
    a = _floats(rng, n, -60, 60)
    a[rng.random(n) < 0.01] = 0.0
    edges = np.float32([0.0, LO, np.nextafter(np.float32(LO), np.float32(1)),
                        HI, np.nextafter(np.float32(HI), np.float32(0)),
                        1.0, 11.0, 33.0, 0.1])
    ea = np.repeat(edges, 32)
    eb = np.tile(np.arange(1, 33, dtype=np.float32), edges.size)
    a, b = np.concatenate([a, ea]), np.concatenate([b, eb])
    assert count_takes_step(a).all()
    np.testing.assert_array_equal(_bits(step(a, b)), _bits(a / b))


def test_step_equals_division_next_to_ties():
    """Quotients within 8 / (B 2^k) of a rounding tie, for 16384 seeded odd
    divisor significands, scaled to seeded exponents across the window:
    bit for bit.  q = RN(a y) alone misses about half of them."""
    rng = np.random.default_rng(24)
    a, b = _near_ties(rng, 16384)
    assert a.size > 50_000
    eb = rng.integers(-55, 55, a.size)
    ea = eb + rng.integers(-4, 5, a.size)
    a = np.ldexp(a.astype(np.float64), ea - 23).astype(np.float32)
    b = np.ldexp(b.astype(np.float64), eb - 23).astype(np.float32)
    assert in_window(b).all() and (a <= np.float32(HI)).all()
    want = _bits(a / b)
    np.testing.assert_array_equal(_bits(step(a, b)), want)
    one = _bits(a * (np.float32(1.0) / b))
    assert (one != want).mean() > 0.3


def test_guard_takes_the_division_outside_the_window():
    """Outside the window the guard takes the IEEE division: a divisor or
    numerator that is 0 where it is divided by, subnormal, below kRcpLo,
    above kRcpHi, inf or NaN, and a tsig above kRcpHi (a tap large enough
    for its quotient to overflow).  There the step can be wrong."""
    tiny = np.float32(1e-40)
    out = np.float32([0.0, tiny, LO / 2, np.nextafter(np.float32(LO),
                      np.float32(0)), np.nextafter(np.float32(HI),
                      np.float32(np.inf)), 2 * HI, np.inf, np.nan, -1.0])
    assert not in_window(out).any()
    assert not count_takes_step(out[1:]).any()
    assert count_takes_step(np.float32([0.0, LO, HI, 1.0])).all()
    one = np.float32(1.0)
    for own in out:
        # the average of a tap's bit out of the window: its offset falls back
        assert not taps_take_step(one, own, one, 5, 11)
        assert not taps_take_step(one, one, own, 5, 11)
        # unless no tap has that bit
        assert taps_take_step(one, own, one, 0, 11)
        assert taps_take_step(one, one, own, 11, 11)
    for tsig in (np.nextafter(np.float32(HI), np.float32(np.inf)), np.inf,
                 np.nan):
        assert not taps_take_step(tsig, one, one, 5, 11)
    assert taps_take_step(np.float32(HI), one, one, 5, 11)
    # what the guard keeps from the step: x / 0 (inf against NaN), a
    # subnormal divisor (y overflows), a quotient that underflows
    a = np.float32([1.0, 1.0, 2.0 ** -100])
    b = np.float32([0.0, 1e-40, 2.0 ** 40])
    with np.errstate(all="ignore"):
        assert (_bits(step(a, b)) != _bits(a / b)).any()


def test_k1_reg_offsets_by_frame_bits():
    """k1_reg_offsets counts every scored offset up to REG_BITS frame bits
    (Bell-202's 11 and RTTY's 8) and none above (a 20-bit frame)."""
    import dataclasses

    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.ops import fused_score
    from minimodem_tpu_torch.ops.device_rx import device_rx_key, geo_from_key

    def geo_of(mode):
        return geo_from_key(device_rx_key(FskModem(mode, device="cpu").cfg))

    assert fused_score.REG_BITS == 16
    for mode in ("1200", "rtty"):
        c = fused_score.launch_counts(geo_of(mode), 3, 5000, 1)
        assert c["k1_reg_offsets"] == c["k1_offsets"] == 15000
    geo = geo_of("1200")
    step_ = geo.bit_begin[1] - geo.bit_begin[0]
    wide = dataclasses.replace(
        geo, n_bits=20, bit_begin=tuple(range(0, 20 * step_, step_)),
        req_data=(-1,) * 20, req_sync=(-1,) * 20)
    assert fused_score.serves(wide)
    assert fused_score.launch_counts(wide, 3, 5000, 1)["k1_reg_offsets"] == 0


def test_k1_ab_variants_apply_to_the_kernel():
    """scripts/k1_ab.py's split variants change a copy of the kernel's
    source (every __fdiv_rn a multiply; stage 2 replaced by a store of the
    signal and noise words), its census reads the buckets' template
    arguments, and its CTAs an SM follow the register and shared-memory
    limits (Bell-202's 55 KB CTA: 4 an SM up to 64 registers, 3 above)."""
    from minimodem_tpu_torch.scripts import k1_ab

    src = CU.read_text()
    nodiv = k1_ab.VARIANTS["nodiv"](src)
    assert "__fdiv_rn(" in src and "__fdiv_rn(" not in nodiv
    stage1 = k1_ab.VARIANTS["stage1"](src)
    assert "stage2<" in src and "stage2<" not in stage1
    assert "variant: an offset's signal and noise words" in stage1
    assert stage1.count("{") == stage1.count("}")
    assert k1_ab._template_args(
        "_ZN1a18fused_score_kernelILi9ELi16ELi1ELb1EEEvPKfxiS2_") == [
            9, 16, 1, 1]
    assert k1_ab._template_args("_ZN1a18fused_score_kernelEPKf") == []
    assert k1_ab.ctas_per_sm(64, 54928, 144) == 4
    assert k1_ab.ctas_per_sm(72, 54928, 144) == 3
    assert k1_ab.ctas_per_sm(63, 159104, 144) == 1
