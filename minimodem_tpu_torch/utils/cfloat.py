"""C-float32 arithmetic helpers.

The reference modem (kamalmostafa/minimodem) derives every geometry quantity
(samples per bit, FFT sizes, band indices, bit-window offsets, ...) with C
``float`` arithmetic followed by integer truncation.  Those integer results
feed framing decisions, so the TPU build must reproduce them *exactly* —
a one-sample difference in a bit-window offset changes which samples a DFT
sees and therefore (potentially) which bytes come out.

Every helper here mirrors a specific C idiom:

- ``f32(x)``               — C ``(float)x`` cast / float literal.
- ``f32_div / f32_mul ...``— C single-precision binary op (one rounding).
- ``trunc_i(x)``           — C ``(int)f`` / ``(unsigned)f`` truncation.
- ``round_half_up_i(x)``   — the reference's pervasive ``(unsigned)(f + 0.5f)``.
- ``lroundf(x)``           — C ``lroundf`` (round half away from zero).

All of this runs on host (NumPy scalars); it is config-derivation code, not
the compute path.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "F32_EPSILON",
    "f32",
    "f32_add",
    "f32_sub",
    "f32_mul",
    "f32_div",
    "f32_fmod1",
    "trunc_i",
    "round_half_up_i",
    "lroundf",
    "lroundf_arr",
]

# FLT_EPSILON from <float.h>; the demodulator's noise gate
# (reference: src/fsk.c:279).
F32_EPSILON = np.float32(np.finfo(np.float32).eps)


def f32(x) -> np.float32:
    """C ``(float)`` cast — round ``x`` to the nearest binary32."""
    return np.float32(x)


def f32_add(a, b) -> np.float32:
    return np.float32(np.float32(a) + np.float32(b))


def f32_sub(a, b) -> np.float32:
    return np.float32(np.float32(a) - np.float32(b))


def f32_mul(a, b) -> np.float32:
    return np.float32(np.float32(a) * np.float32(b))


def f32_div(a, b) -> np.float32:
    return np.float32(np.float32(a) / np.float32(b))


def f32_fmod1(x) -> np.float32:
    """C ``fmodf(x, 1.0f)`` — used for tone-generator phase wrap
    (reference: src/simple-tone-generator.c:163)."""
    return np.float32(np.fmod(np.float32(x), np.float32(1.0)))


def trunc_i(x) -> int:
    """C float→integer conversion: truncation toward zero."""
    return int(np.trunc(np.float32(x)))


def round_half_up_i(x) -> int:
    """The reference's ``(unsigned int)(f + 0.5f)`` idiom.

    The addition itself is performed in float32 (single rounding) before
    truncation, exactly as C does it.
    """
    return int(np.trunc(np.float32(np.float32(x) + np.float32(0.5))))


def lroundf(x) -> int:
    """C ``lroundf`` — round to nearest, halfway away from zero."""
    xf = float(np.float32(x))
    return int(math.floor(xf + 0.5)) if xf >= 0 else int(math.ceil(xf - 0.5))


def lroundf_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized ``lroundf`` over a float32 array."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)
