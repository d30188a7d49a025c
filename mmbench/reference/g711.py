"""G.711 u-law expansion (ITU-T G.711, the 8-bit telephony wire) to
float32 samples in [-1, 1): the 14-bit linear value over 32768.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.
"""

from __future__ import annotations

import numpy as np


def ulaw_expand(code: np.ndarray) -> np.ndarray:
    u = ~np.asarray(code).astype(np.int32) & 0xFF
    t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
    v = np.where(u & 0x80, 0x84 - t, t - 0x84)
    return v.astype(np.float32) / np.float32(32768.0)
