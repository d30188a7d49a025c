"""The receiver's protocol lines on standard error (minimodem's
src/minimodem.c:253-291 and 1336-1348) from an event stream, in C float32
arithmetic.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import numpy as np

from .modem import Geometry, f32_add, f32_div, f32_mul, round_half_up_i
from .statemachine import EV_CARRIER, EV_NOCARRIER


def _f32_sub(a, b):
    return np.float32(np.float32(a) - np.float32(b))


def carrier_line(g: Geometry, band_width: float) -> str:
    freq = float(f32_mul(g.b_mark, band_width))
    if float(g.data_rate) >= 100:
        return "### CARRIER %u @ %.1f Hz ###\n" % (
            round_half_up_i(g.data_rate), freq)
    return "### CARRIER %.2f @ %.1f Hz ###\n" % (float(g.data_rate), freq)


def nocarrier_line(g: Geometry, nframes: int, carrier_ns: int,
                   conf_total, ampl_total) -> str:
    nbits = f32_mul(nframes, g.frame_n_bits)
    bps = f32_div(f32_mul(nbits, g.sample_rate), carrier_ns)
    conf = float(f32_div(conf_total, nframes)) if nframes else float("nan")
    ampl = float(f32_div(ampl_total, nframes)) if nframes else float("nan")
    line = "\n### NOCARRIER ndata=%u confidence=%.3f ampl=%.3f bps=%.2f" % (
        nframes, conf, ampl, float(bps))
    lhs = int(np.trunc(f32_add(f32_mul(nbits, g.sample_rate), 0.5)))
    rhs = int(np.trunc(f32_mul(g.data_rate, carrier_ns)))
    if lhs == rhs:
        return line + " (rate perfect) ###\n"
    skew = f32_div(_f32_sub(bps, g.data_rate), g.data_rate)
    way = "slow" if math.copysign(1.0, float(skew)) < 0 else "fast"
    return line + " (%.1f%% %s) ###\n" % (abs(float(skew)) * 100.0, way)


def stderr_text(g: Geometry, band_width: float, ev_type, ev_pay,
                _bytes=None) -> str:
    out = []
    for et, pay in zip(ev_type, ev_pay):
        if et == EV_CARRIER:
            out.append(carrier_line(g, band_width))
        elif et == EV_NOCARRIER:
            out.append(nocarrier_line(
                g, int(pay[0]), int(pay[3]),
                np.uint32(pay[1]).view(np.float32),
                np.uint32(pay[2]).view(np.float32)))
    return "".join(out)
