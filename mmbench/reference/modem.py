"""The modem geometry a configuration file states, worked out in plain
NumPy with C float32 arithmetic (minimodem's src/minimodem.c:943-1131 and
src/fsk.c:33-66): bit windows, DFT bands, frame and scan lengths, and the
state machine's candidate tables and bounds.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F32_EPSILON = np.float32(np.finfo(np.float32).eps)
FSK_ANALYZE_NSTEPS = 3           # minimodem.c:1248
FSK_ANALYZE_NSTEPS_FINE = 8      # minimodem.c:1365
FSK_MAX_NOCONFIDENCE_BITS = 20   # minimodem.c:1290


def f32(x) -> np.float32:
    return np.float32(x)


def f32_add(a, b):
    return np.float32(np.float32(a) + np.float32(b))


def f32_mul(a, b):
    return np.float32(np.float32(a) * np.float32(b))


def f32_div(a, b):
    return np.float32(np.float32(a) / np.float32(b))


def trunc_i(x) -> int:
    return int(np.trunc(np.float32(x)))


def round_half_up_i(x) -> int:
    """C's (unsigned)(f + 0.5f), the add in float32."""
    return int(np.trunc(np.float32(np.float32(x) + np.float32(0.5))))


def expect_string(nstartbits: int, n_data_bits: int, nstopbits: float) -> str:
    """The frame pattern the demodulator scans (minimodem.c:442-487): the
    previous stop bit, start bits, don't-care data bits, the stop bit."""
    stop = f32(nstopbits) != f32(0.0)
    return (("1" if stop else "") + "0" * nstartbits + "d" * n_data_bits
            + ("1" if stop else ""))


def scan_order(try_first: int, try_max: int, try_step: int) -> list:
    """fsk_find_frame's center-out candidate order (src/fsk.c:477-502)."""
    out, j = [], 0
    while True:
        up = 1 if (j % 2) else -1
        t = try_first + up * ((j + 1) // 2) * try_step
        j += 1
        if t >= try_max:
            break
        if t < 0:
            continue
        out.append(t)
        if j > 8192:
            break
    return out


def round_up_bucket(n: int, floor: int = 1 << 14) -> int:
    """The scored length the receiver pads a stream to: powers of two up
    to 2^18, then multiples of 2^18."""
    v = floor
    while v < n and v < (1 << 18):
        v *= 2
    if v < n:
        v = ((n + (1 << 18) - 1) >> 18) << 18
    return v


def sched_pad(n_bits: int) -> int:
    """The width the loopback pads a bit schedule to (pad bits are space
    tone): powers of two from 512 to 4096, then multiples of 4096."""
    v = 512
    while v < n_bits and v < 4096:
        v *= 2
    if v < n_bits:
        v = ((n_bits + 4095) // 4096) * 4096
    return v


@dataclass(frozen=True)
class Geometry:
    sample_rate: int
    data_rate: np.float32
    n_data_bits: int
    nstartbits: int
    nstopbits: np.float32
    mark_f: np.float32
    space_f: np.float32
    frame_n_bits: int
    bit_nsamples_tx: int
    nsamples_per_bit: np.float32
    frame_nsamples: int
    overscan: int
    expect_nsamples: int
    nb: int
    bit_begin: tuple
    n_bits: int
    req: tuple                   # per frame bit: -1 don't care, else 0 / 1
    fftsize: int
    b_mark: int
    b_space: int
    magscalar: np.float32

    @property
    def max_begin(self) -> int:
        return self.bit_begin[-1]

    @property
    def halo(self) -> int:
        return self.max_begin + self.nb

    @property
    def n_planes(self) -> int:
        """conf, ampl, bits_lo, and bits_hi past 32 frame bits (data and
        sync expectations are one here: no sync byte)."""
        return 4 if self.n_bits > 32 else 3


def geometry(cfg: dict) -> Geometry:
    """The geometry of a configuration file's `modem` block."""
    m = cfg["modem"]
    rate = int(m["sample_rate"])
    data_rate = f32(m["data_rate"])
    nd, nstart = int(m["n_data_bits"]), int(m["nstartbits"])
    nstop = f32(m["nstopbits"])
    band_width = f32(m["band_width"])
    expect = m.get("expect_data_string") or expect_string(nstart, nd, nstop)
    n_bits = len(expect)
    fnb = trunc_i(f32_add(nd + nstart, nstop))
    nspb = f32_div(rate, data_rate)
    expect_ns = trunc_i(f32_mul(nspb, n_bits))
    spb_scan = f32_div(expect_ns, n_bits)
    half_bw = f32_div(band_width, 2.0)
    nb = round_half_up_i(spb_scan)
    return Geometry(
        sample_rate=rate, data_rate=data_rate, n_data_bits=nd,
        nstartbits=nstart, nstopbits=nstop, mark_f=f32(m["mark_f"]),
        space_f=f32(m["space_f"]), frame_n_bits=fnb,
        bit_nsamples_tx=trunc_i(f32_add(f32_div(rate, data_rate), 0.5)),
        nsamples_per_bit=nspb,
        frame_nsamples=round_half_up_i(f32_mul(nspb, fnb)),
        overscan=max(1, round_half_up_i(f32_mul(nspb, 0.5))),
        expect_nsamples=expect_ns, nb=nb,
        bit_begin=tuple(round_half_up_i(f32_mul(spb_scan, b))
                        for b in range(n_bits)),
        n_bits=n_bits,
        req=tuple(-1 if c == "d" else int(c) for c in expect),
        fftsize=trunc_i(f32_div(f32_add(rate, half_bw), band_width)),
        b_mark=trunc_i(f32_div(f32_add(m["mark_f"], half_bw), band_width)),
        b_space=trunc_i(f32_div(f32_add(m["space_f"], half_bw), band_width)),
        magscalar=f32_div(2.0, nb))


@dataclass(frozen=True)
class Statics:
    """The state machine's tables and bounds for one scored length."""

    t_total: int
    try_max: tuple
    coarse_step: tuple
    cand_c: tuple
    cand_f: tuple
    max_events: int
    b_cap: int
    compact: bool
    data_shift: int


def statics(g: Geometry, t_total: int, compact: bool) -> Statics:
    """Candidate tables per carrier state (src/fsk.c:449-538 with
    minimodem.c:1248,1365) and the event and byte bounds of the
    receiver's route: the short-window route for <= 8 data bits and a scan
    window of <= 16384 samples, else one record per frame."""
    nspb = np.float32(np.float32(g.sample_rate) / g.data_rate)
    geom = {}
    for carrier in (0, 1):
        if carrier:
            try_max = int(np.trunc(np.float32(
                nspb * np.float32(0.75)) + np.float32(0.5))) + g.overscan
            first = g.overscan
        else:
            try_max = int(np.trunc(nspb)) + g.overscan
            first = 0
        coarse = max(try_max // FSK_ANALYZE_NSTEPS, 1)
        fine = max(try_max // FSK_ANALYZE_NSTEPS_FINE, 1)
        geom[carrier] = (try_max, coarse, tuple(scan_order(first, try_max,
                                                           coarse)),
                         tuple(scan_order(first, try_max, fine)))
    try_max = (geom[0][0], geom[1][0])
    w_scan = max(try_max)
    window = ((w_scan + 127) // 128 + 1) * 128
    short_route = g.n_data_bits <= 8 and window <= 16384
    if compact and short_route:
        frame_adv = max(1, g.frame_nsamples - g.overscan)
        drop_adv = max(1, (FSK_MAX_NOCONFIDENCE_BITS + 1) * min(try_max))
        max_events = 2 * (t_total // (frame_adv + drop_adv)) + 16
        b_cap = t_total // frame_adv + 17
    else:
        min_adv = max(1, min(g.frame_nsamples - g.overscan, *try_max))
        max_events = ((t_total // min_adv + 16 + 7) // 8) * 8
        b_cap = max_events if compact else 0
    nstop_shift = 0 if float(g.nstopbits) == 0.0 else 1
    return Statics(t_total, try_max, (geom[0][1], geom[1][1]),
                   (geom[0][2], geom[1][2]), (geom[0][3], geom[1][3]),
                   max_events, b_cap, compact, nstop_shift + g.nstartbits)
