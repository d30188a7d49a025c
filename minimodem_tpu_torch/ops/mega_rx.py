"""K2: the carrier state machine as one CUDA kernel ("megakernel").

Replaces minimodem_tpu/ops/pallas_rx.py::build_mega_rx, and serves as well
every geometry and mode the JAX package gives its XLA while_loop receiver
(minimodem_tpu/ops/device_rx.py::_build_device_rx).  Each stream's whole
receive loop runs inside the kernel over the score planes
(ops/device_rx.py make_score_packer_planes): the center-out coarse frame
search with early exit and strict-improvement ties (reference:
src/fsk.c:477-516), the fine rescan on acquisition or confidence drop,
the confidence and amplitude squelch, the 20-scan carrier drop, f32
tracking and stats in reference order, the event log, the carry in and
out, and the final NOCARRIER flush.  Its output modes:

  compact   the data byte decode (stop strip, bit window, MSB reversal,
            sync-byte suppression, reference: src/minimodem.c:1414-1443)
            and carrier-transition events carrying byte positions
  wide      one record per frame, [bits_lo, bits_hi, conf, ampl, fstart,
            pos or 0, EV_FRAME | ACQUIRED << 8], and NOCARRIER records of
            the stats (device_rx.py:779-802); frames of more than 32 bits
            take their high word from the bits_hi plane
  stop_on_overflow  (wide only) the stream stops at every no-confidence
            overflow, and the records carry the iteration's scan position
            in lane 5

The event and byte bounds are those of the JAX route that serves the
geometry (megakernel_route), so the two match event for event.

Carry format: [B, 8] int32 (pos, carrier, noconfidence, nframes,
carrier_nsamples, stop, 0, 0) + [B, 4] float32 (track_amplitude,
peak_confidence, conf_total, ampl_total) — the JAX megakernel's SMEM
carry (pallas_rx.py:1268-1301), so a JAX carry resumes here.

Outputs: ev [B, max_events, 8] int32 records (lanes 0-5 payload, 6 type),
n_ev [B], bytes [B, b_cap] uint8, n_by [B], and the carry out.  Byte
positions in event records restart at 0 each call.

`MegaRx.__call__` is the wrapper: CUDA planes launch csrc/mega_rx.cu (one
CTA per stream: a TMA-fed ring of score windows in shared memory, whose
geometry `ring_geometry` picks, or no ring where a scan window does not
fit, and a warp-parallel frame search, whose rule `find_frame_parallel`
states), CPU planes run `mega_rx_plain` (a per-stream Python loop with
numpy float32 stats), anything else raises.  Of the TPU kernel's latency
tricks the prefetched resident window is carried over as the ring;
speculative multi-frame decode, the fast-path probe and the byte-ring
blend are not.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import device as _device
from ..utils import trace as _trace
from .device_rx import (
    EV_CARRIER,
    EV_FLAG_ACQUIRED,
    EV_FRAME,
    EV_NOCARRIER,
    FSK_ANALYZE_NSTEPS,
    FSK_ANALYZE_NSTEPS_FINE,
    FSK_MAX_NOCONFIDENCE_BITS,
    U8_ENCODINGS,
    _collect,
    _round_up_pow2,
    _scan_order,
    device_rx_key,
    expand_wire,
    geo_from_key,
    make_score_packer_planes,
    plane_names,
    wire_dtype,
    wire_stager,
)
from .wirepack import parse_spec, unpack_expand

W_LANES = 128
# largest scan window the JAX megakernel serves (pallas_rx.py:93); the JAX
# package serves wider windows with its XLA receiver
W_FETCH_MAX = 16384
# candidate table width the kernel's parameter block holds: no geometry of
# the presets or of bell_like bauds at 8-96 kHz has more than 15
K_MAX = 16


def _static_geom(cfg_key):
    (sample_rate, data_rate_bits, n_data_bits, nstartbits, nstopbits_bits,
     b_mark, b_space, fftsize, nb, magscalar_bits, bit_begin, n_bits,
     req_data, req_sync, use_f64, frame_nsamples, overscan,
     expect_nsamples, msb_first, do_rx_sync, sync_byte) = cfg_key
    data_rate_f = np.uint32(data_rate_bits).view(np.float32)
    nspb = np.float32(np.float32(sample_rate) / data_rate_f)
    geom = {}
    for carrier in (0, 1):
        if carrier:
            try_max = int(np.trunc(np.float32(
                nspb * np.float32(0.75)) + np.float32(0.5))) + overscan
            try_first = overscan
        else:
            try_max = int(np.trunc(nspb)) + overscan
            try_first = 0
        coarse = max(try_max // FSK_ANALYZE_NSTEPS, 1)
        fine = max(try_max // FSK_ANALYZE_NSTEPS_FINE, 1)
        geom[carrier] = dict(
            try_max=try_max, coarse_step=coarse,
            coarse=_scan_order(try_first, try_max, coarse),
            fine=_scan_order(try_first, try_max, fine))
    return geom


def _mega_window(cfg_key):
    """w_fetch of the JAX megakernel for this geometry
    (pallas_rx.py:177)."""
    geom = _static_geom(cfg_key)
    w_scan = max(geom[0]["try_max"], geom[1]["try_max"])
    return ((w_scan + W_LANES - 1) // W_LANES + 1) * W_LANES


def megakernel_route(cfg_key) -> bool:
    """Whether the JAX package decodes this geometry with its megakernel
    (pallas_rx.py:1187-1200: <= 8 data bits, float32 scoring, a scan
    window of <= 16384 samples) rather than its XLA receiver.  K2 serves
    both routes; the route decides only the event and byte bounds, so
    that each matches its JAX counterpart event for event."""
    return (cfg_key[2] <= 8 and not geo_from_key(cfg_key).use_f64
            and _mega_window(cfg_key) <= W_FETCH_MAX)


@dataclass(frozen=True)
class MegaStatics:
    """Everything static the state machine depends on, for one geometry,
    one scored length and one output mode."""

    t_total: int
    expect_nsamples: int
    frame_nsamples: int
    overscan: int
    try_max: tuple
    coarse_step: tuple
    cand_c: tuple              # per carrier flag: tuple of offsets
    cand_f: tuple
    max_events: int
    b_cap: int
    rx_one: bool
    n_data_bits: int
    data_shift: int
    msb_first: bool
    sync_ok: bool
    sync_byte: int
    dual: bool
    bits_hi: bool              # a bits_hi plane (more than 32 frame bits)
    n_planes: int
    compact: bool              # bytes + transition events, else wide records
    stop_on_overflow: bool

    @classmethod
    def build(cls, cfg_key, t_total: int, rx_one: bool, compact: bool = True,
              stop_on_overflow: bool = False) -> "MegaStatics":
        """compact: frame bits become data bytes in the kernel and the
        event log holds the carrier transitions (<= 8 data bits); else
        every frame is a wide record of its raw bits.  stop_on_overflow:
        the stream stops at every no-confidence overflow (-a re-arms its
        carrier detection there)."""
        (sample_rate, data_rate_bits, n_data_bits, nstartbits,
         nstopbits_bits, b_mark, b_space, fftsize, nb, magscalar_bits,
         bit_begin, n_bits, req_data, req_sync, use_f64, frame_nsamples,
         overscan, expect_nsamples, msb_first, do_rx_sync,
         sync_byte) = cfg_key
        if compact and (n_data_bits > 8 or stop_on_overflow):
            raise ValueError("compact mode needs <= 8 data bits and no "
                             "stop_on_overflow (its records are wide)")
        geom = _static_geom(cfg_key)
        assert max(len(g[k]) for g in geom.values()
                   for k in ("coarse", "fine")) <= K_MAX
        nstop_shift = (0 if np.uint32(nstopbits_bits).view(np.float32) == 0
                       else 1)
        try_max = (geom[0]["try_max"], geom[1]["try_max"])
        if compact and megakernel_route(cfg_key):
            # the JAX megakernel's bounds (pallas_rx.py:276-293)
            frame_adv = max(1, frame_nsamples - overscan)
            drop_adv = max(1, (FSK_MAX_NOCONFIDENCE_BITS + 1) * min(try_max))
            max_events = 2 * (t_total // (frame_adv + drop_adv)) + 16
            b_cap = t_total // frame_adv + 17
        else:
            # the JAX XLA receiver's (device_rx.py:442-445), whose wide mode
            # spends one record on every frame; its byte log is as long
            min_advance = max(1, min(frame_nsamples - overscan, *try_max))
            max_events = ((t_total // min_advance + 16 + 7) // 8) * 8
            b_cap = max_events if compact else 0
        names = plane_names(geo_from_key(cfg_key))
        return cls(
            t_total=t_total,
            expect_nsamples=expect_nsamples,
            frame_nsamples=frame_nsamples,
            overscan=overscan,
            try_max=try_max,
            coarse_step=(geom[0]["coarse_step"], geom[1]["coarse_step"]),
            cand_c=(tuple(geom[0]["coarse"]), tuple(geom[1]["coarse"])),
            cand_f=(tuple(geom[0]["fine"]), tuple(geom[1]["fine"])),
            max_events=max_events,
            b_cap=b_cap,
            rx_one=bool(rx_one),
            n_data_bits=n_data_bits,
            data_shift=nstop_shift + nstartbits,
            msb_first=bool(msb_first),
            sync_ok=bool(do_rx_sync and 0 <= sync_byte < (1 << n_data_bits)),
            sync_byte=int(sync_byte),
            dual="conf_sync" in names,
            bits_hi="bits_hi" in names,
            n_planes=len(names),
            compact=bool(compact),
            stop_on_overflow=bool(stop_on_overflow),
        )


# ======================================================================
# the kernel's ring of score windows
# ======================================================================

RING_WINDOW = 1024            # G, samples per window (csrc/mega_rx.cu kG)
RING_MIN_STAGES = 4          # the least S, for short scan windows
SMEM_MAX = 232448             # dynamic shared memory a CTA may use on sm_90


def ring_smem_bytes(n_held: int, stages: int) -> int:
    """Shared memory of K2's CTA (csrc/mega_rx.cu smem_bytes): the ring
    [n_held][stages * G] words, a full and an empty mbarrier per stage,
    the four 32-lane candidate tables and the done flag."""
    return 4 * n_held * stages * RING_WINDOW + 16 * stages + 4 * 4 * 32 + 16


@dataclass(frozen=True)
class Ring:
    window: int        # G
    stages: int        # S; 0: no ring, the search reads global memory
    hold_all: bool     # every plane held, else the confidence plane(s) only
    n_held: int
    smem_bytes: int


def ring_geometry(st: MegaStatics) -> Ring:
    """G and S of K2's ring, and the planes it holds, from the geometry.

    A search at pos reads [pos, pos + w_scan); the next frame starts at
    most one advance later (a frame minus the overscan plus the offset
    found, or a scan window without carrier).  The rule:

        G * (S - 1) >= w_scan + max_advance

    so the producer can have the next frame's windows in flight while
    this frame decides.  The ring holds every plane when that fits in
    SMEM_MAX, else the confidence plane(s) only (cd, and cs in the dual
    layout).  Where not even those cover an advance (scan windows of
    thousands of samples) it takes the stages that fit, as long as they
    hold a scan window (G * (S - 1) >= w_scan): the search stays exact,
    only its prefetch is shorter than a frame.  Where they do not (scan
    windows of tens of thousands of samples, or dual planes at slow
    bauds) there is no ring: the warp reads its candidates straight from
    global memory.  The bits_hi plane is never held: the winner's high
    word is one global load."""
    n_all = 5 if st.dual else 3
    n_conf = 2 if st.dual else 1
    w_scan = max(st.try_max)
    adv = max(w_scan - 1 + st.frame_nsamples - st.overscan, w_scan)
    g = RING_WINDOW
    stages = max(-(-(w_scan + adv) // g) + 1, RING_MIN_STAGES)
    for n_held in (n_all, n_conf):
        if ring_smem_bytes(n_held, stages) <= SMEM_MAX:
            return Ring(g, stages, n_held == n_all, n_held,
                        ring_smem_bytes(n_held, stages))
    stages = (SMEM_MAX - ring_smem_bytes(n_conf, 0)) // (
        ring_smem_bytes(n_conf, 1) - ring_smem_bytes(n_conf, 0))
    if stages >= 2 and g * (stages - 1) >= w_scan:
        return Ring(g, stages, False, n_conf,
                    ring_smem_bytes(n_conf, stages))
    return Ring(g, 0, False, 0, ring_smem_bytes(0, 0))


# ======================================================================
# plain version
# ======================================================================

_F0 = np.float32(0.0)
_INF = np.float32(np.inf)


def _i32(v: int) -> int:
    """Wrap a Python int to int32, as the kernel's registers do."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _fbits(v) -> int:
    return int(np.float32(v).view(np.int32))


def _find_frame(conf, ampl, bits, t_scored, pos, cands, limit):
    """fsk_find_frame replay (reference: src/fsk.c:477-516): center-out
    candidates in table order, strict improvement from 0, stop at the
    first running best >= limit.  Reads at or past the scored length
    (and NaN confidences) never improve, like the zero-signal scores the
    JAX megakernel reads there.  Returns (conf, ampl, bits, t)."""
    best, bidx, bt = _F0, -1, 0
    for t in cands:
        if t < 0:                      # -1 ends a padded table
            break
        idx = pos + t
        if idx < 0 or idx >= t_scored:
            continue
        c = conf[idx]
        if best < c:
            best, bidx, bt = c, idx, t
            if best >= limit:
                break
    if bidx < 0:
        return _F0, _F0, 0, 0
    return best, ampl[bidx], int(bits[bidx]) & 0xFFFFFFFF, bt


def find_frame_parallel(conf, ampl, bits, t_scored, pos, cands, limit):
    """_find_frame as K2's warp computes it (csrc/mega_rx.cu search):
    lane k holds candidate k of a table of up to 32 offsets (-1 ends it)
    and its confidence cv (0 out of [0, t_scored)).  The winner is the
    first lane with cv >= limit and cv > 0; else the first lane of the
    largest cv > 0.  NaN never wins; with no cv > 0 there is no winner.
    One max-reduction over a 32-bit key decides both: a hit's key is
    0xff000000 | (31 - lane), above every positive float's bits (which
    order as unsigned integers, +inf 0x7f800000 the largest), a miss's
    key is cv's bits where cv > 0, else 0; then the first lane holding
    the top key (a ballot, then find-first-set).  Same returns as
    _find_frame."""
    lanes = np.full(32, -1, np.int64)
    lanes[:len(cands)] = cands
    idx = pos + lanes
    inb = (lanes >= 0) & (idx >= 0) & (idx < t_scored)
    cv = np.where(inb, np.asarray(conf, np.float32)[
        np.clip(idx, 0, max(t_scored - 1, 0))], _F0).astype(np.float32)
    with np.errstate(invalid="ignore"):
        pos_cv = cv > 0
        hit = pos_cv & (cv >= np.float32(limit))
    key = np.where(hit, np.uint32(0xFF000000) | (31 - np.arange(32)).astype(
        np.uint32), np.where(pos_cv, cv.view(np.uint32), np.uint32(0)))
    top = key.max()
    if top == 0:
        return _F0, _F0, 0, 0
    k = int(np.flatnonzero(key == top)[0])
    i = int(idx[k])
    return cv[k], ampl[i], int(bits[i]) & 0xFFFFFFFF, int(lanes[k])


def _decode_word(st: MegaStatics, blo: int):
    """Frame bits -> (data byte, keep flag) (minimodem.c:1414-1439)."""
    word = (blo >> st.data_shift) & ((1 << st.n_data_bits) - 1)
    if st.msb_first:
        rev = 0
        for k in range(st.n_data_bits):
            rev |= ((word >> k) & 1) << (st.n_data_bits - 1 - k)
        word = rev
    return word, not (st.sync_ok and word == st.sync_byte)


def _hi_word(bh, pos: int, t: int, c) -> int:
    """The high frame-bits word at a search's winner (found: c > 0), or 0
    (no bits_hi plane, or no winner), as an int32."""
    if bh is None or not c > 0:
        return 0
    return int(bh[pos + t])


def _run_stream(st: MegaStatics, finalize: bool, planes, total, thr, lim,
                ci, cf, ev, by):
    """One stream's state machine over numpy planes [P, T] int32.
    Writes ev [E, 8] / by [b_cap]; returns (n_ev, n_by, ci_out, cf_out,
    frame searches, candidate words read)."""
    t_scored = planes.shape[1]
    n_search = n_words = 0
    cd, ad = planes[0].view(np.float32), planes[1].view(np.float32)
    bl = planes[2]
    cs, as_ = ((planes[3].view(np.float32), planes[4].view(np.float32))
               if st.dual else (cd, ad))
    bh = planes[st.n_planes - 1] if st.bits_hi else None
    pos, carrier, noconf, nframes, carrier_ns, stop = (int(v) for v in ci[:6])
    track, peak, conf_tot, ampl_tot = (np.float32(v) for v in cf[:4])
    n_ev = n_by = 0
    q75, q25, two = np.float32(0.75), np.float32(0.25), np.float32(2.0)
    while (stop == 0 and pos + st.expect_nsamples <= total
           and n_ev < st.max_events - 2):
        cw = carrier
        conf_a, ampl_a = (cd, ad) if cw else (cs, as_)
        c, a, blo, fs = _find_frame(conf_a, ampl_a, bl, t_scored, pos,
                                    st.cand_c[cw], lim)
        bhi = _hi_word(bh, pos, fs, c)
        n_search += 1
        n_words += len(st.cand_c[cw]) + 2 + st.bits_hi
        refine = c < peak * q75
        if refine:
            peak = _F0
        if a < track * q25:
            c = _F0
        got = not (c <= thr)
        noconf = 0 if got else noconf + 1
        drop = not got and noconf > FSK_MAX_NOCONFIDENCE_BITS
        drop_report = drop and cw == 1
        acquired = got and cw == 0
        fs_coarse = fs
        if (got and (refine or acquired) and c < _INF
                and st.coarse_step[cw] > 1):
            # fine rescan: same window, data expect, no early exit
            c2, a2, blo2, fs2 = _find_frame(cd, ad, bl, t_scored, pos,
                                            st.cand_f[cw], _INF)
            n_words += len(st.cand_f[cw]) + 2 + st.bits_hi
            if c2 > c:
                # NB: confidence itself is not updated (minimodem.c:1383)
                a, blo, fs = a2, blo2, fs2
                bhi = _hi_word(bh, pos, fs, c2)
        if got:
            carrier_ns += st.frame_nsamples + (
                fs_coarse - st.overscan if cw else 0)
            track = (track + a) / two
            if peak < c:
                peak = c
            conf_tot = conf_tot + c
            ampl_tot = ampl_tot + a
            nframes += 1
            advance = fs + st.frame_nsamples - st.overscan
        else:
            advance = st.try_max[cw]
        if st.compact:
            if drop_report:
                ev[n_ev] = (_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                            _i32(carrier_ns), n_by, 0, EV_NOCARRIER, 0)
                n_ev += 1
            elif acquired:
                ev[n_ev] = (n_by, 0, 0, 0, 0, 0, EV_CARRIER, 0)
                n_ev += 1
        elif drop_report or got:
            # wide records (device_rx.py:779-802): a NOCARRIER's stats, or
            # the frame's raw bits with the ACQUIRED flag; lane 5 is this
            # iteration's scan position when the stream stops on overflow
            at = _i32(pos) if st.stop_on_overflow else 0
            if drop_report:
                ev[n_ev] = (_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                            _i32(carrier_ns), 0, at, EV_NOCARRIER, 0)
            else:
                ev[n_ev] = (_i32(blo), bhi, _fbits(c), _fbits(a), fs, at,
                            EV_FRAME | (EV_FLAG_ACQUIRED if acquired else 0),
                            0)
            n_ev += 1
        if got and st.compact:
            word, keep = _decode_word(st, blo)
            if keep:
                if n_by >= st.b_cap:
                    raise RuntimeError("byte log overflow")
                by[n_by] = word
                n_by += 1
        pos += advance
        carrier = 1 if got else (0 if drop else cw)
        if drop_report:
            track = conf_tot = ampl_tot = _F0
            nframes = carrier_ns = 0
            if st.rx_one:
                stop = 1
        if drop and st.stop_on_overflow:
            # -a re-arms carrier detection at every overflow, reported or
            # not (minimodem.c:1295-1297): the host retunes here
            stop = 1
    ci_out = (_i32(pos), carrier, noconf, _i32(nframes), _i32(carrier_ns),
              stop, 0, 0)
    cf_out = (track, peak, conf_tot, ampl_tot)
    if finalize and carrier:
        ev[n_ev] = (_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                    _i32(carrier_ns), n_by, 0, EV_NOCARRIER, 0)
        n_ev += 1
    return n_ev, n_by, ci_out, cf_out, n_search, n_words


def mega_rx_plain(st: MegaStatics, finalize: bool, planes, totals,
                  thr: tuple, carry_i, carry_f):
    """Plain version of K2 over numpy arrays: planes [B, P, T] int32,
    totals [B], carry [B, 8] int32 + [B, 4] float32.  Returns numpy
    (ev [B, E, 8] i32, n_ev [B], bytes [B, b_cap] u8, n_by [B],
    carry_i_out, carry_f_out).  The work of the last call, for the
    kernel's bounds: `searches` [B] frame searches (the length of each
    stream's chain of decisions) and `words` plane words the searches
    read (every candidate's confidence, the winner's ampl and bits)."""
    mega_rx_plain.calls += 1
    b = planes.shape[0]
    ev = np.zeros((b, st.max_events, 8), np.int32)
    by = np.zeros((b, st.b_cap), np.uint8)
    n_ev = np.zeros(b, np.int32)
    n_by = np.zeros(b, np.int32)
    ci_out = np.zeros((b, 8), np.int32)
    cf_out = np.zeros((b, 4), np.float32)
    thr_f, lim_f = np.float32(thr[0]), np.float32(thr[1])
    mega_rx_plain.searches = np.zeros(b, np.int64)
    mega_rx_plain.words = 0
    for i in range(b):
        (n_ev[i], n_by[i], ci_out[i], cf_out[i], mega_rx_plain.searches[i],
         words) = _run_stream(st, finalize, planes[i], int(totals[i]), thr_f,
                              lim_f, carry_i[i], carry_f[i], ev[i], by[i])
        mega_rx_plain.words += words
    return ev, n_ev, by, n_by, ci_out, cf_out


mega_rx_plain.calls = 0
mega_rx_plain.searches = np.zeros(0, np.int64)
mega_rx_plain.words = 0


# ======================================================================
# the wrapper
# ======================================================================

class MegaParams(ctypes.Structure):
    """Mirror of csrc/mega_rx.cu's MegaParams (passed by value)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "n_planes", "t_scored", "expect_nsamples", "frame_nsamples",
        "overscan", "try_max0", "try_max1", "coarse_step0", "coarse_step1",
        "max_events", "b_cap", "rx_one", "finalize", "n_data_bits",
        "data_shift", "msb_first", "sync_ok", "sync_byte", "dual",
        "hold_all", "window", "stages", "smem_bytes", "compact",
        "stop_on_overflow", "bits_hi")] + [
        ("conf_threshold", ctypes.c_float),
        ("conf_search_limit", ctypes.c_float),
        ("cand_c", (ctypes.c_int * K_MAX) * 2),
        ("cand_f", (ctypes.c_int * K_MAX) * 2),
    ]


class MegaRx:
    """K2 for one geometry and scored length."""

    launches = 0

    def __init__(self, st: MegaStatics):
        self.st = st
        self.ring = ring_geometry(st)

    def __call__(self, planes: torch.Tensor, totals: torch.Tensor,
                 thr: tuple, carry_i: torch.Tensor, carry_f: torch.Tensor,
                 finalize: bool):
        """planes [B, P, T] int32 -> (ev, n_ev, bytes, n_by, ci, cf)
        tensors on the planes' device."""
        dev = planes.device
        for t in (totals, carry_i, carry_f):
            if t.device != dev:
                raise ValueError("planes, totals and carry must share a "
                                 "device")
        if dev.type == "cpu":
            out = mega_rx_plain(self.st, finalize, planes.numpy(),
                                totals.numpy(), thr, carry_i.numpy(),
                                carry_f.numpy())
            return tuple(torch.from_numpy(a) for a in out)
        if dev.type != "cuda":
            raise ValueError(f"no megakernel for device {dev}")
        planes = planes.contiguous()
        n_planes = self.st.n_planes
        if (planes.dtype != torch.int32 or planes.dim() != 3
                or planes.shape[1] != n_planes or planes.shape[2] % 4
                or planes.data_ptr() % 16):
            # the ring's TMA copies move 16-byte aligned runs of words
            raise ValueError(
                f"expected 16-byte aligned int32 planes [B, {n_planes}, T] "
                f"with T % 4 == 0, got {tuple(planes.shape)} {planes.dtype}")
        return self._launch(planes, totals.to(torch.int32).contiguous(), thr,
                            carry_i.to(torch.int32).contiguous(),
                            carry_f.to(torch.float32).contiguous(), finalize)

    def _launch(self, planes, totals, thr, carry_i, carry_f, finalize):
        from . import _kernels

        st = self.st
        b, n_planes, t_scored = planes.shape
        dev = planes.device
        ev = torch.empty((b, st.max_events, 8), dtype=torch.int32,
                         device=dev)
        by = torch.empty((b, st.b_cap), dtype=torch.uint8, device=dev)
        n_ev = torch.empty(b, dtype=torch.int32, device=dev)
        n_by = torch.empty(b, dtype=torch.int32, device=dev)
        ci = torch.empty((b, 8), dtype=torch.int32, device=dev)
        cf = torch.empty((b, 4), dtype=torch.float32, device=dev)
        if b == 0:
            return ev, n_ev, by, n_by, ci, cf
        p = MegaParams(
            batch=b, n_planes=n_planes, t_scored=t_scored,
            expect_nsamples=st.expect_nsamples,
            frame_nsamples=st.frame_nsamples, overscan=st.overscan,
            try_max0=st.try_max[0], try_max1=st.try_max[1],
            coarse_step0=st.coarse_step[0], coarse_step1=st.coarse_step[1],
            max_events=st.max_events, b_cap=st.b_cap, rx_one=int(st.rx_one),
            finalize=int(finalize), n_data_bits=st.n_data_bits,
            data_shift=st.data_shift, msb_first=int(st.msb_first),
            sync_ok=int(st.sync_ok), sync_byte=st.sync_byte,
            dual=int(st.dual), hold_all=int(self.ring.hold_all),
            window=self.ring.window, stages=self.ring.stages,
            smem_bytes=self.ring.smem_bytes, compact=int(st.compact),
            stop_on_overflow=int(st.stop_on_overflow),
            bits_hi=int(st.bits_hi),
            conf_threshold=float(np.float32(thr[0])),
            conf_search_limit=float(np.float32(thr[1])))
        for row, (cc, ff) in enumerate(zip(st.cand_c, st.cand_f)):
            for k in range(K_MAX):
                p.cand_c[row][k] = cc[k] if k < len(cc) else -1
                p.cand_f[row][k] = ff[k] if k < len(ff) else -1
        lib = _kernels.load()
        err = lib.mm_mega_rx(
            ctypes.addressof(p), planes.data_ptr(), totals.data_ptr(),
            carry_i.data_ptr(), carry_f.data_ptr(), ev.data_ptr(),
            n_ev.data_ptr(), by.data_ptr(), n_by.data_ptr(), ci.data_ptr(),
            cf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(err, "mm_mega_rx")
        MegaRx.launches += 1
        return ev, n_ev, by, n_by, ci, cf


@functools.lru_cache(maxsize=32)
def mega_runner(cfg_key, t_total: int, rx_one: bool, input_dtype: str,
                finalize: bool = True, u8_extra: int = 0,
                compact: bool = True, stop_on_overflow: bool = False):
    """The packer + state machine program for one geometry, scored length,
    wire dtype and output mode (the counterpart of pallas_rx._mega_run_fn
    and device_rx._build_device_rx), for any batch and device.  Returns
    run(x [B, t_total + halo] (a dpack wire: [B, its row]), totals [B]
    i32, (thr, limit), carry_i, carry_f) -> (ev, n_ev, bytes, n_by,
    carry_i_out, carry_f_out) on x's device."""
    st = MegaStatics.build(cfg_key, t_total, rx_one, compact,
                           stop_on_overflow)
    u8 = input_dtype in U8_ENCODINGS
    # u8 and dpack wires expand to float32 and zero every position past
    # totals + u8_extra (real lookahead samples past a segment's scan
    # bound) before the packer
    dp = parse_spec(input_dtype)
    packer, _ = make_score_packer_planes(
        cfg_key, t_total, "float32" if u8 or dp else input_dtype)
    mega = MegaRx(st)
    n_x = t_total + geo_from_key(cfg_key).halo

    def run(x, totals, thr, carry_i, carry_f):
        if dp:
            x = unpack_expand(x, totals, *dp, n_x, u8_extra)
        elif u8:
            x = expand_wire(x, totals, input_dtype, u8_extra)
        return mega(packer(x), totals, thr, carry_i, carry_f, finalize)

    return run


class MegaReceiver:
    """Batched receiver on the score planes (K1, or make_score_packer) and
    K2: per-stream (ev_type, ev_pay, byte_stream) tuples in compact mode,
    (ev_type, ev_pay) with wide records, as the JAX receivers return
    them."""

    def __init__(self, cfg, precision: str = "auto", rx_one: bool = False,
                 device=_device.DEFAULT, compact: bool = True,
                 stop_on_overflow: bool = False):
        self.cfg = cfg
        self.key = device_rx_key(cfg, precision)
        self.rx_one = rx_one
        self.device = torch.device(device)
        self.compact = bool(compact)
        self.stop_on_overflow = bool(stop_on_overflow)

    @staticmethod
    def carry_to_arrays(carry, b):
        """Pack a CARRY_FIELDS dict into the kernel's carry arrays."""
        ci = np.zeros((b, 8), np.int32)
        cf = np.zeros((b, 4), np.float32)
        if carry is not None:
            ci[:, 0] = np.asarray(carry["pos"], np.int32)
            ci[:, 1] = np.asarray(carry["carrier"]).astype(np.int32)
            ci[:, 2] = np.asarray(carry["noconfidence"], np.int32)
            ci[:, 3] = np.asarray(carry["nframes"], np.int32)
            ci[:, 4] = np.asarray(carry["carrier_nsamples"], np.int32)
            ci[:, 5] = np.asarray(carry["stop"]).astype(np.int32)
            cf[:, 0] = np.asarray(carry["track_amplitude"], np.float32)
            cf[:, 1] = np.asarray(carry["peak_confidence"], np.float32)
            cf[:, 2] = np.asarray(carry["conf_total"], np.float32)
            cf[:, 3] = np.asarray(carry["ampl_total"], np.float32)
        return ci, cf

    @staticmethod
    def arrays_to_carry(ci, cf):
        ci = np.asarray(ci)
        cf = np.asarray(cf)
        return {
            "pos": ci[:, 0].copy(),
            "carrier": ci[:, 1] != 0,
            "noconfidence": ci[:, 2].copy(),
            "track_amplitude": cf[:, 0].copy(),
            "peak_confidence": cf[:, 1].copy(),
            "conf_total": cf[:, 2].copy(),
            "ampl_total": cf[:, 3].copy(),
            "nframes": ci[:, 3].copy(),
            "carrier_nsamples": ci[:, 4].copy(),
            "stop": ci[:, 5] != 0,
        }

    def run_events_batch(self, samples: np.ndarray, totals,
                         conf_threshold: float, conf_search_limit: float,
                         carry=None, finalize: bool = True,
                         in_encoding: str = None):
        dev = _device.require(self.device)
        b, L = samples.shape
        totals = np.asarray(totals, np.int32)
        t_total = _round_up_pow2(
            int(totals.max(initial=0)) + self.cfg.nsamples_overscan + 1)
        halo = geo_from_key(self.key).halo
        in_dtype = wire_dtype(samples, in_encoding)
        run = mega_runner(self.key, t_total, self.rx_one, in_dtype,
                          finalize, 0, self.compact, self.stop_on_overflow)
        # the four spans cover the call's work (utils/trace.py: recorded
        # only under torch.profiler).  The wire row: dpack rows pass
        # through at the caller's capacity, any other wire is t_total +
        # halo samples, silence past the samples
        row = L if parse_spec(in_dtype) else t_total + halo
        with _trace.span("rx.wire") as sp:
            # through the device's reused host chunks, their DMAs
            # overlapping the host's copy; the pads set on the device
            stager = wire_stager(dev)
            x_d, chunks = stager.wire(samples, row, in_encoding)
            sp.count(bytes=x_d.nbytes, chunks=chunks)
        with _trace.span("rx.upload") as sp:
            ci, cf = self.carry_to_arrays(carry, b)
            small = (totals, ci, cf)
            totals_d, ci_d, cf_d = (torch.from_numpy(a).to(dev)
                                    for a in small)
            stager.join(x_d)
            sp.count(bytes=sum(a.nbytes for a in small))
        with _trace.span("rx.enqueue"):
            out = run(x_d, totals_d, (conf_threshold, conf_search_limit),
                      ci_d, cf_d)
        with _trace.span("rx.collect"):
            events = _collect(out[:4], b, self.compact)
            carry_out = self.arrays_to_carry(out[4].cpu().numpy(),
                                             out[5].cpu().numpy())
        return events, carry_out
