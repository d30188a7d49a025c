"""The carrier state machine in plain Python and NumPy: minimodem's
receive loop (src/minimodem.c:1137-1463, src/fsk.c:449-538) over the score
planes, one stream at a time.

Outputs the receiver's two record forms:

  compact  data bytes (stop strip, bit window, MSB reversal) and the
           carrier transitions, the NOCARRIER record carrying the stats
           (frames, confidence and amplitude totals as float32 bits,
           carrier samples) and byte positions
  wide     one record per frame: bits_lo, bits_hi, conf, ampl, frame
           start, then NOCARRIER records of the stats

`events()` turns the records into the host's event stream (ev_type [M]
int32, ev_pay [M, 6] uint32), a CARRIER event before each acquiring
frame.

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.
"""

from __future__ import annotations

import numpy as np

from .modem import FSK_MAX_NOCONFIDENCE_BITS, Geometry, Statics

EV_FRAME, EV_CARRIER, EV_NOCARRIER = 0, 1, 2
EV_FLAG_ACQUIRED = 1 << 8
_F0 = np.float32(0.0)
_INF = np.float32(np.inf)


def _i32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _fbits(v) -> int:
    return int(np.float32(v).view(np.int32))


def _find_frame(conf, ampl, bits, t_scored, pos, cands, limit):
    """Center-out candidates in table order, strict improvement from 0,
    stop at the first running best >= limit (src/fsk.c:477-516)."""
    best, bidx, bt = _F0, -1, 0
    for t in cands:
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


def run_stream(g: Geometry, st: Statics, planes: np.ndarray, total: int,
               thr: float, lim: float):
    """One stream from a fresh state to its final flush.  planes
    [P, T] int32 -> (records [n, 8] int32, data bytes uint8)."""
    t_scored = planes.shape[1]
    cd, ad, bl = planes[0].view(np.float32), planes[1].view(np.float32), \
        planes[2]
    bh = planes[3] if g.n_planes > 3 else None
    thr, lim = np.float32(thr), np.float32(lim)
    pos = carrier = noconf = nframes = carrier_ns = 0
    track = peak = conf_tot = ampl_tot = _F0
    ev, by = [], []
    q75, q25, two = np.float32(0.75), np.float32(0.25), np.float32(2.0)
    n_mask = (1 << g.n_data_bits) - 1

    def hi(p, t, c):
        return 0 if bh is None or not c > 0 else int(bh[p + t])

    while pos + g.expect_nsamples <= total and len(ev) < st.max_events - 2:
        cw = carrier
        c, a, blo, fs = _find_frame(cd, ad, bl, t_scored, pos,
                                    st.cand_c[cw], lim)
        bhi = hi(pos, fs, c)
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
            # fine rescan, no early exit; the confidence stays the coarse
            # one (minimodem.c:1383)
            c2, a2, blo2, fs2 = _find_frame(cd, ad, bl, t_scored, pos,
                                            st.cand_f[cw], _INF)
            if c2 > c:
                a, blo, fs = a2, blo2, fs2
                bhi = hi(pos, fs, c2)
        if got:
            carrier_ns += g.frame_nsamples + (fs_coarse - g.overscan
                                              if cw else 0)
            track = (track + a) / two
            if peak < c:
                peak = c
            conf_tot = conf_tot + c
            ampl_tot = ampl_tot + a
            nframes += 1
            advance = fs + g.frame_nsamples - g.overscan
        else:
            advance = st.try_max[cw]
        stats = (_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                 _i32(carrier_ns))
        if st.compact:
            if drop_report:
                ev.append((*stats, len(by), 0, EV_NOCARRIER, 0))
            elif acquired:
                ev.append((len(by), 0, 0, 0, 0, 0, EV_CARRIER, 0))
            if got:
                word = (blo >> st.data_shift) & n_mask
                by.append(word)
        elif drop_report:
            ev.append((*stats, 0, 0, EV_NOCARRIER, 0))
        elif got:
            ev.append((_i32(blo), bhi, _fbits(c), _fbits(a), fs, 0,
                       EV_FRAME | (EV_FLAG_ACQUIRED if acquired else 0), 0))
        pos += advance
        carrier = 1 if got else (0 if drop else cw)
        if drop_report:
            track = conf_tot = ampl_tot = _F0
            nframes = carrier_ns = 0
    if carrier:
        ev.append((_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                   _i32(carrier_ns), len(by), 0, EV_NOCARRIER, 0))
    return (np.asarray(ev, np.int64).astype(np.int32).reshape(-1, 8),
            np.asarray(by, np.uint8))


def events(records: np.ndarray):
    """Records [n, 8] int32 -> (ev_type [M] int32, ev_pay [M, 6] uint32),
    each ACQUIRED-flagged frame preceded by a CARRIER event."""
    rec = records.view(np.uint32)
    types, pays = [], []
    for r in rec:
        if int(r[6]) & EV_FLAG_ACQUIRED:
            types.append(EV_CARRIER)
            pays.append([0] * 6)
        types.append(int(r[6]) & 0xFF)
        pays.append([int(v) for v in r[:6]])
    return (np.asarray(types, np.int32),
            np.asarray(pays, np.uint32).reshape(-1, 6))
