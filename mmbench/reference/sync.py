"""NOAA SAME on the loopback in plain NumPy and PyTorch: the sync
expectation, the dual score planes, the carrier state machine that
acquires on the sync byte and drops it, and the alert feeds the benchmark
keys (minimodem's src/minimodem.c:114-250 on the transmit side,
:1137-1463 on the receive side; the EAS protocol, 47 CFR 11.31).

A configuration with a sync byte (`do_rx_sync`, `sync_byte`) whose frame
pattern differs from the data one scores every offset twice: against the
data expectation and against the sync byte's bits.  The planes are then
five: conf_data, ampl_data, bits_lo, conf_sync, ampl_sync.  Without
carrier the state machine searches the sync pair, so a stream acquires
only on a sync byte; with carrier it searches the data pair, and every
decoded word equal to the sync byte is dropped (minimodem.c:1414-1443).

Departures from src/minimodem.c, as in reference/statemachine.py: one
stream is decoded from a fresh state to its final flush in one call, the
protocol lines are events (`statemachine.events`), and the byte log keeps
the data bytes a codec would be given.  The keyed feed departs from the
air in one way: the 1 s pauses between an alert's transmissions are mark
carrier, as `minimodem --tx --tx-carrier` keys idle input
(minimodem.c:169-237), not silence; after every pause the 0xAB preamble is
keyed again (minimodem.c:230-237).

Part of the benchmark's frozen plain reference: it imports nothing of the
program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import score
from .modem import FSK_MAX_NOCONFIDENCE_BITS, Geometry, Statics
from .statemachine import (EV_CARRIER, EV_NOCARRIER, _F0, _INF, _fbits,
                           _find_frame, _i32)

# the EAS header's fields (47 CFR 11.31(c)): originators, a fixed list of
# event codes, purge times (15 min steps to an hour, then 30 min steps)
ORIGINATORS = ("WXR", "EAS", "CIV", "PEP")
EVENTS = ("TOR", "SVR", "FFW", "FLW", "WSW", "BZW", "HUW", "TSW", "EVI",
          "CEM", "SPW", "FRW", "RWT", "RMT", "NPT", "DMO")
PURGE = ("0015", "0030", "0045") + tuple(
    f"{h:02d}{m:02d}" for h in range(1, 7) for m in (0, 30))[:-1]
EOM = b"NNNN"


def sync_expectation(g: Geometry, sync_byte: int) -> tuple:
    """The frame pattern of the sync byte: the data pattern with its data
    bits set to the sync byte's, LSB first (a preamble frame is always
    LSB first, minimodem.c:216-221 and :442-487)."""
    bits = iter((sync_byte >> k) & 1 for k in range(g.n_data_bits))
    return tuple(next(bits) if r < 0 else r for r in g.req)


def planes(x: torch.Tensor, g: Geometry, sync: tuple, t_len: int,
           precision: str = "float32") -> torch.Tensor:
    """x [B, >= t_len + halo] float32 -> the dual planes [B, 5, t_len]
    int32: conf_data, ampl_data, bits_lo, then conf_sync, ampl_sync, the
    frame channels of the same correlation scored against `sync` as the
    data ones are against g.req."""
    b = torch.from_numpy(score.basis(g)).to(x.device)
    x = x[:, :t_len + g.halo]
    if precision == "tf32":
        x, b = score.to_tf32(x), score.to_tf32(b)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    corr = score.correlate(x, b, t_len + g.max_begin)
    data = score.channels(corr, g, t_len)
    syn = score.channels(corr, dataclasses.replace(g, req=sync), t_len)
    return torch.stack(data[:3] + syn[:2], dim=1)


def run_stream(g: Geometry, st: Statics, planes: np.ndarray, total: int,
               thr: float, lim: float, sync_byte: int):
    """One stream over the dual planes [5, T] int32, compact records:
    -> (records [n, 8] int32, data bytes uint8), as
    statemachine.run_stream gives them.  Without carrier the coarse search
    reads the sync pair; the fine rescan, run with carrier just set
    (minimodem.c:1357-1389), reads the data pair."""
    assert st.compact and g.n_bits <= 32
    t_scored = planes.shape[1]
    cd, ad, bl = planes[0].view(np.float32), planes[1].view(np.float32), \
        planes[2]
    cs, as_ = planes[3].view(np.float32), planes[4].view(np.float32)
    thr, lim = np.float32(thr), np.float32(lim)
    pos = carrier = noconf = nframes = carrier_ns = 0
    track = peak = conf_tot = ampl_tot = _F0
    ev, by = [], []
    q75, q25, two = np.float32(0.75), np.float32(0.25), np.float32(2.0)
    n_mask = (1 << g.n_data_bits) - 1

    while pos + g.expect_nsamples <= total and len(ev) < st.max_events - 2:
        cw = carrier
        conf, ampl = (cd, ad) if cw else (cs, as_)
        c, a, blo, fs = _find_frame(conf, ampl, bl, t_scored, pos,
                                    st.cand_c[cw], lim)
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
            c2, a2, blo2, fs2 = _find_frame(cd, ad, bl, t_scored, pos,
                                            st.cand_f[cw], _INF)
            if c2 > c:
                a, blo, fs = a2, blo2, fs2
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
        if drop_report:
            ev.append((_i32(nframes), _fbits(conf_tot), _fbits(ampl_tot),
                       _i32(carrier_ns), len(by), 0, EV_NOCARRIER, 0))
        elif acquired:
            ev.append((len(by), 0, 0, 0, 0, 0, EV_CARRIER, 0))
        if got:
            word = (blo >> st.data_shift) & n_mask
            if word != sync_byte:
                by.append(word)
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


# ----------------------------------------------------------------------
# SAME's alert feeds
# ----------------------------------------------------------------------

def header_bytes(locations: int) -> int:
    """Bytes of an EAS header with `locations` location codes."""
    return 35 + 7 * locations


def headers(rng: np.random.Generator, n: int, locations: int) -> np.ndarray:
    """n seeded EAS headers `ZCZC-ORG-EEE-PSSCCC(-PSSCCC...)+TTTT-JJJHHMM-
    LLLLLLLL-` (47 CFR 11.31(c)) -> [n, header_bytes(locations)] uint8."""
    org = rng.integers(0, len(ORIGINATORS), n)
    eee = rng.integers(0, len(EVENTS), n)
    loc = rng.integers(0, 10, (n, locations, 6))
    purge = rng.integers(0, len(PURGE), n)
    day = rng.integers(1, 367, n)
    hour = rng.integers(0, 24, n)
    minute = rng.integers(0, 60, n)
    station = rng.integers(0, 26, (n, 8))
    out = []
    for i in range(n):
        codes = "-".join("".join(map(str, c)) for c in loc[i])
        sid = "".join(chr(65 + int(c)) for c in station[i])
        out.append(f"ZCZC-{ORIGINATORS[org[i]]}-{EVENTS[eee[i]]}-{codes}"
                   f"+{PURGE[purge[i]]}-{day[i]:03d}{hour[i]:02d}"
                   f"{minute[i]:02d}-{sid}-")
    return np.frombuffer("".join(out).encode("ascii"), np.uint8).reshape(
        n, -1)


def _transmissions(payloads: np.ndarray, t: dict, sync_byte: int):
    """payloads [..., n] uint8, each sent `repeats` times as the preamble,
    its bytes LSB first 8-N-0 and the idle mark bits -> bits [...,
    repeats * (8 * (preamble + n) + idle)] uint8."""
    shape = payloads.shape[:-1]
    pre = np.full(shape + (t["preamble_bytes"],), sync_byte, np.uint8)
    frame = np.unpackbits(np.concatenate([pre, payloads], axis=-1),
                          axis=-1, bitorder="little")
    one = np.concatenate([frame, np.ones(shape + (t["idle_bits"],),
                                         np.uint8)], axis=-1)
    return np.concatenate([one] * t["repeats"], axis=-1)


def alert_schedules(head: np.ndarray, t: dict, sync_byte: int) -> np.ndarray:
    """Headers [B, alerts, H] uint8 -> the streams' bit schedules [B, L]
    uint8 (1 = mark): `leader_bits`, then per alert its header's and then
    the EOM's transmissions, then `trailer_bits`."""
    b, alerts, _ = head.shape
    eom = np.broadcast_to(np.frombuffer(EOM, np.uint8), (b, alerts, len(EOM)))
    per_alert = np.concatenate([_transmissions(head, t, sync_byte),
                                _transmissions(eom, t, sync_byte)], axis=-1)
    return np.concatenate([np.ones((b, t["leader_bits"]), np.uint8),
                           per_alert.reshape(b, -1),
                           np.ones((b, t["trailer_bits"]), np.uint8)],
                          axis=1)


def schedule_bits(t: dict) -> int:
    """Bits of one stream's schedule (alert_schedules)."""
    tx = 8 * (2 * t["preamble_bytes"] + header_bytes(t["locations"])
              + len(EOM)) + 2 * t["idle_bits"]
    return (t["leader_bits"] + t["alerts_per_stream"] * t["repeats"] * tx
            + t["trailer_bits"])
