"""Receiver: the device engine's event rendering and the host engines.

Counterpart of minimodem_tpu/rx/engine.py.  Three engines:

- "device" (and "auto"): the state machine runs on the device
  (ops/mega_rx.py); this module renders its event stream.  With carrier
  autodetect (-a) the detection scans run here and each detected burst
  decodes on the device with the retuned geometry, on a file or on a
  live feed (run_live_autodetect).
- "host": chunked scoring (ops/demod.py DemodScorer, the stage-1 kernel
  on CUDA) and a Python replay of the reference's sequential receive loop
  (reference: src/minimodem.c:1137-1463) over the score arrays, including
  carrier autodetect (-a, reference: :1179-1220).
- "host-native": every chunk scored in batched calls, then the C++ state
  machine (native/hostrx.cpp) over the whole stream.

Stdout carries decoded bytes, stderr the reference's CARRIER / NOCARRIER
protocol lines (reference: src/minimodem.c:253-291, 1336-1348,
1414-1459).
"""

from __future__ import annotations

import copy
import ctypes
import math
import sys
from typing import Callable, Dict, Tuple

import numpy as np

from ..codecs import bit_reverse, bit_window
from ..config import ModemConfig, RxOptions
from ..ops.demod import DemodScorer
from ..utils import device as _device
from ..utils.cfloat import (
    f32,
    f32_add,
    f32_div,
    f32_mul,
    f32_sub,
    round_half_up_i,
    trunc_i,
)

INFINITY = math.inf

FSK_ANALYZE_NSTEPS = 3          # reference: src/minimodem.c:1248
FSK_ANALYZE_NSTEPS_FINE = 8     # reference: src/minimodem.c:1365
FSK_MAX_NOCONFIDENCE_BITS = 20  # reference: src/minimodem.c:1290


class ScoreProvider:
    """Chunked, cached access to per-offset demod scores at absolute
    stream positions.  Owns the sample array; retunes (carrier autodetect)
    swap the scorer.  Each chunk is scored on `device` and its six
    channels come to the host on its first query."""

    def __init__(self, samples: np.ndarray, cfg: ModemConfig,
                 precision: str = "auto", chunk_len: int = 1 << 17,
                 device=_device.DEFAULT):
        self.samples = np.ascontiguousarray(samples, dtype=np.float32)
        self.cfg = cfg
        self.precision = precision
        self.requested_chunk_len = chunk_len
        self.device = device
        self._scorers: Dict[Tuple[int, int], DemodScorer] = {}
        self._cache: Dict[Tuple[int, int, int], dict] = {}
        self._current_bands = (cfg.b_mark, cfg.b_space)

    def set_tones(self, b_mark: int, b_space: int) -> None:
        self._current_bands = (b_mark, b_space)

    def _scorer(self) -> DemodScorer:
        key = self._current_bands
        sc = self._scorers.get(key)
        if sc is None:
            cfg = self.cfg
            if key != (cfg.b_mark, cfg.b_space):
                cfg = copy.copy(cfg)
                cfg.set_tones_by_bandshift(key[0], key[1] - key[0])
            sc = DemodScorer(cfg, self.precision, self.requested_chunk_len,
                             self.device)
            self._scorers[key] = sc
        return sc

    def _chunk(self, abs_t: int) -> Tuple[dict, int]:
        sc = self._scorer()
        t_len = sc.chunk_len
        idx = abs_t // t_len
        key = (*self._current_bands, idx)
        out = self._cache.get(key)
        if out is None:
            c0 = idx * t_len
            out = sc.score(self.samples[c0:c0 + t_len + sc.geo.halo])
            # keep only a couple of chunks around
            if len(self._cache) > 2:
                self._cache.clear()
            self._cache[key] = out
        return out, abs_t - idx * t_len

    def query(self, abs_t: int, use_sync: bool):
        """-> (confidence f32, ampl f32, frame_bits int)"""
        out, rel = self._chunk(abs_t)
        which = "sync" if use_sync else "data"
        conf = out[f"conf_{which}"][rel]
        ampl = out[f"ampl_{which}"][rel]
        bits = int(out["bits_lo"][rel]) | (int(out["bits_hi"][rel]) << 32)
        return conf, ampl, bits


def detect_carrier_band(samples: np.ndarray, nsamples: int, fftsize: int,
                        min_mag_threshold: float) -> int:
    """Full-spectrum argmax carrier detect (reference: src/fsk.c:543-581),
    on the host as in the JAX package."""
    x = np.zeros(fftsize, dtype=np.float32)
    n = min(nsamples, len(samples), fftsize)
    x[:n] = samples[:n]
    spec = np.fft.rfft(x)
    magscalar = f32_div(1.0, f32_div(nsamples, 2.0))
    mags = (np.abs(spec) * float(magscalar)).astype(np.float32)
    best_band, best_mag = -1, np.float32(0.0)
    thr = np.float32(min_mag_threshold)
    for i in range(1, len(mags)):  # skip DC
        m = mags[i]
        if m < thr:
            continue
        if best_mag < m:
            best_mag, best_band = m, i
    return best_band


class Receiver:
    """File/stream receiver: run() consumes a sample array and writes
    decoded bytes + protocol messages."""

    def __init__(
        self,
        cfg: ModemConfig,
        opts: RxOptions,
        codec,
        write_out: Callable[[bytes], None],
        write_err: Callable[[str], None] = lambda s: sys.stderr.write(s),
        device=_device.DEFAULT,
    ):
        self.cfg = cfg
        self.opts = opts.sanitize()
        self.codec = codec
        self.write_out = write_out
        self.write_err = write_err
        self.device = device
        self.stats = None  # filled per NOCARRIER report (for tests)
        self._tuned_b_mark = None  # the band -a detected, for CARRIER lines

    # ------------------------------------------------------------------
    def run(self, samples: np.ndarray, engine: str = "auto",
            in_encoding: str = None, wire_pack="auto") -> int:
        """Decode a sample stream.

        engine: "device" = the device-resident state machine, "host" =
        chunked scoring + the Python state machine (reference replay),
        "host-native" = chunked scoring + the C++ state machine
        (native/hostrx.cpp), "auto" = device.

        in_encoding: u8 wire encoding ("ulaw"/"alaw"/"pcm8") of a raw
        uint8 sample array — the device engine ships 1 byte/sample and
        expands on the device (bit-identical values); the host engines
        expand up front.

        wire_pack: "auto"/True/False — the lossless delta-bitpack wire
        for int16 device uploads (ops/wirepack.py,
        PipelinedReceiver.run); the device engine without -a only."""
        _device.require(self.device)
        if engine == "auto":
            engine = "device"
        if engine == "device":
            if self.opts.carrier_autodetect_threshold > 0.0:
                if in_encoding:
                    samples = self._expand_u8(samples, in_encoding)
                return self._run_device_autodetect(samples)
            return self._run_device(samples, in_encoding, wire_pack)
        if engine not in ("host", "host-native"):
            raise ValueError(f"unknown engine {engine!r}")
        if in_encoding:
            samples = self._expand_u8(samples, in_encoding)
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / np.float32(32768.0)
        if engine == "host-native":
            return self._run_host_native(samples)
        return self._run_host(samples)

    # ------------------------------------------------------------------
    def _run_device(self, samples: np.ndarray,
                    in_encoding: str = None, wire_pack="auto") -> int:
        """Event-stream path: ops/device_rx.py runs the whole pipeline on
        the device; this loop only renders events (codecs + protocol
        lines).  Long streams go through the pipelined receiver so
        host->device transfer overlaps decode."""
        from ..ops.device_rx import PipelinedReceiver

        opts = self.opts
        dtype = (np.uint8 if in_encoding else
                 np.int16 if samples.dtype == np.int16 else np.float32)
        rxer = PipelinedReceiver(self.cfg, opts.precision, opts.rx_one,
                                 device=self.device)
        rc = 0
        for seg_events in rxer.run(
                np.ascontiguousarray(samples, dtype),
                opts.confidence_threshold, opts.confidence_search_limit,
                in_encoding=in_encoding, wire_pack=wire_pack):
            rc = self.render_events(*seg_events)
        return rc

    @staticmethod
    def _expand_u8(samples: np.ndarray, in_encoding: str) -> np.ndarray:
        from ..sigio.containers import expand_u8

        return expand_u8(samples, in_encoding)

    # ------------------------------------------------------------------
    def _run_device_autodetect(self, samples: np.ndarray) -> int:
        """-a on the device engine (the JAX package's
        Receiver._run_device_autodetect, minimodem_tpu/rx/engine.py:
        208-374).  The detection scans run on the host (rfft probes on the
        samplebuf grid, reference: src/minimodem.c:1179-1220); each
        detected burst then decodes on the device with the retuned
        geometry, entering with the carried state-machine fields and
        stopping at the first no-confidence overflow, where the reference
        re-arms detection (:1295-1297; DeviceReceiver's stop_on_overflow).
        The samplebuf refill/advance phase that sets the next probe grid
        is replayed from the wide records, which carry each iteration's
        scan position in lane 5 (_replay_samplebuf)."""
        from ..ops.device_rx import EV_NOCARRIER, DeviceReceiver, zero_carry

        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / np.float32(32768.0)
        samples = np.ascontiguousarray(samples, np.float32)
        cfg = self.cfg
        opts = self.opts
        total = len(samples)

        # samplebuf sizing (reference: src/minimodem.c:1052-1071)
        nbits = 1 + cfg.nstartbits + cfg.n_data_bits + 1
        samplebuf_size = int(np.ceil(
            np.float32(cfg.nsamples_per_bit))) * (nbits + 1)
        samplebuf_size *= 2
        if samplebuf_size < cfg.sample_rate // 12:
            samplebuf_size = cfg.sample_rate // 12
        half = samplebuf_size // 2
        if cfg.expect_nsamples > half:
            # the device's end test (pos + expect <= total) is the host's
            # (nvalid < expect) only while refills keep nvalid >= half:
            # such geometries replay on the host, as in the JAX package
            return self._run_host(samples)

        nspb = cfg.nsamples_per_bit
        overscan = cfg.nsamples_overscan
        try_max_c = round_half_up_i(f32_mul(nspb, 0.75)) + overscan
        try_max_n = trunc_i(nspb) + overscan

        pos = 0
        nvalid = 0
        advance = 0
        carry = zero_carry(1)
        receivers: dict = {}
        ret = 0

        def refill_step(p, nv, a):
            """One loop-top samplebuf update (reference: :1144-1174)."""
            if a == samplebuf_size:
                nv = 0
                a = 0
            if a:
                if a > nv:
                    return p, nv, a, False
                p += a
                nv -= a
                a = 0
            if nv < half:
                nv += min(half, max(0, total - (p + nv)))
            return p, nv, 0, True

        try:
            while True:
                pos, nvalid, advance, ok = refill_step(pos, nvalid, advance)
                if not ok or nvalid == 0:
                    break

                # ---- detection scan (reference: :1179-1220) ----
                nscan_f = nspb
                if float(nscan_f) > cfg.fftsize:
                    nscan_f = f32(cfg.fftsize)
                nscan = trunc_i(nscan_f)
                i = 0
                band = -1
                while np.float32(i) + nscan_f <= np.float32(nvalid):
                    band = detect_carrier_band(
                        samples[pos + i: pos + i + nscan], nscan,
                        cfg.fftsize, opts.carrier_autodetect_threshold)
                    if band >= 0:
                        break
                    i = trunc_i(np.float32(i) + nscan_f)
                advance = trunc_i(np.float32(i) + nscan_f)
                if advance > nvalid:
                    advance = nvalid
                if band < 0:
                    continue
                b_shift = -trunc_i(f32_div(
                    f32_add(cfg.autodetect_shift,
                            f32_div(cfg.band_width, 2.0)),
                    cfg.band_width))
                if cfg.inverted_freqs:
                    b_shift *= -1
                b_space = band + b_shift
                if b_space < 1 or b_space >= cfg.nbands:
                    continue
                self._tuned_b_mark = band
                # the pending detect advance is dropped once decode
                # proceeds (the frame and no-confidence paths set
                # `advance` unconditionally, :1292-1325)
                advance = 0

                if nvalid < cfg.expect_nsamples:
                    break

                # ---- device decode segment (band fixed) ----
                rx = receivers.get((band, b_space))
                if rx is None:
                    rcfg = copy.copy(cfg)
                    rcfg.set_tones_by_bandshift(band, b_space - band)
                    rx = DeviceReceiver(rcfg, opts.precision,
                                        rx_one=opts.rx_one, compact=False,
                                        stop_on_overflow=True,
                                        device=self.device)
                    receivers[(band, b_space)] = rx
                seg_carry = {k: np.asarray(v).copy()
                             for k, v in carry.items()}
                seg_carry["pos"][0] = pos
                seg_carry["stop"][0] = False
                events, carry = rx.run_events_batch(
                    samples[None, :], [total],
                    float(opts.confidence_threshold),
                    float(opts.confidence_search_limit),
                    carry=seg_carry, finalize=False)
                ev_t, ev_p = events[0]
                ret = self.render_events(ev_t, ev_p)
                pos_end = int(carry["pos"][0])

                # ---- samplebuf phase replay over the segment ----
                pos, nvalid = self._replay_samplebuf(
                    pos, nvalid, ev_t, ev_p, pos_end,
                    try_max_c, try_max_n, samplebuf_size, total)

                if opts.rx_one and any(int(t) == EV_NOCARRIER for t in ev_t):
                    return ret
                # the device stopped at the end of the stream, not at an
                # overflow: nothing is left to re-arm on
                if not bool(carry["stop"][0]):
                    break
                carry["stop"][0] = False
                advance = 0
        except KeyboardInterrupt:
            pass

        if bool(carry["carrier"][0]) and not opts.quiet:
            self._report_no_carrier(
                int(carry["nframes"][0]), int(carry["carrier_nsamples"][0]),
                carry["conf_total"][0], carry["ampl_total"][0])
        return ret

    def run_live_autodetect(self, chunks) -> int:
        """-a over a live feed, an iterable of float32 chunks (the JAX
        package's Receiver.run_live_autodetect, minimodem_tpu/rx/engine.py:
        376-606); the reference runs autodetect on any RECORD stream
        (src/minimodem.c:1179-1220).  _run_device_autodetect made
        incremental: detection iterations run as soon as a half-buffer of
        audio is there (the reference's blocking sa_read fills every
        refill except at the end of the stream), and each detected burst
        decodes on a retuned DeviceStreamReceiver until its no-confidence
        overflow stop, where the samplebuf replay sets the next probe
        grid."""
        from ..ops.device_rx import (
            EV_NOCARRIER,
            DeviceStreamReceiver,
            zero_carry,
        )

        _device.require(self.device)
        cfg = self.cfg
        opts = self.opts

        # samplebuf sizing (reference: src/minimodem.c:1052-1071)
        nbits = 1 + cfg.nstartbits + cfg.n_data_bits + 1
        samplebuf_size = int(np.ceil(
            np.float32(cfg.nsamples_per_bit))) * (nbits + 1)
        samplebuf_size *= 2
        if samplebuf_size < cfg.sample_rate // 12:
            samplebuf_size = cfg.sample_rate // 12
        half = samplebuf_size // 2

        nspb = cfg.nsamples_per_bit
        overscan = cfg.nsamples_overscan
        try_max_c = round_half_up_i(f32_mul(nspb, 0.75)) + overscan
        try_max_n = trunc_i(nspb) + overscan

        buf = np.zeros(0, np.float32)
        org = 0                      # absolute position of buf[0]
        pos = 0
        nvalid = 0
        advance = 0
        ended = False
        mode_band = None             # (band, b_space) while decoding
        rs = None
        rs_origin = 0                # absolute position of rs's stream[0]
        seg_ev = []                  # events since the handoff
        ret = 0
        it = iter(chunks)
        # the state machine's carry persists across handoffs: the
        # no-confidence counters survive re-detection (reference
        # :1280-1297), so the probes after a drop re-run after every
        # no-confidence iteration, not after a fresh 20-frame overflow
        carry = zero_carry(1)

        def pump_detect():
            """Detection iterations until a band is found, the feed
            starves or the stream ends: (band, b_space), "starved" or
            None."""
            nonlocal pos, nvalid, advance, buf, org
            while True:
                avail = org + len(buf) - (pos + nvalid)
                if advance == samplebuf_size:
                    nvalid = 0
                    advance = 0
                if advance:
                    if advance > nvalid:
                        return None
                    pos += advance
                    nvalid -= advance
                    advance = 0
                if nvalid < half:
                    if not ended and avail < half:
                        return "starved"
                    nvalid += min(half, max(0, avail))
                if nvalid == 0:
                    return None
                nscan_f = nspb
                if float(nscan_f) > cfg.fftsize:
                    nscan_f = f32(cfg.fftsize)
                nscan = trunc_i(nscan_f)
                i = 0
                band = -1
                while np.float32(i) + nscan_f <= np.float32(nvalid):
                    b0 = pos + i - org
                    band = detect_carrier_band(
                        buf[b0: b0 + nscan], nscan, cfg.fftsize,
                        opts.carrier_autodetect_threshold)
                    if band >= 0:
                        break
                    i = trunc_i(np.float32(i) + nscan_f)
                advance = trunc_i(np.float32(i) + nscan_f)
                if advance > nvalid:
                    advance = nvalid
                if band < 0:
                    # drop the scanned prefix: live memory stays bounded
                    keep = max(0, pos - org)
                    if keep > samplebuf_size:
                        buf = buf[keep:]
                        org = pos
                    continue
                b_shift = -trunc_i(f32_div(
                    f32_add(cfg.autodetect_shift,
                            f32_div(cfg.band_width, 2.0)),
                    cfg.band_width))
                if cfg.inverted_freqs:
                    b_shift *= -1
                b_space = band + b_shift
                if b_space < 1 or b_space >= cfg.nbands:
                    continue
                advance = 0
                return (band, b_space)

        def handoff(band, b_space):
            nonlocal rs, rs_origin, seg_ev, mode_band
            rcfg = copy.copy(cfg)
            rcfg.set_tones_by_bandshift(band, b_space - band)
            self._tuned_b_mark = band
            seed = {k: np.asarray(v).copy() for k, v in carry.items()}
            seed["pos"][0] = 0          # rs's stream starts at `pos`
            seed["stop"][0] = False
            rs = DeviceStreamReceiver(
                rcfg, opts.precision, opts.rx_one,
                segment_len=1 << 16,
                conf_threshold=float(opts.confidence_threshold),
                conf_search_limit=float(opts.confidence_search_limit),
                stop_on_overflow=True, initial_carry=seed,
                device=self.device)
            rs_origin = pos
            seg_ev = []
            mode_band = (band, b_space)

        def after_stop() -> bool:
            """Replay the samplebuf over the finished burst and re-arm
            detection; True when the decode ends entirely."""
            nonlocal pos, nvalid, mode_band, rs, carry
            if rs._carry is not None:
                carry = {k: np.asarray(v).copy()
                         for k, v in rs._carry.items()}
                carry["stop"][0] = False
            ev_t = (np.concatenate([e[0] for e in seg_ev])
                    if seg_ev else np.zeros(0, np.int32))
            ev_p = (np.concatenate([e[1] for e in seg_ev])
                    if seg_ev else np.zeros((0, 6), np.uint32))
            # lane 5 from fed-stream to absolute coordinates
            if len(ev_p):
                ev_p = ev_p.copy()
                ev_p[:, 5] = ev_p[:, 5] + np.uint32(rs_origin)
            pos, nvalid = self._replay_samplebuf(
                pos, nvalid, ev_t, ev_p, rs_origin + rs.abs_pos,
                try_max_c, try_max_n, samplebuf_size,
                org + len(buf) if ended else None)
            if opts.rx_one and any(int(t) == EV_NOCARRIER for t in ev_t):
                return True
            mode_band = None
            rs = None
            return False

        def render(ev):
            nonlocal ret
            if len(ev[0]):
                seg_ev.append(ev)
                ret = self.render_events(*ev)

        try:
            while True:
                if mode_band is None:
                    r = pump_detect()
                    if r == "starved" or (r is None and not ended):
                        chunk = next(it, None)
                        if chunk is None or len(chunk) == 0:
                            ended = True
                        else:
                            buf = np.concatenate(
                                [buf, np.asarray(chunk, np.float32)])
                        continue
                    if r is None:
                        break
                    handoff(*r)
                    # feed everything buffered past the handoff position
                    pending = buf[pos - org:]
                    if len(pending):
                        render(rs.feed(pending))
                    continue
                # decoding: stream chunks into the retuned receiver
                if rs.stopped:
                    if after_stop():
                        return ret
                    continue
                chunk = next(it, None)
                if chunk is None or len(chunk) == 0:
                    ended = True
                    render(rs.finish())
                    if rs.stopped:
                        # the overflow fired before the buffered tail ran
                        # out: re-arm detection over the rest (as the
                        # file path's outer loop does)
                        if after_stop():
                            return ret
                        continue
                    return ret
                chunk = np.asarray(chunk, np.float32)
                buf = np.concatenate([buf, chunk])
                render(rs.feed(chunk))
        except KeyboardInterrupt:
            pass
        if rs is not None:
            ev = rs.finish()
            if len(ev[0]):
                ret = self.render_events(*ev)
        return ret

    def _replay_samplebuf(self, pos, nvalid, ev_t, ev_p, pos_end,
                          try_max_c, try_max_n, samplebuf_size, total):
        """Integer replay of the samplebuf advance/refill phase across a
        device decode segment (minimodem_tpu/rx/engine.py:608-662): wide
        frame records carry their scan position (lane 5) and frame start
        (lane 4), so every iteration's advance can be rebuilt; frames
        advance by fstart + frame_nsamples - overscan, no-confidence
        iterations by the carrier-dependent try_max (reference:
        :1144-1174, :1236-1251).  total=None is a live stream not yet at
        its end, where a blocking refill always grants a full
        half-buffer."""
        from ..ops.device_rx import EV_CARRIER, EV_FRAME, EV_NOCARRIER

        cfg = self.cfg
        half = samplebuf_size // 2
        cursor = pos
        nv = nvalid
        carrier = False

        def step(adv):
            nonlocal cursor, nv
            if adv == samplebuf_size:
                nv = 0
            else:
                cursor += adv
                nv -= adv
            if nv < half:
                avail = half if total is None else max(
                    0, total - (cursor + nv))
                nv += min(half, avail)

        def try_max():
            return try_max_c if carrier else try_max_n

        for et, pay in zip(ev_t, ev_p):
            et = int(et)
            if et == EV_CARRIER:
                continue
            ev_pos = int(pay[5])
            while cursor < ev_pos:
                step(try_max())
            if et == EV_FRAME:
                fstart = int(np.int32(np.uint32(pay[4])))
                step(fstart + cfg.frame_nsamples - cfg.nsamples_overscan)
                carrier = True
            elif et == EV_NOCARRIER:
                step(try_max())      # the drop iteration's advance
                carrier = False
        while cursor < pos_end:
            step(try_max())
        if cursor != pos_end:
            raise RuntimeError(
                f"samplebuf replay ended at {cursor}, the device at "
                f"{pos_end}")
        return cursor, nv

    # ------------------------------------------------------------------
    def _run_host_native(self, samples: np.ndarray) -> int:
        """C++ state machine (native/hostrx.cpp) over full-stream score
        arrays from the batched scorer (DemodScorer.score_chunks)."""
        from .. import native

        lib = native.load()
        if lib is None:
            return self._run_host(samples)
        if self.opts.carrier_autodetect_threshold > 0.0:
            # -a retunes the basis mid-stream; the C++ state machine
            # consumes pre-scored arrays, so autodetect runs run on the
            # Python host engine (same decisions, scan included)
            return self._run_host(samples)

        cfg = self.cfg
        opts = self.opts
        sc = DemodScorer(cfg, opts.precision, device=self.device)
        total = len(samples)
        t_scored = max(total, 1)
        arrs = {k: np.ascontiguousarray(v[:t_scored])
                for k, v in sc.score_chunks(samples).items()}

        nspb = cfg.nsamples_per_bit
        try_max_c = round_half_up_i(f32_mul(nspb, 0.75)) + cfg.nsamples_overscan
        try_max_n = trunc_i(nspb) + cfg.nsamples_overscan

        rc = native.MmRxConfig(
            total=total,
            t_scored=t_scored,
            expect_nsamples=cfg.expect_nsamples,
            frame_nsamples=cfg.frame_nsamples,
            overscan=cfg.nsamples_overscan,
            try_max_carrier=try_max_c,
            try_max_nocarrier=try_max_n,
            rx_one=int(opts.rx_one),
            conf_threshold=np.float32(opts.confidence_threshold),
            conf_search_limit=np.float32(opts.confidence_search_limit),
        )
        min_adv = max(1, min(cfg.frame_nsamples - cfg.nsamples_overscan,
                             try_max_c, try_max_n))
        max_events = t_scored // min_adv + 16
        ev_type = np.zeros(max_events, np.int32)
        ev_pay = np.zeros((max_events, 6), np.uint32)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        n = lib.mm_hostrx_run(
            ctypes.byref(rc),
            ptr(arrs["conf_data"]), ptr(arrs["conf_sync"]),
            ptr(arrs["ampl_data"]), ptr(arrs["ampl_sync"]),
            ptr(arrs["bits_lo"]), ptr(arrs["bits_hi"]),
            ptr(ev_type), ptr(ev_pay), max_events)
        if n < 0:
            raise RuntimeError("hostrx event buffer overflow")
        return self.render_events(ev_type[:n], ev_pay[:n])

    # ------------------------------------------------------------------
    def _render_carrier_line(self, b_mark=None) -> None:
        """### CARRIER line (reference: src/minimodem.c:1336-1348);
        b_mark overrides the configured band after -a retuning."""
        cfg = self.cfg
        freq = float(f32_mul(cfg.b_mark if b_mark is None else b_mark,
                             cfg.band_width))
        if float(cfg.data_rate) >= 100:
            self.write_err("### CARRIER %u @ %.1f Hz ###\n"
                           % (round_half_up_i(cfg.data_rate), freq))
        else:
            self.write_err("### CARRIER %.2f @ %.1f Hz ###\n"
                           % (float(cfg.data_rate), freq))

    @staticmethod
    def _printable(data: bytes) -> bytes:
        """--print-filter byte mapping (reference: src/minimodem.c:
        1451-1459): printable ASCII and whitespace pass, the rest
        become '.'."""
        return bytes(c if (32 <= c < 127 or c in (9, 10, 11, 12, 13))
                     else ord(".") for c in data)

    def _flush_bytes(self, arr) -> None:
        """Run decoded data bytes through the codec + output filter."""
        from ..codecs.ascii import Ascii8Codec

        if len(arr) == 0:
            return
        opts = self.opts
        if isinstance(self.codec, Ascii8Codec) and not opts.print_filter:
            self.write_out(bytes(bytearray(arr)))
            return
        for b in arr:
            data = self.codec.decode(int(b), self.cfg.n_data_bits)
            if not data:
                continue
            if opts.print_filter:
                data = self._printable(data)
            self.write_out(data)

    def render_events(self, ev_type, ev_pay, byte_stream=None) -> int:
        """Render an RX event stream: codec bytes + protocol lines.

        byte_stream (compact mode, the device engine): per-frame data
        bytes already post-processed on the device; events are carrier
        transitions carrying their byte-stream positions.  Without it
        (wide mode, host-native) every frame is an event carrying its raw
        frame bits."""
        from ..ops.device_rx import EV_CARRIER, EV_FRAME, EV_NOCARRIER

        cfg = self.cfg
        opts = self.opts
        if byte_stream is not None:
            pos = 0
            for k in range(len(ev_type)):
                et = int(ev_type[k])
                pay = ev_pay[k]
                bpos = int(pay[0]) if et == EV_CARRIER else int(pay[4])
                self._flush_bytes(byte_stream[pos:bpos])
                pos = bpos
                if et == EV_CARRIER:
                    if not opts.quiet:
                        self._render_carrier_line(self._tuned_b_mark)
                    self.codec.reset()
                elif et == EV_NOCARRIER:
                    if not opts.quiet:
                        self._report_no_carrier(
                            int(pay[0]), int(pay[3]),
                            pay[1].view(np.float32),
                            pay[2].view(np.float32))
            self._flush_bytes(byte_stream[pos:])
            return 0
        for k in range(len(ev_type)):
            et = int(ev_type[k])
            pay = ev_pay[k]
            if et == EV_CARRIER:
                if not opts.quiet:
                    self._render_carrier_line(self._tuned_b_mark)
                self.codec.reset()
            elif et == EV_FRAME:
                bits = int(pay[0]) | (int(pay[1]) << 32)
                if float(cfg.nstopbits) != 0.0:
                    bits >>= 1
                bits = bit_window(bits, cfg.nstartbits, cfg.n_data_bits)
                if cfg.msb_first:
                    bits = bit_reverse(bits, cfg.n_data_bits)
                if cfg.do_rx_sync and bits == cfg.sync_byte:
                    continue
                data = self.codec.decode(bits, cfg.n_data_bits)
                if not data:
                    continue
                if opts.print_filter:
                    data = bytes(
                        b if (32 <= b < 127 or b in (9, 10, 11, 12, 13, 32))
                        else ord(".") for b in data)
                self.write_out(data)
            elif et == EV_NOCARRIER:
                if not opts.quiet:
                    self._report_no_carrier(
                        int(pay[0]), int(pay[3]),
                        pay[1].view(np.float32),
                        pay[2].view(np.float32))
        return 0

    # ------------------------------------------------------------------
    def _run_host(self, samples: np.ndarray) -> int:
        """The reference's receive loop replayed in Python over chunked
        scores (reference: src/minimodem.c:1137-1463), with carrier
        autodetect (:1179-1220)."""
        cfg = self.cfg
        opts = self.opts
        provider = ScoreProvider(samples, cfg, opts.precision,
                                 device=self.device)
        total = len(samples)

        # samplebuf sizing (reference: src/minimodem.c:1052-1071)
        nbits = 1 + cfg.nstartbits + cfg.n_data_bits + 1
        samplebuf_size = int(np.ceil(np.float32(cfg.nsamples_per_bit))) * (nbits + 1)
        samplebuf_size *= 2
        if samplebuf_size < cfg.sample_rate // 12:
            samplebuf_size = cfg.sample_rate // 12

        nspb = cfg.nsamples_per_bit
        overscan = cfg.nsamples_overscan
        expect_nsamples = cfg.expect_nsamples
        frame_nsamples = cfg.frame_nsamples

        pos = 0                # absolute index of samplebuf[0]
        nvalid = 0
        advance = 0
        carrier = False
        carrier_band = -1
        noconfidence = 0
        track_amplitude = f32(0.0)
        peak_confidence = f32(0.0)
        confidence_total = f32(0.0)
        amplitude_total = f32(0.0)
        nframes_decoded = 0
        carrier_nsamples = 0
        ret = 0

        try:
            while True:
                # ---- window advance (reference: :1144-1156) ----
                if advance == samplebuf_size:
                    nvalid = 0
                    advance = 0
                if advance:
                    if advance > nvalid:
                        break
                    pos += advance
                    nvalid -= advance
                    advance = 0

                # ---- refill (reference: :1158-1174) ----
                if nvalid < samplebuf_size // 2:
                    read_n = samplebuf_size // 2
                    r = min(read_n, max(0, total - (pos + nvalid)))
                    nvalid += r

                if nvalid == 0:
                    break

                # ---- carrier autodetect (reference: :1179-1220) ----
                if opts.carrier_autodetect_threshold > 0.0 and carrier_band < 0:
                    nscan_f = nspb
                    if float(nscan_f) > cfg.fftsize:
                        nscan_f = f32(cfg.fftsize)
                    nscan = trunc_i(nscan_f)
                    i = 0
                    carrier_band = -1
                    while np.float32(i) + nscan_f <= np.float32(nvalid):
                        carrier_band = detect_carrier_band(
                            provider.samples[pos + i: pos + i + nscan],
                            nscan, cfg.fftsize,
                            opts.carrier_autodetect_threshold)
                        if carrier_band >= 0:
                            break
                        i = trunc_i(np.float32(i) + nscan_f)
                    advance = trunc_i(np.float32(i) + nscan_f)
                    if advance > nvalid:
                        advance = nvalid
                    if carrier_band < 0:
                        continue

                    b_shift = -trunc_i(f32_div(
                        f32_add(cfg.autodetect_shift,
                                f32_div(cfg.band_width, 2.0)),
                        cfg.band_width))
                    if cfg.inverted_freqs:
                        b_shift *= -1
                    b_space = carrier_band + b_shift
                    if b_space < 1 or b_space >= cfg.nbands:
                        carrier_band = -1
                        continue
                    provider.set_tones(carrier_band, b_space)

                if nvalid < expect_nsamples:
                    break

                # ---- frame search (reference: :1232-1274) ----
                if carrier:
                    try_max = round_half_up_i(f32_mul(nspb, 0.75))
                else:
                    try_max = trunc_i(nspb)
                try_max += overscan
                try_step = try_max // FSK_ANALYZE_NSTEPS
                if try_step == 0:
                    try_step = 1

                try_first = overscan if carrier else 0
                use_sync = not carrier

                confidence, bits, amplitude, frame_start = self._find_frame(
                    provider, pos, try_first, try_max, try_step,
                    f32(opts.confidence_search_limit), use_sync)

                do_refine_frame = False
                if confidence < peak_confidence * np.float32(0.75):
                    do_refine_frame = True
                    peak_confidence = f32(0.0)

                # amplitude-drop squelch (reference: :1284-1288)
                if amplitude < track_amplitude * np.float32(0.25):
                    confidence = f32(0.0)

                # ---- no-confidence path (reference: :1292-1321) ----
                if confidence <= np.float32(opts.confidence_threshold):
                    noconfidence += 1
                    if noconfidence > FSK_MAX_NOCONFIDENCE_BITS:
                        carrier_band = -1
                        if carrier:
                            if not opts.quiet:
                                self._report_no_carrier(
                                    nframes_decoded, carrier_nsamples,
                                    confidence_total, amplitude_total)
                            carrier = False
                            carrier_nsamples = 0
                            confidence_total = f32(0.0)
                            amplitude_total = f32(0.0)
                            nframes_decoded = 0
                            track_amplitude = f32(0.0)
                            if opts.rx_one:
                                break
                    advance = try_max
                    continue

                # ---- got a frame ----
                carrier_nsamples += frame_nsamples
                if carrier:
                    carrier_nsamples += frame_start
                    carrier_nsamples -= overscan
                else:
                    # acquired carrier (reference: :1332-1355); after -a
                    # the line names the detected band
                    if not opts.quiet:
                        self._render_carrier_line(
                            carrier_band if carrier_band >= 0 else None)
                    carrier = True
                    self.codec.reset()
                    do_refine_frame = True

                # ---- fine rescan (reference: :1357-1389) ----
                if do_refine_frame:
                    if confidence < INFINITY and try_step > 1:
                        fine_step = try_max // FSK_ANALYZE_NSTEPS_FINE
                        if fine_step == 0:
                            fine_step = 1
                        c2, b2, a2, fs2 = self._find_frame(
                            provider, pos, try_first, try_max, fine_step,
                            f32(INFINITY), not carrier)
                        if c2 > confidence:
                            bits, amplitude, frame_start = b2, a2, fs2
                            # NB: the reference does NOT update `confidence`
                            # here (src/minimodem.c:1383-1387)

                track_amplitude = f32_div(f32_add(track_amplitude, amplitude), 2.0)
                if peak_confidence < confidence:
                    peak_confidence = confidence
                confidence_total = f32_add(confidence_total, confidence)
                amplitude_total = f32_add(amplitude_total, amplitude)
                nframes_decoded += 1
                noconfidence = 0

                advance = frame_start + frame_nsamples - overscan

                # ---- frame bit post-processing (reference: :1414-1443) ----
                if float(cfg.nstopbits) != 0.0:
                    bits >>= 1  # chop prev_stop bit
                bits = bit_window(bits, cfg.nstartbits, cfg.n_data_bits)
                if cfg.msb_first:
                    bits = bit_reverse(bits, cfg.n_data_bits)

                if cfg.do_rx_sync and bits == cfg.sync_byte:
                    continue  # suppress sync bytes

                data = self.codec.decode(bits, cfg.n_data_bits)
                if not data:
                    continue
                if opts.print_filter:
                    data = self._printable(data)
                self.write_out(data)
        except KeyboardInterrupt:
            pass

        if carrier and not opts.quiet:
            self._report_no_carrier(nframes_decoded, carrier_nsamples,
                                    confidence_total, amplitude_total)
        return ret

    # ------------------------------------------------------------------
    def _find_frame(self, provider: ScoreProvider, pos: int, try_first: int,
                    try_max: int, try_step: int, limit, use_sync: bool):
        """Center-out scan with early exit (reference: src/fsk.c:449-538).
        Pure replay over precomputed scores; strict improvement, so a NaN
        never improves."""
        best_t = 0
        best_c = np.float32(0.0)
        best_a = np.float32(0.0)
        best_bits = 0
        j = 0
        while True:
            up = 1 if (j % 2) else -1
            t = try_first + up * ((j + 1) // 2) * try_step
            j += 1
            if t >= try_max:
                break
            if t < 0:
                continue
            c, a, bits = provider.query(pos + t, use_sync)
            if best_c < c:
                best_t, best_c, best_a, best_bits = t, c, a, bits
                if best_c >= limit:
                    break
        return best_c, best_bits, best_a, best_t

    # ------------------------------------------------------------------
    def _report_no_carrier(self, nframes: int, carrier_nsamples: int,
                           confidence_total, amplitude_total) -> None:
        """NOCARRIER stats line (reference: src/minimodem.c:253-291)."""
        cfg = self.cfg
        nbits_decoded = f32_mul(nframes, cfg.frame_n_bits)
        throughput = f32_div(
            f32_mul(nbits_decoded, cfg.sample_rate), carrier_nsamples)
        conf_avg = float(f32_div(confidence_total, nframes)) if nframes else float("nan")
        ampl_avg = float(f32_div(amplitude_total, nframes)) if nframes else float("nan")
        line = "\n### NOCARRIER ndata=%u confidence=%.3f ampl=%.3f bps=%.2f" % (
            nframes, conf_avg, ampl_avg, float(throughput))

        lhs = int(np.trunc(f32_add(f32_mul(nbits_decoded, cfg.sample_rate), 0.5)))
        rhs = int(np.trunc(f32_mul(cfg.data_rate, carrier_nsamples)))
        if lhs == rhs:
            line += " (rate perfect) ###\n"
        else:
            skew = f32_div(f32_sub(throughput, cfg.data_rate), cfg.data_rate)
            direction = "slow" if math.copysign(1.0, float(skew)) < 0 else "fast"
            line += " (%.1f%% %s) ###\n" % (abs(float(skew)) * 100.0, direction)
        self.stats = line
        self.write_err(line)
