"""Receiver: runs the device pipeline and renders its events.

Counterpart of minimodem_tpu/rx/engine.py, device engine only.  The
state machine itself runs on the device (ops/mega_rx.py); this module
turns its event stream into decoded bytes on stdout and the reference's
CARRIER / NOCARRIER protocol lines on stderr
(reference: src/minimodem.c:253-291, 1336-1348, 1414-1459).

Not ported yet: the host engines ("host", "host-native") with their
ScoreProvider and Python state machine (ROADMAP queue 1 item 10), and
carrier autodetect (-a, queue 1 item 9).
"""

from __future__ import annotations

import math
import sys
from typing import Callable

import numpy as np

from ..config import ModemConfig, RxOptions
from ..utils.cfloat import f32_add, f32_div, f32_mul, f32_sub, round_half_up_i


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
        device="cpu",
    ):
        self.cfg = cfg
        self.opts = opts.sanitize()
        self.codec = codec
        self.write_out = write_out
        self.write_err = write_err
        self.device = device
        self.stats = None  # filled per NOCARRIER report (for tests)

    # ------------------------------------------------------------------
    def run(self, samples: np.ndarray, engine: str = "auto",
            in_encoding: str = None) -> int:
        """Decode a sample stream on the device engine.

        in_encoding: u8 wire encoding ("ulaw"/"alaw"/"pcm8") of a raw
        uint8 sample array — it ships 1 byte/sample and expands on the
        device (bit-identical values)."""
        if engine in ("host", "host-native"):
            raise NotImplementedError(
                f"the {engine} engine is not ported to the PyTorch package "
                "yet (ROADMAP queue 1 item 10); use --engine device")
        if engine not in ("auto", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        if self.opts.carrier_autodetect_threshold > 0.0:
            raise NotImplementedError(
                "carrier autodetect (-a) is not ported to the PyTorch "
                "package yet (ROADMAP queue 1 item 9)")
        return self._run_device(samples, in_encoding)

    # ------------------------------------------------------------------
    def _run_device(self, samples: np.ndarray,
                    in_encoding: str = None) -> int:
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
                in_encoding=in_encoding):
            rc = self.render_events(*seg_events)
        return rc

    # ------------------------------------------------------------------
    def _render_carrier_line(self) -> None:
        """### CARRIER line (reference: src/minimodem.c:1336-1348)."""
        cfg = self.cfg
        freq = float(f32_mul(cfg.b_mark, cfg.band_width))
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

    def render_events(self, ev_type, ev_pay, byte_stream) -> int:
        """Render a compact RX event stream: the per-frame data bytes were
        post-processed on the device; events are carrier transitions
        carrying their byte-stream positions."""
        from ..ops.device_rx import EV_CARRIER, EV_NOCARRIER

        opts = self.opts
        pos = 0
        for k in range(len(ev_type)):
            et = int(ev_type[k])
            pay = ev_pay[k]
            bpos = int(pay[0]) if et == EV_CARRIER else int(pay[4])
            self._flush_bytes(byte_stream[pos:bpos])
            pos = bpos
            if et == EV_CARRIER:
                if not opts.quiet:
                    self._render_carrier_line()
                self.codec.reset()
            elif et == EV_NOCARRIER:
                if not opts.quiet:
                    self._report_no_carrier(
                        int(pay[0]), int(pay[3]),
                        pay[1].view(np.float32),
                        pay[2].view(np.float32))
        self._flush_bytes(byte_stream[pos:])
        return 0

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
