"""Modem configuration and geometry derivation.

This module reproduces, with C-float32 exactness, the parameter derivation
rules of the reference CLI driver (reference: src/minimodem.c:819-965 for
baudmode presets and frequency-band defaulting, src/minimodem.c:1037-1131 for
the RX geometry, src/minimodem.c:114-132 for the TX geometry, and
src/fsk.c:33-66 for the DFT plan geometry).

The derived integer geometry (bit-window offsets, filter sizes, band indices)
feeds the batched TPU demodulator; everything here runs once per
configuration on host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .utils.cfloat import (
    f32,
    f32_add,
    f32_div,
    f32_mul,
    round_half_up_i,
    trunc_i,
)


class ConfigError(ValueError):
    pass


def build_expect_bits_string(
    nstartbits: int,
    n_data_bits: int,
    nstopbits: float,
    invert_start_stop: bool,
    expect_bits: Optional[int] = None,
) -> str:
    """Build the framing-pattern string scanned by the demodulator.

    Mirrors reference src/minimodem.c:442-487: a leading *previous stop* bit
    (if the frame has stop bits), then start bits, then data bits ('d' =
    don't-care, or literal bits of ``expect_bits`` LSB-first for sync
    patterns), then the stop bit.
    """
    start_c = "1" if invert_start_stop else "0"
    stop_c = "0" if invert_start_stop else "1"
    s = []
    if f32(nstopbits) != f32(0.0):
        s.append(stop_c)  # prev_stop
    s.extend(start_c for _ in range(nstartbits))
    for i in range(n_data_bits):
        if expect_bits is None:
            s.append("d")
        else:
            s.append(chr(((expect_bits >> i) & 1) + ord("0")))
    if f32(nstopbits) != f32(0.0):
        s.append(stop_c)
    return "".join(s)


@dataclass
class ModemConfig:
    """Fully-resolved modem parameters plus derived DSP geometry.

    Florating-point fields deliberately carry ``np.float32`` values so every
    downstream computation sees exactly what the reference's C floats held.
    """

    # ---- primary parameters -------------------------------------------------
    sample_rate: int = 48000
    data_rate: np.float32 = f32(0.0)
    n_data_bits: int = 8
    nstartbits: int = 1
    nstopbits: np.float32 = f32(1.0)
    mark_f: np.float32 = f32(0.0)
    space_f: np.float32 = f32(0.0)
    band_width: np.float32 = f32(0.0)
    msb_first: bool = False
    invert_start_stop: bool = False
    inverted_freqs: bool = False
    do_rx_sync: bool = False
    do_tx_sync_bytes: int = 0
    sync_byte: int = -1
    autodetect_shift: int = 0
    expect_data_string: str = ""
    expect_sync_string: str = ""
    expect_n_bits: int = 0

    # ---- derived geometry (filled by finalize) ------------------------------
    nsamples_per_bit: np.float32 = f32(0.0)      # RX float samples/bit
    bit_nsamples_tx: int = 0                     # TX integer samples/bit
    frame_n_bits: int = 0                        # whole bits per frame
    frame_nsamples: int = 0
    expect_nsamples: int = 0
    samples_per_bit_scan: np.float32 = f32(0.0)  # find_frame's samples_per_bit
    bit_nsamples_rx: int = 0                     # DFT window length per bit
    bit_begin_samples: tuple = ()                # per-bit window start offsets
    nsamples_overscan: int = 0
    fftsize: int = 0
    nbands: int = 0
    b_mark: int = 0
    b_space: int = 0

    def finalize(self) -> "ModemConfig":
        """Derive all geometry.  Call after the primary fields are set."""
        if float(self.data_rate) == 0.0:
            raise ConfigError("data rate must be specified")

        # --- frame size (reference: src/minimodem.c:943-947) ---
        # C computes (int + int) + float in float32, truncates to unsigned.
        fnb = trunc_i(f32_add(self.n_data_bits + self.nstartbits, self.nstopbits))
        if fnb > 64:
            raise ConfigError("total number of bits per frame must be <= 64")
        self.frame_n_bits = fnb

        # --- TX geometry (reference: src/minimodem.c:131-132) ---
        self.bit_nsamples_tx = trunc_i(
            f32_add(f32_div(self.sample_rate, self.data_rate), 0.5)
        )

        # --- RX geometry (reference: src/minimodem.c:1037,1105-1131) ---
        self.nsamples_per_bit = f32_div(self.sample_rate, self.data_rate)
        self.frame_nsamples = round_half_up_i(
            f32_mul(self.nsamples_per_bit, self.frame_n_bits)
        )
        self.nsamples_overscan = round_half_up_i(
            f32_mul(self.nsamples_per_bit, 0.5)
        )
        # overscan 0.5 > 0, so ensure at least one sample
        if self.nsamples_overscan == 0:
            self.nsamples_overscan = 1

        if not self.expect_data_string:
            self.expect_data_string = build_expect_bits_string(
                self.nstartbits, self.n_data_bits, float(self.nstopbits),
                self.invert_start_stop,
            )
            self.expect_n_bits = len(self.expect_data_string)
        if not self.expect_n_bits:
            self.expect_n_bits = len(self.expect_data_string)
        if self.do_rx_sync and self.sync_byte >= 0:
            self.expect_sync_string = build_expect_bits_string(
                self.nstartbits, self.n_data_bits, float(self.nstopbits),
                self.invert_start_stop, self.sync_byte,
            )
        else:
            self.expect_sync_string = self.expect_data_string

        if self.expect_n_bits > 64:
            raise ConfigError("expect pattern must be <= 64 bits")

        # expect_nsamples: plain float→unsigned truncation, no +0.5f
        # (reference: src/minimodem.c:1131)
        self.expect_nsamples = trunc_i(
            f32_mul(self.nsamples_per_bit, self.expect_n_bits)
        )
        # find_frame re-derives samples_per_bit from the truncated window size
        # (reference: src/fsk.c:465)
        self.samples_per_bit_scan = f32_div(self.expect_nsamples, self.expect_n_bits)
        self.bit_nsamples_rx = round_half_up_i(self.samples_per_bit_scan)
        self.bit_begin_samples = tuple(
            round_half_up_i(f32_mul(self.samples_per_bit_scan, b))
            for b in range(self.expect_n_bits)
        )

        # --- DFT plan geometry (reference: src/fsk.c:50-66) ---
        if float(self.band_width) == 0.0:
            raise ConfigError("band width must be resolved before finalize")
        half_bw = f32_div(self.band_width, 2.0)
        self.fftsize = trunc_i(
            f32_div(f32_add(self.sample_rate, half_bw), self.band_width)
        )
        self.nbands = self.fftsize // 2 + 1
        self.b_mark = trunc_i(f32_div(f32_add(self.mark_f, half_bw), self.band_width))
        self.b_space = trunc_i(f32_div(f32_add(self.space_f, half_bw), self.band_width))
        if self.b_mark >= self.nbands or self.b_space >= self.nbands:
            raise ConfigError(
                f"b_mark={self.b_mark} or b_space={self.b_space} is invalid "
                f"(nbands={self.nbands})"
            )
        return self

    # ------------------------------------------------------------------
    def set_tones_by_bandshift(self, b_mark: int, b_shift: int) -> None:
        """Carrier-autodetect retune (reference: src/fsk.c:584-598)."""
        assert b_shift != 0
        assert 0 <= b_mark < self.nbands
        b_space = b_mark + b_shift
        assert 0 <= b_space < self.nbands
        self.b_mark = b_mark
        self.b_space = b_space
        self.mark_f = f32_mul(b_mark, self.band_width)
        self.space_f = f32_mul(b_space, self.band_width)


@dataclass
class RxOptions:
    """Receiver runtime knobs (reference: src/minimodem.c:514-545)."""

    confidence_threshold: float = 1.5
    confidence_search_limit: float = 2.3
    carrier_autodetect_threshold: float = 0.0
    rx_one: bool = False
    rxnoise_factor: float = 0.0
    quiet: bool = False
    print_filter: bool = False
    # precision of the demod scoring path: "auto" | "float32" | "float64"
    precision: str = "auto"

    def sanitize(self) -> "RxOptions":
        # reference: src/minimodem.c:963-965
        if self.confidence_search_limit < self.confidence_threshold:
            self.confidence_search_limit = self.confidence_threshold
        return self


@dataclass
class TxOptions:
    """Transmitter runtime knobs (reference: src/minimodem.c:537-543)."""

    amplitude: np.float32 = f32(1.0)
    sin_table_len: int = 4096
    interactive: bool = False
    print_eot: bool = False
    tx_carrier: bool = False
    leader_bits_len: int = 2
    trailer_bits_len: int = 2


def resolve_mode_defaults(
    cfg: ModemConfig,
    data_rate: float,
) -> None:
    """Apply the rate-band frequency defaults.

    Mirrors reference src/minimodem.c:900-934: >=400 baud gets Bell-202-style
    tone placement, >=100 baud Bell-103-style, below that RTTY-style.
    Only fills fields that are still zero.
    """
    rate = f32(data_rate)
    if rate >= 400:
        cfg.autodetect_shift = -trunc_i(f32_div(f32_mul(rate, 5.0), 6.0))
        if float(cfg.mark_f) == 0.0:
            cfg.mark_f = f32_add(f32_div(rate, 2.0), 600.0)
        if float(cfg.space_f) == 0.0:
            cfg.space_f = f32_sub_space(cfg.mark_f, cfg.autodetect_shift)
        if float(cfg.band_width) == 0.0:
            cfg.band_width = f32(200.0)
    elif rate >= 100:
        cfg.autodetect_shift = 200
        if float(cfg.mark_f) == 0.0:
            cfg.mark_f = f32(1270.0)
        if float(cfg.space_f) == 0.0:
            cfg.space_f = f32_sub_space(cfg.mark_f, cfg.autodetect_shift)
        if float(cfg.band_width) == 0.0:
            cfg.band_width = f32(50.0)
    else:
        cfg.autodetect_shift = 170
        if float(cfg.mark_f) == 0.0:
            cfg.mark_f = f32(1585.0)
        if float(cfg.space_f) == 0.0:
            cfg.space_f = f32_sub_space(cfg.mark_f, cfg.autodetect_shift)
        if float(cfg.band_width) == 0.0:
            cfg.band_width = f32(10.0)

    # restrict band_width to <= data rate (reference: src/minimodem.c:959-961)
    if float(cfg.band_width) > float(rate):
        cfg.band_width = rate


def f32_sub_space(mark_f: np.float32, shift) -> np.float32:
    """space = mark - autodetect_shift in float32."""
    return np.float32(np.float32(mark_f) - np.float32(shift))
