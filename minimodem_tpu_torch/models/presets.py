"""Baudmode preset "model zoo".

Library-level constructors for every modem family the reference CLI exposes
(reference: src/minimodem.c:819-886 presets, 900-934 band defaults).  Each
returns a finalized ModemConfig plus the codec names to use.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import ModemConfig, resolve_mode_defaults
from ..utils.cfloat import f32


@dataclass
class Preset:
    cfg: ModemConfig
    encoder: str
    decoder: str
    tx_supported: bool = True


def _finish(cfg: ModemConfig, data_rate, nstartbits, nstopbits) -> ModemConfig:
    resolve_mode_defaults(cfg, data_rate)
    cfg.nstartbits = 1 if nstartbits < 0 else nstartbits
    cfg.nstopbits = f32(1.0) if nstopbits < 0 else f32(nstopbits)
    return cfg.finalize()


def bell_like(data_rate: float, sample_rate: int = 48000,
              n_data_bits: int = 8, **kw) -> Preset:
    """Generic Bell-like mode at any baud rate (the numeric baudmode)."""
    cfg = ModemConfig(sample_rate=sample_rate, data_rate=f32(data_rate),
                      n_data_bits=n_data_bits, **kw)
    return Preset(_finish(cfg, data_rate, -1, -1.0), "ascii8", "ascii8")


def bell202(sample_rate: int = 48000, **kw) -> Preset:
    """Bell 202: 1200 baud, mark 1200 Hz, space 2200 Hz."""
    return bell_like(1200.0, sample_rate, **kw)


def bell103(sample_rate: int = 48000, **kw) -> Preset:
    """Bell 103: 300 baud, mark 1270 Hz, space 1070 Hz."""
    return bell_like(300.0, sample_rate, **kw)


def v21(sample_rate: int = 48000) -> Preset:
    """ITU V.21: 300 baud, mark 980 Hz, space 1180 Hz."""
    cfg = ModemConfig(sample_rate=sample_rate, data_rate=f32(300.0),
                      n_data_bits=8, mark_f=f32(980), space_f=f32(1180))
    return Preset(_finish(cfg, 300.0, -1, -1.0), "ascii8", "ascii8")


def rtty(sample_rate: int = 48000) -> Preset:
    """RTTY: 45.45 baud Baudot 5-N-1.5."""
    cfg = ModemConfig(sample_rate=sample_rate, data_rate=f32(45.45),
                      n_data_bits=5)
    return Preset(_finish(cfg, 45.45, -1, 1.5), "baudot", "baudot")


def tdd(sample_rate: int = 48000) -> Preset:
    """TTY/TDD: 45.45 baud Baudot 5-N-2, mark 1400 / space 1800 Hz."""
    cfg = ModemConfig(sample_rate=sample_rate, data_rate=f32(45.45),
                      n_data_bits=5, mark_f=f32(1400), space_f=f32(1800))
    return Preset(_finish(cfg, 45.45, -1, 2.0), "baudot", "baudot")


def same(sample_rate: int = 48000) -> Preset:
    """NOAA SAME: 520.83 baud, sync byte 0xAB, no start/stop bits."""
    rate = 520.0 + 5 / 6.0
    cfg = ModemConfig(
        sample_rate=sample_rate, data_rate=f32(rate), n_data_bits=8,
        do_rx_sync=True, do_tx_sync_bytes=16, sync_byte=0xAB,
        mark_f=f32(2083.0 + 1 / 3.0), space_f=f32(1562.5),
        band_width=f32(rate))
    return Preset(_finish(cfg, rate, 0, 0.0), "ascii8", "ascii8")


def callerid(sample_rate: int = 48000) -> Preset:
    """Bell 202 Caller-ID (SDMF/MDMF), decode-only."""
    cfg = ModemConfig(sample_rate=sample_rate, data_rate=f32(1200.0),
                      n_data_bits=8)
    return Preset(_finish(cfg, 1200.0, -1, -1.0), "ascii8", "callerid",
                  tx_supported=False)


def uic(direction: str = "train", sample_rate: int = 48000) -> Preset:
    """UIC-751-3: 600 baud, 39 data bits, 8 sync start bits, decode-only."""
    cfg = ModemConfig(
        sample_rate=sample_rate, data_rate=f32(600.0), n_data_bits=39,
        mark_f=f32(1300), space_f=f32(1700),
        expect_data_string="11110010ddddddddddddddddddddddddddddddddddddddd",
        expect_n_bits=47)
    return Preset(_finish(cfg, 600.0, 8, 0.0), "ascii8", f"uic-{direction}",
                  tx_supported=False)


PRESETS = {
    "1200": bell202,
    "300": bell103,
    "bell202": bell202,
    "bell103": bell103,
    "v.21": v21,
    "rtty": rtty,
    "tdd": tdd,
    "same": same,
    "callerid": callerid,
    "uic-train": lambda **kw: uic("train", **kw),
    "uic-ground": lambda **kw: uic("ground", **kw),
}
