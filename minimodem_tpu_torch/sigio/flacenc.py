"""Deterministic FLAC encoder (write path of the sigio file backend).

The reference gets FLAC write from libsndfile
(reference: src/simpleaudio-sndfile.c:111-157).  This is a from-scratch
encoder producing spec-valid streams with real compression: per-subframe
choice of CONSTANT, FIXED order 0-2 with Rice-coded residuals, or
VERBATIM fallback; fixed 4096-sample blocks; correct CRC-8/CRC-16 and
STREAMINFO MD5.  Output depends only on the samples (no timestamps), so
TX determinism tests hold for .flac like .wav
(reference contract: tests/16-verify-tx-consistent.test).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

BLOCK = 4096


def _make_crc8_table() -> list:
    out = []
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
        out.append(crc)
    return out


def _make_crc16_table() -> list:
    out = []
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
        out.append(crc)
    return out


_CRC8_T = _make_crc8_table()
_CRC16_T = _make_crc16_table()


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_T[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFF00) ^ _CRC16_T[(crc >> 8) ^ b]
    return crc


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def unary(self, q: int) -> None:
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def bit_array(self, bits: np.ndarray) -> None:
        """Append a uint8 0/1 bit array (MSB-first stream order) in bulk
        via np.packbits — the fast path for rice/verbatim runs."""
        if self.n:
            head = np.array(
                [(self.acc >> (self.n - 1 - i)) & 1
                 for i in range(self.n)], np.uint8)
            bits = np.concatenate([head, bits])
            self.acc = 0
            self.n = 0
        nfull = len(bits) // 8 * 8
        self.buf += np.packbits(bits[:nfull]).tobytes()
        for b in bits[nfull:]:
            self.acc = (self.acc << 1) | int(b)
            self.n += 1

    def align(self) -> None:
        if self.n:
            self.bits(0, 8 - self.n)

    def bytes(self) -> bytes:
        assert self.n == 0
        return bytes(self.buf)


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (nbytes * 5 + 1)) and nbytes < 7:
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _rice_cost(res: np.ndarray, param: int) -> int:
    u = (np.abs(res.astype(np.int64)) << 1) - (res < 0)
    return int(np.sum(u >> param)) + len(res) * (1 + param)


def _best_rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.mean(np.abs(res.astype(np.int64)))) + 1e-9
    p = max(0, int(np.log2(mean + 1)))
    best_p, best_c = 0, None
    for cand in range(max(0, p - 1), min(14, p + 2) + 1):
        c = _rice_cost(res, cand)
        if best_c is None or c < best_c:
            best_p, best_c = cand, c
    return best_p


def _write_rice(bw: _BitWriter, res: np.ndarray, param: int) -> None:
    """Vectorized: per sample q zeros + '1' + param remainder bits, built
    as one bit array (q_i zero bits is exactly the unary coding bw.unary
    emits)."""
    u = ((np.abs(res.astype(np.int64)) << 1) - (res < 0)).astype(np.int64)
    q = u >> param
    lens = q + 1 + param
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    bits = np.zeros(int(lens.sum()), np.uint8)
    bits[starts + q] = 1
    for b in range(param):
        bits[starts + q + 1 + b] = (u >> (param - 1 - b)) & 1
    bw.bit_array(bits)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int) -> None:
    n = len(x)
    if np.all(x == x[0]):
        bw.bits(0, 1)
        bw.bits(0, 6)          # CONSTANT
        bw.bits(0, 1)
        bw.bits(int(x[0]), bps)
        return

    # candidate fixed orders 0..2: pick the cheapest rice encoding
    best = None
    for order in range(0, 3):
        if n <= order:
            break
        res = _fixed_residual(x, order)
        param = _best_rice_param(res)
        cost = order * bps + _rice_cost(res, param)
        if best is None or cost < best[0]:
            best = (cost, order, res, param)
    verbatim_cost = n * bps
    if best is None or best[0] >= verbatim_cost:
        bw.bits(0, 1)
        bw.bits(1, 6)          # VERBATIM
        bw.bits(0, 1)
        shifts = bps - 1 - np.arange(bps)
        bw.bit_array(((x.astype(np.int64)[:, None] >> shifts) & 1)
                     .astype(np.uint8).ravel())
        return

    _, order, res, param = best
    bw.bits(0, 1)
    bw.bits(0x08 | order, 6)   # FIXED
    bw.bits(0, 1)              # no wasted bits
    for v in x[:order].tolist():
        bw.bits(int(v), bps)
    bw.bits(0, 2)              # residual method: 4-bit rice
    bw.bits(0, 4)              # partition order 0
    bw.bits(param, 4)
    _write_rice(bw, res, param)


def encode(samples: np.ndarray, rate: int, channels: int = 1,
           bps: int = 16) -> bytes:
    """Encode int samples (interleaved [n*channels], or float32 in [-1,1])
    to a FLAC stream."""
    if samples.dtype.kind == "f":
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * ((1 << (bps - 1)) - 1)).astype(np.int32)
    else:
        samples = samples.astype(np.int32)
    nframes = len(samples) // channels
    x = samples[: nframes * channels].reshape(nframes, channels)

    # STREAMINFO md5: raw samples, little-endian, bps/8 bytes each
    nbytes = bps // 8
    raw4 = np.ascontiguousarray(x.astype("<i4"))
    md5 = hashlib.md5(
        np.ascontiguousarray(
            raw4.reshape(-1, 1).view(np.uint8)[:, :nbytes]).tobytes()
        if nbytes != 4 else raw4.tobytes()).digest()

    out = bytearray(b"fLaC")
    si = bytearray()
    si += struct.pack(">HH", BLOCK, BLOCK)
    min_fr = max_fr = 0      # unknown frame sizes (allowed: 0)
    si += bytes([min_fr >> 16, (min_fr >> 8) & 0xFF, min_fr & 0xFF])
    si += bytes([max_fr >> 16, (max_fr >> 8) & 0xFF, max_fr & 0xFF])
    si += bytes([
        (rate >> 12) & 0xFF, (rate >> 4) & 0xFF,
        ((rate & 0xF) << 4) | ((channels - 1) << 1) | ((bps - 1) >> 4),
        (((bps - 1) & 0xF) << 4) | ((nframes >> 32) & 0xF),
        (nframes >> 24) & 0xFF, (nframes >> 16) & 0xFF,
        (nframes >> 8) & 0xFF, nframes & 0xFF])
    si += md5
    out += bytes([0x80]) + struct.pack(">I", len(si))[1:] + si

    for fidx in range(0, max(1, (nframes + BLOCK - 1) // BLOCK)):
        lo = fidx * BLOCK
        blk = x[lo: lo + BLOCK]
        bs = len(blk)
        if bs == 0:
            break
        hdr = bytearray()
        hdr += b"\xFF\xF8"                      # sync + fixed blocksize
        bs_code = 12 if bs == BLOCK else (6 if bs - 1 < 256 else 7)
        sr_code = 0                             # rate from STREAMINFO
        hdr.append((bs_code << 4) | sr_code)
        ch_code = channels - 1
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        hdr.append((ch_code << 4) | (ss_code << 1))
        hdr += _utf8_number(fidx)
        if bs_code == 6:
            hdr.append(bs - 1)
        elif bs_code == 7:
            hdr += struct.pack(">H", bs - 1)
        hdr.append(_crc8(bytes(hdr)))

        bw = _BitWriter()
        for c in range(channels):
            _encode_subframe(bw, blk[:, c], bps)
        bw.align()
        frame = bytes(hdr) + bw.bytes()
        out += frame + struct.pack(">H", _crc16(frame))
    return bytes(out)
