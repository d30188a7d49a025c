"""Baudot / ITA2 5-bit codec with LTRS/FIGS shift tracking.

Behavior-parity with the reference Baudot engine
(reference: src/baudot.c:33-185 for the tables, 202-242 for decode,
266-308 for encode, src/databits_baudot.c:26-40 for the frame hook).

The tables below are the standard ITA2 / US-TTY assignments, expressed as a
single declarative table per 5-bit code and expanded into encode/decode maps
at import time.
"""

from __future__ import annotations

import sys

BAUDOT_LTRS = 0x1F
BAUDOT_FIGS = 0x1B
BAUDOT_SPACE = 0x04

# code -> (letters char, U.S. figures char, CCITT No.2 figures char)
# Control codes carry their ASCII control characters; the NUL / FIGS / LTRS
# rows use the reference's debug markers so decoded output matches
# byte-for-byte ('_' for NUL; shift codes are never stuffed).
_ITA2 = {
    0x00: ("_", "^", "^"),          # NUL (debug markers)
    0x01: ("E", "3", "3"),
    0x02: ("\n", "\n", "\n"),       # LF
    0x03: ("A", "-", "-"),
    0x04: (" ", " ", " "),          # SPACE
    0x05: ("S", "\x07", "'"),       # BELL / apostrophe
    0x06: ("I", "8", "8"),
    0x07: ("U", "7", "7"),
    0x08: ("\r", "\r", "\r"),       # CR
    0x09: ("D", "$", "^"),          # '$' / ENQ
    0x0A: ("R", "4", "4"),
    0x0B: ("J", "'", "\x07"),       # apostrophe / BELL
    0x0C: ("N", ",", ","),
    0x0D: ("F", "!", "!"),
    0x0E: ("C", ":", ":"),
    0x0F: ("K", "(", "("),
    0x10: ("T", "5", "5"),
    0x11: ("Z", '"', "+"),
    0x12: ("L", ")", ")"),
    0x13: ("W", "2", "2"),
    0x14: ("H", "#", "%"),          # '#' / pounds symbol
    0x15: ("Y", "6", "6"),
    0x16: ("P", "0", "0"),
    0x17: ("Q", "1", "1"),
    0x18: ("O", "9", "9"),
    0x19: ("B", "?", "?"),
    0x1A: ("G", "&", "&"),
    0x1B: ("%", "%", "%"),          # FIGS shift (debug marker, never stuffed)
    0x1C: ("M", ".", "."),
    0x1D: ("X", "/", "/"),
    0x1E: ("V", ";", "="),
    0x1F: ("%", "%", "%"),          # LTRS shift (debug marker, never stuffed)
}

# charset masks: 1 = reachable in LTRS, 2 = reachable in FIGS, 3 = both
_MASK_LTRS, _MASK_FIGS, _MASK_BOTH = 1, 2, 3


def _build_encode_table() -> dict:
    enc: dict[str, tuple[int, int]] = {}
    # both-charset control codes first
    for code, chars in _ITA2.items():
        ch = chars[0]
        if code in (0x1B, 0x1F):
            continue
        if code == 0x00:
            # NUL encodes as code 0 in either charset; its debug markers
            # '_' and '^' are themselves non-encodable.
            enc["\x00"] = (0x00, _MASK_BOTH)
        elif chars[0] == chars[1] == chars[2]:
            enc[ch] = (code, _MASK_BOTH)
        else:
            enc[ch] = (code, _MASK_LTRS)
            # U.S. figures column is the encodable figures set
            fig = chars[1]
            if fig not in enc:
                enc[fig] = (code, _MASK_FIGS)
    # The reference's encode table maps '+' to code 0x12 (same as ')'),
    # not CCITT2's 0x11 (reference: src/baudot.c:122 "/* + */ {0x12, 2}").
    # Keep that mapping for stream-level interop.
    enc["+"] = (0x12, _MASK_FIGS)
    return enc


_ENCODE = _build_encode_table()


class BaudotCodec:
    """Stateful Baudot codec.

    charset state: 0 unknown, 1 LTRS, 2 FIGS (reference: src/baudot.c:192-197).
    ``usos`` = unshift-on-space (reference: src/baudot.c:201, CLI -u).
    """

    name = "baudot"

    def __init__(self, usos: bool = True):
        self.usos = usos
        self._charset = 0

    # -- decode ---------------------------------------------------------
    def reset(self) -> None:
        self._charset = 1

    def decode(self, bits: int, n_databits: int) -> bytes:
        code = bits & 0x1F
        if code == BAUDOT_FIGS:
            self._charset = 2
            return b""
        if code == BAUDOT_LTRS:
            self._charset = 1
            return b""
        if code == BAUDOT_SPACE and self.usos:
            self._charset = 1
        col = 0 if self._charset == 1 else 1   # unknown state reads as figures
        return _ITA2[code][col].encode("latin-1")

    # -- encode ---------------------------------------------------------
    def encode(self, byte: int) -> list[int]:
        # C applies toupper() first, then rejects chars >= 0x60 or negative
        # (signed char: bytes >= 0x80); reference: src/baudot.c:269-273.
        code_pt = byte & 0xFF
        if 0x61 <= code_pt <= 0x7A:
            code_pt -= 0x20
        if code_pt >= 0x60:
            self._skip_warning(byte)
            return []
        ch = chr(code_pt)
        entry = _ENCODE.get(ch)
        out: list[int] = []
        mask = entry[1] if entry else 0
        if (self._charset & mask) == 0:
            if mask == 0:
                self._skip_warning(byte)
                return []
            if self._charset == 0:
                self._charset = 1
            if mask != _MASK_BOTH:
                self._charset = mask
            out.append(BAUDOT_LTRS if self._charset == 1 else BAUDOT_FIGS)
        out.append(entry[0])
        if ch == " " and self.usos:
            self._charset = 1
        return out

    @staticmethod
    def _skip_warning(byte: int) -> None:
        ch = chr(byte & 0xFF)
        print(
            f"W: baudot skipping non-encodable character '{ch}' 0x{byte & 0xFF:02x}",
            file=sys.stderr,
        )
