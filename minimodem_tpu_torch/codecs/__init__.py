"""Databits codec layer: byte <-> bit-frame encoders/decoders.

Re-implements the reference's pluggable codec interface
(reference: src/databits.h:48-53).  Each codec is a small stateful object:

- ``encode(byte) -> list[int]``   : data words to transmit for one input byte
- ``decode(bits, n_databits) -> bytes`` : output bytes for one received frame
- ``reset()``                     : clear decoder state (the reference's
  "call with dataout_p == NULL" convention, invoked on carrier acquisition,
  reference: src/minimodem.c:1351)

Codecs are host-side byte-state machines; they are deliberately tiny and
sequential (the TPU does the signal processing, not the framing).
"""

from __future__ import annotations

__all__ = [
    "bit_reverse",
    "bit_window",
    "Ascii8Codec",
    "BaudotCodec",
    "BinaryCodec",
    "CallerIdCodec",
    "UicCodec",
    "get_codec",
]


def bit_reverse(value: int, bits: int) -> int:
    """Reverse the low ``bits`` bits of ``value``
    (reference: src/databits.h:21-33)."""
    out = 0
    for _ in range(bits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def bit_window(value: int, offset: int, bits: int) -> int:
    """Extract ``bits`` bits starting ``offset`` bits into ``value``
    (reference: src/databits.h:35-46)."""
    if bits >= 64:
        return value >> offset
    return (value >> offset) & ((1 << bits) - 1)


from .ascii import Ascii8Codec          # noqa: E402
from .baudot import BaudotCodec         # noqa: E402
from .binary import BinaryCodec         # noqa: E402
from .callerid import CallerIdCodec     # noqa: E402
from .uic import UicCodec               # noqa: E402


def get_codec(name: str, **kwargs):
    """Construct a codec by name."""
    table = {
        "ascii8": Ascii8Codec,
        "baudot": BaudotCodec,
        "binary": BinaryCodec,
        "callerid": CallerIdCodec,
        "uic-train": lambda: UicCodec(direction="train"),
        "uic-ground": lambda: UicCodec(direction="ground"),
    }
    try:
        factory = table[name]
    except KeyError:
        raise ValueError(f"unknown codec: {name!r}") from None
    return factory(**kwargs) if kwargs else factory()
