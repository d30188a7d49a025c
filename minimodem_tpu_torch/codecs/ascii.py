"""ASCII 8-bit (and 7-bit) passthrough codec
(reference: src/databits_ascii.c:28-44; 7-bit mode only changes
n_data_bits, reference: src/minimodem.c:670-672)."""

from __future__ import annotations


class Ascii8Codec:
    name = "ascii8"

    def encode(self, byte: int) -> list[int]:
        return [byte & 0xFF]

    def decode(self, bits: int, n_databits: int) -> bytes:
        return bytes([bits & 0xFF])

    def reset(self) -> None:  # stateless
        pass
