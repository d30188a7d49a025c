"""Raw binary codec: each frame prints its bits as '0'/'1' plus newline
(reference: src/databits_binary.c:29-41; selected by --binary-output /
--binary-raw, reference: src/minimodem.c:891-898)."""

from __future__ import annotations


class BinaryCodec:
    name = "binary"

    def encode(self, byte: int) -> list[int]:
        # The reference has no binary encoder wired to TX; provide the
        # obvious passthrough for API completeness.
        return [byte & 0xFF]

    def decode(self, bits: int, n_databits: int) -> bytes:
        out = bytearray()
        for j in range(n_databits):
            out.append(ord("0") + ((bits >> j) & 1))
        out.append(ord("\n"))
        return bytes(out)

    def reset(self) -> None:
        pass
