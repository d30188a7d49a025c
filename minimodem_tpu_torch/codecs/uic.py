"""UIC-751-3 ground<->train telegram decoder.

Behavior-parity with the reference decoder (reference: src/databits_uic.c and
src/uic_codes.c): a 39-bit frame carries a 6-nibble train ID plus an 8-bit
message code (stored MSB-first -> bit-reversed before lookup).  Decode-only.
"""

from __future__ import annotations

from . import bit_reverse, bit_window

UIC_GROUND_TO_TRAIN = {
    0x00: "Test",
    0x02: "Run slower",
    0x03: "Extension of telegram",
    0x04: "Run faster",
    0x06: "Written order",
    0x08: "Speech",
    0x09: "Emergency stop",
    0x0C: "Announcem. by loudspeaker",
    0x55: "Idle",
}

UIC_TRAIN_TO_GROUND = {
    0x08: "Communic. desired",
    0x0A: "Acknowl. of order",
    0x06: "Advice",
    0x00: "Test",
    0x09: "Train staff wish to comm.",
    0x0C: "Telephone link desired",
    0x03: "Extension of telegram",
}


class UicCodec:
    name = "uic"

    def __init__(self, direction: str = "ground"):
        # "ground" = ground-to-train message table, "train" = train-to-ground
        if direction not in ("ground", "train"):
            raise ValueError(f"bad UIC direction: {direction!r}")
        self.direction = direction

    def reset(self) -> None:
        pass

    def encode(self, byte: int) -> list[int]:
        raise NotImplementedError("uic-751-3 --tx mode is not supported")

    def decode(self, bits: int, n_databits: int) -> bytes:
        code = bit_reverse(bit_window(bits, 24, 8), 8)
        table = (
            UIC_GROUND_TO_TRAIN if self.direction == "ground"
            else UIC_TRAIN_TO_GROUND
        )
        meaning = table.get(code, "Unknown")
        nibbles = [bit_window(bits, 4 * i, 4) for i in range(6)]
        text = "Train ID: %X%X%X%X%X%X - Message: %02X (%s)\n" % (
            *nibbles, code, meaning)
        return text.encode("ascii")
