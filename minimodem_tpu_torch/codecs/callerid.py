"""Caller-ID (USA SDMF/MDMF) multi-frame decoder.

Behavior-parity with the reference decoder
(reference: src/databits_callerid.c:30-210): collects one byte per frame
until message-length + 2 bytes have arrived, then renders "Time:/Name:/
Phone:" lines.  Decode-only (TX is rejected by the CLI, reference:
src/minimodem.c:849-853).  Like the reference, the checksum byte is NOT
verified (reference: src/databits_callerid.c:192).
"""

from __future__ import annotations

CID_MSG_MDMF = 0x80
CID_MSG_SDMF = 0x04

CID_DATA_DATETIME = 0x01
CID_DATA_PHONE = 0x02
CID_DATA_PHONE_NA = 0x04
CID_DATA_NAME = 0x07
CID_DATA_NAME_NA = 0x08

_DATATYPE_NAMES = [
    "unknown0:", "Time:", "Phone:", "unknown3:",
    "Phone:", "unknown5:", "unknown6:", "Name:",
    "Name:",
]


def _label(datatype: int) -> bytes:
    # C's "%-6s " -- left-justified min-width 6 plus one space
    return ("%-6s " % _DATATYPE_NAMES[datatype]).encode("ascii")


class CallerIdCodec:
    name = "callerid"

    def __init__(self):
        self._msgtype = 0
        self._buf = bytearray()

    def reset(self) -> None:
        self._msgtype = 0
        self._buf.clear()

    def encode(self, byte: int) -> list[int]:
        raise NotImplementedError("callerid --tx mode is not supported")

    def decode(self, bits: int, n_databits: int) -> bytes:
        byte = bits & 0xFF

        if self._msgtype == 0:
            if byte == CID_MSG_MDMF:
                self._msgtype = CID_MSG_MDMF
            elif byte == CID_MSG_SDMF:
                self._msgtype = CID_MSG_SDMF
            else:
                return b""
            self._buf.append(byte)
            return b""

        if len(self._buf) >= 256:
            # buffer overflow: drop the message (reference: :176-179)
            self.reset()
            return b""

        self._buf.append(byte)

        # collect msglen + 2 bytes (type byte + checksum byte)
        msglen = self._buf[1]
        if len(self._buf) < msglen + 2:
            return b""

        out = bytearray(b"CALLER-ID\n")
        if self._msgtype == CID_MSG_MDMF:
            out += self._decode_mdmf()
        else:
            out += self._decode_sdmf()
        self.reset()
        return bytes(out)

    # ------------------------------------------------------------------
    def _decode_mdmf(self) -> bytes:
        out = bytearray()
        msglen = self._buf[1]
        m = 2  # index into buf
        i = 0
        while i < msglen:
            datatype = self._buf[m]; m += 1
            if datatype > CID_DATA_NAME_NA:
                return b""  # bad datastream
            datalen = self._buf[m]; m += 1
            if m + 2 + datalen >= 256:
                return b""  # bad datastream
            out += _label(datatype)

            data = bytes(self._buf[m:m + datalen])
            if datatype == CID_DATA_DATETIME:
                out += b"%s/%s %s:%s\n" % (
                    data[0:2], data[2:4], data[4:6], data[6:8])
            elif datatype == CID_DATA_PHONE and datalen == 10:
                out += b"%s-%s-%s\n" % (data[0:3], data[3:6], data[6:10])
            elif datatype in (CID_DATA_PHONE, CID_DATA_NAME):
                out += data + b"\n"
            elif datatype in (CID_DATA_PHONE_NA, CID_DATA_NAME_NA):
                if datalen == 1 and data == b"O":
                    out += b"[N/A]\n"
                elif datalen == 1 and data == b"P":
                    out += b"[blocked]\n"
                # else: label only, no value line (matches reference)

            m += datalen
            i += datalen + 2
        return bytes(out)

    def _decode_sdmf(self) -> bytes:
        out = bytearray()
        msglen = self._buf[1]
        m = 2
        data = bytes(self._buf[m:m + 8])
        out += _label(CID_DATA_DATETIME)
        out += b"%s/%s %s:%s\n" % (data[0:2], data[2:4], data[4:6], data[6:8])
        m += 8
        out += _label(CID_DATA_PHONE)
        datalen = msglen - 8
        data = bytes(self._buf[m:m + datalen])
        if datalen == 10:
            out += b"%s-%s-%s\n" % (data[0:3], data[3:6], data[6:10])
        else:
            out += data + b"\n"
        return bytes(out)
