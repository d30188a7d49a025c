"""PCM-family audio container codecs (reference: src/simpleaudio-sndfile.c).

The reference reaches ~25 container majors through libsndfile's
extension table (src/simpleaudio-sndfile.c:111-157).  This module
implements the PCM-family members as self-contained header codecs around
the same sample pipeline the WAV/AU writers use — byte-deterministic
output, no timestamps, no peak chunks:

  aiff/aif (incl. AIFC fl32/sowt/ulaw/alaw and ima4 Apple-IMA reads),
  caf, w64, rf64, wavex, nist (SPHERE), ircam, pvf, htk, avr, voc,
  svx (IFF/16SV)

  plus mat4/mat5 (MATLAB), paf (Ensoniq PARIS), mpc2k (Akai MPC 2000),
  sd2 (Sound Designer II data fork), sds (MIDI Sample Dump Standard,
  7-bit packetized), wve (Psion A-law), xi (FastTracker 2 instrument,
  16-bit delta PCM)

Compressed/codec containers live elsewhere (flac: native/flacdec.cpp +
sigio/flacenc.py; ogg: sigio/oggvorbis.py).  With these, every major in
the reference's extension table (src/simpleaudio-sndfile.c:111-157) is
covered.  The exotic-container layouts were derived empirically against
libsndfile 1.1.0 and are locked by tests/test_sndfile_interop.py, which
cross-reads real libsndfile output and vice versa.

Each codec provides:
- header(stream, data_nbytes) -> bytes   (placeholder at open, final at
  close; always the same length for a given stream)
- encode(stream, buf) -> bytes           (app samples -> wire bytes)
- sniff(head, ext) -> bool               (read-side detection)
- parse(stream) -> None                  (set rate/channels/_src_dtype/
  _src_bits/_src_fmt_tag/_data_remaining, seek fh to the data start)

Sample conversion conventions follow libsndfile (float <-> PCM via
2^(bits-1) with clip), matching wavfile._encode_pcm/_convert.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import SampleFormat

_PCM = 1        # mirrors wavfile._WAVE_FORMAT_PCM
_FLOAT = 3      # mirrors wavfile._WAVE_FORMAT_IEEE_FLOAT


# ---------------------------------------------------------------- helpers
def _quantize16(buf: np.ndarray) -> np.ndarray:
    """float [-1,1] -> int16, libsndfile convention (scale 2^15, clip)."""
    v = np.rint(np.asarray(buf, np.float64) * 32768.0)
    return np.clip(v, -32768, 32767).astype(np.int16)


def _wire(stream, buf: np.ndarray, dtype: str) -> bytes:
    """App samples -> the container's wire encoding."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        if stream.format is SampleFormat.S16:
            buf = np.asarray(buf, np.float32) / np.float32(32768.0)
        return np.asarray(buf, np.float32).astype(dt).tobytes()
    if stream.format is SampleFormat.FLOAT:
        buf = _quantize16(buf)
    return np.asarray(buf, np.int16).astype(dt).tobytes()


def _ext80(rate: float) -> bytes:
    """80-bit IEEE extended float, for the AIFF COMM sample rate."""
    if rate == 0:
        return b"\x00" * 10
    m = int(rate)
    e = 16383 + 63
    while m < (1 << 63):
        m <<= 1
        e -= 1
    return struct.pack(">HQ", e, m)


def _from_ext80(raw: bytes) -> int:
    e, m = struct.unpack(">HQ", raw)
    if e == 0 and m == 0:
        return 0
    return int(round(m * 2.0 ** (e - 16383 - 63)))


def _u32(x: int) -> bytes:
    return struct.pack(">I", x)


class _Codec:
    name = ""
    exts: tuple = ()

    def header(self, stream, data_nbytes: int) -> bytes:
        raise NotImplementedError

    def encode(self, stream, buf: np.ndarray) -> bytes:
        raise NotImplementedError

    def sniff(self, head: bytes, ext: str) -> bool:
        return False

    def parse(self, stream) -> None:
        raise NotImplementedError


def _set_src(stream, rate, channels, dtype, bits, fmt_tag, remaining):
    stream.rate = rate
    stream.channels = channels
    stream._src_dtype = dtype
    stream._src_bits = bits
    stream._src_fmt_tag = fmt_tag
    stream._data_remaining = remaining


def _set_mem_src(stream, vals: np.ndarray, rate: int,
                 channels: int = 1) -> None:
    """Decoded-in-memory source (codecs whose wire format can't be
    streamed by wavfile._read): the full sample array plus the same
    source fields _set_src establishes."""
    stream.rate = rate
    stream.channels = channels
    stream._mem_buf = vals
    stream._mem_pos = 0
    stream._src_dtype = "mem"
    stream._src_bits = 16
    stream._src_fmt_tag = _PCM
    stream._data_remaining = vals.nbytes


def _file_size(stream) -> int:
    return os.fstat(stream._fh.fileno()).st_size


# ------------------------------------------------------------------- AIFF
class Aiff(_Codec):
    """AIFF / AIFC.  PCM16 big-endian; float32 written as AIFC 'fl32'.
    Reads NONE/twos (BE PCM), sowt (LE PCM16), fl32/FL32 (BE float)."""

    name = "aiff"
    exts = ("aiff", "aif")

    def header(self, stream, data_nbytes: int) -> bytes:
        ch = stream.channels
        is_float = stream.format is SampleFormat.FLOAT
        bits = 32 if is_float else 16
        nframes = data_nbytes // (ch * bits // 8) if ch else 0
        if is_float:
            # pascal-string name "float32": count byte + 7 chars = 8 (even)
            comm = struct.pack(">hLh", ch, nframes, bits) + \
                _ext80(stream.rate) + b"fl32" + b"\x07float32"
            body = (b"FVER" + _u32(4) + _u32(0xA2805140)
                    + b"COMM" + _u32(len(comm)) + comm)
            form_type = b"AIFC"
        else:
            comm = struct.pack(">hLh", ch, nframes, bits) + \
                _ext80(stream.rate)
            body = b"COMM" + _u32(len(comm)) + comm
            form_type = b"AIFF"
        body += b"SSND" + _u32(data_nbytes + 8) + _u32(0) + _u32(0)
        return (b"FORM" + _u32(4 + len(body) + data_nbytes) + form_type
                + body)

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = ">f4" if stream.format is SampleFormat.FLOAT else ">i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC")

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(4)
        (_form_size,) = struct.unpack(">I", fh.read(4))
        fh.read(4)  # AIFF/AIFC
        comm = None
        compression = b"NONE"
        ssnd = None                        # (data_pos, data_nbytes)
        while comm is None or ssnd is None:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack(">4sI", hdr)
            if cid == b"COMM":
                body = fh.read(csize + (csize & 1))
                comm = struct.unpack(">hLh", body[:8])
                rate = _from_ext80(body[8:18])
                if csize > 18:
                    compression = body[18:22]
            elif cid == b"SSND":
                # SSND may legally precede COMM: remember the data run
                # and keep scanning
                off, _blk = struct.unpack(">II", fh.read(8))
                ssnd = (fh.tell() + off, csize - 8 - off)
                fh.seek(csize - 8 + (csize & 1), 1)
            else:
                fh.seek(csize + (csize & 1), 1)
        if comm is None:
            raise RuntimeError(f"{stream.path}: no COMM chunk")
        if ssnd is None:
            raise RuntimeError(f"{stream.path}: no SSND chunk")
        fh.seek(ssnd[0])
        data_nbytes = ssnd[1]
        ch, _nframes, bits = comm
        if compression in (b"fl32", b"FL32"):
            _set_src(stream, rate, ch, np.dtype(">f4"), 32, _FLOAT,
                     data_nbytes)
        elif compression == b"sowt":
            _set_src(stream, rate, ch, np.dtype("<i2"), 16, _PCM,
                     data_nbytes)
        elif compression in (b"NONE", b"twos"):
            dt = {8: np.dtype(np.int8), 16: np.dtype(">i2"),
                  32: np.dtype(">i4")}.get(bits)
            if dt is None:
                raise RuntimeError(
                    f"{stream.path}: unsupported AIFF bit depth {bits}")
            _set_src(stream, rate, ch, dt, bits, _PCM, data_nbytes)
        elif compression == b"raw ":
            # AIFC 'raw ': unsigned 8-bit (libsndfile's PCM_U8 in AIFF)
            _set_src(stream, rate, ch, np.dtype(np.uint8), 8, _PCM,
                     data_nbytes)
        elif compression in (b"ulaw", b"ULAW"):
            # G.711 bytes decoded by wavfile._read's companded branch
            _set_src(stream, rate, ch, "ulaw", 16, 7, data_nbytes)
        elif compression in (b"alaw", b"ALAW"):
            _set_src(stream, rate, ch, "alaw", 16, 6, data_nbytes)
        elif compression == b"ima4":
            # Apple IMA: decode the whole SSND up front (wavfile's
            # vectorized packet decoder) and serve reads from memory.
            # COMM numSampleFrames counts packets here and libsndfile
            # returns whole decoded blocks — match sf_readf_float
            from .wavfile import _ima4_decode
            data = fh.read(data_nbytes)
            vals = _ima4_decode(data, max(ch, 1))
            stream.rate = rate
            stream.channels = ch
            stream._src_bits = 16
            stream._src_fmt_tag = 0x11
            stream._mem_buf = stream._convert(vals, src_bits=16)
            stream._mem_pos = 0
            stream._src_dtype = "mem"
            stream._data_remaining = stream._mem_buf.nbytes
        elif compression == b"GSM ":
            # GSM 6.10, plain 33-byte frames (no WAV49 two-frame
            # packing outside WAV/W64); libsndfile trims the decoded
            # run to COMM's numSampleFrames — match it
            from .wavfile import _gsm610_decode
            data = fh.read(data_nbytes)
            vals = _gsm610_decode(data, wav49=False)
            vals = vals[: _nframes * max(ch, 1)]
            stream.rate = rate
            stream.channels = ch
            stream._src_bits = 16
            stream._src_fmt_tag = 0x31
            stream._mem_buf = stream._convert(vals, src_bits=16)
            stream._mem_pos = 0
            stream._src_dtype = "mem"
            stream._data_remaining = stream._mem_buf.nbytes
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported AIFC compression "
                f"{compression!r}")


# -------------------------------------------------------------------- CAF
class Caf(_Codec):
    """Apple Core Audio Format: 'lpcm' little-endian int16 or float32
    (formatFlags bit0=float, bit1=littleEndian).  Reads both endiannesses
    at 16/32 bits.  Layout: Apple CAF spec chapter 2."""

    name = "caf"
    exts = ("caf",)

    def header(self, stream, data_nbytes: int) -> bytes:
        ch = stream.channels
        is_float = stream.format is SampleFormat.FLOAT
        bits = 32 if is_float else 16
        flags = (1 if is_float else 0) | 2          # little-endian
        bpp = ch * bits // 8
        desc = struct.pack(">d4sIIIII", float(stream.rate), b"lpcm",
                           flags, bpp, 1, ch, bits)
        out = b"caff" + struct.pack(">HH", 1, 0)
        out += b"desc" + struct.pack(">q", len(desc)) + desc
        out += b"data" + struct.pack(">q", 4 + data_nbytes) + _u32(0)
        return out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"caff"

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(8)
        desc = None
        while True:
            hdr = fh.read(12)
            if len(hdr) < 12:
                raise RuntimeError(f"{stream.path}: no data chunk")
            cid, csize = struct.unpack(">4sq", hdr)
            if cid == b"desc":
                desc = struct.unpack(">d4sIIIII", fh.read(32))
            elif cid == b"data":
                fh.read(4)  # editCount
                if csize < 0:  # unknown length: rest of file
                    csize = _file_size(stream) - fh.tell() + 4
                data_nbytes = csize - 4
                break
            else:
                fh.seek(csize, 1)
        if desc is None:
            raise RuntimeError(f"{stream.path}: no desc chunk")
        rate, fmt_id, flags, _bpp, _fpp, ch, bits = desc
        if fmt_id == b"ulaw":
            _set_src(stream, int(rate), ch, "ulaw", 16, 7, data_nbytes)
            return
        if fmt_id == b"alaw":
            _set_src(stream, int(rate), ch, "alaw", 16, 6, data_nbytes)
            return
        if fmt_id != b"lpcm":
            raise RuntimeError(
                f"{stream.path}: unsupported CAF codec {fmt_id!r}")
        le = bool(flags & 2)
        bo = "<" if le else ">"
        if flags & 1:
            if bits != 32:
                raise RuntimeError(
                    f"{stream.path}: unsupported CAF float depth {bits}")
            dt = np.dtype(bo + "f4")
            tag = _FLOAT
        else:
            dt = {8: np.dtype(np.int8), 16: np.dtype(bo + "i2"),
                  32: np.dtype(bo + "i4")}.get(bits)
            if dt is None:
                raise RuntimeError(
                    f"{stream.path}: unsupported CAF bit depth {bits}")
            tag = _PCM
        _set_src(stream, int(rate), ch, dt, bits, tag, data_nbytes)


# -------------------------------------------------------------------- W64
_W64_RIFF = bytes.fromhex("726966662E91CF11A5D628DB04C10000")
_W64_WAVE = bytes.fromhex("77617665F3ACD3118CD100C04F8EDB8A")
_W64_FMT = bytes.fromhex("666D7420F3ACD3118CD100C04F8EDB8A")
_W64_DATA = bytes.fromhex("64617461F3ACD3118CD100C04F8EDB8A")


class W64(_Codec):
    """Sony Wave64: WAV's fmt struct inside 16-byte-GUID / 64-bit-size
    chunks (sizes include the 24-byte chunk header, bodies 8-aligned)."""

    name = "w64"
    exts = ("w64",)

    def _fmt_body(self, stream) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        bits = 32 if is_float else 16
        ba = bits // 8 * stream.channels
        return struct.pack("<HHIIHH", _FLOAT if is_float else _PCM,
                           stream.channels, stream.rate, stream.rate * ba,
                           ba, bits)

    def header(self, stream, data_nbytes: int) -> bytes:
        # fmt body is 16 bytes, so the next chunk starts 8-aligned after
        # size 24 + 16 = 40 with no pad
        out = _W64_FMT + struct.pack("<q", 24 + 16) + self._fmt_body(stream)
        out += _W64_DATA + struct.pack("<q", 24 + data_nbytes)
        total = 16 + 8 + 16 + len(out) + data_nbytes
        return _W64_RIFF + struct.pack("<q", total) + _W64_WAVE + out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:16] == _W64_RIFF

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(40)  # riff GUID + size + wave GUID
        fmt = None
        while True:
            hdr = fh.read(24)
            if len(hdr) < 24:
                raise RuntimeError(f"{stream.path}: no data chunk")
            guid, csize = hdr[:16], struct.unpack("<q", hdr[16:])[0]
            body = csize - 24
            if guid == _W64_FMT:
                fmt_raw = fh.read(body)
                fmt = struct.unpack("<HHIIHH", fmt_raw[:16])
                fh.seek((-csize) % 8, 1)
            elif guid == _W64_DATA:
                data_nbytes = body
                break
            else:
                fh.seek(body + ((-csize) % 8), 1)
        if fmt is None:
            raise RuntimeError(f"{stream.path}: no fmt chunk")
        tag, ch, rate, _br, block_align, bits = fmt
        if tag == 7:                   # G.711 u-law
            _set_src(stream, rate, ch, "ulaw", 16, 7, data_nbytes)
            return
        if tag == 6:                   # G.711 A-law
            _set_src(stream, rate, ch, "alaw", 16, 6, data_nbytes)
            return
        if tag in (0x11, 0x02):        # IMA / MS ADPCM, as in WAV
            from .wavfile import (
                _MS_COEF_DEFAULT,
                _ima_decode,
                _ms_decode,
            )
            nch = max(ch, 1)
            ext = fmt_raw[16:]
            if len(ext) >= 4:
                spb = struct.unpack("<H", ext[2:4])[0]
            elif tag == 0x11:
                spb = (block_align - 4 * nch) * 2 // nch + 1
            else:
                spb = (block_align - 7 * nch) * 2 // nch + 2
            data = fh.read(data_nbytes)
            if tag == 0x11:
                vals = _ima_decode(data, block_align, nch, spb)
            else:
                coefs = _MS_COEF_DEFAULT
                if len(ext) >= 6:
                    ncoef = struct.unpack("<H", ext[4:6])[0]
                    if ncoef and len(ext) >= 6 + 4 * ncoef:
                        coefs = [struct.unpack_from("<hh", ext, 6 + 4 * i)
                                 for i in range(ncoef)]
                vals = _ms_decode(data, block_align, nch, spb, coefs)
            stream.rate = rate
            stream.channels = ch
            stream._src_bits = 16
            stream._src_fmt_tag = tag
            stream._mem_buf = stream._convert(vals, src_bits=16)
            stream._mem_pos = 0
            stream._src_dtype = "mem"
            stream._data_remaining = stream._mem_buf.nbytes
            return
        if tag == 0x31:                # GSM 6.10, WAV49 packing as in WAV
            from .wavfile import _gsm610_decode
            data = fh.read(data_nbytes)
            vals = _gsm610_decode(data, wav49=True)
            stream.rate = rate
            stream.channels = ch
            stream._src_bits = 16
            stream._src_fmt_tag = tag
            stream._mem_buf = stream._convert(vals, src_bits=16)
            stream._mem_pos = 0
            stream._src_dtype = "mem"
            stream._data_remaining = stream._mem_buf.nbytes
            return
        if tag == _FLOAT:
            dt = np.dtype("<f4") if bits == 32 else np.dtype("<f8")
        elif tag == _PCM and bits == 8:
            dt = np.dtype(np.uint8)
        elif tag == _PCM and bits in (16, 32):
            dt = np.dtype(f"<i{bits // 8}")
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported W64 format {tag}/{bits}")
        _set_src(stream, rate, ch, dt, bits, tag, data_nbytes)


# ------------------------------------------------------------------- RF64
class Rf64(_Codec):
    """EBU RF64: RIFF with 64-bit sizes carried in a ds64 chunk
    (EBU tech 3306).  Written unconditionally as RF64 (sizes in ds64,
    riff/data sizes set to 0xFFFFFFFF), like libsndfile's .rf64."""

    name = "rf64"
    exts = ("rf64",)

    def _fmt_body(self, stream) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        bits = 32 if is_float else 16
        ba = bits // 8 * stream.channels
        return struct.pack("<HHIIHH", _FLOAT if is_float else _PCM,
                           stream.channels, stream.rate, stream.rate * ba,
                           ba, bits)

    def header(self, stream, data_nbytes: int) -> bytes:
        fmt_body = self._fmt_body(stream)
        bits = 32 if stream.format is SampleFormat.FLOAT else 16
        nframes = data_nbytes // (bits // 8 * stream.channels) \
            if stream.channels else 0

        def chunks(riff_size: int) -> bytes:
            ds64 = struct.pack("<qqqI", riff_size, data_nbytes, nframes,
                               0)
            out = b"ds64" + struct.pack("<I", len(ds64)) + ds64
            out += b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            out += b"data" + struct.pack("<I", 0xFFFFFFFF)
            return out

        riff_size = 4 + len(chunks(0)) + data_nbytes
        return (b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                + chunks(riff_size))

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"RF64" and head[8:12] == b"WAVE"

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(12)
        fmt = None
        data64 = None
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                raise RuntimeError(f"{stream.path}: no data chunk")
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"ds64":
                body = fh.read(csize + (csize & 1))
                _riff64, data64, _n64, _tbl = struct.unpack(
                    "<qqqI", body[:28])
            elif cid == b"fmt ":
                fmt_raw = fh.read(csize + (csize & 1))
                fmt = struct.unpack("<HHIIHH", fmt_raw[:16])
            elif cid == b"data":
                data_nbytes = csize if csize != 0xFFFFFFFF else data64
                if data_nbytes is None:
                    raise RuntimeError(f"{stream.path}: RF64 missing ds64")
                break
            else:
                fh.seek(csize + (csize & 1), 1)
        if fmt is None:
            raise RuntimeError(f"{stream.path}: no fmt chunk")
        tag, ch, rate, _br, _ba, bits = fmt
        if tag == 0xFFFE and len(fmt_raw) >= 26:
            # WAVE_FORMAT_EXTENSIBLE: the real tag leads the SubFormat
            # GUID (same handling as wavfile._parse_wav)
            (tag,) = struct.unpack("<H", fmt_raw[24:26])
        if tag == 7:                   # G.711 u-law
            _set_src(stream, rate, ch, "ulaw", 16, 7, data_nbytes)
            return
        if tag == 6:                   # G.711 A-law
            _set_src(stream, rate, ch, "alaw", 16, 6, data_nbytes)
            return
        if tag == _FLOAT:
            dt = np.dtype("<f4") if bits == 32 else np.dtype("<f8")
        elif tag == _PCM and bits == 8:
            dt = np.dtype(np.uint8)
        elif tag == _PCM and bits in (16, 32):
            dt = np.dtype(f"<i{bits // 8}")
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported RF64 format {tag}/{bits}")
        _set_src(stream, rate, ch, dt, bits, tag, data_nbytes)


# ------------------------------------------------------------------ WAVEX
_KSDATAFORMAT_PCM = bytes.fromhex("0100000000001000800000aa00389b71")
_KSDATAFORMAT_FLOAT = bytes.fromhex("0300000000001000800000aa00389b71")


class Wavex(_Codec):
    """WAV with a WAVE_FORMAT_EXTENSIBLE fmt chunk, always (what
    libsndfile's SF_FORMAT_WAVEX major does).  Reading EXTENSIBLE files
    is already handled by the plain WAV parser (wavfile._parse_wav)."""

    name = "wavex"
    exts = ("wavex",)

    def header(self, stream, data_nbytes: int) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        bits = 32 if is_float else 16
        ba = bits // 8 * stream.channels
        sub = _KSDATAFORMAT_FLOAT if is_float else _KSDATAFORMAT_PCM
        fmt_body = struct.pack(
            "<HHIIHHHHI", 0xFFFE, stream.channels, stream.rate,
            stream.rate * ba, ba, bits, 22, bits,
            0x4 if stream.channels == 1 else 0x3) + sub
        chunks = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
        if is_float:
            chunks += b"fact" + struct.pack(
                "<II", 4, data_nbytes // ba if ba else 0)
        chunks += b"data" + struct.pack("<I", data_nbytes)
        riff_size = 4 + len(chunks) + data_nbytes
        return struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE") + chunks

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    # read side: RIFF magic routes to wavfile._parse_wav, never here


# ---------------------------------------------------------- NIST / SPHERE
class Nist(_Codec):
    """NIST SPHERE: 1024-byte ASCII header + PCM16 little-endian."""

    name = "nist"
    exts = ("nist", "sph")

    def header(self, stream, data_nbytes: int) -> bytes:
        nframes = data_nbytes // (2 * stream.channels) \
            if stream.channels else 0
        fields = (
            f"sample_rate -i {stream.rate}\n"
            f"channel_count -i {stream.channels}\n"
            f"sample_n_bytes -i 2\n"
            f"sample_byte_format -s2 01\n"
            f"sample_sig_bits -i 16\n"
            f"sample_coding -s3 pcm\n"
            f"sample_count -i {nframes}\n"
            "end_head\n")
        head = "NIST_1A\n   1024\n" + fields
        return head.encode().ljust(1024, b" ")

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, "<i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:8] == b"NIST_1A\n"

    def parse(self, stream) -> None:
        fh = stream._fh
        head = fh.read(1024).decode("ascii", "replace")
        kv = {}
        for line in head.splitlines():
            parts = line.split()
            if len(parts) >= 3 and parts[1].startswith("-"):
                kv[parts[0]] = parts[2]
            if line.strip() == "end_head":
                break
        rate = int(kv.get("sample_rate", 0))
        ch = int(kv.get("channel_count", 1))
        nbytes_per = int(kv.get("sample_n_bytes", 2))
        byte_fmt = kv.get("sample_byte_format", "01")
        coding = kv.get("sample_coding", "pcm")
        count = int(kv.get("sample_count", 0))
        remaining = count * ch * nbytes_per if count \
            else _file_size(stream) - 1024
        if coding.startswith("ulaw") or coding.startswith("mu-law"):
            _set_src(stream, rate, ch, "ulaw", 16, 7, remaining)
            return
        if coding.startswith("alaw"):
            _set_src(stream, rate, ch, "alaw", 16, 6, remaining)
            return
        if not coding.startswith("pcm") or nbytes_per not in (1, 2):
            raise RuntimeError(
                f"{stream.path}: unsupported SPHERE coding "
                f"{coding}/{nbytes_per * 8}-bit")
        if nbytes_per == 1:            # signed 8-bit linear
            _set_src(stream, rate, ch, np.dtype(np.int8), 8, _PCM,
                     remaining)
            return
        bo = "<" if byte_fmt == "01" else ">"
        _set_src(stream, rate, ch, np.dtype(bo + "i2"), 16, _PCM,
                 remaining)


# ------------------------------------------------------------------ IRCAM
# four historical IRCAM magic variants (VAX/Sun/MIPS/NeXT); libsndfile
# writes 0x0003A364 little-endian and 0x0002A364 big-endian
_IRCAM_MAGICS = (0x0001A364, 0x0002A364, 0x0003A364, 0x0004A364)
_IRCAM_BE = 0x0001A364
_IRCAM_PCM16 = 0x00002
_IRCAM_FLOAT = 0x00004
_IRCAM_ALAW = 0x10001
_IRCAM_ULAW = 0x20001


class Ircam(_Codec):
    """IRCAM/BICSF: 1024-byte header (magic, rate f32, channels u32,
    encoding u32), PCM16 or float32; written big-endian."""

    name = "ircam"
    exts = ("ircam", "sf")

    def header(self, stream, data_nbytes: int) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        enc = _IRCAM_FLOAT if is_float else _IRCAM_PCM16
        head = struct.pack(">IfII", _IRCAM_BE, float(stream.rate),
                           stream.channels, enc)
        return head.ljust(1024, b"\x00")

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = ">f4" if stream.format is SampleFormat.FLOAT else ">i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        (m_be,) = struct.unpack(">I", head[:4])
        (m_le,) = struct.unpack("<I", head[:4])
        return m_be in _IRCAM_MAGICS or m_le in _IRCAM_MAGICS

    def parse(self, stream) -> None:
        fh = stream._fh
        raw = fh.read(16)
        (m_be,) = struct.unpack(">I", raw[:4])
        bo = ">" if m_be in _IRCAM_MAGICS else "<"
        rate, ch, enc = struct.unpack(bo + "fII", raw[4:16])
        fh.seek(1024)
        remaining = _file_size(stream) - 1024
        if enc == _IRCAM_PCM16:
            _set_src(stream, int(round(rate)), ch, np.dtype(bo + "i2"),
                     16, _PCM, remaining)
        elif enc == _IRCAM_FLOAT:
            _set_src(stream, int(round(rate)), ch, np.dtype(bo + "f4"),
                     32, _FLOAT, remaining)
        elif enc == _IRCAM_ULAW:
            _set_src(stream, int(round(rate)), ch, "ulaw", 16, 7,
                     remaining)
        elif enc == _IRCAM_ALAW:
            _set_src(stream, int(round(rate)), ch, "alaw", 16, 6,
                     remaining)
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported IRCAM encoding {enc:#x}")


# -------------------------------------------------------------------- PVF
class Pvf(_Codec):
    """Portable Voice Format: ASCII 'PVF1' header, big-endian PCM."""

    name = "pvf"
    exts = ("pvf",)

    def header(self, stream, data_nbytes: int) -> bytes:
        return (f"PVF1\n{stream.channels} {stream.rate} 16\n"
                .encode("ascii"))

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, ">i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:5] == b"PVF1\n"

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.readline()                    # PVF1
        parts = fh.readline().split()
        ch, rate, bits = int(parts[0]), int(parts[1]), int(parts[2])
        dt = {8: np.dtype(np.int8), 16: np.dtype(">i2"),
              32: np.dtype(">i4")}.get(bits)
        if dt is None:
            raise RuntimeError(
                f"{stream.path}: unsupported PVF bit depth {bits}")
        remaining = _file_size(stream) - fh.tell()
        _set_src(stream, rate, ch, dt, bits, _PCM, remaining)


# -------------------------------------------------------------------- HTK
class Htk(_Codec):
    """HTK waveform: 12-byte big-endian header (nSamples, samplePeriod in
    100 ns units, sampleSize bytes, parmKind 0=WAVEFORM), PCM16 BE, mono.
    No magic — detected by .htk extension."""

    name = "htk"
    exts = ("htk",)

    def header(self, stream, data_nbytes: int) -> bytes:
        n = data_nbytes // 2
        period = round(1e7 / stream.rate) if stream.rate else 0
        return struct.pack(">IIHH", n, period, 2, 0)

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, ">i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        if ext != "htk" or len(head) < 12:
            return False
        _n, period, size, kind = struct.unpack(">IIHH", head[:12])
        return kind == 0 and size == 2 and period > 0

    def parse(self, stream) -> None:
        fh = stream._fh
        n, period, size, kind = struct.unpack(">IIHH", fh.read(12))
        if kind != 0 or size != 2:
            raise RuntimeError(
                f"{stream.path}: unsupported HTK sample kind {kind}")
        rate = int(round(1e7 / period)) if period else 0
        _set_src(stream, rate, 1, np.dtype(">i2"), 16, _PCM, n * 2)


# -------------------------------------------------------------------- AVR
class Avr(_Codec):
    """Audio Visual Research: 128-byte big-endian header, PCM16 BE."""

    name = "avr"
    exts = ("avr",)

    def header(self, stream, data_nbytes: int) -> bytes:
        nframes = data_nbytes // (2 * stream.channels) \
            if stream.channels else 0
        stereo = 0xFFFF if stream.channels == 2 else 0
        return struct.pack(
            ">4s8sHHHHHIIII", b"2BIT", b"\x00" * 8, stereo, 16, 0xFFFF,
            0, 0, stream.rate & 0x00FFFFFF, nframes, 0, 0) \
            + b"\x00" * (128 - 38)

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, ">i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"2BIT"

    def parse(self, stream) -> None:
        fh = stream._fh
        raw = fh.read(128)
        _magic, _name, stereo, rez, sign, _loop, _midi, rate, nframes, \
            _lbeg, _lend = struct.unpack(">4s8sHHHHHIIII", raw[:38])
        signed = sign == 0xFFFF
        if rez == 16 and signed:
            dt = np.dtype(">i2")
        elif rez == 8:
            dt = np.dtype(np.int8) if signed else np.dtype(np.uint8)
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported AVR sample format "
                f"({rez}-bit, signed={sign:#x})")
        ch = 2 if stereo else 1
        _set_src(stream, rate & 0x00FFFFFF, ch, dt, rez, _PCM,
                 nframes * ch * (rez // 8))


# -------------------------------------------------------------------- VOC
class Voc(_Codec):
    """Creative Voice: 26-byte header + block 9 (format 4 = PCM16 LE)
    + terminator block 0 on close."""

    name = "voc"
    exts = ("voc",)

    _MAGIC = b"Creative Voice File\x1a"

    def header(self, stream, data_nbytes: int) -> bytes:
        version = 0x0114
        check = (~version + 0x1234) & 0xFFFF
        out = self._MAGIC + struct.pack("<HHH", 26, version, check)
        bsize = 12 + data_nbytes
        if bsize > 0xFFFFFF:
            raise RuntimeError(
                "VOC block size field is 24-bit; audio exceeds "
                f"{(0xFFFFFF - 12) // (2 * stream.channels)} frames "
                "— use a WAV/AU/FLAC container for long recordings")
        out += b"\x09" + struct.pack("<I", bsize)[:3]
        out += struct.pack("<IBBH4x", stream.rate, 16, stream.channels, 4)
        return out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, "<i2")

    def trailer(self, stream) -> bytes:
        # Terminator block 0, appended after the sample data and NOT
        # counted in the block-9 24-bit size field (libsndfile voc.c
        # writes the same byte on close).
        return b"\x00"

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:20] == self._MAGIC

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(20)
        (hsize,) = struct.unpack("<H", fh.read(2))
        fh.seek(hsize)
        while True:
            btype = fh.read(1)
            if not btype or btype == b"\x00":
                raise RuntimeError(f"{stream.path}: no VOC sound block")
            (bsize,) = struct.unpack("<I", fh.read(3) + b"\x00")
            if btype == b"\x09":
                rate, bits, ch, fmt = struct.unpack("<IBBH4x", fh.read(12))
                if fmt == 4 and bits == 16:
                    _set_src(stream, rate, ch, np.dtype("<i2"), 16,
                             _PCM, bsize - 12)
                elif fmt == 7 and bits == 8:        # G.711 u-law
                    _set_src(stream, rate, ch, "ulaw", 16, 7, bsize - 12)
                elif fmt == 6 and bits == 8:        # G.711 A-law
                    _set_src(stream, rate, ch, "alaw", 16, 6, bsize - 12)
                elif fmt == 0 and bits == 8:        # unsigned 8-bit
                    _set_src(stream, rate, ch, np.dtype(np.uint8), 8,
                             _PCM, bsize - 12)
                else:
                    raise RuntimeError(
                        f"{stream.path}: unsupported VOC format "
                        f"{fmt}/{bits}-bit")
                return
            if btype == b"\x01":
                # legacy Sound Data block: u8 rate-divisor code + codec
                div, codec = struct.unpack("<BB", fh.read(2))
                if codec != 0:
                    raise RuntimeError(
                        f"{stream.path}: unsupported VOC codec {codec}")
                # libsndfile 1.1.0 computes this with C integer division
                # (truncation, not rounding) — match it exactly, since the
                # rate drives demod geometry (decision-exact parity).
                rate = 1_000_000 // (256 - div)
                _set_src(stream, rate, 1, np.dtype(np.uint8), 8, _PCM,
                         bsize - 2)
                return
            fh.seek(bsize, 1)


# -------------------------------------------------------------------- SVX
class Svx(_Codec):
    """Amiga IFF 16SV (16-bit) / 8SVX (8-bit read): VHDR + BODY, PCM BE,
    mono."""

    name = "svx"
    exts = ("svx", "iff")

    def header(self, stream, data_nbytes: int) -> bytes:
        nframes = data_nbytes // 2
        if stream.rate > 0xFFFF:
            raise RuntimeError(
                f"SVX sample-rate field is 16-bit; {stream.rate} Hz "
                "does not fit — use a WAV/AU/FLAC container")
        vhdr = struct.pack(">IIIHBBI", nframes, 0, 32, stream.rate,
                           1, 0, 1 << 16)
        body = b"VHDR" + _u32(len(vhdr)) + vhdr
        body += b"BODY" + _u32(data_nbytes)
        return b"FORM" + _u32(4 + len(body) + data_nbytes) + b"16SV" + body

    def encode(self, stream, buf: np.ndarray) -> bytes:
        if stream.channels != 1:
            raise RuntimeError("SVX supports mono only")
        return _wire(stream, buf, ">i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"FORM" and head[8:12] in (b"16SV", b"8SVX")

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(8)
        form = fh.read(4)
        bits = 16 if form == b"16SV" else 8
        rate = 0
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                raise RuntimeError(f"{stream.path}: no BODY chunk")
            cid, csize = struct.unpack(">4sI", hdr)
            if cid == b"VHDR":
                body = fh.read(csize + (csize & 1))
                rate = struct.unpack(">H", body[12:14])[0]
            elif cid == b"BODY":
                data_nbytes = csize
                break
            else:
                fh.seek(csize + (csize & 1), 1)
        dt = np.dtype(">i2") if bits == 16 else np.dtype(np.int8)
        _set_src(stream, rate, 1, dt, bits, _PCM, data_nbytes)


# ------------------------------------------------------------------- MAT4
class Mat4(_Codec):
    """MATLAB level-4 MAT-file: two little-endian matrices, the layout
    libsndfile's SF_FORMAT_MAT4 uses — 'samplerate' (1x1 double) then
    'wavedata' (channels x frames; column-major = interleaved).  MOPT
    type code: P digit 0=double 1=single 3=int16."""

    name = "mat4"
    exts = ("mat4",)

    def _p_digit(self, stream) -> int:
        return 1 if stream.format is SampleFormat.FLOAT else 3

    def header(self, stream, data_nbytes: int) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        itemsize = 4 if is_float else 2
        frames = data_nbytes // (itemsize * stream.channels) \
            if stream.channels else 0
        out = struct.pack("<5i", 0, 1, 1, 0, 11) + b"samplerate\x00"
        out += struct.pack("<d", float(stream.rate))
        out += struct.pack("<5i", self._p_digit(stream) * 10,
                           stream.channels, frames, 0, 9) + b"wavedata\x00"
        return out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        if ext != "mat4" or len(head) < 20:
            return False
        t, mrows, ncols, imagf, namlen = struct.unpack("<5i", head[:20])
        return (0 <= t < 5000 and t % 10 == 0 and imagf in (0, 1)
                and 0 < namlen < 64 and mrows >= 0 and ncols >= 0)

    def parse(self, stream) -> None:
        fh = stream._fh
        rate = 0
        while True:
            hdr = fh.read(20)
            if len(hdr) < 20:
                raise RuntimeError(f"{stream.path}: no wavedata matrix")
            t, mrows, ncols, _imagf, namlen = struct.unpack("<5i", hdr)
            name = fh.read(namlen).rstrip(b"\x00").decode("ascii",
                                                          "replace")
            p = (t // 10) % 10
            itemsize = {0: 8, 1: 4, 2: 4, 3: 2, 4: 2, 5: 1}[p]
            nbytes = mrows * ncols * itemsize
            if name == "samplerate":
                if p != 0 or mrows * ncols != 1:
                    raise RuntimeError(
                        f"{stream.path}: malformed samplerate matrix")
                (rate,) = struct.unpack("<d", fh.read(8))
            elif name == "wavedata":
                dt = {0: "<f8", 1: "<f4", 2: "<i4", 3: "<i2"}.get(p)
                if dt is None:
                    raise RuntimeError(
                        f"{stream.path}: unsupported MAT4 type {t}")
                dtype = np.dtype(dt)
                tag = _FLOAT if dtype.kind == "f" else _PCM
                _set_src(stream, int(round(rate)), mrows, dtype,
                         dtype.itemsize * 8 if tag == _PCM else 32,
                         tag, nbytes)
                return
            else:
                fh.seek(nbytes, 1)


# ------------------------------------------------------------------- MAT5
_MI_INT8 = 1
_MI_INT16 = 3
_MI_INT32 = 5
_MI_UINT32 = 6
_MI_SINGLE = 7
_MI_DOUBLE = 9
_MI_MATRIX = 14
_MX_DOUBLE = 6
_MX_SINGLE = 7
_MX_INT16 = 10


class Mat5(_Codec):
    """MATLAB level-5 MAT-file (MathWorks MAT-file format spec): 128-byte
    text header then miMATRIX elements 'samplerate' (1x1 double) and
    'wavedata' (channels x frames int16/single, column-major =
    interleaved)."""

    name = "mat5"
    exts = ("mat5",)

    @staticmethod
    def _element(mi_type: int, payload: bytes) -> bytes:
        pad = (-len(payload)) % 8
        return struct.pack("<II", mi_type, len(payload)) + payload \
            + b"\x00" * pad

    def _matrix_header(self, name: bytes, mx_class: int, rows: int,
                       cols: int) -> bytes:
        sub = self._element(_MI_UINT32, struct.pack("<II", mx_class, 0))
        sub += self._element(_MI_INT32, struct.pack("<ii", rows, cols))
        sub += self._element(_MI_INT8, name)
        return sub

    def header(self, stream, data_nbytes: int) -> bytes:
        is_float = stream.format is SampleFormat.FLOAT
        itemsize = 4 if is_float else 2
        frames = data_nbytes // (itemsize * stream.channels) \
            if stream.channels else 0
        # libsndfile's reader scans the text as a C string: the NUL
        # terminator before the space padding is load-bearing
        text = b"MATLAB 5.0 MAT-file, written by minimodem_tpu\x00"
        head = text.ljust(124, b" ") + struct.pack("<H", 0x0100) + b"IM"

        sr = self._matrix_header(b"samplerate", _MX_DOUBLE, 1, 1)
        sr += self._element(_MI_DOUBLE, struct.pack("<d",
                                                    float(stream.rate)))
        out = head + self._element(_MI_MATRIX, sr)

        # libsndfile writes (and its reader requires) array class
        # mxDOUBLE regardless of the storage type of the data subelement
        wd = self._matrix_header(b"wavedata", _MX_DOUBLE,
                                 stream.channels, frames)
        mi = _MI_SINGLE if is_float else _MI_INT16
        # the data subelement tag is written here; samples follow raw
        # (close() rewrites this header with the real frame count, and
        # the trailing pad bytes of an odd int16 count are never written
        # — readers bound by nbytes, as we do, are unaffected)
        wd_tag = struct.pack("<II", mi, data_nbytes)
        matrix_payload_len = len(wd) + 8 + data_nbytes
        out += struct.pack("<II", _MI_MATRIX, matrix_payload_len)
        out += wd + wd_tag
        return out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        dt = "<f4" if stream.format is SampleFormat.FLOAT else "<i2"
        return _wire(stream, buf, dt)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:10] == b"MATLAB 5.0"

    @staticmethod
    def _subelement(fh):
        """-> (mi_type, size, payload_or_None).  payload is returned for
        small (tag-embedded) elements — their data lives in bytes 4..8
        of the 8-byte tag itself; for normal elements the caller reads
        `size` bytes (+ pad to 8) itself."""
        raw = fh.read(8)
        (st,) = struct.unpack("<I", raw[:4])
        if st & 0xFFFF0000:  # small data element: size in the high half
            size = st >> 16
            return st & 0xFFFF, size, raw[4:4 + size]
        (ssize,) = struct.unpack("<I", raw[4:8])
        return st, ssize, None

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(126)
        if fh.read(2) != b"IM":
            raise RuntimeError(
                f"{stream.path}: big-endian MAT5 is not supported")
        rate = 0
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                raise RuntimeError(f"{stream.path}: no wavedata matrix")
            mtype, msize = struct.unpack("<II", hdr)
            end = fh.tell() + msize + ((-msize) % 8)
            if mtype != _MI_MATRIX:
                fh.seek(end)
                continue
            # subelements in spec order: flags, dims, name, data
            st, ssize, body = self._subelement(fh)          # array flags
            if body is None:
                fh.seek(ssize + ((-ssize) % 8), 1)
            st, ssize, body = self._subelement(fh)          # dimensions
            raw = body if body is not None \
                else fh.read(ssize + ((-ssize) % 8))[:ssize]
            dims = struct.unpack("<ii", raw[:8])
            st, ssize, body = self._subelement(fh)          # name
            raw = body if body is not None \
                else fh.read(ssize + ((-ssize) % 8))[:ssize]
            name = raw.rstrip(b"\x00").decode("ascii", "replace")
            st, ssize, body = self._subelement(fh)          # data
            if name == "samplerate":
                # MAT5 allows compressed numeric storage: libsndfile
                # writes the rate as a small miUINT16 when it fits
                dt = {1: "<i1", 2: "<u1", 3: "<i2", 4: "<u2", 5: "<i4",
                      6: "<u4", _MI_SINGLE: "<f4",
                      _MI_DOUBLE: "<f8"}.get(st)
                if dt is None:
                    raise RuntimeError(
                        f"{stream.path}: unsupported MAT5 samplerate "
                        f"type {st}")
                raw = body if body is not None \
                    else fh.read(ssize + ((-ssize) % 8))[:ssize]
                rate = float(np.frombuffer(raw[:ssize], dt)[0])
                fh.seek(end)
                continue
            if name == "wavedata":
                dt = {2: "u1", _MI_INT16: "<i2", _MI_SINGLE: "<f4",
                      _MI_DOUBLE: "<f8"}.get(st)
                if dt is None or body is not None:
                    raise RuntimeError(
                        f"{stream.path}: unsupported MAT5 wavedata "
                        f"type {st}")
                dtype = np.dtype(dt)
                tag = _FLOAT if dtype.kind == "f" else _PCM
                bits = {2: 8, _MI_INT16: 16}.get(st, 32)
                _set_src(stream, int(round(rate)), dims[0], dtype,
                         bits, tag, ssize)
                return  # fh sits at the first sample
            fh.seek(end)


# ------------------------------------------------------------------- PAF
class Paf(_Codec):
    """Ensoniq PARIS: 2048-byte header — magic ' paf' (big-endian file)
    or 'fap ' (little-endian), then version, endianness (0=big 1=little),
    samplerate, format (0=PCM16 1=PCM24 2=PCM-S8), channels.  Written
    big-endian PCM16 like libsndfile 1.1.0; paf24's blocked 24-bit
    layout is not supported."""

    name = "paf"
    exts = ("paf",)

    def header(self, stream, data_nbytes: int) -> bytes:
        head = b" paf" + struct.pack(">5I", 0, 0, stream.rate, 0,
                                     stream.channels)
        return head.ljust(2048, b"\x00")

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, ">i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] in (b" paf", b"fap ")

    def parse(self, stream) -> None:
        fh = stream._fh
        raw = fh.read(24)
        bo = ">" if raw[:4] == b" paf" else "<"
        _ver, _endian, rate, fmt, ch = struct.unpack(bo + "5I", raw[4:24])
        if fmt == 0:
            dt, bits = np.dtype(bo + "i2"), 16
        elif fmt == 2:
            dt, bits = np.dtype(np.int8), 8
        else:
            raise RuntimeError(
                f"{stream.path}: unsupported PAF format {fmt} "
                "(paf24 blocked layout)")
        fh.seek(2048)
        _set_src(stream, rate, ch, dt, bits, _PCM,
                 _file_size(stream) - 2048)


# ------------------------------------------------------------------- SD2
class Sd2(_Codec):
    """Sound Designer II data fork: headerless big-endian PCM16 (the
    rate/format metadata lives in a Mac resource fork that neither
    libsndfile 1.1.0 on this image nor this codec materializes — its
    .sd2 output is exactly this data fork).  Read at the configured
    stream rate, like RAW."""

    name = "sd2"
    exts = ("sd2",)

    def header(self, stream, data_nbytes: int) -> bytes:
        return b""

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, ">i2")

    # no magic: reached only via the .sd2 extension on read
    def sniff(self, head: bytes, ext: str) -> bool:
        return ext == "sd2"

    def parse(self, stream) -> None:
        stream._fh.seek(0)
        _set_src(stream, stream.rate, stream.channels, np.dtype(">i2"),
                 16, _PCM, _file_size(stream))


# ------------------------------------------------------------------ MPC2K
class Mpc2k(_Codec):
    """Akai MPC 2000 sample: 42-byte header — bytes {01 04}, 17-byte
    space-padded name, level (100), tune, channels byte (0=mono
    1=stereo), u32 LE start / loopend / end / frames?, loop flags, and a
    u16 LE sample rate at offset 40; PCM16 LE data.  Field layout
    matched byte-for-byte against libsndfile 1.1.0 output."""

    name = "mpc2k"
    exts = ("mpc2k", "mpc")

    def header(self, stream, data_nbytes: int) -> bytes:
        if stream.rate > 0xFFFF:
            raise RuntimeError(
                f"MPC2K sample-rate field is 16-bit; {stream.rate} Hz "
                "does not fit — use a WAV/AU/FLAC container")
        frames = data_nbytes // (2 * stream.channels) \
            if stream.channels else 0
        # fixed label, not the basename libsndfile stamps: output bytes
        # must not depend on the output path (TX determinism contract)
        name = b"minimodem_tpu".ljust(17)
        return (b"\x01\x04" + name
                + struct.pack("<BBB", 100, 0,
                              1 if stream.channels == 2 else 0)
                + struct.pack("<III", 0, frames, frames)
                + struct.pack("<IBB", frames, 0, 1)
                + struct.pack("<H", stream.rate))

    def encode(self, stream, buf: np.ndarray) -> bytes:
        return _wire(stream, buf, "<i2")

    def sniff(self, head: bytes, ext: str) -> bool:
        return ext in ("mpc", "mpc2k") and head[:2] == b"\x01\x04"

    def parse(self, stream) -> None:
        fh = stream._fh
        raw = fh.read(42)
        if len(raw) < 42:
            raise RuntimeError(f"{stream.path}: truncated MPC2K header")
        ch = 2 if raw[21] == 1 else 1
        (rate,) = struct.unpack("<H", raw[40:42])
        _set_src(stream, rate, ch, np.dtype("<i2"), 16, _PCM,
                 _file_size(stream) - 42)


# ---------------------------------------------------------------- A-law
def _alaw_decode_table() -> np.ndarray:
    """G.711 A-law -> int16 (16-bit range), the table libsndfile uses."""
    out = np.empty(256, np.int16)
    for i in range(256):
        a = i ^ 0x55
        t = (a & 0x0F) << 4
        seg = (a & 0x70) >> 4
        if seg == 0:
            t += 8
        elif seg == 1:
            t += 0x108
        else:
            t = (t + 0x108) << (seg - 1)
        out[i] = t if (a & 0x80) else -t
    return out


_ALAW_DEC = _alaw_decode_table()


def _ulaw_decode_table() -> np.ndarray:
    """G.711 u-law -> int16 (16-bit range), the table libsndfile uses
    (reference reads these transparently via sf_readf_float,
    src/simpleaudio-sndfile.c:46-70)."""
    out = np.empty(256, np.int16)
    for i in range(256):
        u = ~i & 0xFF
        t = ((u & 0x0F) << 3) + 0x84
        t <<= (u & 0x70) >> 4
        out[i] = (0x84 - t) if (u & 0x80) else (t - 0x84)
    return out


_ULAW_DEC = _ulaw_decode_table()

# u-law segment boundaries of the biased magnitude (BIAS 0x84)
_ULAW_SEG = np.array([0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000, 0x4000],
                     np.int32)


def _ulaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 -> G.711 u-law u8 (classic linear2ulaw, BIAS 0x84 —
    libsndfile's convention; tests pin byte equality with it)."""
    x = np.asarray(pcm, np.int32)
    sign = x < 0
    mag = np.minimum(np.where(sign, -x, x) + 0x84, 0x7FFF)
    seg = np.searchsorted(_ULAW_SEG, mag, side="right")
    u = ((sign.astype(np.int32) << 7) | (seg << 4)
         | ((mag >> (seg + 3)) & 0xF))
    return (~u & 0xFF).astype(np.uint8)


def expand_u8(samples: np.ndarray, encoding: str) -> np.ndarray:
    """Host-side expansion of a raw u8 wire encoding -> float32 samples
    (the same values ops/device_rx.normalize_input produces on device)."""
    b = np.asarray(samples, np.uint8)
    if encoding == "ulaw":
        v = _ULAW_DEC[b]
    elif encoding == "alaw":
        v = _ALAW_DEC[b]
    elif encoding == "pcm8":
        v = (b.astype(np.int16) - 128) << 8
    else:
        raise ValueError(f"unknown u8 encoding {encoding!r}")
    return v.astype(np.float32) / np.float32(32768.0)
# encode via nearest-boundary search over the decode table's positive half
_ALAW_SEG = np.array([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF],
                     np.int32)


def _alaw_encode(pcm: np.ndarray) -> np.ndarray:
    """int16 -> A-law u8.  Negative magnitudes are (-pcm) >> 3, NOT the
    classic g711.c -(pcm >> 3) - 1: that's libsndfile's convention, and
    tests/test_sndfile_interop.py pins byte equality with it."""
    x = np.asarray(pcm, np.int32)
    neg = x < 0
    v = np.where(neg, -x, x) >> 3
    mask = np.where(neg, 0x55, 0xD5)
    seg = np.searchsorted(_ALAW_SEG, v)
    seg_c = np.minimum(seg, 7)
    low = np.where(seg_c < 2, (v >> 1) & 0xF, (v >> seg_c) & 0xF)
    aval = (seg_c << 4) | low
    aval = np.where(seg > 7, 0x7F, aval)
    return (aval ^ mask).astype(np.uint8)


# -------------------------------------------------------------------- WVE
class Wve(_Codec):
    """Psion Series 3 sound file: 'ALawSoundFile**\\0' magic, u16 BE
    version 0x0F10, u32 BE sample count, 10 pad bytes (32-byte header),
    then G.711 A-law at a fixed 8000 Hz (the format carries no rate;
    readers, including libsndfile, always report 8000)."""

    name = "wve"
    exts = ("wve",)

    _MAGIC = b"ALawSoundFile**\x00"

    def header(self, stream, data_nbytes: int) -> bytes:
        return (self._MAGIC + struct.pack(">HI", 0x0F10, data_nbytes)
                + b"\x00" * 10)

    def encode(self, stream, buf: np.ndarray) -> bytes:
        if stream.format is SampleFormat.FLOAT:
            buf = _quantize16(buf)
        return _alaw_encode(np.asarray(buf, np.int16)).tobytes()

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:16] == self._MAGIC

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(16)
        _ver, count = struct.unpack(">HI", fh.read(6))
        fh.seek(32)
        raw = np.frombuffer(fh.read(count), np.uint8)
        pcm = _ALAW_DEC[raw]
        vals = (pcm.astype(np.float32) / np.float32(32768.0)
                if stream.format is SampleFormat.FLOAT else pcm)
        _set_mem_src(stream, vals, 8000)


# -------------------------------------------------------------------- SDS
class Sds(_Codec):
    """MIDI Sample Dump Standard: a 21-byte dump-header sysex (format
    bits, sample period in ns, length) followed by 127-byte data packets
    — 40 16-bit samples each as 3 MSB-first 7-bit bytes (value offset by
    0x8000), XOR checksum.  Layout verified against libsndfile 1.1.0."""

    name = "sds"
    exts = ("sds",)

    @staticmethod
    def _u21(v: int) -> bytes:
        return bytes([v & 0x7F, (v >> 7) & 0x7F, (v >> 14) & 0x7F])

    def header(self, stream, data_nbytes: int) -> bytes:
        # data_nbytes counts packet wire bytes, not samples — the frame
        # counter tracks the true sample count
        nframes = getattr(stream, "_frames_written", 0)
        if nframes > 0x1FFFFF:
            raise RuntimeError(
                "SDS sample-count field is 21-bit; audio exceeds "
                "2097151 frames — use a WAV/AU/FLAC container for "
                "long recordings")
        period = round(1e9 / stream.rate) if stream.rate else 0
        return (b"\xF0\x7E\x00\x01\x00\x00\x10"
                + self._u21(period) + self._u21(nframes)
                + self._u21(0) + self._u21(0) + b"\x00\xF7")

    def encode(self, stream, buf: np.ndarray) -> bytes:
        if stream.channels != 1:
            raise RuntimeError("SDS supports mono only")
        if stream.format is SampleFormat.FLOAT:
            buf = _quantize16(buf)
        pend = getattr(stream, "_sds_pend", np.zeros(0, np.int16))
        buf = np.concatenate([pend, np.asarray(buf, np.int16)])
        n_full = len(buf) // 40 * 40
        stream._sds_pend = buf[n_full:]
        out = self._packets(stream, buf[:n_full])
        return out

    def _packets(self, stream, samples: np.ndarray) -> bytes:
        if not len(samples):
            return b""
        u = samples.astype(np.int32) + 0x8000
        tri = np.empty((len(samples), 3), np.uint8)
        tri[:, 0] = (u >> 9) & 0x7F
        tri[:, 1] = (u >> 2) & 0x7F
        tri[:, 2] = (u & 0x3) << 5
        seq0 = getattr(stream, "_sds_seq", 0)
        out = bytearray()
        for i in range(0, len(samples), 40):
            data = tri[i:i + 40].tobytes().ljust(120, b"\x00")
            seq = (seq0 + i // 40) & 0x7F
            ck = 0x7E ^ 0x00 ^ 0x02 ^ seq
            for b in data:
                ck ^= b
            out += b"\xF0\x7E\x00\x02" + bytes([seq]) + data \
                + bytes([ck & 0x7F]) + b"\xF7"
        stream._sds_seq = seq0 + len(samples) // 40
        return bytes(out)

    def flush(self, stream) -> bytes:
        pend = getattr(stream, "_sds_pend", np.zeros(0, np.int16))
        stream._sds_pend = np.zeros(0, np.int16)
        return self._packets(stream, pend)

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:4] == b"\xF0\x7E\x00\x01" or (
            ext == "sds" and head[:2] == b"\xF0\x7E")

    def parse(self, stream) -> None:
        fh = stream._fh
        raw = fh.read(21)
        if len(raw) < 21 or raw[3] != 0x01:
            raise RuntimeError(f"{stream.path}: no SDS dump header")
        fmt_bits = raw[6]
        if fmt_bits not in (8, 14, 15, 16):
            raise RuntimeError(
                f"{stream.path}: unsupported SDS depth {fmt_bits}")
        period = raw[7] | (raw[8] << 7) | (raw[9] << 14)
        nframes = raw[10] | (raw[11] << 7) | (raw[12] << 14)
        rate = int(1e9 / period) if period else 0  # sf truncates
        chunks = []
        got = 0
        while got < nframes:
            pkt = fh.read(127)
            if len(pkt) < 127 or pkt[0] != 0xF0 or pkt[3] != 0x02:
                break
            if fmt_bits == 8:
                # 2 x 7-bit bytes, left-justified: 60 samples/packet
                # (libsndfile sds_8bit_read's << 25/<< 18 collapses to
                # this after its >> 16 short conversion)
                duo = np.frombuffer(pkt[5:125], np.uint8).reshape(60, 2)
                vals = ((duo[:, 0].astype(np.int32) << 9)
                        | (duo[:, 1].astype(np.int32) << 2)) - 0x8000
                got += 60
            else:
                tri = np.frombuffer(pkt[5:125], np.uint8).reshape(40, 3)
                vals = ((tri[:, 0].astype(np.int32) << 9)
                        | (tri[:, 1].astype(np.int32) << 2)
                        | (tri[:, 2].astype(np.int32) >> 5)) - 0x8000
                got += 40
            chunks.append(vals.astype(np.int16))
        pcm = (np.concatenate(chunks) if chunks
               else np.zeros(0, np.int16))
        if len(pcm) < nframes:
            pcm = np.concatenate(
                [pcm, np.zeros(nframes - len(pcm), np.int16)])
        pcm = pcm[:nframes].copy()
        # libsndfile delivers whole packets only: samples past
        # floor(nframes / samples_per_packet) packets read back as 0
        spp = 60 if fmt_bits == 8 else 40
        pcm[nframes // spp * spp:] = 0
        vals = (pcm.astype(np.float32) / np.float32(32768.0)
                if stream.format is SampleFormat.FLOAT else pcm)
        _set_mem_src(stream, vals, rate)


# --------------------------------------------------------------------- XI
class Xi(_Codec):
    """FastTracker 2 instrument: 0x152-byte header ('Extended
    Instrument: ', 22-byte name, 0x1A, 20-byte tracker id, version
    0x0102, zeroed keymap/envelope block, fadeout, one sample entry)
    holding 16-bit little-endian DELTA-coded PCM.  The format carries no
    sample rate; libsndfile reports 44100 and so does this reader.
    Layout matched against libsndfile 1.1.0 output."""

    name = "xi"
    exts = ("xi",)

    def header(self, stream, data_nbytes: int) -> bytes:
        out = b"Extended Instrument: "
        out += b"minimodem_tpu".ljust(22) + b"\x1A"
        out += b"minimodem_tpu".ljust(20)
        out += struct.pack("<H", 0x0102)
        out += b"\x00" * (96 + 48 + 48 + 14)      # keymap + envelopes
        out += struct.pack("<H", 0x1234)          # volume fadeout
        out += b"\x00" * 22
        out += struct.pack("<H", 1)               # sample count
        # sample header: length, loopstart, looplen, vol, fine, type
        # (0x10 = 16-bit), pan, relnote, reserved, 22-byte name
        out += struct.pack("<IIIBbBBbB", data_nbytes, 0, 0,
                           0x80, 0, 0x10, 0x80, 0, 0)
        out += b"Sample #1".ljust(22, b"\x00")
        assert len(out) == 0x152, len(out)
        return out

    def encode(self, stream, buf: np.ndarray) -> bytes:
        if stream.channels != 1:
            raise RuntimeError("XI supports mono only")
        if stream.format is SampleFormat.FLOAT:
            buf = _quantize16(buf)
        buf = np.asarray(buf, np.int16)
        prev = getattr(stream, "_xi_prev", np.int16(0))
        delta = (buf.astype(np.int32)
                 - np.concatenate([[np.int32(prev)],
                                   buf[:-1].astype(np.int32)]))
        if len(buf):
            stream._xi_prev = buf[-1]
        return delta.astype(np.int16).astype("<i2").tobytes()

    def sniff(self, head: bytes, ext: str) -> bool:
        return head[:21] == b"Extended Instrument: "

    def parse(self, stream) -> None:
        fh = stream._fh
        fh.seek(0x128)
        (nsamples,) = struct.unpack("<H", fh.read(2))
        if nsamples != 1:
            raise RuntimeError(
                f"{stream.path}: multi-sample XI not supported")
        length, _ls, _ll, _vol, _fine, s_type = struct.unpack(
            "<IIIBbB", fh.read(15))
        if not (s_type & 0x10):
            raise RuntimeError(f"{stream.path}: 8-bit XI not supported")
        fh.seek(0x152)
        nbytes = length or (_file_size(stream) - 0x152)
        raw = np.frombuffer(fh.read(nbytes), "<i2")
        pcm = np.cumsum(raw.astype(np.int64)).astype(np.int16)
        vals = (pcm.astype(np.float32) / np.float32(32768.0)
                if stream.format is SampleFormat.FLOAT else pcm)
        _set_mem_src(stream, vals, 44100)


# Sd2 sniffs by extension alone (the data fork is headerless), so it
# must come after every magic-bearing codec
_CODECS = [Aiff(), Caf(), W64(), Rf64(), Wavex(), Nist(), Ircam(), Pvf(),
           Htk(), Avr(), Voc(), Svx(), Mat4(), Mat5(), Paf(),
           Mpc2k(), Wve(), Sds(), Xi(), Sd2()]
_BY_NAME = {}
for _c in _CODECS:
    _BY_NAME[_c.name] = _c
    for _e in _c.exts:
        _BY_NAME.setdefault(_e, _c)


def supported_container(ext: str) -> bool:
    return ext in _BY_NAME


def get_container(name: str):
    return _BY_NAME[name]


def probe_container(fh, path: str):
    """Identify a container by magic (plus extension for magicless HTK).
    Leaves fh at position 0."""
    head = fh.read(64)
    fh.seek(0)
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    for codec in _CODECS:
        if codec.sniff(head, ext):
            return codec
    return None
