"""Deterministic WAV/AU/RAW file codec.

Replaces the reference's libsndfile backend
(reference: src/simpleaudio-sndfile.c) with a self-contained codec.  Output
is byte-deterministic: fixed headers, no timestamps, and no PEAK chunk (the
reference explicitly disables libsndfile's PEAK chunk for the same reason,
reference: src/simpleaudio-sndfile.c:203-210).

Containers (selected by filename extension on write, by magic on read,
mirroring the reference's extension table at
src/simpleaudio-sndfile.c:111-157):
- .wav  : RIFF/WAVE; writes PCM16/24/32 (pcm_bits) or IEEE-float32, reads
          PCM8/16/24/32, float32/64, EXTENSIBLE, G.711 u-law/A-law,
          IMA/DVI ADPCM, Microsoft ADPCM, and GSM 6.10 (native RPE-LTP
          decoder, native/gsm610.cpp) — the reference accepts any
          libsndfile-readable subformat via sf_readf_float,
          src/simpleaudio-sndfile.c:46-70
- .flac : reads via the native decoder (native/flacdec.cpp), writes via
          the deterministic encoder (sigio/flacenc.py)
- .ogg  : Vorbis via the runtime-loaded Xiph libraries
          (sigio/oggvorbis.py)
- .au   : Sun AU; writes PCM16-BE or float32-BE, reads additionally
          PCM8(signed)/24/32-BE, float64-BE, u-law, A-law
- .raw  : headerless samples at the configured rate/format
- .aiff/.aif .caf .w64 .rf64 .wavex .nist .ircam .pvf .htk .avr .voc
  .svx .mat4 .mat5 .paf .sd2 .mpc .wve .sds .xi : container codecs
  (sigio/containers.py) — every major in the reference's table is
  covered; layouts for the exotic ones were verified byte-for-byte
  against libsndfile 1.1.0 (tests/test_sndfile_interop.py).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import Direction, SampleFormat, Stream

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_MS_ADPCM = 2
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_ALAW = 6
_WAVE_FORMAT_MULAW = 7
_WAVE_FORMAT_IMA_ADPCM = 0x11
_WAVE_FORMAT_GSM610 = 0x31

_AU_MAGIC = b".snd"
_AU_ENC_ULAW = 1
_AU_ENC_PCM8 = 2
_AU_ENC_PCM16 = 3
_AU_ENC_PCM24 = 4
_AU_ENC_PCM32 = 5
_AU_ENC_FLOAT32 = 6
_AU_ENC_FLOAT64 = 7
_AU_ENC_ALAW = 27

# ---- IMA/DVI ADPCM (WAV format tag 0x11) --------------------------------
# step/index tables per IMA ADPCM spec; decode semantics mirror
# libsndfile's ima_adpcm.c (the reference's file layer decodes these
# transparently through sf_readf_float, src/simpleaudio-sndfile.c:46-70)
_IMA_INDEX_ADJUST = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8] * 2, np.int32)
_IMA_STEP_SIZE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)


def _ima_decode(data: bytes, block_align: int, channels: int,
                samples_per_block: int) -> np.ndarray:
    """Decode IMA ADPCM blocks -> interleaved int16 frames.

    Block layout (WAV DVI/IMA): per channel a 4-byte header (int16 LE
    predictor = the block's first output sample, u8 step index, u8
    reserved), then the channels' nibble data interleaved in 4-byte
    groups.  Vectorized across blocks: the nibble chain is sequential
    within a block but independent between blocks."""
    nblocks = len(data) // block_align
    if nblocks == 0:
        return np.zeros(0, np.int16)
    raw = np.frombuffer(data[:nblocks * block_align], np.uint8)
    raw = raw.reshape(nblocks, block_align)
    hdr = raw[:, : 4 * channels].reshape(nblocks, channels, 4)
    pred = (hdr[:, :, 0].astype(np.int32)
            | (hdr[:, :, 1].astype(np.int8).astype(np.int32) << 8))
    idx = np.clip(hdr[:, :, 2].astype(np.int32), 0, 88)

    body = raw[:, 4 * channels:]                     # [nblocks, nbytes]
    # nibble k of channel c lives in byte group (k//8), word c, byte
    # (k%8)//2; low nibble first
    ngroups = body.shape[1] // (4 * channels)
    grp = body[:, : ngroups * 4 * channels].reshape(
        nblocks, ngroups, channels, 4)
    lo = grp & 0x0F
    hi = grp >> 4
    nib = np.empty((nblocks, ngroups, channels, 8), np.uint8)
    nib[..., 0::2] = lo
    nib[..., 1::2] = hi
    # [nblocks, channels, nsamp_chain] in output order
    nib = nib.transpose(0, 2, 1, 3).reshape(nblocks, channels, -1)

    nchain = min(nib.shape[2], max(samples_per_block - 1, 0))
    out = np.empty((nblocks, channels, 1 + nchain), np.int16)
    out[:, :, 0] = pred.astype(np.int16)
    cur = pred
    for k in range(nchain):
        bc = nib[:, :, k].astype(np.int32)
        step = _IMA_STEP_SIZE[idx]
        diff = step >> 3
        diff += np.where(bc & 1, step >> 2, 0)
        diff += np.where(bc & 2, step >> 1, 0)
        diff += np.where(bc & 4, step, 0)
        cur = cur + np.where(bc & 8, -diff, diff)
        cur = np.clip(cur, -32768, 32767)
        idx = np.clip(idx + _IMA_INDEX_ADJUST[bc], 0, 88)
        out[:, :, k + 1] = cur.astype(np.int16)
    # interleave channels per frame: [nblocks, nsamp, ch] -> flat
    return out.transpose(0, 2, 1).reshape(-1)


def _ima4_decode(data: bytes, channels: int) -> np.ndarray:
    """Decode AIFF-C 'ima4' (Apple IMA) packets -> interleaved int16.

    34-byte packets, channel-interleaved per packet group: a 2-byte
    big-endian header (predictor in the top 9 bits, step index in the
    low 7) then 32 code bytes = 64 samples, low nibble first.  The
    predictor is running state only (not emitted); step semantics match
    the WAV IMA chain.  Mirrors libsndfile's aiff_ima_decode_block."""
    pkt = 34
    nblocks = len(data) // (pkt * channels)
    if nblocks == 0:
        return np.zeros(0, np.int16)
    raw = np.frombuffer(data[:nblocks * channels * pkt], np.uint8)
    raw = raw.reshape(nblocks, channels, pkt)
    hdr = (raw[:, :, 0].astype(np.int32) << 8) | raw[:, :, 1]
    cur = hdr & 0xFF80
    cur = np.where(cur & 0x8000, cur - 0x10000, cur)
    idx = np.clip(hdr & 0x7F, 0, 88)
    body = raw[:, :, 2:]
    nib = np.empty((nblocks, channels, 32, 2), np.uint8)
    nib[..., 0] = body & 0x0F
    nib[..., 1] = body >> 4
    nib = nib.reshape(nblocks, channels, 64)
    out = np.empty((nblocks, channels, 64), np.int16)
    for k in range(64):
        bc = nib[:, :, k].astype(np.int32)
        step = _IMA_STEP_SIZE[idx]
        diff = step >> 3
        diff += np.where(bc & 1, step >> 2, 0)
        diff += np.where(bc & 2, step >> 1, 0)
        diff += np.where(bc & 4, step, 0)
        cur = cur + np.where(bc & 8, -diff, diff)
        cur = np.clip(cur, -32768, 32767)
        idx = np.clip(idx + _IMA_INDEX_ADJUST[bc], 0, 88)
        out[:, :, k] = cur.astype(np.int16)
    return out.transpose(0, 2, 1).reshape(-1)


# ---- Microsoft ADPCM (WAV format tag 0x02) ------------------------------
# adaptation table + default coefficient sets per the WAVE_FORMAT_ADPCM
# spec; decode semantics mirror libsndfile's ms_adpcm.c (the reference's
# file layer decodes these transparently through sf_readf_float,
# src/simpleaudio-sndfile.c:46-70)
_MS_ADAPT = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                      768, 614, 512, 409, 307, 230, 230, 230], np.int32)
_MS_COEF_DEFAULT = ((256, 0), (512, -256), (0, 0), (192, 64),
                    (240, 0), (460, -208), (392, -232))


def _ms_decode(data: bytes, block_align: int, channels: int,
               samples_per_block: int, coefs) -> np.ndarray:
    """Decode MS ADPCM blocks -> interleaved int16 frames.

    Block layout: per channel a u8 coefficient-set index, then per
    channel int16 LE idelta, sample1, sample2 (sample2 is the OLDER
    sample and is emitted first); then 4-bit codes high-nibble-first,
    cycling channels per nibble.  predictor = (s1*c1 + s2*c2) >> 8 +
    signed4(code)*delta; delta = max((adapt[code]*delta) >> 8, 16).
    Vectorized across blocks (the code chain is sequential within a
    block, independent between blocks)."""
    nch = channels
    nblocks = len(data) // block_align
    if nblocks == 0:
        return np.zeros(0, np.int16)
    raw = np.frombuffer(data[:nblocks * block_align], np.uint8)
    raw = raw.reshape(nblocks, block_align)
    coef = np.asarray(coefs, np.int32)
    bpred = raw[:, :nch].astype(np.int32)
    if np.any(bpred >= len(coef)):
        raise RuntimeError("invalid MS ADPCM block predictor")

    def i16(col):
        lo = raw[:, col].astype(np.int32)
        hi = raw[:, col + 1].astype(np.int8).astype(np.int32)
        return lo | (hi << 8)

    delta = np.stack([i16(nch + 2 * c) for c in range(nch)], axis=1)
    s1 = np.stack([i16(3 * nch + 2 * c) for c in range(nch)], axis=1)
    s2 = np.stack([i16(5 * nch + 2 * c) for c in range(nch)], axis=1)
    c1 = coef[bpred, 0]
    c2 = coef[bpred, 1]

    body = raw[:, 7 * nch:]
    nib = np.empty((nblocks, body.shape[1], 2), np.uint8)
    nib[:, :, 0] = body >> 4
    nib[:, :, 1] = body & 0x0F
    nib = nib.reshape(nblocks, -1)

    nchain = min(nib.shape[1] // nch, max(samples_per_block - 2, 0))
    out = np.empty((nblocks, nch, 2 + nchain), np.int16)
    out[:, :, 0] = s2.astype(np.int16)
    out[:, :, 1] = s1.astype(np.int16)
    for k in range(nchain):
        code = nib[:, k * nch:(k + 1) * nch].astype(np.int32)
        signed = np.where(code >= 8, code - 16, code)
        cur = ((s1 * c1 + s2 * c2) >> 8) + signed * delta
        cur = np.clip(cur, -32768, 32767)
        out[:, :, 2 + k] = cur.astype(np.int16)
        s2 = s1
        s1 = cur
        delta = np.maximum((_MS_ADAPT[code] * delta) >> 8, 16)
    return out.transpose(0, 2, 1).reshape(-1)


# ---- GSM 06.10 (WAV format tag 0x31, AIFF 'GSM ') ------------------------
def _gsm610_decode(data: bytes, wav49: bool) -> np.ndarray:
    """Decode GSM 06.10 RPE-LTP frames -> int16 samples via the
    from-scratch native decoder (native/gsm610.cpp), sample-exact vs
    libsndfile's embedded libgsm (the reference reads GSM-compressed
    files transparently through sf_readf_float,
    src/simpleaudio-sndfile.c:46-70).  WAV49 = the WAV/W64 two-frames-
    per-65-byte-block packing; plain 33-byte frames otherwise."""
    import ctypes

    from .. import native

    lib = native.load()
    if lib is None or not hasattr(lib, "mm_gsm610_decode"):
        raise RuntimeError(
            "GSM 6.10 read needs the native library "
            "(make -C minimodem_tpu_torch/native)")
    bsz, spb = (65, 320) if wav49 else (33, 160)
    rem = len(data) % bsz
    if rem:
        # libsndfile's block buffer is not cleared on a short read: a
        # truncated final block decodes the fresh bytes followed by the
        # PREVIOUS block's stale tail (zeros before the first block) —
        # verified against the 1.1.0 oracle
        nfull = len(data) // bsz
        stale = (data[(nfull - 1) * bsz + rem: nfull * bsz]
                 if nfull else b"\x00" * (bsz - rem))
        data = data + stale
    out = np.empty((len(data) // bsz) * spb, np.int16)
    got = lib.mm_gsm610_decode(
        data, len(data), 1 if wav49 else 0,
        out.ctypes.data_as(ctypes.c_void_p), out.size)
    if got < 0:
        raise RuntimeError("undecodable GSM 6.10 stream")
    return out[:got]


def _container_from_path(path: str) -> str:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in ("wav", "wave"):
        return "wav"
    if ext == "au":
        return "au"
    if ext in ("raw", "pcm", "sw"):
        return "raw"
    if ext == "flac":
        return "flac"
    if ext in ("ogg", "oga"):
        return "ogg"
    if ext in ("aiff", "aif", "caf", "w64", "voc", "mat4",
               "mat5", "paf", "svx", "nist", "ircam", "pvf", "xi", "htk",
               "sds", "avr", "wavex", "sd2", "wve", "mpc", "mpc2k",
               "rf64"):
        from .containers import supported_container
        if supported_container(ext):
            return ext
        raise RuntimeError(
            f"E: container '.{ext}' requires an external codec library not "
            f"included in this build; use .wav, .flac, .ogg, .au, or .raw")
    # unknown extension defaults to WAV, like the reference
    # (src/simpleaudio-sndfile.c:159-172)
    return "wav"


class FileStream(Stream):
    def __init__(self, path: str, direction: Direction, fmt: SampleFormat,
                 rate: int, channels: int, pcm_bits: int = 0):
        super().__init__(fmt, rate, channels)
        self.path = path
        self.direction = direction
        self._frames_written = 0
        # optional PCM depth override for WAV/FLAC writes (16/24/32)
        self._pcm_bits = pcm_bits or (16 if fmt is SampleFormat.S16 else 0)
        self._flac_pending = None
        self._ogg_writer = None
        self._codec = None
        if direction is Direction.PLAYBACK:
            self.container = _container_from_path(path)
            self._fh = open(path, "wb")
            if self.container == "flac":
                self._flac_pending = []
            elif self.container == "ogg":
                from .oggvorbis import OggWriter
                self._ogg_writer = OggWriter(self._fh, rate, channels)
            else:
                if self.container not in ("wav", "au", "raw"):
                    from .containers import get_container
                    self._codec = get_container(self.container)
                self._write_header_placeholder()
        else:
            self._fh = open(path, "rb")
            try:
                self._read_header()
            except RuntimeError:
                # subformats the native reader doesn't decode (G.72x,
                # DWVW, anything else exotic): defer to a host
                # libsndfile when one exists — the reference's own
                # architecture (src/simpleaudio-sndfile.c:46-70 reads
                # any subformat transparently through sf_readf_float).
                # Without one, the native reader's error stands.
                if not self._sndfile_fallback():
                    raise

    # ================= write side =================
    def _write_header_placeholder(self) -> None:
        if self.container == "wav":
            self._fh.write(self._wav_header(0))
        elif self.container == "au":
            self._fh.write(self._au_header(0xFFFFFFFF))
        elif self._codec is not None:
            self._fh.write(self._codec.header(self, 0))
        # raw: no header

    def _wav_header(self, data_nbytes: int) -> bytes:
        if self._pcm_bits:
            fmt_tag = _WAVE_FORMAT_PCM
            bits = self._pcm_bits
        else:
            fmt_tag = _WAVE_FORMAT_IEEE_FLOAT
            bits = 32
        block_align = (bits // 8) * self.channels
        byte_rate = self.rate * block_align
        chunks = b""
        chunks += struct.pack(
            "<4sIHHIIHH", b"fmt ", 16, fmt_tag, self.channels,
            self.rate, byte_rate, block_align, bits)
        if fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
            nframes = data_nbytes // block_align
            chunks += struct.pack("<4sII", b"fact", 4, nframes)
        chunks += struct.pack("<4sI", b"data", data_nbytes)
        riff_size = 4 + len(chunks) + data_nbytes
        return struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE") + chunks

    def _au_header(self, data_nbytes: int) -> bytes:
        enc = (_AU_ENC_FLOAT32 if self.format is SampleFormat.FLOAT
               else _AU_ENC_PCM16)
        return struct.pack(
            ">4sIIIII", _AU_MAGIC, 24, data_nbytes, enc, self.rate,
            self.channels)

    def _native_pcm_depth(self) -> bool:
        """True when the file encoding equals the app sample format."""
        if self.format is SampleFormat.S16:
            return self._pcm_bits == 16
        return self._pcm_bits == 0

    def _encode_pcm(self, buf: np.ndarray) -> bytes:
        """Re-quantize app samples to the PCM24/32 file depth
        (libsndfile's float->PCM convention: scale by 2^(bits-1), clip)."""
        bits = self._pcm_bits
        if self.format is SampleFormat.FLOAT:
            scale = float(1 << (bits - 1))
            v = np.rint(np.asarray(buf, np.float64) * scale)
            v = np.clip(v, -scale, scale - 1).astype("<i4")
        else:
            v = np.asarray(buf, np.int64) << (bits - 16)
            v = v.astype("<i4")
        if bits == 32:
            return v.tobytes()
        return v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()  # PCM24 LE

    def _write(self, buf: np.ndarray) -> int:
        buf = np.asarray(buf, dtype=self.format.dtype)
        nframes = buf.size // self.channels if self.channels else buf.size
        self._frames_written += nframes
        if self.container == "flac":
            self._flac_pending.append(np.array(buf, copy=True))
            return nframes
        if self.container == "ogg":
            self._ogg_writer.write(buf)
            return nframes
        if self._codec is not None:
            data = self._codec.encode(self, buf)
        elif self.container == "wav" and not self._native_pcm_depth():
            data = self._encode_pcm(buf)
        elif self.container == "au":
            data = buf.astype(buf.dtype.newbyteorder(">")).tobytes()
        else:
            data = buf.astype(buf.dtype.newbyteorder("<")).tobytes()
        self._fh.write(data)
        self._data_bytes = getattr(self, "_data_bytes", 0) + len(data)
        return nframes

    # ================= read side =================
    def _sndfile_fallback(self) -> bool:
        """Decode the whole file via a host libsndfile into memory and
        serve reads from there (already in the stream's format), like
        the OGG path.  -> False when no library can open it."""
        from .sndfile_fallback import read_file

        res = read_file(self.path, self.format is SampleFormat.FLOAT)
        if res is None:
            return False
        samples, rate, ch = res
        self.container = "sndfile"
        self.rate = rate
        self.channels = ch
        self._mem_buf = samples
        self._mem_pos = 0
        self._src_dtype = "mem"
        self._src_fmt_tag = None
        self._src_bits = 16
        self._data_remaining = samples.nbytes
        return True

    def raw_u8_encoding(self):
        """Wire encoding name when this source is a 1-byte-per-sample
        format the device can expand itself (ops/device_rx.U8_ENCODINGS)
        — u-law / A-law / unsigned WAV PCM8 — else None.  Call
        enable_raw_u8() to make read() return the raw uint8 bytes."""
        if self._src_dtype in ("ulaw", "alaw"):
            return self._src_dtype
        # unsigned PCM8 (WAV/RF64/W64/VOC/AVR/AIFC-raw); containers
        # store either the type or a dtype instance
        if self._src_dtype is np.uint8 or (
                isinstance(self._src_dtype, np.dtype)
                and self._src_dtype == np.uint8):
            return "pcm8"
        return None

    def enable_raw_u8(self) -> None:
        assert self.raw_u8_encoding() is not None
        self._raw_u8 = True

    def _read_header(self) -> None:
        magic = self._fh.read(4)
        if magic == b"RIFF":
            self._parse_wav()
        elif magic == _AU_MAGIC:
            self._parse_au()
        elif magic == b"fLaC":
            self._parse_flac()
        elif magic == b"OggS":
            self._parse_ogg()
        else:
            from .containers import probe_container
            self._fh.seek(0)
            codec = probe_container(self._fh, self.path)
            if codec is not None:
                self.container = codec.name
                codec.parse(self)
                return
            # headerless: raw samples at configured rate/format
            self._fh.seek(0)
            self.container = "raw"
            self._src_dtype = self.format.dtype.newbyteorder("<")
            self._src_fmt_tag = None
            size = os.fstat(self._fh.fileno()).st_size
            self._data_remaining = size

    def _parse_wav(self) -> None:
        self.container = "wav"
        self._fh.read(4)  # riff size
        if self._fh.read(4) != b"WAVE":
            raise RuntimeError(f"{self.path}: not a WAVE file")
        fmt_tag = None
        block_align = 0
        fmt_extra = b""
        fact_frames = None
        while True:
            hdr = self._fh.read(8)
            if len(hdr) < 8:
                raise RuntimeError(f"{self.path}: no data chunk")
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                if csize < 16:
                    raise RuntimeError(
                        f"{self.path}: truncated fmt chunk ({csize} B)")
                body = self._fh.read(csize + (csize & 1))  # RIFF pad
                (fmt_tag, nch, rate, _br, block_align, bits) = struct.unpack(
                    "<HHIIHH", body[:16])
                fmt_extra = body[16:csize]
                if fmt_tag == 0xFFFE and csize >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    fmt_tag = struct.unpack("<H", body[24:26])[0]
                self.channels = nch
                self.rate = rate
                self._src_bits = bits
            elif cid == b"fact" and csize >= 4:
                fact_frames = struct.unpack(
                    "<I", self._fh.read(csize + (csize & 1))[:4])[0]
            elif cid == b"data":
                self._data_remaining = csize
                break
            else:
                self._fh.seek(csize + (csize & 1), 1)
        if fmt_tag == _WAVE_FORMAT_PCM:
            dt = {8: np.uint8, 16: np.int16, 32: np.int32}.get(self._src_bits)
            if dt is None and self._src_bits == 24:
                dt = "i24"
            if dt is None:
                raise RuntimeError(
                    f"{self.path}: unsupported PCM bit depth {self._src_bits}")
            self._src_dtype = dt
        elif fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
            self._src_dtype = np.dtype(np.float32).newbyteorder("<") \
                if self._src_bits == 32 else np.dtype(np.float64).newbyteorder("<")
        elif fmt_tag == _WAVE_FORMAT_ALAW:
            self._src_dtype = "alaw"
            self._src_bits = 16
        elif fmt_tag == _WAVE_FORMAT_MULAW:
            self._src_dtype = "ulaw"
            self._src_bits = 16
        elif fmt_tag in (_WAVE_FORMAT_IMA_ADPCM, _WAVE_FORMAT_MS_ADPCM):
            nch = max(self.channels, 1)
            # wSamplesPerBlock lives in the fmt extension (cbSize >= 2)
            if len(fmt_extra) >= 4:
                spb = struct.unpack("<H", fmt_extra[2:4])[0]
            elif fmt_tag == _WAVE_FORMAT_IMA_ADPCM:
                spb = (block_align - 4 * nch) * 2 // nch + 1
            else:
                spb = (block_align - 7 * nch) * 2 // nch + 2
            data = self._fh.read(self._data_remaining)
            if fmt_tag == _WAVE_FORMAT_IMA_ADPCM:
                vals = _ima_decode(data, block_align, nch, spb)
            else:
                # wNumCoef + coefficient pairs follow wSamplesPerBlock
                coefs = _MS_COEF_DEFAULT
                if len(fmt_extra) >= 6:
                    ncoef = struct.unpack("<H", fmt_extra[4:6])[0]
                    if ncoef and len(fmt_extra) >= 6 + 4 * ncoef:
                        coefs = [struct.unpack_from("<hh", fmt_extra,
                                                    6 + 4 * i)
                                 for i in range(ncoef)]
                try:
                    vals = _ms_decode(data, block_align, nch, spb, coefs)
                except RuntimeError as e:
                    raise RuntimeError(f"{self.path}: {e}") from None
                # libsndfile reports whole decoded blocks for MS ADPCM
                # (fact is ignored on read); match sf_readf_float
                fact_frames = None
            if fact_frames is not None:
                vals = vals[: fact_frames * self.channels]
            self._src_bits = 16
            self._src_fmt_tag = fmt_tag
            self._mem_buf = self._convert(vals, src_bits=16)
            self._mem_pos = 0
            self._src_dtype = "mem"
            self._data_remaining = self._mem_buf.nbytes
            return
        elif fmt_tag == _WAVE_FORMAT_GSM610:
            data = self._fh.read(self._data_remaining)
            if self._data_remaining & 1:
                # libsndfile counts the RIFF pad byte into the GSM data
                # length, so an odd block count decodes one extra
                # zero-filled block (verified against the 1.1.0 oracle)
                data += self._fh.read(1)
            vals = _gsm610_decode(data, wav49=True)
            self._src_bits = 16
            self._src_fmt_tag = fmt_tag
            self._mem_buf = self._convert(vals, src_bits=16)
            self._mem_pos = 0
            self._src_dtype = "mem"
            self._data_remaining = self._mem_buf.nbytes
            return
        else:
            raise RuntimeError(f"{self.path}: unsupported WAV format {fmt_tag}")
        self._src_fmt_tag = fmt_tag

    def _parse_au(self) -> None:
        self.container = "au"
        hdr = self._fh.read(20)
        data_off, data_size, enc, rate, nch = struct.unpack(">IIIII", hdr)
        self._fh.seek(data_off)
        self.rate = rate
        self.channels = nch
        if enc == _AU_ENC_PCM16:
            self._src_dtype = np.dtype(np.int16).newbyteorder(">")
            self._src_fmt_tag = _WAVE_FORMAT_PCM
            self._src_bits = 16
        elif enc == _AU_ENC_FLOAT32:
            self._src_dtype = np.dtype(np.float32).newbyteorder(">")
            self._src_fmt_tag = _WAVE_FORMAT_IEEE_FLOAT
            self._src_bits = 32
        elif enc == _AU_ENC_FLOAT64:
            self._src_dtype = np.dtype(np.float64).newbyteorder(">")
            self._src_fmt_tag = _WAVE_FORMAT_IEEE_FLOAT
            self._src_bits = 64
        elif enc == _AU_ENC_PCM8:          # signed 8-bit linear
            self._src_dtype = np.dtype(np.int8)
            self._src_fmt_tag = _WAVE_FORMAT_PCM
            self._src_bits = 8
        elif enc == _AU_ENC_PCM24:
            self._src_dtype = "i24be"
            self._src_fmt_tag = _WAVE_FORMAT_PCM
            self._src_bits = 24
        elif enc == _AU_ENC_PCM32:
            self._src_dtype = np.dtype(np.int32).newbyteorder(">")
            self._src_fmt_tag = _WAVE_FORMAT_PCM
            self._src_bits = 32
        elif enc == _AU_ENC_ULAW:
            self._src_dtype = "ulaw"
            self._src_fmt_tag = _WAVE_FORMAT_MULAW
            self._src_bits = 16
        elif enc == _AU_ENC_ALAW:
            self._src_dtype = "alaw"
            self._src_fmt_tag = _WAVE_FORMAT_ALAW
            self._src_bits = 16
        else:
            raise RuntimeError(f"{self.path}: unsupported AU encoding {enc}")
        size = os.fstat(self._fh.fileno()).st_size
        self._data_remaining = min(data_size, size - data_off)

    def _parse_flac(self) -> None:
        """Decode the whole FLAC stream up front via the native decoder
        (native/flacdec.cpp) and serve reads from memory."""
        import ctypes

        from .. import native

        self.container = "flac"
        lib = native.load()
        if lib is None or not hasattr(lib, "mm_flac_info"):
            raise RuntimeError(
                f"{self.path}: FLAC read needs the native library "
                f"(make -C minimodem_tpu_torch/native)")
        rate = ctypes.c_int()
        nch = ctypes.c_int()
        bits = ctypes.c_int()
        nfr = ctypes.c_longlong()
        rc = lib.mm_flac_info(self.path.encode(), ctypes.byref(rate),
                              ctypes.byref(nch), ctypes.byref(bits),
                              ctypes.byref(nfr))
        if rc != 0:
            raise RuntimeError(f"{self.path}: not a decodable FLAC stream")
        self.rate = rate.value
        self.channels = nch.value
        self._src_bits = bits.value
        self._src_fmt_tag = _WAVE_FORMAT_PCM
        total = int(nfr.value)
        if total == 0:
            # STREAMINFO total-samples 0 = unknown (streaming encoders):
            # decode with a growing capacity until a call comes back
            # short of the buffer
            total = max(os.fstat(self._fh.fileno()).st_size, 1 << 16)
        while True:
            buf = np.zeros(max(total, 1) * self.channels, np.int32)
            got = lib.mm_flac_read(
                self.path.encode(),
                buf.ctypes.data_as(ctypes.c_void_p), total)
            if got < 0:
                raise RuntimeError(f"{self.path}: FLAC decode failed")
            if got < total or int(nfr.value) > 0:
                break
            total *= 4
        self._flac_buf = buf[: int(got) * self.channels]
        self._flac_pos = 0
        self._src_dtype = "flac"
        self._data_remaining = self._flac_buf.size * 4

    def _parse_ogg(self) -> None:
        """Decode the whole OGG Vorbis stream up front (sigio/oggvorbis.py)
        and serve reads from memory, already in the stream's format."""
        from .oggvorbis import read_ogg

        self._fh.seek(0)
        self.container = "ogg"
        want_float = self.format is SampleFormat.FLOAT
        samples, rate, nch = read_ogg(self.path, want_float)
        self.rate = rate
        self.channels = nch
        self._mem_buf = samples
        self._mem_pos = 0
        self._src_dtype = "mem"
        self._src_fmt_tag = _WAVE_FORMAT_IEEE_FLOAT if want_float \
            else _WAVE_FORMAT_PCM
        self._src_bits = 32 if want_float else 16
        self._data_remaining = samples.nbytes

    def _read(self, nframes: int) -> np.ndarray:
        if self._src_dtype == "mem":
            n = min(nframes * self.channels,
                    self._mem_buf.size - self._mem_pos)
            vals = self._mem_buf[self._mem_pos: self._mem_pos + n]
            self._mem_pos += n
            self._data_remaining = (
                (self._mem_buf.size - self._mem_pos)
                * self._mem_buf.itemsize)
            return vals
        if self._src_dtype == "flac":
            n = min(nframes * self.channels,
                    self._flac_buf.size - self._flac_pos)
            vals = self._flac_buf[self._flac_pos: self._flac_pos + n]
            self._flac_pos += n
            self._data_remaining = (self._flac_buf.size - self._flac_pos) * 4
            return self._convert(vals)
        if self._src_dtype in ("i24", "i24be"):
            return self._read_pcm24(nframes, self._src_dtype == "i24be")
        if self._src_dtype in ("alaw", "ulaw"):
            # G.711 companded bytes -> int16 via the libsndfile tables
            # (the reference reads these transparently through
            # sf_readf_float, src/simpleaudio-sndfile.c:46-70)
            from .containers import _ALAW_DEC, _ULAW_DEC

            want = min(nframes * self.channels, self._data_remaining)
            raw = self._fh.read(want)
            self._data_remaining -= len(raw)
            b = np.frombuffer(raw, np.uint8)
            if getattr(self, "_raw_u8", False):
                return b                     # wire bytes, expanded on device
            table = _ALAW_DEC if self._src_dtype == "alaw" else _ULAW_DEC
            return self._convert(table[b], src_bits=16)
        dt = np.dtype(self._src_dtype)
        want = nframes * self.channels * dt.itemsize
        want = min(want, self._data_remaining)
        raw = self._fh.read(want)
        self._data_remaining -= len(raw)
        n = len(raw) // dt.itemsize
        vals = np.frombuffer(raw[: n * dt.itemsize], dtype=dt)
        if getattr(self, "_raw_u8", False) and dt == np.uint8:
            return vals                      # PCM8 wire bytes
        return self._convert(vals)

    def _read_pcm24(self, nframes: int, big_endian: bool = False) -> np.ndarray:
        want = min(nframes * self.channels * 3, self._data_remaining)
        raw = self._fh.read(want)
        self._data_remaining -= len(raw)
        n = len(raw) // 3
        b = np.frombuffer(raw[: n * 3], dtype=np.uint8).reshape(n, 3)
        if big_endian:
            b = b[:, ::-1]
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
        )
        # scale like 32-bit PCM for normalization purposes
        vals = vals << 8
        return self._convert(vals.view(np.int32), src_bits=32)

    def _convert(self, vals: np.ndarray, src_bits: int | None = None) -> np.ndarray:
        """Convert source samples to the stream's requested format using
        libsndfile's normalization conventions (PCM16 <-> float via /32768)."""
        bits = src_bits or getattr(self, "_src_bits", 16)
        if self.format is SampleFormat.FLOAT:
            if vals.dtype.kind == "f":
                return np.asarray(vals, dtype=np.float32)
            if vals.dtype == np.uint8:
                return ((vals.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
            scale = np.float32(1 << (bits - 1))
            return (vals.astype(np.float32) / scale).astype(np.float32)
        else:  # S16
            if vals.dtype.kind == "f":
                f = np.clip(np.asarray(vals, np.float32), -1.0, 1.0)
                return (f * 32767.0).astype(np.int16)
            if vals.dtype == np.uint8:
                return ((vals.astype(np.int16) - 128) << 8).astype(np.int16)
            if bits == 16:
                return np.asarray(vals, np.int16)
            if bits < 16:                  # signed PCM8 (AU/AIFF)
                return (vals.astype(np.int16) << (16 - bits)).astype(np.int16)
            return (vals >> (bits - 16)).astype(np.int16)

    # ================= close =================
    def _close(self) -> None:
        if self.direction is Direction.PLAYBACK:
            if self.container == "flac":
                from .flacenc import encode

                pend = (np.concatenate(self._flac_pending)
                        if self._flac_pending
                        else np.zeros(0, self.format.dtype))
                bps = self._pcm_bits or 16
                if self.format is SampleFormat.S16 and bps != 16:
                    pend = pend.astype(np.int32) << (bps - 16)
                self._fh.write(encode(pend, self.rate, self.channels, bps))
            elif self.container == "ogg":
                self._ogg_writer.close()
            else:
                # packetizing codecs (SDS) may hold a partial packet
                flush = getattr(self._codec, "flush", None) \
                    if self._codec is not None else None
                if flush is not None:
                    tail = flush(self)
                    if tail:
                        self._fh.write(tail)
                        self._data_bytes = getattr(
                            self, "_data_bytes", 0) + len(tail)
                # trailer bytes (VOC terminator block) follow the data
                # but do NOT count toward the header's data size field
                trailer = getattr(self._codec, "trailer", None) \
                    if self._codec is not None else None
                if trailer is not None:
                    t = trailer(self)
                    if t:
                        self._fh.write(t)
                data_nbytes = getattr(self, "_data_bytes", 0)
                if self.container == "wav":
                    self._fh.seek(0)
                    self._fh.write(self._wav_header(data_nbytes))
                elif self.container == "au":
                    self._fh.seek(0)
                    self._fh.write(self._au_header(data_nbytes))
                elif self._codec is not None:
                    self._fh.seek(0)
                    self._fh.write(self._codec.header(self, data_nbytes))
        self._fh.close()


def read_all(path: str, fmt: SampleFormat = SampleFormat.FLOAT):
    """Convenience: read an entire audio file -> (samples, rate, channels)."""
    st = FileStream(path, Direction.RECORD, fmt, 0, 1)
    chunks = []
    while True:
        c = st.read(1 << 20)
        if c.size == 0:
            break
        chunks.append(c)
    rate, ch = st.rate, st.channels
    st.close()
    if chunks:
        samples = np.concatenate(chunks)
    else:
        samples = np.zeros(0, dtype=fmt.dtype)
    return samples, rate, ch
