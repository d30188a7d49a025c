"""OGG Vorbis read/write via ctypes (reference: src/simpleaudio-sndfile.c
SF_FORMAT_OGG, table entry :137).

The reference gets OGG through libsndfile; this build talks to the Xiph
libraries directly at runtime (libvorbisfile for decode, libvorbis +
libvorbisenc + libogg for encode), so there is no build-time codec
dependency.  Hosts without the libraries get a clear one-line error.

Decode: ov_fopen / ov_info / ov_read(_float) / ov_clear — the whole
stream is decoded up front (modem inputs are seconds long).

Encode: the canonical libvorbis analysis loop (vorbis_encode_init_vbr ->
vorbis_analysis_buffer/wrote -> blockout/analysis/bitrate ->
ogg_stream pages).  The ogg serial number is fixed, and vorbis's
analysis is deterministic, so output files are byte-deterministic like
every other writer in this backend (the property the TX-consistency
tests rely on).  Quality 0.4 (~128 kbps at 44.1k stereo) keeps FSK
tones well above the lossy floor.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_QUALITY = 0.4
_SERIALNO = 0x4D4D  # fixed: deterministic output

_libs = None
_tried = False


class OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


class VorbisInfo(ctypes.Structure):
    _fields_ = [("version", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("rate", ctypes.c_long),
                ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long),
                ("codec_setup", ctypes.c_void_p)]


# opaque state blobs: we only ever pass pointers, the real structs are
# smaller than these buffers (OggVorbis_File ~944B, vorbis_dsp_state
# ~192B, vorbis_block ~192B, ogg_stream_state ~408B, vorbis_comment 32B)
_OVFILE_SIZE = 2048
_OPAQUE_SIZE = 4096


def load_libvorbis():
    """Load the Xiph codec stack once; None when it isn't on this host.
    Returns (vorbisfile, vorbis, vorbisenc, ogg) CDLLs."""
    global _libs, _tried
    if _libs is not None or _tried:
        return _libs
    _tried = True
    names = {}
    for key in ("vorbisfile", "vorbis", "vorbisenc", "ogg"):
        name = ctypes.util.find_library(key)
        if not name:
            return None
        names[key] = name
    try:
        libs = tuple(ctypes.CDLL(names[k])
                     for k in ("vorbisfile", "vorbis", "vorbisenc", "ogg"))
        _prototypes(*libs)
    except OSError:
        return None
    _libs = libs
    return _libs


def _prototypes(vf, vb, ve, og) -> None:
    c = ctypes
    vf.ov_fopen.restype = c.c_int
    vf.ov_fopen.argtypes = [c.c_char_p, c.c_void_p]
    vf.ov_info.restype = c.POINTER(VorbisInfo)
    vf.ov_info.argtypes = [c.c_void_p, c.c_int]
    vf.ov_pcm_total.restype = c.c_int64
    vf.ov_pcm_total.argtypes = [c.c_void_p, c.c_int]
    vf.ov_read.restype = c.c_long
    vf.ov_read.argtypes = [c.c_void_p, c.c_void_p, c.c_int, c.c_int,
                           c.c_int, c.c_int, c.POINTER(c.c_int)]
    vf.ov_read_float.restype = c.c_long
    vf.ov_read_float.argtypes = [
        c.c_void_p, c.POINTER(c.POINTER(c.POINTER(c.c_float))), c.c_int,
        c.POINTER(c.c_int)]
    vf.ov_clear.restype = c.c_int
    vf.ov_clear.argtypes = [c.c_void_p]

    vb.vorbis_info_init.argtypes = [c.c_void_p]
    vb.vorbis_info_clear.argtypes = [c.c_void_p]
    vb.vorbis_comment_init.argtypes = [c.c_void_p]
    vb.vorbis_comment_clear.argtypes = [c.c_void_p]
    vb.vorbis_analysis_init.restype = c.c_int
    vb.vorbis_analysis_init.argtypes = [c.c_void_p, c.c_void_p]
    vb.vorbis_block_init.restype = c.c_int
    vb.vorbis_block_init.argtypes = [c.c_void_p, c.c_void_p]
    vb.vorbis_analysis_headerout.restype = c.c_int
    vb.vorbis_analysis_headerout.argtypes = [
        c.c_void_p, c.c_void_p, c.POINTER(OggPacket), c.POINTER(OggPacket),
        c.POINTER(OggPacket)]
    vb.vorbis_analysis_buffer.restype = c.POINTER(c.POINTER(c.c_float))
    vb.vorbis_analysis_buffer.argtypes = [c.c_void_p, c.c_int]
    vb.vorbis_analysis_wrote.restype = c.c_int
    vb.vorbis_analysis_wrote.argtypes = [c.c_void_p, c.c_int]
    vb.vorbis_analysis_blockout.restype = c.c_int
    vb.vorbis_analysis_blockout.argtypes = [c.c_void_p, c.c_void_p]
    vb.vorbis_analysis.restype = c.c_int
    vb.vorbis_analysis.argtypes = [c.c_void_p, c.POINTER(OggPacket)]
    vb.vorbis_bitrate_addblock.restype = c.c_int
    vb.vorbis_bitrate_addblock.argtypes = [c.c_void_p]
    vb.vorbis_bitrate_flushpacket.restype = c.c_int
    vb.vorbis_bitrate_flushpacket.argtypes = [c.c_void_p,
                                              c.POINTER(OggPacket)]
    vb.vorbis_block_clear.argtypes = [c.c_void_p]
    vb.vorbis_dsp_clear.argtypes = [c.c_void_p]

    ve.vorbis_encode_init_vbr.restype = c.c_int
    ve.vorbis_encode_init_vbr.argtypes = [c.c_void_p, c.c_long, c.c_long,
                                          c.c_float]

    og.ogg_stream_init.restype = c.c_int
    og.ogg_stream_init.argtypes = [c.c_void_p, c.c_int]
    og.ogg_stream_packetin.restype = c.c_int
    og.ogg_stream_packetin.argtypes = [c.c_void_p, c.POINTER(OggPacket)]
    og.ogg_stream_pageout.restype = c.c_int
    og.ogg_stream_pageout.argtypes = [c.c_void_p, c.POINTER(OggPage)]
    og.ogg_stream_flush.restype = c.c_int
    og.ogg_stream_flush.argtypes = [c.c_void_p, c.POINTER(OggPage)]
    og.ogg_stream_clear.restype = c.c_int
    og.ogg_stream_clear.argtypes = [c.c_void_p]


def read_ogg(path: str, want_float: bool):
    """Decode a whole .ogg file -> (samples interleaved, rate, channels).
    samples: float32 when want_float else int16."""
    libs = load_libvorbis()
    if libs is None:
        raise RuntimeError(
            f"{path}: OGG needs the vorbis libraries (libvorbisfile not "
            f"found on this host)")
    vf = libs[0]
    ovf = ctypes.create_string_buffer(_OVFILE_SIZE)
    if vf.ov_fopen(path.encode(), ovf) != 0:
        raise RuntimeError(f"{path}: not a decodable OGG Vorbis stream")
    try:
        info = vf.ov_info(ovf, -1).contents
        rate, channels = int(info.rate), int(info.channels)
        bitstream = ctypes.c_int(0)
        chunks = []
        if want_float:
            pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
            while True:
                n = vf.ov_read_float(ovf, ctypes.byref(pcm), 4096,
                                     ctypes.byref(bitstream))
                if n == -3:        # OV_HOLE: recoverable gap, keep going
                    continue
                if n <= 0:
                    break
                frame = np.empty((int(n), channels), np.float32)
                for ch in range(channels):
                    frame[:, ch] = np.ctypeslib.as_array(pcm[ch],
                                                         (int(n),))
                chunks.append(frame.reshape(-1))
            out_dtype = np.float32
        else:
            buf = ctypes.create_string_buffer(4096 * 4)
            while True:
                n = vf.ov_read(ovf, buf, len(buf), 0, 2, 1,
                               ctypes.byref(bitstream))
                if n == -3:        # OV_HOLE: recoverable gap, keep going
                    continue
                if n <= 0:
                    break
                chunks.append(np.frombuffer(buf.raw[:int(n)],
                                            np.int16).copy())
            out_dtype = np.int16
        samples = (np.concatenate(chunks) if chunks
                   else np.zeros(0, out_dtype))
        return samples, rate, channels
    finally:
        vf.ov_clear(ovf)


class OggWriter:
    """Streaming OGG Vorbis encoder (canonical libvorbis analysis loop)."""

    def __init__(self, fh, rate: int, channels: int):
        libs = load_libvorbis()
        if libs is None:
            raise RuntimeError(
                "OGG needs the vorbis libraries (libvorbisenc not found "
                "on this host)")
        _, self._vb, ve, self._og = libs
        self._fh = fh
        self.channels = channels

        self._vi = ctypes.create_string_buffer(_OPAQUE_SIZE)
        self._vb.vorbis_info_init(self._vi)
        if ve.vorbis_encode_init_vbr(self._vi, channels, rate,
                                     _QUALITY) != 0:
            raise RuntimeError("E: vorbis_encode_init_vbr failed")
        self._vc = ctypes.create_string_buffer(_OPAQUE_SIZE)
        self._vb.vorbis_comment_init(self._vc)
        self._vd = ctypes.create_string_buffer(_OPAQUE_SIZE)
        self._vb.vorbis_analysis_init(self._vd, self._vi)
        self._blk = ctypes.create_string_buffer(_OPAQUE_SIZE)
        self._vb.vorbis_block_init(self._vd, self._blk)
        self._os = ctypes.create_string_buffer(_OPAQUE_SIZE)
        self._og.ogg_stream_init(self._os, _SERIALNO)

        hdr = OggPacket()
        hdr_comm = OggPacket()
        hdr_code = OggPacket()
        self._vb.vorbis_analysis_headerout(
            self._vd, self._vc, ctypes.byref(hdr), ctypes.byref(hdr_comm),
            ctypes.byref(hdr_code))
        for p in (hdr, hdr_comm, hdr_code):
            self._og.ogg_stream_packetin(self._os, ctypes.byref(p))
        self._drain(flush=True)   # audio data must start on a fresh page

    def _drain(self, flush: bool) -> None:
        page = OggPage()
        fn = self._og.ogg_stream_flush if flush \
            else self._og.ogg_stream_pageout
        while fn(self._os, ctypes.byref(page)) != 0:
            self._fh.write(ctypes.string_at(page.header, page.header_len))
            self._fh.write(ctypes.string_at(page.body, page.body_len))

    def _pump(self) -> None:
        op = OggPacket()
        while self._vb.vorbis_analysis_blockout(self._vd, self._blk) == 1:
            self._vb.vorbis_analysis(self._blk, None)
            self._vb.vorbis_bitrate_addblock(self._blk)
            while self._vb.vorbis_bitrate_flushpacket(
                    self._vd, ctypes.byref(op)) == 1:
                self._og.ogg_stream_packetin(self._os, ctypes.byref(op))
                self._drain(flush=False)

    def write(self, samples: np.ndarray) -> None:
        """samples: interleaved float32 in [-1, 1] or int16."""
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / np.float32(32768.0)
        frames = np.ascontiguousarray(samples, np.float32).reshape(
            -1, self.channels)
        n = frames.shape[0]
        if n == 0:
            return
        buf = self._vb.vorbis_analysis_buffer(self._vd, n)
        for ch in range(self.channels):
            ctypes.memmove(
                buf[ch], np.ascontiguousarray(frames[:, ch]).ctypes.data,
                n * 4)
        self._vb.vorbis_analysis_wrote(self._vd, n)
        self._pump()

    def close(self) -> None:
        self._vb.vorbis_analysis_wrote(self._vd, 0)   # end of stream
        self._pump()
        self._drain(flush=True)
        self._og.ogg_stream_clear(self._os)
        self._vb.vorbis_block_clear(self._blk)
        self._vb.vorbis_dsp_clear(self._vd)
        self._vb.vorbis_comment_clear(self._vc)
        self._vb.vorbis_info_clear(self._vi)
