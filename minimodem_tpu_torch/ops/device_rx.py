"""Device-resident receiver: audio in, events and bytes out.

Counterpart of minimodem_tpu/ops/device_rx.py.  One call runs the whole
receive pipeline on the device:

  wire   : the host uploads int16 / float32 / raw u8 (G.711, PCM8) samples
           or a delta-bitpacked int16 row (ops/wirepack.py), and the
           device normalizes them (normalize_input, expand_wire,
           wirepack.unpack_expand)
  score  : per-offset score planes, by geometry alone: K1, the fused
           scorer (ops/fused_score.py), where it serves the geometry, else
           make_score_packer (stage 1 through K3, the FFT or the float64
           chain, then the frame channels through K5,
           ops/frame_channels.py)
  K2     : the carrier state machine over the planes -> events, bytes and
           the streaming carry (ops/mega_rx.py), in compact mode (data
           bytes, carrier transitions) or with wide records (one per
           frame, its raw bits), optionally stopping at every
           no-confidence overflow (the device -a loop)

Only the event log and the decoded bytes return to the host, where
rx/engine.py renders them.  Decisions replay the reference's sequential
receive loop (reference: src/minimodem.c:1137-1463, src/fsk.c:449-538)
and match the JAX package event for event.

PipelinedReceiver cuts a known-length stream into carried segments;
DeviceStreamReceiver takes audio as it arrives (live RX, live -a) and
decodes each whole segment with the carry of the one before.

DeviceLoopback puts device synthesis (ops/tx_device.py) in front of the
scorer and K2: bit schedules go up, events come back, and the audio never
crosses the host link.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import ModemConfig
from ..utils import device as _device
from ..utils import trace as _trace
from .demod import DemodGeometry, geometry_from_config
from .wirepack import parse_spec

FSK_ANALYZE_NSTEPS = 3          # reference: src/minimodem.c:1248
FSK_ANALYZE_NSTEPS_FINE = 8     # reference: src/minimodem.c:1365
FSK_MAX_NOCONFIDENCE_BITS = 20  # reference: src/minimodem.c:1290

# event types in the output stream
EV_FRAME = 0
EV_CARRIER = 1
EV_NOCARRIER = 2
# flag folded into the device event-type word (host expands to EV_CARRIER)
EV_FLAG_ACQUIRED = 1 << 8


def unpack_events(ev_8e: np.ndarray, n: int):
    """Unpack a device event log [8, E] uint32 (columns = records) into the
    host event-stream form (ev_type [M] i32, ev_pay [M, 6] u32), expanding
    ACQUIRED-flagged frames into a CARRIER event followed by the frame."""
    rec = np.ascontiguousarray(ev_8e[:, :n].T)          # [n, 8]
    types = (rec[:, 6] & 0xFF).astype(np.int32)
    acq = (rec[:, 6] & EV_FLAG_ACQUIRED) != 0
    m = n + int(acq.sum())
    out_t = np.empty(m, np.int32)
    out_p = np.zeros((m, 6), np.uint32)
    ins = np.cumsum(acq) - acq.astype(np.int64)          # exclusive prefix
    idx = np.arange(n) + ins + acq                        # record positions
    out_t[idx] = types
    out_p[idx] = rec[:, :6]
    car_idx = idx[acq] - 1
    out_t[car_idx] = EV_CARRIER
    out_p[car_idx] = 0
    return out_t, out_p


def _scan_order(try_first: int, try_max: int, try_step: int) -> list:
    """The center-out candidate order of fsk_find_frame
    (reference: src/fsk.c:477-502), as a static offset list."""
    out = []
    j = 0
    while True:
        up = 1 if (j % 2) else -1
        t = try_first + up * ((j + 1) // 2) * try_step
        j += 1
        if t >= try_max:
            break
        if t < 0:
            continue
        out.append(t)
        if j > 8192:
            break
    return out


def device_rx_key(cfg: ModemConfig, precision: str = "auto"):
    """Hashable snapshot of everything the receiver depends on (the same
    tuple as the JAX package's device_rx_key)."""
    geo = geometry_from_config(cfg, precision)
    return (
        cfg.sample_rate,
        int(np.float32(cfg.data_rate).view(np.uint32)),
        cfg.n_data_bits,
        cfg.nstartbits,
        int(np.float32(cfg.nstopbits).view(np.uint32)),
        geo.b_mark, geo.b_space, geo.fftsize, geo.nb,
        int(np.float32(geo.magscalar).view(np.uint32)),
        geo.bit_begin, geo.n_bits, geo.req_data, geo.req_sync, geo.use_f64,
        cfg.frame_nsamples, cfg.nsamples_overscan, cfg.expect_nsamples,
        cfg.msb_first, cfg.do_rx_sync, cfg.sync_byte,
    )


CARRY_FIELDS = (
    "pos", "carrier", "noconfidence", "track_amplitude", "peak_confidence",
    "conf_total", "ampl_total", "nframes", "carrier_nsamples", "stop",
)


def zero_carry(batch: int) -> dict:
    """Fresh per-stream state machine carry (all counters zero)."""
    zf = np.zeros(batch, np.float32)
    zi = np.zeros(batch, np.int32)
    zb = np.zeros(batch, bool)
    return {
        "pos": zi.copy(), "carrier": zb.copy(), "noconfidence": zi.copy(),
        "track_amplitude": zf.copy(), "peak_confidence": zf.copy(),
        "conf_total": zf.copy(), "ampl_total": zf.copy(),
        "nframes": zi.copy(), "carrier_nsamples": zi.copy(),
        "stop": zb.copy(),
    }


def geo_from_key(cfg_key) -> DemodGeometry:
    (sample_rate, data_rate_bits, n_data_bits, nstartbits, nstopbits_bits,
     b_mark, b_space, fftsize, nb, magscalar_bits, bit_begin, n_bits,
     req_data, req_sync, use_f64, frame_nsamples, overscan,
     expect_nsamples, msb_first, do_rx_sync, sync_byte) = cfg_key
    return DemodGeometry(
        nb=nb, fftsize=fftsize, b_mark=b_mark, b_space=b_space,
        magscalar=float(np.uint32(magscalar_bits).view(np.float32)),
        bit_begin=bit_begin, n_bits=n_bits, req_data=req_data,
        req_sync=req_sync, use_f64=use_f64)


def normalize_input(x: torch.Tensor, input_dtype: str) -> torch.Tensor:
    """Device-side sample normalization for compact wire encodings.

    "int16" is x/32768 (the libsndfile convention the reference relies
    on, sf_readf_float in src/simpleaudio-sndfile.c:49); "ulaw" / "alaw"
    / "pcm8" expand one byte per sample with the same integer algebra as
    the host tables (sigio/containers.py _ULAW_DEC/_ALAW_DEC), so device
    values are bit-identical to a host-expanded float read."""
    scale = 32768.0
    if input_dtype == "int16":
        return x.to(torch.float32) / scale
    if input_dtype == "ulaw":
        u = ~x.to(torch.int32) & 0xFF
        t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
        v = torch.where((u & 0x80) != 0, 0x84 - t, t - 0x84)
        return v.to(torch.float32) / scale
    if input_dtype == "alaw":
        a = x.to(torch.int32) ^ 0x55
        t = (a & 0x0F) << 4
        seg = (a & 0x70) >> 4
        t = torch.where(seg == 0, t + 8,
                        torch.where(seg == 1, t + 0x108,
                                    (t + 0x108)
                                    << torch.clamp(seg - 1, min=0)))
        v = torch.where((a & 0x80) != 0, t, -t)
        return v.to(torch.float32) / scale
    if input_dtype == "pcm8":                # unsigned WAV PCM8
        v = (x.to(torch.int32) - 128) << 8
        return v.to(torch.float32) / scale
    return x.to(torch.float32)


# wire dtypes that arrive as raw uint8 and expand on device
U8_ENCODINGS = ("ulaw", "alaw", "pcm8")

# pad/fill byte per encoding: u-law 0xFF and PCM8 0x80 decode to exactly
# 0.0; A-law has no zero codeword (0xD5 decodes to +8), so expand_wire
# also masks expanded u8 wires to exact 0.0 past each stream's total
# (reference zero-refill: src/minimodem.c:1166-1174)
PAD_BYTE = {"ulaw": 0xFF, "alaw": 0xD5, "pcm8": 0x80}


def expand_wire(x: torch.Tensor, total: torch.Tensor, input_dtype: str,
                extra: int = 0) -> torch.Tensor:
    """Expand a raw-u8 wire buffer [B, T] on device and zero every
    position >= the stream's real-sample end (total + extra).

    extra: count of REAL samples past `total` (a segmented decode feeds
    lookahead beyond the scan bound, which must not be clipped); 0 for
    one-shot calls, where `total` IS the end of real data."""
    v = normalize_input(x, input_dtype)
    idx = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    bound = total.to(torch.int32) + extra
    return torch.where(idx[None, :] < bound[:, None], v,
                       torch.zeros((), dtype=v.dtype, device=v.device))


def wire_pad(in_encoding: str = None) -> int:
    """The silence codeword of a wire, past its samples: PAD_BYTE for a
    raw u8 encoding, 0 for int16, float32 and dpack (zero header seeds and
    zero deltas reconstruct exact silence)."""
    return PAD_BYTE.get(in_encoding, 0)


def wire_dtype(samples: np.ndarray, in_encoding: str = None) -> str:
    """Wire encoding of a host sample array: a dpack spec
    (ops/wirepack.py) or an explicit u8 encoding (U8_ENCODINGS) wins;
    else int16/float32 by dtype."""
    if in_encoding and parse_spec(in_encoding):
        return in_encoding
    if in_encoding:
        if in_encoding not in U8_ENCODINGS:
            raise ValueError(f"unknown wire encoding {in_encoding!r}")
        if samples.dtype != np.uint8:
            raise ValueError(f"{in_encoding} wire needs uint8 samples, got "
                             f"{samples.dtype}")
        return in_encoding
    return "int16" if samples.dtype == np.int16 else "float32"


def _round_up_pow2(n: int, floor: int = 1 << 14) -> int:
    """Bucket sizes to limit distinct shapes without inflating memory:
    powers of two up to 256K, then multiples of 256K."""
    v = floor
    while v < n and v < (1 << 18):
        v *= 2
    if v < n:
        step = 1 << 18
        v = ((n + step - 1) // step) * step
    return v


def plane_names(geo: DemodGeometry) -> list:
    """The channels of the score planes K2 reads, in row order: conf_data,
    ampl_data, bits_lo; then conf_sync, ampl_sync where the sync expect
    string differs from the data one (the dual layout); then bits_hi, the
    frame bits' high word, where a frame has more than 32 bits."""
    names = ["conf_data", "ampl_data", "bits_lo"]
    if tuple(geo.req_sync) != tuple(geo.req_data):
        names += ["conf_sync", "ampl_sync"]
    if geo.n_bits > 32:
        names.append("bits_hi")
    return names


# offsets scored per tile of make_score_packer (the JAX package's T_TILE)
SCORE_TILE = 1 << 18


def make_score_packer(cfg_key, t_total: int, input_dtype: str):
    """fn x[B, t_total + halo] (wire dtype) -> score planes
    [B, len(plane_names), t_total] int32, for the geometries K1 does not serve
    (minimodem_tpu/ops/device_rx.py:244-309): stage 1 by the route the
    geometry needs (ops/demod.py correlator_for: K3 for float32 filters of
    up to 4096 taps, the FFT beyond, the float64 chain for float64
    geometries), then the frame channels by K5 (ops/frame_channels.py)
    straight into the tile's columns of the planes.  Scores tiles of
    min(t_total, SCORE_TILE) offsets, so the correlation exists only at
    tile size; a ragged last tile is scored over zero padding, only its
    first t_total - t0 offsets."""
    from .demod import correlator_for, make_basis
    from .frame_channels import FrameChannels

    geo = geo_from_key(cfg_key)
    stage1 = correlator_for(
        geo, make_basis(geo, np.float64 if geo.use_f64 else np.float32))
    channels = FrameChannels(geo)
    tile = min(t_total, SCORE_TILE)
    n_tiles = -(-t_total // tile)
    rows = plane_names(geo)

    def score_planes(x: torch.Tensor) -> torch.Tensor:
        x = normalize_input(x, input_dtype)
        b = x.shape[0]
        need = n_tiles * tile + geo.halo
        if x.shape[1] < need:
            x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
        out = torch.empty((b, len(rows), t_total), dtype=torch.int32,
                          device=x.device)
        for k in range(n_tiles):
            t0 = k * tile
            corr = stage1(x[:, t0:t0 + tile + geo.halo],
                          tile + geo.max_begin)
            channels(corr, min(tile, t_total - t0), out, rows, t0)
        return out

    return score_planes


def make_score_packer_planes(cfg_key, t_total: int, input_dtype: str):
    """fn x[B, t_total + halo] (wire dtype) -> score planes
    [B, n_planes, t_total] int32, by geometry alone: K1
    (ops/fused_score.py) where it serves the geometry, else
    make_score_packer.  Returns (fn, n_planes)."""
    from . import fused_score

    geo = geo_from_key(cfg_key)
    if not fused_score.serves(geo):
        return (make_score_packer(cfg_key, t_total, input_dtype),
                len(plane_names(geo)))
    scorer = fused_score.FusedScorer(geo)

    def score_planes(x: torch.Tensor) -> torch.Tensor:
        return scorer(normalize_input(x, input_dtype), t_total)

    return score_planes, scorer.n_planes


def _per_stream(nev: np.ndarray, nby: np.ndarray, ev_h: np.ndarray,
                by_h: np.ndarray, cap: int, compact: bool = True):
    """Host copies of the device results -> per-stream (ev_type, ev_pay,
    byte_stream) tuples, or (ev_type, ev_pay) with wide records.  ev_h
    [B, >= max n_ev, 8] int32, by_h [B, >= max n_by] uint8; cap is the
    device byte log's width."""
    bmax = int(nby.max(initial=0))
    if bmax > cap:
        raise RuntimeError(f"byte log overflow ({bmax} > {cap})")
    ev_h = ev_h.view(np.uint32)
    if not compact:
        return [unpack_events(ev_h[i].T, int(nev[i])) for i in range(len(nev))]
    return [
        (*unpack_events(ev_h[i].T, int(nev[i])), by_h[i, :int(nby[i])].copy())
        for i in range(len(nev))
    ]


def _collect(out, b: int, compact: bool = True):
    """Device results -> per-stream (ev_type, ev_pay, byte_stream) tuples,
    or (ev_type, ev_pay) with wide records (compact=False).
    out = (ev [B, E, 8] i32, n_ev [B], bytes [B, cap] u8, n_by [B])."""
    ev, n_ev, by, n_by = out
    nev = n_ev.cpu().numpy()
    nby = n_by.cpu().numpy()
    kmax = int(nev.max(initial=0))
    bmax = min(int(nby.max(initial=0)), by.shape[1])
    return _per_stream(nev, nby, ev[:, :kmax].cpu().numpy(),
                       by[:, :bmax].cpu().numpy(), by.shape[1], compact)


class DeviceReceiver:
    """Host wrapper: pads the streams, runs the scorer and K2 on `device`,
    returns the per-stream event tuples.

    compact "auto" (the JAX package's default): data bytes and carrier
    transitions for <= 8 data bits without stop_on_overflow, else wide
    records, one per frame with its raw bits.  stop_on_overflow (wide
    records only): every stream stops at its first no-confidence
    overflow, with each record's scan position in lane 5 (the device -a
    loop, rx/engine.py)."""

    def __init__(self, cfg: ModemConfig, precision: str = "auto",
                 rx_one: bool = False, compact="auto",
                 stop_on_overflow: bool = False, device=_device.DEFAULT):
        from .mega_rx import MegaReceiver

        self.cfg = cfg
        self.key = device_rx_key(cfg, precision)
        self.rx_one = rx_one
        self.stop_on_overflow = stop_on_overflow
        if compact == "auto":
            self.compact = cfg.n_data_bits <= 8 and not stop_on_overflow
        else:
            self.compact = bool(compact)
        self.device = torch.device(device)
        self._mega = MegaReceiver(cfg, precision, rx_one, self.device,
                                  self.compact, stop_on_overflow)

    def run_events_batch(self, samples: np.ndarray, totals,
                         conf_threshold: float, conf_search_limit: float,
                         carry=None, finalize: bool = True,
                         in_encoding: str = None):
        """samples: [B, L] (int16, float32, or uint8 with in_encoding in
        U8_ENCODINGS); totals: [B] valid lengths.
        Returns (events, carry_out): events is a list of per-stream
        tuples, (ev_type, ev_pay, byte_stream) in compact mode, else
        (ev_type, ev_pay).  Pass carry_out back in (with finalize=False on
        all but the last segment) for streaming decode."""
        return self._mega.run_events_batch(
            samples, totals, conf_threshold, conf_search_limit,
            carry=carry, finalize=finalize, in_encoding=in_encoding)


# the staging of every receiver's wire (MegaReceiver.run_events_batch,
# PipelinedReceiver.run, the fleet's ShardedReceiver): per device,
# STAGE_SLOTS host chunks of STAGE_CHUNK_BYTES, pinned on a card,
# allocated at first use and reused by every call after
STAGE_CHUNK_BYTES = 4 << 20
STAGE_SLOTS = 3
# a call whose samples reach this many bytes fills the chunks through
# ATen's copy on the intra-op threads, a smaller one through NumPy on the
# calling thread: below ~2 MB waking the threads costs more than they
# save (an H100's 8-core host, the stager's host time after 20 ms idle:
# a 0.26 MB streaming segment 0.90-1.17 ms by ATen against 0.60-0.68 by
# NumPy, 4 MB 0.95-1.17 against 1.34-1.56; PERF.md, Findings)
PARALLEL_FILL_BYTES = 4 << 20


def _host_view(samples: np.ndarray):
    """samples as a CPU tensor over their own memory, or None where torch
    cannot view them (a negative stride).  A read-only source (a WAV
    reader's np.frombuffer) is only read through the view, so torch's
    warning that it is not writable is silenced around this view alone."""
    try:
        if samples.flags.writeable:
            return torch.from_numpy(samples)
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", "The given NumPy array is not writable",
                UserWarning)
            return torch.from_numpy(samples)
    except ValueError:
        return None


class WireStager:
    """A wire's host -> device copy through reused host chunks: the host
    fills one chunk while the chunks before it move by DMA on a copy
    stream, and the pad columns are set on the device to the encoding's
    silence (wire_pad), so no call allocates or fills a wire-sized host
    buffer.  From PARALLEL_FILL_BYTES of samples up the host fills a
    chunk with ATen's copy, on the process's intra-op threads, from a
    tensor view of the samples; a smaller call, or a source torch cannot
    view, keeps NumPy's copy.  On the CPU the chunks are plain memory
    and the copies synchronous."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._chunks = [None] * STAGE_SLOTS
        self._done = [None] * STAGE_SLOTS     # each chunk's last DMA
        self._lock = threading.Lock()

    def _chunk(self, slot: int) -> torch.Tensor:
        """The slot's chunk once its last DMA has landed."""
        if self._done[slot] is not None:
            self._done[slot].synchronize()
        c = self._chunks[slot]
        if c is None:
            c = self._chunks[slot] = torch.empty(
                STAGE_CHUNK_BYTES, dtype=torch.uint8,
                pin_memory=self.stream is not None)
            _trace.add(alloc_bytes=c.numel())  # fresh host bytes, when traced
        return c

    def wire(self, samples: np.ndarray, row: int, in_encoding: str = None):
        """The wire [B, row] on the device in samples' dtype:
        samples[:, :row], then wire_pad(in_encoding) in every column past
        the samples.  Returns it and the count of chunks it took; join()
        before the launch stream reads it."""
        b, n = samples.shape
        m = min(n, row)
        dtype = torch.from_numpy(np.empty(0, samples.dtype)).dtype
        per = STAGE_CHUNK_BYTES // samples.itemsize
        chunks = 0
        on = (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext())
        with self._lock, on:
            src = (_host_view(samples)
                   if b * m * samples.itemsize >= PARALLEL_FILL_BYTES
                   else None)
            out = torch.empty((b, row), dtype=dtype, device=self.device)
            out[:, m:].fill_(wire_pad(in_encoding))
            for e0 in range(0, b * m, per):
                e1 = min(e0 + per, b * m)
                slot = chunks % STAGE_SLOTS
                host = self._chunk(slot)[:per * samples.itemsize].view(dtype)
                hn = host.numpy() if src is None else None
                e = e0
                while e < e1:              # the chunk's piece of each row
                    r, c = divmod(e, m)
                    k = min(m - c, e1 - e)
                    if src is None:
                        hn[e - e0:e - e0 + k] = samples[r, c:c + k]
                    else:
                        host[e - e0:e - e0 + k].copy_(src[r, c:c + k])
                    out[r, c:c + k].copy_(host[e - e0:e - e0 + k],
                                          non_blocking=True)
                    e += k
                if self.stream is not None:
                    self._done[slot] = self.stream.record_event()
                chunks += 1
            if src is not None:
                # the bytes filled on the intra-op threads, when traced
                _trace.add(parallel_bytes=b * m * samples.itemsize)
        return out, chunks

    def join(self, wire: torch.Tensor) -> None:
        """Make the launch stream wait for the wire's copies."""
        if self.stream is not None:
            launch = torch.cuda.current_stream(self.device)
            launch.wait_stream(self.stream)
            wire.record_stream(launch)


@functools.lru_cache(maxsize=None)
def wire_stager(device: torch.device) -> WireStager:
    """The device's one WireStager, shared by every receiver on it."""
    return WireStager(device)


class PipelinedReceiver:
    """Single-stream decode with the host->device transfer overlapped
    against compute: a known-length stream is cut into fixed-size
    segments, segment k+1's upload is issued while segment k decodes, and
    the state machine carries across segments on the device.

    Byte positions are per segment, so run() yields one event tuple per
    segment — render them in order (codec/stderr state persists across
    render calls).  The reference reads audio in half-buffer chunks
    interleaved with decode (src/minimodem.c:1144-1174); this is that
    overlap, done with asynchronous copies instead of blocking reads.
    """

    def __init__(self, cfg: ModemConfig, precision: str = "auto",
                 rx_one: bool = False, segment_len: int = 1 << 21,
                 device=_device.DEFAULT):
        from ..utils.cfloat import trunc_i

        self.cfg = cfg
        self.precision = precision
        self.rx_one = rx_one
        self.device = torch.device(device)
        self.key = device_rx_key(cfg, precision)
        self.compact = cfg.n_data_bits <= 8
        geo = geometry_from_config(cfg, precision)
        self.geo = geo
        scan_w = trunc_i(cfg.nsamples_per_bit) + cfg.nsamples_overscan + 1
        # a non-final segment is scanned only while every score it reads
        # came from real samples
        self._lookahead = geo.halo + scan_w
        # worst-case distance between the scan-total and the final scan
        # position: one full advance (frame + scan window)
        max_adv = cfg.frame_nsamples + scan_w
        self.overlap = self._lookahead + max_adv
        self.segment_len = max(segment_len,
                               4 * (self.overlap + cfg.expect_nsamples))
        self.step = self.segment_len - self.overlap
        # segments of the last run() that a dpack stream sent on the raw
        # int16 wire (exception overflow, or a clipped segment)
        self.raw_segments = 0

    def run(self, samples: np.ndarray, conf_threshold: float,
            conf_search_limit: float, in_encoding: str = None,
            wire_pack="auto"):
        """Yield per-segment event tuples: (ev_type, ev_pay, byte_stream),
        or (ev_type, ev_pay) for more than 8 data bits.

        wire_pack: the lossless delta-bitpack wire (ops/wirepack.py) for
        int16 samples without in_encoding, bit-identical decode on fewer
        wire bytes.  "auto" engages it only on streams longer than one
        segment and only with MINIMODEM_TPU_WIREPACK=1
        (wirepack.default_on); True packs whenever choose_params finds
        the wire pays; False keeps the raw int16 wire."""
        from . import wirepack
        from .mega_rx import MegaReceiver, mega_runner

        _device.require(self.device)
        cfg = self.cfg
        n = len(samples)
        self.raw_segments = 0
        dp = None
        if (wire_pack and in_encoding is None and samples.dtype == np.int16
                and (wire_pack is True
                     or (n > self.segment_len and wirepack.default_on()))):
            dp = wirepack.choose_params(samples)
        if n <= self.segment_len:
            wire = samples[None, :]
            if dp is not None:
                k, w = dp
                e_cap = wirepack.exc_capacity(
                    wirepack.count_exceptions(samples, k, w))
                # pack at the receiver's power-of-two bucket of t_total,
                # so nearby lengths share one runner (the shortfall
                # decodes as held deltas, masked past totals)
                n_packed = _round_up_pow2(n + cfg.nsamples_overscan + 1)
                wire = wirepack.pack(samples, n_packed, k, w,
                                     e_cap).view(np.int16)[None, :]
                in_encoding = wirepack.spec_str(k, w, n_packed, e_cap)
            events, _ = DeviceReceiver(
                cfg, self.precision, self.rx_one, self.compact,
                device=self.device
            ).run_events_batch(wire, [n], conf_threshold,
                               conf_search_limit, in_encoding=in_encoding)
            yield events[0]
            return

        if dp is not None:
            # every segment, the tail included, packs at n_packed =
            # segment_len, so one layout serves both runners; the
            # exception capacity comes from segment 0 plus headroom
            k, w = dp
            e_cap = wirepack.exc_capacity(wirepack.count_exceptions(
                samples[:self.segment_len], k, w))
            dp = (k, w, self.segment_len, e_cap)
            in_dtype = wirepack.spec_str(*dp)
        else:
            in_dtype = wire_dtype(samples, in_encoding)
        total_nf = self.segment_len - self._lookahead + cfg.expect_nsamples
        # non-final segments carry REAL lookahead samples past the scan
        # bound `total_nf` (up to segment_len); u8 and dpack wires must
        # not tail-mask them away (expand_wire's `extra`)
        u8x = (max(0, self.segment_len - total_nf)
               if in_dtype in U8_ENCODINGS or dp is not None else 0)
        t_total = _round_up_pow2(total_nf + cfg.nsamples_overscan + 1)

        starts = []
        s = 0
        while s + self.segment_len < n:
            starts.append(s)
            s += self.step
        tail_start = s                                # tail in (overlap, seg]
        tail_total = n - tail_start
        t_total_f = _round_up_pow2(tail_total + cfg.nsamples_overscan + 1)

        dev = self.device
        runners = {}

        def runner(raw: bool, final: bool):
            """The program for a segment's wire; the raw int16 runners
            (a dpack stream's fallback) share the carry format and are
            built at first need."""
            if (raw, final) not in runners:
                runners[raw, final] = mega_runner(
                    self.key, t_total_f if final else t_total, self.rx_one,
                    "int16" if raw else in_dtype, final,
                    0 if raw or final else u8x, self.compact)
            return runners[raw, final]

        thr = (float(conf_threshold), float(conf_search_limit))
        halo = self.geo.halo
        # segment table: (start, scored length, totals, final)
        segs = [(s0, t_total, total_nf, False) for s0 in starts]
        segs.append((tail_start, t_total_f, tail_total, True))

        stager = wire_stager(dev)

        def host_of(j):
            """Segment j's host rows (no device call): the samples, or a
            dpack segment's packed row; the wire's width and encoding; and
            whether it rides the raw int16 wire of a dpack stream."""
            s0, tt, _, final = segs[j]
            seg = samples[None, s0:n if final else s0 + self.segment_len]
            if dp is not None and seg.shape[1] <= tt + halo:
                k, w, n_packed, e_cap = dp
                try:
                    row = wirepack.pack(seg[0], n_packed, k, w,
                                        e_cap).view(np.int16)[None, :]
                    return row, row.shape[1], in_dtype, False
                except ValueError:           # denser content: raw wire
                    pass
            # a clipped dpack segment rides the raw wire too: it pads with
            # silence where the packed hold-tail would survive the mask
            return seg, tt + halo, in_encoding, dp is not None

        # a dpack segment's pack is host work as long as several decodes
        # (PERF.md section 5), so segment prep runs on a pool of two
        # workers, two segments ahead; wires are staged in segment order,
        # one ahead of the decode
        pool = ThreadPoolExecutor(max_workers=2) if dp is not None else None
        preps = {}

        def upload(j):
            if pool is None:
                host, row, enc, raw = host_of(j)
            else:
                for a in range(j, min(j + 2, len(segs))):
                    if a not in preps:
                        preps[a] = pool.submit(host_of, a)
                host, row, enc, raw = preps.pop(j).result()
            return stager.wire(host, row, enc)[0], raw

        ci, cf = (torch.from_numpy(a).to(dev)
                  for a in MegaReceiver.carry_to_arrays(None, 1))
        try:
            pending = upload(0)
            for i, (_, _, total_i, final) in enumerate(segs):
                x, raw = pending
                self.raw_segments += raw
                stager.join(x)
                totals = torch.tensor([total_i], dtype=torch.int32,
                                      device=dev)
                out = runner(raw, final)(x, totals, thr, ci, cf)
                if not final:
                    # rebase the carried position onto the next segment's
                    # origin (on the device: no host sync between segments)
                    ci = out[4].clone()
                    ci[:, 0] -= self.step
                    cf = out[5]
                    pending = upload(i + 1)
                yield _collect(out[:4], 1, self.compact)[0]
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


class DeviceStreamReceiver:
    """Streaming decode (minimodem_tpu/ops/device_rx.py:1776-1911): feed()
    audio of any size; events come out as whole segments decode; finish()
    flushes the final stats.  The state machine's carry crosses segments
    (the analogue of the reference's sliding samplebuf, reference:
    src/minimodem.c:1144-1174, for unbounded streams in bounded device
    memory).  Each segment is one DeviceReceiver call on `device`: the
    scorer (K1 where it serves the geometry) and K2."""

    def __init__(self, cfg: ModemConfig, precision: str = "auto",
                 rx_one: bool = False, segment_len: int = 1 << 19,
                 conf_threshold: float = 1.5,
                 conf_search_limit: float = 2.3,
                 stop_on_overflow: bool = False,
                 initial_carry: dict = None, device=_device.DEFAULT):
        from ..utils.cfloat import trunc_i

        # compact events + bytes where eligible: their byte positions are
        # per segment, so feed() rebases the CARRIER / NOCARRIER
        # byte-position lanes onto the byte stream it returns.
        # stop_on_overflow (-a) keeps wide records, whose lane 5 holds the
        # scan position
        self.rx = DeviceReceiver(
            cfg, precision, rx_one,
            compact="auto" if not stop_on_overflow else False,
            stop_on_overflow=stop_on_overflow, device=device)
        self.compact = self.rx.compact
        # lane 5 is segment-relative; rebase it to the fed stream so -a
        # can replay the samplebuf phase
        self._rebase_pos_lane = stop_on_overflow
        self.consumed_total = 0
        self.cfg = cfg
        geo = geometry_from_config(cfg, precision)
        # a non-final segment is scanned only while every score it reads
        # came from real samples: the frame search reads offsets
        # [pos, pos + W) whose windows reach `halo` samples further
        scan_w = trunc_i(cfg.nsamples_per_bit) + cfg.nsamples_overscan + 1
        self._lookahead = geo.halo + scan_w
        self.segment_len = max(segment_len,
                               4 * (self._lookahead + cfg.expect_nsamples))
        self.thr = conf_threshold
        self.lim = conf_search_limit
        # a caller's carry seeds the state machine mid-stream (the -a
        # re-arm: no-confidence counters persist across detection,
        # reference src/minimodem.c:1280-1297); its pos must be 0 in this
        # receiver's fed-stream coordinates
        self._carry = initial_carry
        self._buf = np.zeros(0, np.float32)
        self._done = False

    def _process(self, samples: np.ndarray, finalize: bool):
        if finalize:
            total = len(samples)
        else:
            total = max(
                0, len(samples) - self._lookahead + self.cfg.expect_nsamples)
            total = min(total, len(samples))
        events, carry = self.rx.run_events_batch(
            samples[None, :], [total], self.thr, self.lim,
            self._carry, finalize)
        # the carry changes only once a whole call has returned: after an
        # interrupt, finish() redoes the tail from a consistent state
        self._carry = carry
        if self.compact:
            return events[0]                    # (et, ep, byte_stream)
        et, ep = events[0]
        if self._rebase_pos_lane and len(et):
            ep = ep.copy()
            ep[:, 5] = ep[:, 5] + np.uint32(self.consumed_total)
        return et, ep

    @property
    def stopped(self) -> bool:
        """True once a stop condition (rx_one, an overflow) fired."""
        return self._carry is not None and bool(self._carry["stop"][0])

    @property
    def abs_pos(self) -> int:
        """The scan position in fed-stream coordinates."""
        if self._carry is None:
            return 0
        return self.consumed_total + int(self._carry["pos"][0])

    @staticmethod
    def _concat_compact(parts):
        """Concatenate per-segment compact tuples, rebasing the
        byte-position lanes (CARRIER pay[0], NOCARRIER pay[4]) onto the
        concatenated byte stream, so one render_events call takes it."""
        evs_t, evs_p, evs_b = [], [], []
        off = 0
        for et, ep, by in parts:
            if len(et):
                ep = ep.copy()
                car = et == EV_CARRIER
                ep[car, 0] += np.uint32(off)
                ep[~car, 4] += np.uint32(off)
                evs_t.append(et)
                evs_p.append(ep)
            evs_b.append(np.asarray(by, np.uint8))
            off += len(by)
        by_all = (np.concatenate(evs_b) if evs_b
                  else np.zeros(0, np.uint8))
        if not evs_t:
            return (np.zeros(0, np.int32), np.zeros((0, 6), np.uint32),
                    by_all)
        return np.concatenate(evs_t), np.concatenate(evs_p), by_all

    def feed(self, samples: np.ndarray):
        """The events of the segments completed so far: (ev_type, ev_pay)
        wide, or (ev_type, ev_pay, byte_stream) in compact mode."""
        assert not self._done
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        parts = []
        while len(self._buf) >= self.segment_len:
            seg = self._buf[:self.segment_len]
            parts.append(self._process(seg, finalize=False))
            # consume up to the carried position; keep the unscanned tail
            consumed = int(self._carry["pos"][0])
            if consumed <= 0:
                break
            self._buf = self._buf[consumed:]
            self._carry["pos"] = np.zeros_like(self._carry["pos"])
            self.consumed_total += consumed
        if self.compact:
            return self._concat_compact(parts)
        if parts:
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        return (np.zeros(0, np.int32), np.zeros((0, 6), np.uint32))

    def finish(self):
        """Decode the remaining tail and flush the final stats."""
        assert not self._done
        self._done = True
        return self._process(self._buf, finalize=True)


def _sched_pad(n_bits: int) -> int:
    """Bit-schedule pad bucket: powers of two from 512 up to 4096 (so a
    short burst — e.g. one ~300-bit Caller-ID message — doesn't score
    8x its audio), then multiples of 4096 (512 packed bytes/stream over
    the host link)."""
    v = 512
    while v < n_bits and v < 4096:
        v *= 2
    if v < n_bits:
        v = ((n_bits + 4095) // 4096) * 4096
    return v


# event records per stream in the prefetched result copy; a stream that
# logged more makes collect fetch the whole log (events are carrier
# transitions, a clean stream logs two)
EV_CAP = 32


class _HostBuffers:
    """Page-locked host buffers, made once per (shape, dtype) and reused:
    a dispatched batch takes its upload and result buffers and gives them
    back when it is collected (by then every copy of it has finished).
    On the CPU they are plain tensors."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._free = {}

    def take(self, shape, dtype) -> torch.Tensor:
        free = self._free.get((tuple(shape), dtype))
        if free:
            return free.pop()
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pinned)

    def give(self, bufs) -> None:
        for t in bufs:
            self._free.setdefault((tuple(t.shape), t.dtype), []).append(t)


class _Batch:
    """A dispatched loopback batch: the device results of each sub-batch,
    the host buffers it holds, and the events of its compute and copy."""

    def __init__(self, outs, held, done):
        self.outs = outs          # per sub-batch (ev, n_ev, bytes, n_by)
        self.held = held          # pinned upload buffers
        self.done = done          # CUDA event after the last K2, or None
        self.host = None          # per sub-batch host copies, once prefetched
        self.copied = None        # CUDA event after the copies, or None


class DeviceLoopback:
    """On-device TX->RX pipeline: a compact bit schedule goes up, decoded
    frame events come back; audio never crosses the host link.

    Counterpart of minimodem_tpu/ops/device_rx.py::DeviceLoopback.  One
    batch synthesizes every stream's audio on `device`
    (ops/tx_device.py), then runs K1 and K2 over it (ops/mega_rx.py
    mega_runner) and returns per-stream (ev_type, ev_pay, byte_stream)
    tuples.  dispatch_* enqueues a batch and returns without waiting
    (CUDA launches are asynchronous), prefetch_* starts the copies of its
    small results into pinned host buffers on a copy stream, collect_*
    waits for them and unpacks: a serving loop that dispatches batch j+1
    before collecting batch j overlaps the host's work with the card's.
    Geometries of more than 8 data bits return wide records (ev_type,
    ev_pay), as the JAX loopback does."""

    def __init__(self, cfg: ModemConfig, precision: str = "auto",
                 amplitude: float = 1.0, rx_one: bool = False,
                 device=_device.DEFAULT):
        from .tx_device import frame_synth_params, uniform_bits_supported

        self.cfg = cfg
        self.key = device_rx_key(cfg, precision)
        self.compact = cfg.n_data_bits <= 8
        self.bit_ns = cfg.bit_nsamples_tx
        self.uniform = uniform_bits_supported(cfg)
        self.frame_len = frame_synth_params(cfg)["frame_len"]
        self.halo = geo_from_key(self.key).halo
        self.device = torch.device(device)
        self._amplitude = amplitude
        self._rx_one = rx_one
        self._fns = {}
        self._bufs = None
        self._copy_stream = None

    def build_loop(self, b_pad: int, frames_mode: bool = False,
                   lead_trail: tuple = (2, 2)):
        """The synth + decode program for one schedule width: run(bits,
        totals, (thr, limit), n_frames=None) -> (ev, n_ev, bytes, n_by) on
        bits' device.  bits is [B, b_pad // 8] uint8, the flat bit
        schedules packed LSB-first (np.packbits bitorder="little"), or in
        frames mode [B, b_pad, n_data_bits] uint8 per-frame data-bit rows
        with n_frames [B] the count of real frames.  Its two halves are
        run.synthesize(bits, n_frames=None) -> audio [B, t_total + halo]
        float32 (K4 on the card, the plain route on the CPU;
        run.synthesize_plain takes the plain route on any device) and
        run.t_total, the scored length."""
        from .mega_rx import mega_runner
        from .tx_device import (TxSynth, frames_len, synth_bits_plain,
                                synth_frames_plain)

        cache_key = (b_pad, frames_mode, tuple(lead_trail))
        if cache_key in self._fns:
            return self._fns[cache_key]
        cfg = self.cfg
        if frames_mode:
            n_samples = frames_len(cfg, b_pad, lead_trail)
        else:
            n_samples = b_pad * self.bit_ns
        t_total = _round_up_pow2(n_samples + cfg.nsamples_overscan + 1)
        rx = mega_runner(self.key, t_total, self._rx_one, "float32", True, 0,
                         self.compact)
        width = t_total + self.halo
        amp = self._amplitude
        k4 = TxSynth(cfg, amp)

        def synthesize_plain(bits, n_frames=None):
            if frames_mode:
                return synth_frames_plain(bits, n_frames, cfg, lead_trail,
                                          width, amp)
            return synth_bits_plain(bits, cfg, width, amp)

        def synthesize(bits, n_frames=None):
            # zero signal past each stream's synthesized schedule, as the
            # JAX loop pads it
            if bits.device.type == "cpu":
                return synthesize_plain(bits, n_frames)
            if frames_mode:
                return k4.frames(bits, n_frames, lead_trail, width)
            return k4.bits(bits, width)

        def loop(bits, totals, thr, n_frames=None):
            x = synthesize(bits, n_frames)
            bsz, dev = x.shape[0], x.device
            ci = torch.zeros((bsz, 8), dtype=torch.int32, device=dev)
            cf = torch.zeros((bsz, 4), dtype=torch.float32, device=dev)
            return rx(x, totals, thr, ci, cf)[:4]

        loop.synthesize, loop.t_total = synthesize, t_total
        loop.synthesize_plain = synthesize_plain
        self._fns[cache_key] = loop
        return loop

    # ------------------------------------------------------------------
    def _start(self) -> torch.device:
        dev = _device.require(self.device)
        if self._bufs is None:
            self._bufs = _HostBuffers(dev.type == "cuda")
            if dev.type == "cuda":
                self._copy_stream = torch.cuda.Stream(dev)
        return dev

    def _put(self, a: np.ndarray, dev, held: list) -> torch.Tensor:
        """Upload a host array: through a pinned buffer without waiting on
        the card, or as a tensor view on the CPU."""
        if dev.type != "cuda":
            return torch.from_numpy(a)
        h = self._bufs.take(a.shape, torch.from_numpy(a[:0]).dtype)
        h.numpy()[...] = a
        held.append(h)
        return h.to(dev, non_blocking=True)

    def _dispatch(self, parts, b_pad, conf_threshold, conf_search_limit,
                  frames_mode=False, lead_trail=(2, 2)) -> _Batch:
        """Enqueue one program per part = (bits, totals[, n_frames])."""
        with _trace.span("lb.dispatch"):
            dev = self._start()
            loop = self.build_loop(b_pad, frames_mode, lead_trail)
            thr = (float(conf_threshold), float(conf_search_limit))
            held, outs = [], []
            for part in parts:
                with _trace.span("lb.upload"):
                    args = [self._put(a, dev, held) for a in part]
                with _trace.span("lb.enqueue"):
                    outs.append(loop(args[0], args[1], thr, *args[2:]))
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
        return _Batch(outs, held, done)

    def _flat_parts(self, sched_lists, b_pad):
        parts = []
        with _trace.span("lb.pack"):
            for scheds in sched_lists:
                bits = np.zeros((len(scheds), b_pad), np.uint8)
                for i, s in enumerate(scheds):
                    bits[i, :len(s)] = s
                # 8 bits per byte over the host link, unpacked on the device
                parts.append((np.packbits(bits, axis=1, bitorder="little"),
                              np.asarray([len(s) * self.bit_ns
                                          for s in scheds], np.int32)))
        return parts

    def dispatch_events_batch(self, sched_list, conf_threshold: float = 1.5,
                              conf_search_limit: float = 2.3) -> _Batch:
        """Async half of run_events_batch: upload and enqueue the batch and
        return a handle without waiting for results."""
        assert self.uniform, (
            "flat bit schedules need uniform bit segments; use "
            "run_events_frames_batch for fractional stop bits")
        b_pad = _sched_pad(max(len(s) for s in sched_list))
        return self._dispatch(self._flat_parts([sched_list], b_pad), b_pad,
                              conf_threshold, conf_search_limit)

    def prefetch_events_batch(self, handle: _Batch) -> _Batch:
        """Start the device -> host copies of a dispatched batch's results
        (counts, the first EV_CAP event records, the byte logs) into pinned
        buffers on the copy stream, without blocking."""
        if handle.host is not None:
            return handle
        with _trace.span("lb.prefetch"):
            if handle.done is None:                   # CPU: already there
                handle.host = [(n_ev, n_by, ev, by)
                               for ev, n_ev, by, n_by in handle.outs]
                return handle
            stream = self._copy_stream
            host = []
            with torch.cuda.stream(stream):
                stream.wait_event(handle.done)
                for ev, n_ev, by, n_by in handle.outs:
                    srcs = (n_ev, n_by, ev[:, :min(EV_CAP, ev.shape[1])], by)
                    dsts = []
                    for src in srcs:
                        src.record_stream(stream)
                        dst = self._bufs.take(src.shape, src.dtype)
                        dst.copy_(src, non_blocking=True)
                        dsts.append(dst)
                    host.append(tuple(dsts))
                handle.copied = torch.cuda.Event()
                handle.copied.record(stream)
            handle.host = host
        return handle

    def collect_events_batch(self, handle: _Batch):
        """Blocking half: wait for a dispatched batch's copies and unpack
        the per-stream event tuples (sub-batches in order)."""
        with _trace.span("lb.collect"):
            self.prefetch_events_batch(handle)
            with _trace.span("lb.wait"):
                if handle.copied is not None:
                    handle.copied.synchronize()
            with _trace.span("lb.unpack"):
                res = []
                for (ev, _, by, _), (n_ev, n_by, ev_c, by_h) in zip(
                        handle.outs, handle.host):
                    nev, nby = n_ev.numpy(), n_by.numpy()
                    kmax = int(nev.max(initial=0))
                    ev_h = (ev_c.numpy() if kmax <= ev_c.shape[1]
                            else ev[:, :kmax].cpu().numpy())  # rare: all
                    res.extend(_per_stream(nev, nby, ev_h, by_h.numpy(),
                                           by.shape[1], self.compact))
                if handle.done is not None:
                    self._bufs.give(handle.held)
                    self._bufs.give(t for h in handle.host for t in h)
                handle.held, handle.host = [], None
        return res

    def run_events_batch(self, sched_list, conf_threshold: float = 1.5,
                         conf_search_limit: float = 2.3):
        """sched_list: list of uint8 bit schedules (one per stream).
        Returns per-stream event tuples (see DeviceReceiver)."""
        return self.collect_events_batch(self.dispatch_events_batch(
            sched_list, conf_threshold, conf_search_limit))

    def dispatch_events_chain(self, sched_lists,
                              conf_threshold: float = 1.5,
                              conf_search_limit: float = 2.3) -> _Batch:
        """Dispatch K equal-width batches back to back on the stream; their
        results arrive together (chain-major) at collect."""
        assert self.uniform, (
            "flat bit schedules need uniform bit segments; use "
            "run_events_frames_batch for fractional stop bits")
        assert len(sched_lists) >= 2, (
            "dispatch_events_chain needs >= 2 sub-batches; use "
            "dispatch_events_batch for a single batch")
        batch = len(sched_lists[0])
        assert all(len(s) == batch for s in sched_lists), \
            "chained batches must be equal width"
        b_pad = _sched_pad(max(len(s) for scheds in sched_lists
                               for s in scheds))
        return self._dispatch(self._flat_parts(sched_lists, b_pad), b_pad,
                              conf_threshold, conf_search_limit)

    def prefetch_events_chain(self, handle: _Batch) -> _Batch:
        return self.prefetch_events_batch(handle)

    def collect_events_chain(self, handle: _Batch):
        """K * batch per-stream event tuples, sub-batch 0's streams first."""
        return self.collect_events_batch(handle)

    def run_events_chain(self, sched_lists, conf_threshold: float = 1.5,
                         conf_search_limit: float = 2.3):
        return self.collect_events_chain(self.dispatch_events_chain(
            sched_lists, conf_threshold, conf_search_limit))

    def run_events_frames_batch(self, frame_sched_list,
                                lead_trail: tuple = (2, 2),
                                conf_threshold: float = 1.5,
                                conf_search_limit: float = 2.3):
        """frame_sched_list: list of [F_i, n_data_bits] uint8 frame-bit
        arrays (tx_device.tx_frame_schedule rows).  Works for any
        nstopbits, fractional included (device_synthesize_frames)."""
        f_real = [fb.shape[0] for fb in frame_sched_list]
        f_pad = ((max(f_real) + 511) // 512) * 512
        with _trace.span("lb.pack"):
            bits = np.zeros((len(frame_sched_list), f_pad,
                             self.cfg.n_data_bits), np.uint8)
            for i, fb in enumerate(frame_sched_list):
                bits[i, :fb.shape[0]] = fb
            totals = np.asarray(
                [lead_trail[0] * self.bit_ns + n * self.frame_len
                 + lead_trail[1] * self.bit_ns for n in f_real], np.int32)
        return self.collect_events_batch(self._dispatch(
            [(bits, totals, np.asarray(f_real, np.int32))], f_pad,
            conf_threshold, conf_search_limit, True, tuple(lead_trail)))

    def run_events(self, sched_bits: np.ndarray, conf_threshold: float = 1.5,
                   conf_search_limit: float = 2.3):
        return self.run_events_batch(
            [sched_bits], conf_threshold, conf_search_limit)[0]
