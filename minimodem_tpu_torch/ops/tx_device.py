"""Device-side FSK synthesis from a compact bit schedule.

Counterpart of minimodem_tpu/ops/tx_device.py.  The host expands a byte
stream into the transmit *bit* schedule (leader, sync preamble,
start/data/stop bits, trailer — the keying logic of reference
src/minimodem.c:81-250) as one uint8 array; the device turns bits into
continuous-phase audio:

    phase[k]   = frac(n_mark[<k] * inc_mark + n_space[<k] * inc_space)
    sample[n]  = A * sin(2pi * (phase[bit(n)] + (n mod N)/wave_ns))

The per-bit phase is computed in closed form from exclusive prefix counts
of mark bits (exact integers in float64), so it does not depend on the
order of the scan.  Fractional stop bits (Baudot 1.5 / TDD 2.0, reference
src/minimodem.c:109-111) take the FRAME schedule path: every frame has
the same static segment template, per-frame base phases come from one
float64 prefix sum and the sample expansion is a static gather.

The host half (schedules and static constants) is a copy of the JAX
module's numpy code.  The device half has two routes.  On the card it is
K4 (csrc/tx_synth.cu, the class TxSynth): one pass writes the loopback's
whole audio buffer, bit for bit what the plain version makes there in
flat mode.  The plain version, device_synthesize and
device_synthesize_frames (with synth_bits_plain / synth_frames_plain,
the loopback's buffer around them), is PyTorch batched over streams and
runs for CPU tensors:

- the per-sample phase `turns = phase + i * inv_wave` is rounded once, as
  one fused multiply-add (the JAX package's XLA contracts it on the CPU),
  by `fma_f32_exact` on any device and without a host sync;
- sin is evaluated in float64 and rounded to float32, as the numpy TX
  path does (ops/tx.py::_sin_f32): within one float32 ulp of XLA's sinf,
  and the same on the CPU and the card.

Used by the on-device loopback (ops/device_rx.py::DeviceLoopback: TX ->
RX without audio crossing the host link).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import ModemConfig
from ..utils.cfloat import f32_mul, trunc_i


def uniform_bits_supported(cfg: ModemConfig) -> bool:
    """True when every keyed tone segment is exactly bit_nsamples_tx long."""
    return (float(cfg.nstopbits) == int(float(cfg.nstopbits))
            and cfg.nstartbits == int(cfg.nstartbits))


def tx_bit_schedule(data: bytes, cfg: ModemConfig, encoder,
                    leader_bits_len: int = 2,
                    trailer_bits_len: int = 2) -> np.ndarray:
    """Expand a byte stream into the transmit bit schedule (uint8: 1=mark
    tone, 0=space tone), mirroring the host transmitter's keying."""
    assert uniform_bits_supported(cfg), "fractional stop bits not uniform"
    nstop = int(float(cfg.nstopbits))
    start_bit = 1 if cfg.invert_start_stop else 0
    stop_bit = 1 - start_bit
    leader_bit = 0 if cfg.invert_start_stop else 1

    out: list = []

    def frame(word: int, msb_first: bool):
        out.extend([start_bit] * cfg.nstartbits)
        for i in range(cfg.n_data_bits):
            if msb_first:
                bit = (word >> (cfg.n_data_bits - i - 1)) & 1
            else:
                bit = (word >> i) & 1
            out.append(bit)
        out.extend([stop_bit] * nstop)

    # no leader tone when the frame has no start bits
    # (reference: src/minimodem.c:948-950)
    if cfg.nstartbits == 0:
        leader_bits_len = 0
    transmitting = 0
    for byte in data:
        words = encoder.encode(byte)
        if transmitting == 0:
            transmitting = 1
            out.extend([leader_bit] * leader_bits_len)
        if transmitting < 2:
            transmitting = 2
            for _ in range(cfg.do_tx_sync_bytes):
                frame(cfg.sync_byte, False)
        for w in words:
            frame(w, cfg.msb_first)
    if transmitting:
        out.extend([1] * trailer_bits_len)  # trailer is plain mark tone
    return np.asarray(out, np.uint8)


def synth_params(cfg: ModemConfig):
    """Static per-config synthesis constants."""
    rate = float(cfg.sample_rate)
    bit_ns = cfg.bit_nsamples_tx
    wave_mark = rate / float(cfg.mark_f)
    wave_space = rate / float(cfg.space_f)
    return dict(
        bit_ns=bit_ns,
        inv_wave_mark=1.0 / wave_mark,
        inv_wave_space=1.0 / wave_space,
        inc_mark=bit_ns / wave_mark,
        inc_space=bit_ns / wave_space,
    )


def tx_frame_schedule(data: bytes, cfg: ModemConfig, encoder,
                      leader_bits_len: int = 2,
                      trailer_bits_len: int = 2):
    """Expand a byte stream into per-frame data-bit rows for the frame
    synthesis path (any nstopbits, fractional included).

    -> (frame_bits [F, n_data_bits] uint8 in transmit order — msb
    resolution already applied, sync-preamble frames LSB-first exactly
    like the reference's literal 0 at src/minimodem.c:216-221 —
    leader_bits_len, trailer_bits_len)."""
    rows: list = []

    def frame(word: int, msb_first: bool):
        rows.append([
            (word >> (cfg.n_data_bits - i - 1)) & 1 if msb_first
            else (word >> i) & 1
            for i in range(cfg.n_data_bits)])

    if cfg.nstartbits == 0:
        leader_bits_len = 0  # reference: src/minimodem.c:948-950
    transmitting = 0
    for byte in data:
        words = encoder.encode(byte)
        if transmitting == 0:
            transmitting = 1
        if transmitting < 2:
            transmitting = 2
            for _ in range(cfg.do_tx_sync_bytes):
                frame(cfg.sync_byte, False)
        for w in words:
            frame(w, cfg.msb_first)
    if transmitting == 0:
        leader_bits_len = trailer_bits_len = 0
    return (np.asarray(rows, np.uint8).reshape(-1, cfg.n_data_bits),
            leader_bits_len, trailer_bits_len)


def frame_synth_params(cfg: ModemConfig):
    """Static frame-template constants: segment lengths/tones and the
    per-segment sample->segment maps."""
    bit_ns = cfg.bit_nsamples_tx
    nstart = int(cfg.nstartbits)
    ndata = cfg.n_data_bits
    stop_len = (trunc_i(f32_mul(bit_ns, cfg.nstopbits))
                if float(cfg.nstopbits) > 0 else 0)
    start_tone = 1 if cfg.invert_start_stop else 0
    seg_len = []
    seg_kind = []  # 0 = start const, 1..ndata = data bit, -1 = stop
    if nstart > 0:
        # the reference keys all start bits as ONE tone of
        # trunc(bit_ns * nstart) samples (minimodem.c:96-97)
        seg_len.append(trunc_i(f32_mul(bit_ns, float(nstart))))
        seg_kind.append(0)
    for i in range(ndata):
        seg_len.append(bit_ns)
        seg_kind.append(1 + i)
    if stop_len > 0:
        seg_len.append(stop_len)
        seg_kind.append(-1)
    seg_len = np.asarray(seg_len, np.int64)
    frame_len = int(seg_len.sum())
    seg_of = np.repeat(np.arange(len(seg_len), dtype=np.int32), seg_len)
    seg_start = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    off_in = (np.arange(frame_len, dtype=np.int64)
              - seg_start[seg_of]).astype(np.float32)
    rate = float(cfg.sample_rate)
    return dict(
        bit_ns=bit_ns, frame_len=frame_len,
        seg_len=seg_len, seg_kind=np.asarray(seg_kind, np.int32),
        seg_of=seg_of, off_in=off_in,
        start_tone=start_tone, stop_tone=1 - start_tone,
        inv_wave_mark=float(cfg.mark_f) / rate,
        inv_wave_space=float(cfg.space_f) / rate,
        leader_tone=0 if cfg.invert_start_stop else 1,
    )


def magic_divisor(d: int) -> tuple:
    """(m, s) with n // d == (2n * m) >> (32 + s) for every 0 <= n < 2^31
    (K4's division a sample: a multiply-high and a shift).  s is
    ceil(log2 d) and m = floor(2^(31 + s) / d) + 1 < 2^32, whose error
    m * d - 2^(31 + s) <= d <= 2^s keeps every quotient exact."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    s = (d - 1).bit_length()
    return (1 << (31 + s)) // d + 1, s


def frame_map(p: dict) -> dict:
    """The shape of frame_synth_params' template that K4's frames kernel
    maps a frame offset o through, in place of the seg_of / off_in tables:
    segments [0, s_uni) are one head segment of `head` samples, then
    n_uni segments of uni_len (= bit_ns) samples, then at most one tail.
    o < head lies in segment 0 at o; else with j = min((o - head) //
    uni_len, n_uni) in segment s_uni + j at o - head - j * uni_len."""
    kinds = [int(k) for k in p["seg_kind"]]
    s_uni = int(kinds[0] == 0)
    n_uni = sum(k > 0 for k in kinds)
    return dict(head=int(p["seg_len"][0]) if s_uni else 0, s_uni=s_uni,
                uni_len=int(p["bit_ns"]), n_uni=n_uni)


# ======================================================================
# device half
# ======================================================================

_TWO_PI = float(np.float32(2.0 * np.pi))


def fma_f32_exact(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (a fused multiply-add), elementwise
    over broadcast float32 tensors, on any device and without a host sync.

    a * b is exact in float64; the float64 sum s is then rounded to odd
    (TwoSum gives its exact error; an inexact s with an even last bit
    moves one ulp toward the exact value), whose float32 rounding is
    correct (53 >= 24 + 2 bits).  ops/demod.py::fma_f32 does the same
    repair only where it is needed, at the price of a host sync."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                 # s + err == p + c
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.full_like(s, torch.inf).copysign(err))
    return torch.where((err != 0) & even, away, s).to(torch.float32)


_FRAME_CONSTS = {}


def _frame_consts(p: dict, device: torch.device):
    """frame_synth_params' arrays on the device (segment lengths [S] f64,
    the sample -> segment map [frame_len] i64, the offset in the segment
    [frame_len] f32), uploaded once per frame template and device, so a
    dispatch makes no host-to-device copy of them."""
    key = (p["seg_len"].tobytes(), str(device))
    if key not in _FRAME_CONSTS:
        _FRAME_CONSTS[key] = tuple(torch.from_numpy(a).to(device) for a in (
            p["seg_len"].astype(np.float64), p["seg_of"].astype(np.int64),
            p["off_in"]))
    return _FRAME_CONSTS[key]


def _frame_sum(seg_turns: torch.Tensor) -> torch.Tensor:
    """seg_turns.sum(-1) over a frame's segments (at most 16), in one
    stated order on every device and CPU: four lanes, lane l summing
    segments l, l + 4, ... of the whole groups of four in turn; the rest
    in order from 0.0; then lanes 0-3 added to it.  That is the order of
    PyTorch's vectorized CPU sum of a short contiguous float64 row, which
    K4's frames prep kernel keeps; written out, the plain version does not
    hang on which vector width the host's CPU kernels take."""
    n = seg_turns.shape[-1]
    whole = n - n % 4
    fin = torch.zeros_like(seg_turns[..., 0])
    for s in range(whole, n):
        fin = fin + seg_turns[..., s]
    for lane in range(4 if whole else 0):
        acc = seg_turns[..., lane]
        for s in range(lane + 4, whole, 4):
            acc = acc + seg_turns[..., s]
        fin = fin + acc
    return fin


def _sin_2pi_frac(turns: torch.Tensor) -> torch.Tensor:
    """sin(float32(2pi) * (turns - floor(turns))) in float32, the sine
    evaluated in float64 and rounded once."""
    arg = (turns - torch.floor(turns)) * _TWO_PI
    return torch.sin(arg.to(torch.float64)).to(torch.float32)


def device_synthesize(bits: torch.Tensor, cfg: ModemConfig,
                      amplitude: float = 1.0) -> torch.Tensor:
    """bits: [B, b_pad] uint8 on the device -> samples [B, b_pad * bit_ns]
    float32 on the same device (minimodem_tpu/ops/tx_device.py:260-288,
    one row per stream)."""
    p = synth_params(cfg)
    bit_ns = p["bit_ns"]
    dev = bits.device
    b = bits.to(torch.float64)
    # exclusive prefix counts of mark/space bits -> exact phase
    n_mark_excl = torch.cumsum(b, dim=1) - b
    idx = torch.arange(bits.shape[1], dtype=torch.float64, device=dev)
    n_space_excl = idx - n_mark_excl
    phase = (n_mark_excl * float(p["inc_mark"])
             + n_space_excl * float(p["inc_space"]))
    phase = phase - torch.floor(phase)

    # per-sample phase within a bit stays < ~5 turns; float32 is plenty
    phase32 = phase.to(torch.float32)
    inv_wave = torch.full(bits.shape, float(np.float32(p["inv_wave_space"])),
                          dtype=torch.float32, device=dev).masked_fill_(
        bits == 1, float(np.float32(p["inv_wave_mark"])))
    i = torch.arange(bit_ns, dtype=torch.float32, device=dev)
    turns = fma_f32_exact(i, inv_wave[:, :, None], phase32[:, :, None])
    samples = _sin_2pi_frac(turns) * float(np.float32(amplitude))
    device_synthesize.calls += 1
    return samples.reshape(bits.shape[0], -1)


device_synthesize.calls = 0


def device_synthesize_frames(frame_bits: torch.Tensor, n_frames: torch.Tensor,
                             cfg: ModemConfig, leader_bits_len: int,
                             trailer_bits_len: int,
                             amplitude: float = 1.0) -> torch.Tensor:
    """frame_bits: [B, F_pad, n_data_bits] uint8 on the device (rows past
    n_frames[b] are padding); n_frames: [B] int counts of real frames.
    -> samples [B, leader + F_pad * frame_len + trailer] float32, each
    stream's mark trailer placed after its n_frames[b] real frames
    (padded-frame audio past it stays, as in the JAX package; the caller's
    `total` bounds the scan) (minimodem_tpu/ops/tx_device.py:179-257)."""
    p = frame_synth_params(cfg)
    dev = frame_bits.device
    nb, F = frame_bits.shape[:2]
    frame_len = p["frame_len"]
    iwm = float(np.float64(p["inv_wave_mark"]))
    iws = float(np.float64(p["inv_wave_space"]))
    f64 = torch.float64

    # per-segment mark flags [B, F, S]: const for start/stop, data from bits
    cols = []
    for k in p["seg_kind"]:
        if k == 0:
            cols.append(torch.full((nb, F), float(p["start_tone"]),
                                   dtype=f64, device=dev))
        elif k == -1:
            cols.append(torch.full((nb, F), float(p["stop_tone"]),
                                   dtype=f64, device=dev))
        else:
            cols.append(frame_bits[:, :, k - 1].to(f64))
    is_mark = torch.stack(cols, dim=2)                         # [B, F, S]
    seg_lens, seg_of, off_in = _frame_consts(p, dev)
    inv_wave = torch.full_like(is_mark, iws).masked_fill_(is_mark == 1, iwm)
    seg_turns = seg_lens * inv_wave

    # closed-form base phases: exclusive prefix over segments-in-frame
    # and over frames (float64)
    within = torch.cumsum(seg_turns, dim=2) - seg_turns        # [B, F, S]
    per_frame = _frame_sum(seg_turns)                          # [B, F]
    base = torch.cumsum(per_frame, dim=1) - per_frame          # [B, F]

    leader_len = leader_bits_len * p["bit_ns"]
    trailer_len = trailer_bits_len * p["bit_ns"]
    iw_leader = iwm if p["leader_tone"] == 1 else iws
    leader_phase = float(np.float64(leader_len) * np.float64(iw_leader))

    phase = leader_phase + base[:, :, None] + within           # [B, F, S]
    phase = phase - torch.floor(phase)

    ph = phase.to(torch.float32).index_select(2, seg_of)
    iw = inv_wave.to(torch.float32).index_select(2, seg_of)
    turns = fma_f32_exact(off_in, iw, ph)                      # [B, F, L]
    frames_flat = _sin_2pi_frac(turns).reshape(nb, F * frame_len)

    i_lead = torch.arange(leader_len, dtype=torch.float32, device=dev)
    lead = _sin_2pi_frac(i_lead * float(np.float32(iw_leader)))

    # trailer: mark tone starting at the phase after the last REAL frame
    n_frames = n_frames.to(device=dev, dtype=torch.int64)
    end = torch.gather(base + per_frame, 1,
                       torch.clamp(n_frames - 1, min=0)[:, None])[:, 0]
    base_at_end = torch.where(n_frames > 0, end, 0.0)
    ph0 = leader_phase + base_at_end
    ph0 = (ph0 - torch.floor(ph0)).to(torch.float32)
    i_trail = torch.arange(trailer_len, dtype=torch.float32, device=dev)
    trail = _sin_2pi_frac(fma_f32_exact(
        i_trail, torch.full_like(i_trail, float(np.float32(iwm))),
        ph0[:, None]))

    out = torch.cat([lead.expand(nb, leader_len), frames_flat,
                     torch.zeros((nb, trailer_len), dtype=torch.float32,
                                 device=dev)], dim=1)
    at = (leader_len + n_frames * frame_len)[:, None] + torch.arange(
        trailer_len, device=dev)
    out.scatter_(1, at, trail)
    device_synthesize_frames.calls += 1
    return out * float(np.float32(amplitude))


device_synthesize_frames.calls = 0


# ======================================================================
# the loopback's audio buffer: the plain route and K4
# ======================================================================

# samples the plain route synthesizes a step: bounds its float64
# temporaries to a few hundred MB at any batch size
SYNTH_STEP = 1 << 25


def frames_len(cfg: ModemConfig, n_frames: int, lead_trail: tuple) -> int:
    """Samples of a frame schedule of n_frames frames with lead_trail
    (leader, trailer) bits around them."""
    return ((lead_trail[0] + lead_trail[1]) * cfg.bit_nsamples_tx
            + n_frames * frame_synth_params(cfg)["frame_len"])


def synth_bits_plain(packed: torch.Tensor, cfg: ModemConfig, width: int,
                     amplitude: float = 1.0) -> torch.Tensor:
    """K4's plain version for flat schedules: packed [B, n_bytes] uint8
    bit schedules (LSB-first, np.packbits bitorder="little") -> the audio
    buffer [B, width] float32 on their device, device_synthesize's samples
    in front and 0.0 after, SYNTH_STEP samples a step."""
    dev, bsz, n_bits = packed.device, packed.shape[0], 8 * packed.shape[1]
    n_samples = n_bits * cfg.bit_nsamples_tx
    x = torch.zeros((bsz, width), dtype=torch.float32, device=dev)
    rows = max(1, SYNTH_STEP // max(n_samples, 1))
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    for r in range(0, bsz, rows):
        part = packed[r:r + rows]
        bits = ((part[:, :, None] >> shifts) & 1).reshape(part.shape[0],
                                                          n_bits)
        x[r:r + rows, :n_samples] = device_synthesize(bits, cfg, amplitude)
    return x


def synth_frames_plain(frame_bits: torch.Tensor, n_frames: torch.Tensor,
                       cfg: ModemConfig, lead_trail: tuple, width: int,
                       amplitude: float = 1.0) -> torch.Tensor:
    """K4's plain version for frame schedules: frame_bits [B, F, n_data]
    uint8, n_frames [B] -> the audio buffer [B, width] float32,
    device_synthesize_frames' samples in front and 0.0 after."""
    bsz, n_pad = frame_bits.shape[:2]
    n_samples = frames_len(cfg, n_pad, lead_trail)
    x = torch.zeros((bsz, width), dtype=torch.float32,
                    device=frame_bits.device)
    rows = max(1, SYNTH_STEP // max(n_samples, 1))
    for r in range(0, bsz, rows):
        x[r:r + rows, :n_samples] = device_synthesize_frames(
            frame_bits[r:r + rows], n_frames[r:r + rows], cfg, lead_trail[0],
            lead_trail[1], amplitude)
    return x


class TxSynth:
    """K4 (csrc/tx_synth.cu): the loopback's synthesis for one config and
    amplitude, into the whole audio buffer [B, width] float32 (0.0 past
    the schedule), on CUDA tensors only.  A tensor elsewhere raises: the
    plain route (synth_bits_plain, synth_frames_plain) is the caller's to
    take, for CPU tensors.  `launches` counts mm_tx_synth_bits calls,
    `frames_launches` mm_tx_synth_frames calls."""

    launches = 0
    frames_launches = 0

    def __init__(self, cfg: ModemConfig, amplitude: float = 1.0):
        self.cfg = cfg
        self.amp = float(np.float32(amplitude))
        p = synth_params(cfg)
        self._bits_args = (p["bit_ns"], *magic_divisor(p["bit_ns"]),
                           float(p["inc_mark"]), float(p["inc_space"]),
                           float(np.float32(p["inv_wave_mark"])),
                           float(np.float32(p["inv_wave_space"])), self.amp)
        self._frames_args = None

    def _frame_args(self, lead_trail: tuple) -> tuple:
        """(frame_len, the frames entry's arguments from n_seg to uni_s):
        frame_synth_params, its frame_map and divisors made once a
        TxSynth."""
        if self._frames_args is None:
            p = frame_synth_params(self.cfg)
            fm = frame_map(p)
            ints = ctypes.c_int * len(p["seg_len"])
            iwm = float(p["inv_wave_mark"])
            iws = float(p["inv_wave_space"])
            iw_lead = iwm if p["leader_tone"] == 1 else iws
            self._frames_args = p["frame_len"], p["bit_ns"], iw_lead, (
                len(p["seg_len"]), ints(*map(int, p["seg_len"])),
                ints(*map(int, p["seg_kind"])), int(p["start_tone"]),
                int(p["stop_tone"]), iwm, iws, float(np.float32(iw_lead)),
                float(np.float32(iwm))), (
                fm["head"], fm["s_uni"], fm["uni_len"], fm["n_uni"],
                *magic_divisor(p["frame_len"]),
                *magic_divisor(fm["uni_len"]))
        frame_len, bit_ns, iw_lead, tpl, fmap = self._frames_args
        lead_len = lead_trail[0] * bit_ns
        return frame_len, tpl + (
            lead_len, lead_trail[1] * bit_ns,
            float(np.float64(lead_len) * np.float64(iw_lead)),
            self.amp) + fmap

    @staticmethod
    def _out(dev, bsz: int, width: int, out):
        if out is None:
            return torch.empty((bsz, width), dtype=torch.float32, device=dev)
        if (out.shape != (bsz, width) or out.dtype != torch.float32
                or out.device != dev or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous [{bsz}, {width}] "
                             f"float32 tensor on {dev}")
        return out

    @staticmethod
    def _check(*ts) -> torch.device:
        dev = ts[0].device
        for t in ts:
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(
                    f"TxSynth takes tensors on one CUDA device, got "
                    f"{t.device}; synth_bits_plain / synth_frames_plain "
                    f"are the CPU's route")
        return dev

    def bits(self, packed: torch.Tensor, width: int,
             out: torch.Tensor = None) -> torch.Tensor:
        """packed [B, n_bytes] uint8 flat bit schedules (LSB-first) ->
        out [B, width] float32: device_synthesize's samples for the
        n_bytes * 8 bits, then 0.0."""
        from . import _kernels

        dev = self._check(packed)
        if packed.dim() != 2 or packed.dtype != torch.uint8:
            raise ValueError(f"expected [B, n_bytes] uint8 packed bits, got "
                             f"{tuple(packed.shape)} {packed.dtype}")
        bit_ns = self._bits_args[0]
        bsz, n_bytes = packed.shape
        if not 8 * n_bytes * bit_ns <= width < 2 ** 31:
            raise ValueError(f"width {width} does not hold {8 * n_bytes} "
                             f"bits of {bit_ns} samples (< 2^31)")
        out = self._out(dev, bsz, width, out)
        if bsz == 0 or n_bytes == 0:
            return out.zero_()
        packed = packed.contiguous()
        prefix = torch.empty((bsz, n_bytes), dtype=torch.int32, device=dev)
        err = _kernels.load().mm_tx_synth_bits(
            packed.data_ptr(), bsz, n_bytes, *self._bits_args,
            prefix.data_ptr(), out.data_ptr(), width,
            torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(err, "mm_tx_synth_bits")
        TxSynth.launches += 1
        return out

    def frames(self, frame_bits: torch.Tensor, n_frames: torch.Tensor,
               lead_trail: tuple, width: int,
               out: torch.Tensor = None) -> torch.Tensor:
        """frame_bits [B, F, n_data_bits] uint8, n_frames [B] -> out
        [B, width] float32: device_synthesize_frames' samples (leader,
        F frames, the trailer after each stream's real frames), then 0.0."""
        from . import _kernels

        dev = self._check(frame_bits, n_frames)
        cfg = self.cfg
        if (frame_bits.dim() != 3 or frame_bits.dtype != torch.uint8
                or frame_bits.shape[2] != cfg.n_data_bits
                or n_frames.shape != frame_bits.shape[:1]):
            raise ValueError(
                f"expected [B, F, {cfg.n_data_bits}] uint8 frame bits and "
                f"[B] frame counts, got {tuple(frame_bits.shape)} "
                f"{frame_bits.dtype}, {tuple(n_frames.shape)}")
        bsz, n_pad = frame_bits.shape[:2]
        frame_len, args = self._frame_args(lead_trail)
        n_samples = (sum(lead_trail) * cfg.bit_nsamples_tx
                     + n_pad * frame_len)
        if not n_samples <= width < 2 ** 31:
            raise ValueError(f"width {width} does not hold {n_pad} frames "
                             f"with {lead_trail} lead/trail bits (< 2^31)")
        out = self._out(dev, bsz, width, out)
        if bsz == 0 or n_pad == 0:
            return out.zero_()
        seg = torch.empty((bsz, n_pad, args[0], 2), dtype=torch.float32,
                          device=dev)
        ph0 = torch.empty((bsz,), dtype=torch.float32, device=dev)
        frame_bits = frame_bits.contiguous()
        n_frames = n_frames.to(torch.int32).contiguous()
        err = _kernels.load().mm_tx_synth_frames(
            frame_bits.data_ptr(), n_frames.data_ptr(), bsz, n_pad,
            cfg.n_data_bits, *args, seg.data_ptr(), ph0.data_ptr(),
            out.data_ptr(), width, torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(err, "mm_tx_synth_frames")
        TxSynth.frames_launches += 1
        return out


def sin_check(lo: int, hi: int, stride: int = 1, device="cuda") -> tuple:
    """K4's sine (csrc/tx_synth.cu sin_2pi) against CUDA's float64 sin
    rounded to float32, on the card, for the float32 bit patterns lo, lo +
    stride, ... <= hi (at most 0x3F7FFFFF, the float just below 1) taken
    as the fraction of a turn.  -> (how many differ in any bit, the lowest
    that does or None)."""
    from . import _kernels

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"sin_check runs on a CUDA device, not {dev}")
    res = torch.tensor([0, -1], dtype=torch.int32, device=dev)
    _kernels.check(_kernels.load().mm_tx_sin_check(
        lo, hi, stride, res.data_ptr(), res[1:].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "mm_tx_sin_check")
    count, first = (int(v) & 0xFFFFFFFF for v in res.cpu())
    return count, (None if count == 0 else first)
