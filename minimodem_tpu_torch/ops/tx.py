"""FSK transmit path: continuous-phase tone synthesis + frame keying.

Re-designs the reference's per-sample synthesis loop
(reference: src/simple-tone-generator.c:107-175) as whole-message vectorized
synthesis: the host accumulates a *tone schedule* (freq, nsamples, start
phase) — phase continuity is a sequential scalar recurrence, computed in
C-float32 on host exactly like the reference — and then one vectorized pass
materializes every sample.

Two synthesis backends share the schedule:
- NumPy host path: bit-deterministic on any machine; the CLI default.
  (sin is evaluated in float64 and rounded to float32, which is strictly
  more accurate than the reference's sinf and preserves the half-wave
  antisymmetry that makes integer-ratio signals decode with confidence=inf)
- device path (backend name "jax", as the JAX package's CLI spells it):
  the LUT gather or sine on the `device` the generator was given
  (ops/tx_synth.py), the same samples as the NumPy path.

Framing (start/data/stop bit keying, leader/trailer/sync preamble) mirrors
reference src/minimodem.c:81-250.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import ModemConfig, TxOptions
from ..sigio import SampleFormat, Stream
from ..utils import device as _device
from ..utils.cfloat import f32, f32_add, f32_div, f32_fmod1, f32_mul, lroundf_arr, trunc_i

_TWO_PI_F32 = np.float32(np.float32(3.141592653589793) * np.float32(2.0))
# C computes (float)M_PI * 2 -> float32(pi) * 2, exact in fp


def _sin_f32(arg_f32: np.ndarray) -> np.ndarray:
    """sin() of float32 args, evaluated in float64, rounded to float32."""
    return np.sin(np.asarray(arg_f32, np.float32).astype(np.float64)).astype(np.float32)


def _mag_s16(tone_mag: np.float32) -> int:
    """S16 amplitude scalar (reference: src/simple-tone-generator.c:52-56)."""
    if float(tone_mag) > 1.0:
        return 32767
    m = trunc_i(f32_add(f32_mul(32767.0, tone_mag), 0.5))
    return max(m, 1)


def build_sin_table(sin_table_len: int, tone_mag: np.float32):
    """Build the S16 + float sine LUTs
    (reference: src/simple-tone-generator.c:38-72)."""
    if sin_table_len == 0:
        return None, None
    i = np.arange(sin_table_len, dtype=np.int64)
    # C arg order: (float)M_PI*2*i / sin_table_len, all in float32
    arg = np.float32(_TWO_PI_F32) * i.astype(np.float32)
    arg = (arg / np.float32(sin_table_len)).astype(np.float32)
    s = _sin_f32(arg)
    mag_s = np.float32(_mag_s16(tone_mag))
    table_short = lroundf_arr((mag_s * s).astype(np.float32)).astype(np.int16)
    table_float = (np.float32(tone_mag) * s).astype(np.float32)
    return table_short, table_float


@dataclass
class ToneSegment:
    freq: np.float32       # 0.0 = silence
    nsamples: int
    cphase: np.float32     # phase (turns) at segment start


class ToneGenerator:
    """Continuous-phase FSK tone scheduler + synthesizer.

    ``tone()`` appends to the schedule; ``synthesize()`` renders everything.
    The persistent cross-tone phase (``sa_tone_cphase`` in the reference,
    src/simple-tone-generator.c:98-104,162-168) advances in float32 here.
    """

    def __init__(self, cfg_rate: int, fmt: SampleFormat,
                 sin_table_len: int = 4096, tone_mag: float = 1.0,
                 device=_device.DEFAULT):
        self.rate = cfg_rate
        self.device = device             # where the "jax" backend runs
        self.format = fmt
        self.sin_table_len = sin_table_len
        self.tone_mag = f32(tone_mag)
        self.table_short, self.table_float = build_sin_table(
            sin_table_len, self.tone_mag)
        self.cphase = f32(0.0)
        self.schedule: List[ToneSegment] = []

    def reset_phase(self) -> None:
        self.cphase = f32(0.0)

    def tone(self, freq: float, nsamples: int) -> None:
        if nsamples <= 0:
            return
        freq = f32(freq)
        self.schedule.append(ToneSegment(freq, int(nsamples), self.cphase))
        if float(freq) != 0.0:
            wave_nsamples = f32_div(self.rate, freq)
            self.cphase = f32_fmod1(
                f32_add(self.cphase, f32_div(nsamples, wave_nsamples)))
        else:
            self.cphase = f32(0.0)

    # ------------------------------------------------------------------
    def synthesize(self, backend: str = "numpy") -> np.ndarray:
        """Render and clear the schedule.  Returns int16 or float32 samples."""
        sched, self.schedule = self.schedule, []
        if not sched:
            return np.zeros(0, dtype=self.format.dtype)
        if backend == "jax":
            return self._synthesize_jax(sched)
        return self._synthesize_numpy(sched)

    def _per_sample_turns(self, sched: List[ToneSegment]):
        """Expand the schedule into per-sample phase 'turns' (float32) and a
        silence mask, matching C op-for-op:
        turns = (float)i / wave_nsamples + cphase."""
        counts = np.array([s.nsamples for s in sched], dtype=np.int64)
        total = int(counts.sum())
        seg_of = np.repeat(np.arange(len(sched)), counts)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        i_in_seg = np.arange(total, dtype=np.int64) - starts[seg_of]

        freqs = np.array([float(s.freq) for s in sched], dtype=np.float32)
        cphases = np.array([float(s.cphase) for s in sched], dtype=np.float32)
        silent = freqs == 0.0
        wave_ns = np.empty_like(freqs)
        wave_ns[~silent] = (np.float32(self.rate) / freqs[~silent]).astype(np.float32)
        wave_ns[silent] = 1.0  # placeholder, masked out

        turns = (i_in_seg.astype(np.float32) / wave_ns[seg_of]).astype(np.float32)
        turns = (turns + cphases[seg_of]).astype(np.float32)
        return turns, silent[seg_of]

    def _synthesize_numpy(self, sched: List[ToneSegment]) -> np.ndarray:
        turns, silent = self._per_sample_turns(sched)
        if self.sin_table_len:
            # C: int t = (float)len * turns + 0.5f;  t %= len
            # (reference: src/simple-tone-generator.c:77-94)
            tf = (np.float32(self.sin_table_len) * turns).astype(np.float32)
            tf = (tf + np.float32(0.5)).astype(np.float32)
            idx = np.trunc(tf).astype(np.int64) % self.sin_table_len
            if self.format is SampleFormat.S16:
                out = self.table_short[idx]
            else:
                out = self.table_float[idx]
        else:
            radians = (_TWO_PI_F32 * turns).astype(np.float32)
            s = _sin_f32(radians)
            if self.format is SampleFormat.S16:
                mag_s = np.float32(_mag_s16(self.tone_mag))
                out = lroundf_arr((mag_s * s).astype(np.float32)).astype(np.int16)
            else:
                out = (self.tone_mag * s).astype(np.float32)
        zero = np.int16(0) if self.format is SampleFormat.S16 else np.float32(0.0)
        return np.where(silent, zero, out)

    def _synthesize_jax(self, sched: List[ToneSegment]) -> np.ndarray:
        from .tx_synth import synthesize_device
        turns, silent = self._per_sample_turns(sched)
        return synthesize_device(
            turns, silent,
            self.table_short, self.table_float,
            self.sin_table_len, float(self.tone_mag),
            self.format is SampleFormat.S16, _device.require(self.device),
        ).cpu().numpy()


# ======================================================================
# Frame keying (reference: src/minimodem.c:81-112)
# ======================================================================

def key_frame(
    gen: ToneGenerator,
    bits: int,
    cfg: ModemConfig,
    msb_first: bool = None,
) -> None:
    """Emit one FSK frame into the tone schedule: start bit(s), data bits
    (LSB-first unless msb_first), stop bit(s).  msb_first overrides the
    config's bit order — sync-preamble frames are always LSB-first
    (reference passes a literal 0, src/minimodem.c:216-221)."""
    if msb_first is None:
        msb_first = cfg.msb_first
    bit_ns = cfg.bit_nsamples_tx
    mark_f, space_f = cfg.mark_f, cfg.space_f
    if cfg.nstartbits > 0:
        start_f = mark_f if cfg.invert_start_stop else space_f
        gen.tone(start_f, trunc_i(f32_mul(bit_ns, cfg.nstartbits)))
    for i in range(cfg.n_data_bits):
        if msb_first:
            bit = (bits >> (cfg.n_data_bits - i - 1)) & 1
        else:
            bit = (bits >> i) & 1
        gen.tone(mark_f if bit else space_f, bit_ns)
    if float(cfg.nstopbits) > 0:
        stop_f = space_f if cfg.invert_start_stop else mark_f
        gen.tone(stop_f, trunc_i(f32_mul(bit_ns, cfg.nstopbits)))


class Transmitter:
    """Byte-stream FSK transmitter (reference: src/minimodem.c:114-250).

    Feed bytes with ``send()``; call ``finish()`` at EOF (emits the trailer,
    reference: src/minimodem.c:59-74).  Call ``drain(stream)`` to render
    pending tones and write them to a sigio stream.
    """

    def __init__(self, cfg: ModemConfig, opts: TxOptions, encoder,
                 fmt: SampleFormat, synth_backend: str = "numpy",
                 device=_device.DEFAULT):
        self.cfg = cfg
        self.opts = opts
        self.encoder = encoder
        self.gen = ToneGenerator(cfg.sample_rate, fmt,
                                 opts.sin_table_len, float(opts.amplitude),
                                 device)
        self.transmitting = 0
        self.synth_backend = synth_backend
        self._leader_f = (cfg.space_f if cfg.invert_start_stop else cfg.mark_f)

    def send(self, byte: int) -> None:
        cfg = self.cfg
        words = self.encoder.encode(byte)
        if self.transmitting == 0:
            self.transmitting = 1
            # no leader tone when the frame has no start bits
            # (reference: src/minimodem.c:948-950)
            leader = (0 if cfg.nstartbits == 0
                      else self.opts.leader_bits_len)
            for _ in range(leader):
                self.gen.tone(self._leader_f, cfg.bit_nsamples_tx)
        if self.transmitting < 2:
            self.transmitting = 2
            for _ in range(cfg.do_tx_sync_bytes):
                key_frame(self.gen, cfg.sync_byte, cfg, msb_first=False)
        for w in words:
            key_frame(self.gen, w, cfg)

    def idle_tone(self, nsamples: int) -> None:
        """Idle carrier (interactive/--tx-carrier modes).  The reference
        unconditionally sets tx_transmitting = 1 here, so the sync-byte
        preamble is re-emitted after every idle gap
        (reference: src/minimodem.c:230-237)."""
        self.transmitting = 1
        self.gen.tone(self._leader_f, nsamples)

    def finish(self) -> None:
        """End-of-transmission trailer (reference: src/minimodem.c:59-74)."""
        if not self.transmitting:
            return
        for _ in range(self.opts.trailer_bits_len):
            self.gen.tone(self.cfg.mark_f, self.cfg.bit_nsamples_tx)
        if self.opts.interactive:
            self.gen.tone(0.0, self.cfg.sample_rate // 2)
        self.transmitting = 0
        if self.opts.print_eot:
            import sys
            sys.stderr.write("### EOT\n")

    def drain(self, stream: Optional[Stream]) -> np.ndarray:
        samples = self.gen.synthesize(self.synth_backend)
        if stream is not None and samples.size:
            stream.write(samples)
        return samples

    def transmit_bytes(self, data: bytes, stream: Optional[Stream],
                       chunk: int = 1 << 16) -> None:
        """Send a whole byte string, draining periodically to bound memory."""
        for off in range(0, len(data), chunk):
            for b in data[off:off + chunk]:
                self.send(b)
            self.drain(stream)
        self.finish()
        self.drain(stream)

    def transmit_stdin(self, stdin, stream: Optional[Stream],
                       interactive: bool, tx_carrier: bool) -> None:
        """The reference's stdin transmit loop (src/minimodem.c:114-250):

        - interactive without --tx-carrier: blocking reads; a SIGALRM
          one-shot timer (~one bit period after the last byte) fires the
          trailer + 0.5 s flush mid-stream (src/minimodem.c:139-158,
          230-240); transmission restarts with leader+sync on the next
          byte.
        - otherwise: select() idle detection — when no byte arrives
          within 1/25 s (or instantly when interactive with --tx-carrier)
          an idle carrier tone of 1/25 s is emitted
          (src/minimodem.c:169-237).

        Falls back to bulk transmit when stdin isn't select()-able (e.g.
        an in-process BytesIO in tests).
        """
        import os
        import select as select_mod
        import signal

        try:
            fd = stdin.fileno()
        except (AttributeError, OSError, ValueError):
            self.transmit_bytes(stdin.read(), stream)
            return

        cfg = self.cfg
        rate = float(cfg.data_rate)
        idle_sec = 1.0 / 25.0                     # src/minimodem.c:153
        idle_nsamples = int(idle_sec * cfg.sample_rate)
        block_input = interactive and not tx_carrier
        timer_sec = 1.0 / (rate + rate * 0.03)    # src/minimodem.c:143-146

        old_handler = None
        if block_input:
            def _on_alarm(sig, frame):
                self.finish()
                self.drain(stream)

            old_handler = signal.signal(signal.SIGALRM, _on_alarm)

        try:
            while True:
                if block_input:
                    ready = True
                else:
                    timeout = 0.0 if interactive else idle_sec
                    try:
                        ready = bool(
                            select_mod.select([fd], [], [], timeout)[0])
                    except (OSError, ValueError):
                        ready = True
                if ready:
                    data = os.read(fd, 1)
                    if not data:
                        break                      # EOF
                if block_input:
                    signal.setitimer(signal.ITIMER_REAL, 0)
                if ready:
                    self.send(data[0])
                else:
                    self.idle_tone(idle_nsamples)
                self.drain(stream)
                if block_input:
                    signal.setitimer(signal.ITIMER_REAL, timer_sec)
        finally:
            if block_input:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old_handler)
        if self.transmitting:
            self.finish()
            self.drain(stream)
