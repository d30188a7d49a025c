"""Recorded channels of whole keyed frames (traffic driver
"recorded_frames"): the `recorded` driver, its closed loop, window, check
and shapes, with each burst keyed frame by frame by `tones_frames`, so
that a fractional stop bit is transmitted as minimodem transmits it (RTTY
5-N-1.5: a 1,584-sample stop, 7,920 samples a frame at 48 kHz), where
`recorded` keys whole bits.  Every burst is `frames_per_burst` seeded
data words between `leader_bits` and `trailer_bits` mark bits, then
`gap_s` of silence, with uniform noise of `noise_amplitude`.
"""

from __future__ import annotations

import numpy as np

from .. import tones, tones_frames
from . import recorded


class Driver(recorded.Driver):
    def make_inputs(self):
        """The seeded batches [channels, n] int16 on the host and the
        checked sample, drawn as `recorded` draws them."""
        import torch

        t, g = self.t, self.g
        rng = np.random.default_rng(self.seed)
        gen = tones.generator(self.seed, self.device)
        self.x = []
        for _ in range(t["batches"]):
            parts = []
            for _ in range(t["bursts"]):
                words = rng.integers(0, 1 << g.n_data_bits,
                                     (t["channels"], t["frames_per_burst"]),
                                     dtype=np.uint64)
                parts += [tones_frames.keyed_burst(
                              words, g, t["leader_bits"], t["trailer_bits"],
                              self.device),
                          tones.silence(t["channels"], t["gap_s"], g,
                                        self.device)]
            a = torch.cat(parts, dim=1)
            del parts
            self.x.append(tones.noisy_pcm16(a, gen, t["noise_amplitude"]))
            del a
        n = self.samples()
        assert self.x[0].shape[1] == n
        self.totals = np.full(t["channels"], n, np.int32)
        k = min(t["check_streams"], t["batches"] * t["channels"])
        pick = rng.choice(t["batches"] * t["channels"], k, replace=False)
        self.sample = {(int(p) // t["channels"], int(p) % t["channels"])
                       for p in pick}
        self.audio_call = t["channels"] * n / g.sample_rate

    def samples(self) -> int:
        """Samples of one channel."""
        t, g = self.t, self.g
        burst = (t["leader_bits"] + t["trailer_bits"]) * g.bit_nsamples_tx \
            + t["frames_per_burst"] * tones_frames.frame_nsamples_tx(g)
        return t["bursts"] * (burst + int(round(t["gap_s"] * g.sample_rate)))
