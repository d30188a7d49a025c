"""Recorded channels uploaded from the host (traffic driver "recorded"):
`batches` seeded batches of `channels` PCM16 recordings, each `bursts`
bursts of `frames_per_burst` telegrams of the configuration's framing
(seeded data words) between `leader_bits` and `trailer_bits` mark bits,
every burst followed by `gap_s` of silence, with uniform noise of
`noise_amplitude`.  A closed loop with one client cycles them through
DeviceReceiver.run_events_batch, one synchronous call at a time: the
copy into the wire buffer and the upload, the scoring (K1 where it
serves the geometry, else stage 1 and the frame channels, K3 and K5),
the state machine (K2) and the collect of the events.

The audio is made on the run's device in set-up and handed to the
program as int16 arrays on the host, as a recording read from disk is.

Window record: audio seconds of every channel of every call that returned
in the window.  Check: `check_streams` (batch, channel) pairs drawn from
the seed, every result the window returned for them against the plain
reference (PCM16 -> planes -> state machine).
"""

from __future__ import annotations

import time

import numpy as np

from .. import tones
from ..reference import modem
from . import _common


class Driver:
    def __init__(self, cell, seed: int, device: str, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, \
            spans
        self.t = cell.traffic
        self.g = modem.geometry(cell.config)
        self.thr = (cell.config["confidence_threshold"],
                    cell.config["confidence_search_limit"])

    def make_inputs(self):
        """The seeded batches [channels, n] int16 on the host and the
        checked sample."""
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
                bits = np.concatenate([
                    np.ones((t["channels"], t["leader_bits"]), np.uint8),
                    np.stack([tones.frame_bits(w, g) for w in words]),
                    np.ones((t["channels"], t["trailer_bits"]), np.uint8)],
                    axis=1)
                parts += [tones.keyed_audio(bits, g, self.device),
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

    def setup(self):
        from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

        self.make_inputs()
        self.rx = DeviceReceiver(_common.program_config(self.cell),
                                 device=self.device)
        for b in range(min(2, self.t["batches"])):
            self._call(b)
        self.kept = {k: [] for k in self.sample}

    def _call(self, b):
        with self.spans.span("decode"):
            events, _ = self.rx.run_events_batch(self.x[b], self.totals,
                                                 *self.thr)
        return events

    def window(self, seconds):
        t0 = time.perf_counter()
        t_end = t0 + seconds
        calls, j = 0, 0
        while time.perf_counter() < t_end:
            b = j % len(self.x)
            events = self._call(b)
            j += 1
            if time.perf_counter() <= t_end:
                calls += 1
                for (bb, c), out in self.kept.items():
                    if bb == b:
                        out.append(events[c])
        return {"seconds": float(seconds), "audio_s": calls * self.audio_call,
                "calls": calls, "attempted": calls * self.t["channels"],
                "failed": 0, "t0": t0, "t1": t_end}

    def drain(self):
        pass

    def release(self):
        import torch

        del self.rx
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference(self, precision: str = "float32") -> dict:
        """(batch, channel) -> the reference's events."""
        g = self.g
        keys = sorted(self.sample)
        n = self.x[0].shape[1]
        t_total = modem.round_up_bucket(n + g.overscan + 1)
        x = np.zeros((len(keys), t_total + g.halo), np.float32)
        for r, (b, c) in enumerate(keys):
            x[r, :n] = self.x[b][c].astype(np.float32) / np.float32(32768.0)
        planes = _common.ref_planes(x, g, t_total, self.device, precision)
        outs = _common.ref_decode(planes, g, t_total, [n] * len(keys),
                                  g.n_data_bits <= 8, *self.thr)
        return dict(zip(keys, outs))

    def check(self) -> list:
        return self.judge(self.kept, self.reference())

    @staticmethod
    def judge(kept: dict, ref: dict) -> list:
        return [{"name": "channels_differing",
                 "value": _common.differing(kept, ref), "limit": 0,
                 "what": f"of {len(ref)} sampled channels, those whose "
                         "events in any returned call differ from the plain "
                         "reference"}]

    def samples(self) -> int:
        """Samples of one channel."""
        t, g = self.t, self.g
        bits = t["leader_bits"] + t["frames_per_burst"] * len(
            tones.frame_template(g)) + t["trailer_bits"]
        return t["bursts"] * (bits * g.bit_nsamples_tx
                              + int(round(t["gap_s"] * g.sample_rate)))

    def shapes(self) -> dict:
        """The work of one counted launch of each stage."""
        t, g = self.t, self.g
        n = self.samples()
        compact = g.n_data_bits <= 8
        frames = t["bursts"] * t["frames_per_burst"]
        out = {
            "statemachine": {"streams": t["channels"], "frames": frames,
                             "candidates": len(modem.statics(
                                 g, 1 << 18, compact).cand_c[1]),
                             "bytes_out": frames if compact else 32 * frames},
        }
        if g.n_bits <= 32:
            out["score"] = {"streams": t["channels"], "offsets": n,
                            "nb": g.nb, "n_bits": g.n_bits,
                            "planes": g.n_planes, "halo": g.halo}
        else:
            t_total = modem.round_up_bucket(n + g.overscan + 1)
            per_tile = n / -(-t_total // min(t_total, 1 << 18))
            out["stage1"] = {"streams": t["channels"], "offsets": per_tile,
                             "nb": g.nb}
            out["channels"] = {"streams": t["channels"], "offsets": per_tile,
                               "n_bits": g.n_bits, "planes": g.n_planes}
        return out
