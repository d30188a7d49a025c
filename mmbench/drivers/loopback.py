"""The on-device loopback under a closed loop (traffic driver
"loopback"): `payload_sets` sets of `streams` seeded bit schedules, cycled
for the whole window through DeviceLoopback with `in_flight` batches
dispatched ahead: dispatch a batch, start the result copy of the one
before, collect the oldest.  Every batch synthesizes its audio on the card
(K4), scores it (K1 where it serves the geometry, else stage 1 and the
frame channels, K3 and K5) and runs the state machine (K2); only events
(and bytes) come back.

The schedules: `payload_bytes` seeded printable bytes as the
configuration's frames between two leader and two trailer mark bits.

Window record: audio seconds of every stream of every batch collected in
the window.  Check: `check_streams` (set, stream) pairs drawn from the
seed, every result the window collected for them against the plain
reference (schedule -> audio -> planes -> state machine).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..reference import modem, synth
from . import _common


class Driver:
    def __init__(self, cell, seed: int, device: str, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, \
            spans
        self.t = cell.traffic
        self.g = modem.geometry(cell.config)
        self.thr = (cell.config["confidence_threshold"],
                    cell.config["confidence_search_limit"])
        self.inflight = deque()      # (payload set, dispatched batch)
        self.j = 0                   # batches dispatched

    # ------------------------------------------------------------------
    def make_inputs(self):
        """The seeded payloads, their schedules and the checked sample."""
        t = self.t
        rng = np.random.default_rng(self.seed)
        lo, hi = t["alphabet"]
        pay = rng.integers(lo, hi + 1, (t["payload_sets"], t["streams"],
                                        t["payload_bytes"]), dtype=np.uint8)
        self.scheds = [list(synth.bit_schedules(p, self.g)) for p in pay]
        assert len(self.scheds[0][0]) == self.schedule_bits()
        n = t["payload_sets"] * t["streams"]
        pick = rng.choice(n, size=min(t["check_streams"], n), replace=False)
        self.sample = {(int(k) // t["streams"], int(k) % t["streams"])
                       for k in pick}
        self.audio_batch = (t["streams"] * len(self.scheds[0][0])
                            * self.g.bit_nsamples_tx / self.g.sample_rate)

    def setup(self):
        from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

        t = self.t
        self.make_inputs()
        self.lb = DeviceLoopback(_common.program_config(self.cell),
                                 device=self.device)
        # every shape and pinned buffer the window uses: two rounds of the
        # pipeline
        self._loop(2 * t["in_flight"], None)
        self.drain()
        self.kept = {k: [] for k in self.sample}

    def _loop(self, n_batches, t_end):
        """Dispatch, prefetch the previous batch, collect the oldest once
        `in_flight` are out; until n_batches are dispatched or t_end."""
        lb, depth = self.lb, self.t["in_flight"]
        done, audio = 0, 0.0
        while True:
            if t_end is None and self.j >= n_batches:
                break
            if t_end is not None and time.perf_counter() >= t_end:
                break
            s = self.j % len(self.scheds)
            with self.spans.span("dispatch"):
                h = lb.dispatch_events_batch(self.scheds[s], *self.thr)
            if self.inflight:
                lb.prefetch_events_batch(self.inflight[-1][1])
            self.inflight.append((s, h))
            self.j += 1
            if len(self.inflight) >= depth:
                s0, h0 = self.inflight.popleft()
                with self.spans.span("collect"):
                    res = lb.collect_events_batch(h0)
                if t_end is not None and time.perf_counter() <= t_end:
                    done += 1
                    audio += self.audio_batch
                    self._keep(s0, res)
        return done, audio

    def _keep(self, s, res):
        for (ss, i), out in self.kept.items():
            if ss == s:
                out.append(res[i])

    def window(self, seconds):
        t0 = time.perf_counter()
        done, audio = self._loop(None, t0 + seconds)
        return {"seconds": float(seconds), "audio_s": audio,
                "batches": done, "attempted": done * self.t["streams"],
                "failed": 0, "t0": t0, "t1": t0 + seconds}

    def drain(self):
        while self.inflight:
            self.lb.collect_events_batch(self.inflight.popleft()[1])

    def release(self):
        import torch

        del self.lb
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference(self, precision: str = "float32") -> dict:
        """(set, stream) -> the reference's (ev_type, ev_pay, bytes)."""
        g = self.g
        L = len(self.scheds[0][0])
        b_pad = modem.sched_pad(L)
        n_samples = b_pad * g.bit_nsamples_tx
        t_total = modem.round_up_bucket(n_samples + g.overscan + 1)
        keys = sorted(self.sample)
        bits = np.zeros((len(keys), b_pad), np.uint8)
        for r, (s, i) in enumerate(keys):
            bits[r, :L] = self.scheds[s][i]
        import torch

        x = np.zeros((len(keys), t_total + g.halo), np.float32)
        for r in range(0, len(keys), _common.REF_BLOCK):
            b = torch.from_numpy(bits[r:r + _common.REF_BLOCK]).to(
                self.device)
            x[r:r + len(b), :n_samples] = synth.audio(b, g).cpu().numpy()
        planes = _common.ref_planes(x, g, t_total, self.device, precision)
        outs = _common.ref_decode(planes, g, t_total,
                                  [L * g.bit_nsamples_tx] * len(keys),
                                  g.n_data_bits <= 8, *self.thr)
        return dict(zip(keys, outs))

    def check(self) -> list:
        return self.judge(self.kept, self.reference())

    @staticmethod
    def judge(kept: dict, ref: dict) -> list:
        return [{"name": "streams_differing",
                 "value": _common.differing(kept, ref), "limit": 0,
                 "what": f"of {len(ref)} sampled streams, those whose events "
                         "or bytes in any collected batch differ from the "
                         "plain reference"}]

    def schedule_bits(self) -> int:
        """Bits of one stream's schedule."""
        return 2 + self.t["payload_bytes"] * self.g.frame_n_bits + 2

    def shapes(self) -> dict:
        g, t = self.g, self.t
        L = self.schedule_bits()
        n = L * g.bit_nsamples_tx
        compact = g.n_data_bits <= 8
        frames = t["payload_bytes"]
        out = {
            "synthesis": {"streams": t["streams"], "samples": n, "bits": L},
            "statemachine": {"streams": t["streams"], "frames": frames,
                             "candidates": len(modem.statics(
                                 g, 1 << 18, compact).cand_c[1]),
                             "bytes_out": frames if compact else 32 * frames},
        }
        if g.n_bits <= 32:
            out["score"] = {"streams": t["streams"], "offsets": n,
                            "nb": g.nb, "n_bits": g.n_bits,
                            "planes": g.n_planes, "halo": g.halo}
        else:
            t_total = modem.round_up_bucket(
                modem.sched_pad(L) * g.bit_nsamples_tx + g.overscan + 1)
            per_tile = n / -(-t_total // min(t_total, 1 << 18))
            out["stage1"] = {"streams": t["streams"], "offsets": per_tile,
                             "nb": g.nb}
            out["channels"] = {"streams": t["streams"], "offsets": per_tile,
                               "n_bits": g.n_bits, "planes": g.n_planes}
        return out
