"""The on-device loopback of a configuration with a sync byte (traffic
driver "loopback_sync"): the closed loop, window and judge of "loopback",
over NOAA SAME alert feeds keyed as `minimodem --tx --tx-carrier` keys
them.

The schedules (`reference/sync.py`): `alerts_per_stream` seeded EAS
alerts a stream, each a header of `locations` location codes sent
`repeats` times and then NNNN sent `repeats` times; every transmission
is `preamble_bytes` sync bytes, its bytes LSB first with no start or stop
bits, and `idle_bits` mark bits of idle carrier; `leader_bits` before
the first, `trailer_bits` after the last.  Only the fields' values depend
on the seed: every stream of every seed has the same number of bits.

The scorer writes the dual layout's five planes (the sync expectation
differs from the data one); the state machine acquires on the sync pair
and drops the sync bytes.  The check: the sampled streams against the
plain reference (schedule -> audio -> dual planes -> the sync state
machine), in blocks of streams.
"""

from __future__ import annotations

import numpy as np

from ..reference import modem, statemachine, sync, synth
from . import _common, loopback


class Driver(loopback.Driver):
    def __init__(self, cell, seed: int, device: str, spans):
        super().__init__(cell, seed, device, spans)
        m = cell.config["modem"]
        if not m.get("do_rx_sync"):
            raise ValueError(f"{cell.config_name}: the loopback_sync driver "
                             "needs a configuration with a sync byte")
        self.sync_byte = int(m["sync_byte"])
        self.sync = sync.sync_expectation(self.g, self.sync_byte)

    def make_inputs(self):
        """The seeded alert feeds, their schedules and the checked
        sample."""
        t = self.t
        rng = np.random.default_rng(self.seed)
        n = t["payload_sets"] * t["streams"]
        head = sync.headers(rng, n * t["alerts_per_stream"], t["locations"])
        bits = sync.alert_schedules(
            head.reshape(n, t["alerts_per_stream"], -1), t, self.sync_byte)
        assert bits.shape[1] == self.schedule_bits()
        self.scheds = [list(bits[s * t["streams"]:(s + 1) * t["streams"]])
                       for s in range(t["payload_sets"])]
        pick = rng.choice(n, size=min(t["check_streams"], n), replace=False)
        self.sample = {(int(k) // t["streams"], int(k) % t["streams"])
                       for k in pick}
        self.audio_batch = (t["streams"] * bits.shape[1]
                            * self.g.bit_nsamples_tx / self.g.sample_rate)

    def schedule_bits(self) -> int:
        return sync.schedule_bits(self.t)

    def reference(self, precision: str = "float32") -> dict:
        """(set, stream) -> the reference's (ev_type, ev_pay, bytes)."""
        import torch

        g = self.g
        L = self.schedule_bits()
        b_pad = modem.sched_pad(L)
        n_samples = b_pad * g.bit_nsamples_tx
        t_total = modem.round_up_bucket(n_samples + g.overscan + 1)
        st = modem.statics(g, t_total, True)
        keys = sorted(self.sample)
        out = {}
        for r in range(0, len(keys), _common.REF_BLOCK):
            block = keys[r:r + _common.REF_BLOCK]
            bits = np.zeros((len(block), b_pad), np.uint8)
            for row, (s, i) in enumerate(block):
                bits[row, :L] = self.scheds[s][i]
            x = torch.zeros((len(block), t_total + g.halo),
                            dtype=torch.float32, device=self.device)
            x[:, :n_samples] = synth.audio(
                torch.from_numpy(bits).to(self.device), g)
            p = sync.planes(x, g, self.sync, t_total, precision).cpu().numpy()
            del x
            for k, planes in zip(block, p):
                rec, by = sync.run_stream(g, st, planes, L * g.bit_nsamples_tx,
                                          *self.thr, self.sync_byte)
                out[k] = (*statemachine.events(rec), by)
        return out

    def check(self) -> list:
        ref = self.reference()
        self.ref_bytes = float(np.mean([len(r[2]) for r in ref.values()]))
        return self.judge(self.kept, ref)

    def shapes(self) -> dict:
        """The work of one launch of each stage: the synthesis of the
        schedule, K1 over its real offsets into five planes, and K2 over
        the frames the schedule holds (every frame after the first
        preamble's sync byte is decoded with carrier held).  K2 writes
        the bytes the reference decoded, a mean over the checked streams:
        a pause of idle carrier that is not a whole number of frames
        slips the byte grid, and a slipped preamble is not dropped.
        Before the check, the schedule's bytes less its sync bytes."""
        g, t = self.g, self.t
        L = self.schedule_bits()
        n = L * g.bit_nsamples_tx
        frames = L // g.frame_n_bits
        sync_bytes = (2 * t["alerts_per_stream"] * t["repeats"]
                      * t["preamble_bytes"])
        bytes_out = getattr(self, "ref_bytes", frames - sync_bytes)
        return {
            "synthesis": {"streams": t["streams"], "samples": n, "bits": L},
            "score": {"streams": t["streams"], "offsets": n, "nb": g.nb,
                      "n_bits": g.n_bits, "planes": 5, "halo": g.halo},
            "statemachine": {"streams": t["streams"], "frames": frames,
                             "candidates": len(modem.statics(
                                 g, 1 << 18, True).cand_c[1]),
                             "bytes_out": bytes_out},
        }
