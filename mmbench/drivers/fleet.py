"""The dp decode fleet across cards (traffic driver "fleet"): ShardedReceiver
on a dp = world, sp = 1 mesh, one process a card.  Each call takes
`channels` recordings of `bytes_per_channel` printable bytes keyed as the
configuration's frames between `lead_s` and `trail_s` of silence, with
uniform noise of `noise_amplitude`, on the 8-bit u-law wire (1 byte a
sample); every rank is handed the whole batch, uploads its block of
channels / world, decodes it (the u-law expansion, K1, K2) and joins the
results' all_gather_object and the stats' all-reduce.  `batches` seeded
batches are cycled in a closed loop with one client.

This process is rank 0; it starts ranks 1.. (this module run as a
script), tells them through a TCPStore when to call and when to stop,
and waits for each to end.  Each rank makes the batches itself from the
seed, on its own card.  With tracing on every rank traces its own window
and sends rank 0 what the readers need.

Window record: audio seconds of every channel of every call that returned
on rank 0 in the window.  Check: `check_streams` channels drawn from the
seed, as many from each rank's block, every result the window returned
for them against the plain reference (u-law -> planes -> state machine).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

from .. import tones
from ..reference import g711, modem, synth
from . import _common

STORE_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Driver:
    def __init__(self, cell, seed: int, device: str, spans, rank: int = 0):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, \
            spans
        self.rank = rank
        self.t = cell.traffic
        self.g = modem.geometry(cell.config)
        self.thr = (cell.config["confidence_threshold"],
                    cell.config["confidence_search_limit"])
        self.world = cell.chips if device == "cuda" else self.t.get(
            "cpu_world", cell.chips)
        self.procs, self.store = [], None

    # ------------------------------------------------------------------
    def make_inputs(self):
        """The seeded batches on the u-law wire [channels, n] uint8, made
        on this rank's device, and the checked sample."""
        import torch

        t, g = self.t, self.g
        dev = self._device()
        rng = np.random.default_rng(self.seed)
        gen = tones.generator(self.seed, dev)
        lo, hi = t["alphabet"]
        self.x = []
        for _ in range(t["batches"]):
            pay = rng.integers(lo, hi + 1, (t["channels"],
                                            t["bytes_per_channel"]),
                               dtype=np.uint8)
            a = torch.cat([
                tones.silence(t["channels"], t["lead_s"], g, dev),
                tones.keyed_audio(synth.bit_schedules(pay, g), g, dev),
                tones.silence(t["channels"], t["trail_s"], g, dev)], dim=1)
            self.x.append(tones.ulaw_encode(tones.noisy_pcm16(
                a, gen, t["noise_amplitude"], host=False)))
            del a
        self.totals = np.full(t["channels"], self.x[0].shape[1], np.int32)
        per = t["channels"] // self.world
        k = max(1, t["check_streams"] // self.world)
        self.sample = {(int(b), int(r * per + c))
                       for r in range(self.world)
                       for b, c in zip(rng.integers(0, t["batches"], k),
                                       rng.choice(per, k, replace=False))}
        self.audio_call = t["channels"] * self.x[0].shape[1] / g.sample_rate

    def _device(self):
        return f"cuda:{self.rank}" if self.device == "cuda" else "cpu"

    def _join(self):
        """Join the world: the process group and the mesh, and the store
        rank 0 steers the loop through."""
        import torch.distributed as dist
        from minimodem_tpu_torch.parallel.service import ShardedReceiver
        from minimodem_tpu_torch.parallel.sharding import make_mesh

        self.store = dist.TCPStore(
            "127.0.0.1", int(os.environ["MMB_STORE_PORT"]), self.world,
            is_master=self.rank == 0,
            timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
        mesh = make_mesh(sp=1, device=self.device)
        self.svc = ShardedReceiver(_common.program_config(self.cell), mesh,
                                   device=self.device)
        self.j = 0

    def _call(self, b):
        with self.spans.span("decode"):
            events, stats = self.svc.run_events_batch(
                self.x[b], self.totals, *self.thr, in_encoding="ulaw")
        return events

    def _command(self, cmd: str):
        """Rank 0: tell every rank the next step ("call <b>", "window",
        "stop")."""
        self.store.set(f"cmd{self.j}", cmd)
        self.j += 1

    def setup(self):
        import torch

        t = self.t
        # one host thread a rank, as torchrun starts a node's ranks
        torch.set_num_threads(1)
        os.environ.update(OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(_free_port()),
                          MMB_STORE_PORT=str(_free_port()),
                          WORLD_SIZE=str(self.world), RANK="0",
                          LOCAL_RANK="0")
        spec = json.dumps({"config": self.cell.config, "traffic": t,
                           "name": self.cell.name, "chips": self.cell.chips,
                           "seed": self.seed, "device": self.device,
                           "trace": self.spans.annotate})
        for r in range(1, self.world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "mmbench.drivers.fleet", spec],
                env=env))
        self.make_inputs()
        self._join()
        for b in range(min(2, t["batches"])):
            self._command(f"call {b}")
            self._call(b)
        self.kept = {k: [] for k in self.sample}

    def window(self, seconds):
        self._command("window")
        t0 = time.perf_counter()
        t_end = t0 + seconds
        lat, calls, j = [], 0, 0
        while time.perf_counter() < t_end:
            b = j % len(self.x)
            self._command(f"call {b}")
            a = time.perf_counter()
            events = self._call(b)
            done = time.perf_counter()
            j += 1
            if done <= t_end:
                calls += 1
                lat.append(done - a)
                for (bb, c), out in self.kept.items():
                    if bb == b:
                        out.append(events[c])
        self.calls = calls
        return {"seconds": float(seconds), "audio_s": calls * self.audio_call,
                "latencies_s": lat, "calls": calls,
                "attempted": calls * self.t["channels"], "failed": 0,
                "t0": t0, "t1": t_end}

    def drain(self):
        """Stop the other ranks and read what each sends back."""
        self._command("stop")
        self.ranks = [json.loads(self.store.get(f"summary{r}"))
                      for r in range(1, self.world)]

    def release(self):
        import torch
        import torch.distributed as dist

        del self.svc
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def extra(self, trace) -> dict:
        """Every rank's trace summary (rank 0's from `trace`), the busy
        seconds averaged over the cards, and the fullest card's peak."""
        own = summary(trace, self.calls) if trace is not None else {}
        if self.device == "cuda":
            import torch

            own["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(0))
        ranks = [own] + getattr(self, "ranks", [])
        out = {"ranks": ranks}
        if trace is not None:
            out["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        if self.device == "cuda":
            out["memory_peak_bytes"] = max(r["memory_peak_bytes"]
                                           for r in ranks)
        return out

    # ------------------------------------------------------------------
    def reference(self, precision: str = "float32") -> dict:
        g = self.g
        keys = sorted(self.sample)
        n = self.x[0].shape[1]
        t_total = modem.round_up_bucket(n + g.overscan + 1)
        x = np.zeros((len(keys), t_total + g.halo), np.float32)
        for r, (b, c) in enumerate(keys):
            x[r, :n] = g711.ulaw_expand(self.x[b][c])
        planes = _common.ref_planes(x, g, t_total, self._device(), precision)
        outs = _common.ref_decode(planes, g, t_total, [n] * len(keys), True,
                                  *self.thr)
        return dict(zip(keys, outs))

    def check(self) -> list:
        return self.judge(self.kept, self.reference())

    @staticmethod
    def judge(kept: dict, ref: dict) -> list:
        return [{"name": "streams_differing",
                 "value": _common.differing(kept, ref), "limit": 0,
                 "what": f"of {len(ref)} sampled channels, as many of each "
                         "rank's block, those whose events or bytes in any "
                         "returned call differ from the plain reference"}]

    def shapes(self) -> dict:
        t = self.t
        return {"upload": {"bytes": t["channels"] // self.world
                           * self.x[0].shape[1]}}


def summary(trace, calls: int) -> dict:
    """What rank 0's readers need of one rank's traced window."""
    from ..trace import busy_intervals

    w0, w1 = trace.window_us
    busy = sum(b - a for a, b in busy_intervals(trace.records, w0, w1))
    nccl = [r for r in trace.records if r[1] == "kernel"
            and "nccl" in r[0].lower()]
    h2d = [r for r in trace.records if r[1] == "gpu_memcpy"
           and "HtoD" in r[0] and r[4] > 0]
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "collective_s": sum(r[3] for r in nccl) * 1e-6,
            "collective_kernels": len(nccl),
            "calls": calls,
            "h2d_bytes": sum(r[4] for r in h2d),
            "h2d_s": sum(r[3] for r in h2d) * 1e-6}


def _worker(spec: dict) -> int:
    """Ranks 1..: make the batches, join the world, follow rank 0's
    commands, send a summary, leave."""
    from ..harness import Cell
    from ..trace import WINDOW, Spans, Trace

    cell = Cell(spec["name"], spec["chips"], "", "", spec["config"],
                spec["traffic"], [], [])
    drv = Driver(cell, spec["seed"], spec["device"], Spans(spec["trace"]),
                 int(os.environ["RANK"]))
    drv.make_inputs()
    drv._join()
    j, calls, tr, win = 0, 0, None, None
    try:
        while True:
            cmd = drv.store.get(f"cmd{j}").decode()
            j += 1
            if cmd == "stop":
                break
            if cmd == "window":
                if spec["trace"]:
                    import torch

                    tr = Trace().__enter__()
                    win = torch.profiler.record_function(WINDOW)
                    win.__enter__()
                continue
            drv._call(int(cmd.split()[1]))
            calls += win is not None
    finally:
        out = {}
        if tr is not None:
            import torch

            win.__exit__(None, None, None)
            if spec["device"] == "cuda":
                torch.cuda.synchronize()
            tr.__exit__(None, None, None)
            out = summary(tr, calls)
        if spec["device"] == "cuda":
            import torch

            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
                drv.rank))
        drv.store.set(f"summary{drv.rank}", json.dumps(out))
        import torch.distributed as dist

        del drv.svc
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(json.loads(sys.argv[1])))
