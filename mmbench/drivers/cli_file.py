"""Single recordings through the command line's main path (traffic driver
"cli_file"): `files` seeded PCM16 WAV files, each `lead_s` of silence, a
transmission of printable text keyed as the configuration's frames
(`bytes_per_file` bytes between two leader and two trailer mark bits) and
`trail_s` of silence, plus uniform noise of `noise_amplitude`, written to
TMPDIR in set-up.  A closed loop with one client cycles them through
minimodem_tpu_torch.cli.main(["--rx", "--file", <wav>, <baudmode>]) in
process, its standard output and error captured: the WAV read, the device
decode (segments of 2^21 samples, K1 and K2 with the carry), the collect
and the render.

Window record: each request's wall.  Check: `check_files` files drawn from
the seed, every response the window gave for them (standard output,
standard error, and the event tuples the decode handed the renderer, read
by a spy on Receiver.render_events) against the plain reference's one-shot
decode of the same samples, rendered alike.
"""

from __future__ import annotations

import io
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import tones
from ..reference import modem, render, synth
from . import _common


class Driver:
    def __init__(self, cell, seed: int, device: str, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, \
            spans
        self.t = cell.traffic
        self.g = modem.geometry(cell.config)
        self.thr = (cell.config["confidence_threshold"],
                    cell.config["confidence_search_limit"])
        self.dir = None

    def make_inputs(self):
        """The seeded recordings (kept as samples and written as WAV files
        to TMPDIR) and the checked sample."""
        import torch

        t, g = self.t, self.g
        rng = np.random.default_rng(self.seed)
        lo, hi = t["alphabet"]
        self.dir = tempfile.mkdtemp(prefix="mmbench-")
        pay = rng.integers(lo, hi + 1, (t["files"], t["bytes_per_file"]),
                           dtype=np.uint8)
        x = torch.cat([tones.silence(t["files"], t["lead_s"], g, self.device),
                       tones.keyed_audio(synth.bit_schedules(pay, g), g,
                                         self.device),
                       tones.silence(t["files"], t["trail_s"], g,
                                     self.device)], dim=1)
        self.samples = list(tones.noisy_pcm16(
            x, tones.generator(self.seed, self.device),
            t["noise_amplitude"]))
        del x
        self.paths = []
        for k, s16 in enumerate(self.samples):
            path = os.path.join(self.dir, f"rec{k:02d}.wav")
            tones.write_wav(path, s16, g.sample_rate)
            self.paths.append(path)
        pick = rng.choice(t["files"], size=min(t["check_files"], t["files"]),
                          replace=False)
        self.sample = {int(k) for k in pick}

    def setup(self):
        from minimodem_tpu_torch import cli
        from minimodem_tpu_torch.rx.engine import Receiver

        t = self.t
        _common.program_config(self.cell)        # the file's parameters
        self.make_inputs()
        self.cli = cli
        self.args = ["--rx", "--file", None, self.cell.config["baudmode"]]
        if self.device != "cuda":
            self.args += ["--device", self.device]
        # a spy on the renderer: the event tuples of the request
        self._seen = None
        orig = Receiver.render_events

        def spy(rx, *events):
            if self._seen is not None:
                self._seen.append(events)
            return orig(rx, *events)

        self._orig, self._receiver = orig, Receiver
        Receiver.render_events = spy
        for k in range(min(2, t["files"])):
            self._request(k)
        self.kept = {k: [] for k in self.sample}

    def _request(self, k):
        """One decode of file k -> (rc, stdout bytes, stderr text, event
        tuples)."""
        out, err = io.TextIOWrapper(io.BytesIO()), io.StringIO()
        so, se = sys.stdout, sys.stderr
        self._seen = []
        self.args[2] = self.paths[k]
        sys.stdout, sys.stderr = out, err
        try:
            with self.spans.span("request"):
                rc = self.cli.main(list(self.args))
        finally:
            sys.stdout, sys.stderr = so, se
        out.flush()
        seen, self._seen = self._seen, None
        return rc, out.buffer.getvalue(), err.getvalue(), seen

    def window(self, seconds):
        t0 = time.perf_counter()
        t_end = t0 + seconds
        lat, j, failed = [], 0, 0
        while time.perf_counter() < t_end:
            k = j % len(self.paths)
            a = time.perf_counter()
            resp = self._request(k)
            done = time.perf_counter()
            j += 1
            if done <= t_end:
                lat.append(done - a)
                failed += resp[0] != 0
                if k in self.kept:
                    self.kept[k].append(resp)
        n = self.samples[0].size / self.g.sample_rate
        return {"seconds": float(seconds), "latencies_s": lat,
                "audio_s": len(lat) * n, "attempted": len(lat),
                "failed": failed, "t0": t0, "t1": t_end}

    def drain(self):
        pass

    def release(self):
        import torch

        self._receiver.render_events = self._orig
        self.remove_inputs()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def remove_inputs(self):
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None

    # ------------------------------------------------------------------
    def reference(self, precision: str = "float32") -> dict:
        """file -> (rc 0, stdout, stderr, [(ev_type, ev_pay, bytes)]) of a
        one-shot decode, the shape a response is compared in."""
        g = self.g
        keys = sorted(self.sample)
        n = self.samples[0].size
        t_total = modem.round_up_bucket(n + g.overscan + 1)
        x = np.zeros((len(keys), t_total + g.halo), np.float32)
        for r, k in enumerate(keys):
            x[r, :n] = self.samples[k].astype(np.float32) / np.float32(
                32768.0)
        planes = _common.ref_planes(x, g, t_total, self.device, precision)
        outs = _common.ref_decode(planes, g, t_total, [n] * len(keys), True,
                                  *self.thr)
        band = self.cell.config["modem"]["band_width"]
        return {k: (0, bytes(o[2]), render.stderr_text(g, band, *o), [o])
                for k, o in zip(keys, outs)}

    @staticmethod
    def joined(resp):
        """A response with its per-segment event tuples joined into one,
        byte positions rebased (the CARRIER's lane 0, the NOCARRIER's
        lane 4)."""
        rc, out, err, segs = resp
        types, pays, data = [], [], []
        base = 0
        for et, ep, by in segs:
            ep = ep.copy()
            ep[et == 1, 0] += base               # CARRIER: its byte position
            ep[et == 2, 4] += base               # NOCARRIER: likewise
            types.append(et)
            pays.append(ep)
            data.append(by)
            base += len(by)
        cat = (np.concatenate(types) if types else np.zeros(0, np.int32),
               np.concatenate(pays) if pays else np.zeros((0, 6), np.uint32),
               np.concatenate(data) if data else np.zeros(0, np.uint8))
        return rc, out, err, cat

    def check(self) -> list:
        return self.judge(self.kept, self.reference())

    @classmethod
    def judge(cls, kept: dict, ref: dict) -> list:
        bad = 0
        for k, r in ref.items():
            rr = cls.joined(r)
            got = kept.get(k) or []
            bad += not got or not all(
                p[:3] == rr[:3] and _common.same(p[3], rr[3])
                for p in map(cls.joined, got))
        return [{"name": "files_differing", "value": bad, "limit": 0,
                 "what": f"of {len(ref)} sampled files, those whose standard "
                         "output, standard error or decoded events in any "
                         "response differ from the plain reference"}]

    def shapes(self) -> dict:
        return {}
