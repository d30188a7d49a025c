"""Multi-device decode service: the FULL receiver sharded over a device mesh.

Counterpart of minimodem_tpu/parallel/service.py, on torch.distributed:
one process per device, each a rank of a ("dp", "sp") DeviceMesh
(parallel/sharding.py::make_mesh), every rank handed the same host batch.
parallel/sharding.py shards the scoring stage; this module shards the
COMPLETE decode (scoring, the carrier state machine K2, event collection)
with all-reduced fleet statistics.  Streams are independent (the
reference's RX loop, src/minimodem.c:1144-1463, has no cross-stream
state), so "dp" needs no communication but the stats and the results:
each rank uploads its block of streams and runs the single-card program
on it (ops/mega_rx.py::mega_runner).  With sp > 1 the time axis of
scoring is also sharded: each rank scores t_total / sp offsets (K1, or
make_score_packer where K1 does not serve the geometry) with the halo of
its right neighbour, the score planes are all-gathered along "sp", and
K2 runs sp-replicated on the gathered planes — scoring carries nearly
all of the work, so replicating the sequential state machine trades
little compute for no cross-shard control flow.

This is the deployment shape for a decode fleet: N devices x B/N streams
each, one result assembly, aggregate service stats reduced across the
ranks.  Every rank returns every stream's results.

The JAX module's Mosaic and TPU layout (jit_mosaic, mega_score_len, the
per-shard blocking of the flat result vector, the 4-row planes and the
slim 3-of-8 plane gather) have no counterpart: the port's planes carry no
aliased rows, so its gather is the slim one.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModemConfig
from ..utils import device as _device
from ..utils import trace as _trace
from .sharding import gather_cat, make_mesh, rank_device, right_halo


def _gather_streams(events: list, mesh) -> list:
    """Per-stream results of every dp rank, in stream order (rank d holds
    streams d * Bl .. (d + 1) * Bl - 1), on every rank."""
    group = mesh.get_group("dp")
    n = dist.get_world_size(group)
    if n == 1:
        return events
    parts = [None] * n
    dist.all_gather_object(parts, events, group=group)
    return [e for part in parts for e in part]


class _LazyMesh:
    """The mesh given, else (at first use) a dp-only mesh over the world:
    building a mesh starts the process group, which a constructor must
    not do (no card is touched before first use)."""

    def __init__(self, mesh, device):
        self._mesh = mesh
        self.device = torch.device(device)

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = make_mesh(sp=1, device=self.device)
        return self._mesh

    def rank_device(self) -> torch.device:
        """This rank's device (the mesh's type, or the constructor's)."""
        if self._mesh is not None:
            return rank_device(self._mesh.device_type)
        return rank_device(self.device.type)


class ShardedReceiver(_LazyMesh):
    """dp- (and sp-) sharded batched decode over a DeviceMesh.

    run_events_batch mirrors ops.device_rx.DeviceReceiver's API and
    event format; decode_batch renders events to bytes per stream.
    Fleet stats (total frames decoded, total events, mean confidence
    over carrier frames) are computed on the device from each rank's
    records and all-reduced over "dp"."""

    def __init__(self, cfg: ModemConfig, mesh=None,
                 precision: str = "auto", rx_one: bool = False,
                 compact="auto", device=_device.DEFAULT):
        from ..ops.device_rx import device_rx_key

        super().__init__(mesh, device)
        self.cfg = cfg
        self.precision = precision
        self.rx_one = rx_one
        self.key = device_rx_key(cfg, precision)
        # the production receiver path: byte-sized words post-process to
        # a ~1-byte-per-frame stream on the device (like DeviceReceiver)
        if compact == "auto":
            self.compact = cfg.n_data_bits <= 8
        else:
            self.compact = bool(compact)
        self._fns = {}

    def _program(self, t_total: int, in_dtype: str):
        """run(x, totals, (thr, limit), carry_i, carry_f) -> (ev, n_ev,
        bytes, n_by, ...) for this rank's block: x is [Bl, t_total +
        halo] with sp = 1, else this rank's [Bl, t_total / sp] shard."""
        from ..ops.device_rx import (
            U8_ENCODINGS, expand_wire, geo_from_key, make_score_packer_planes,
            wire_pad)
        from ..ops.mega_rx import MegaRx, MegaStatics, mega_runner

        mesh = self.mesh
        sp = mesh.size(1)
        if sp == 1:
            # the single-card program (DeviceReceiver's), one-shot
            return mega_runner(self.key, t_total, self.rx_one, in_dtype,
                               True, 0, self.compact)
        cache_key = (t_total, in_dtype)
        fn = self._fns.get(cache_key)
        if fn is not None:
            return fn
        t_local = t_total // sp
        geo = geo_from_key(self.key)
        halo = geo.halo
        if halo > t_local:
            raise ValueError(
                f"halo ({halo}) exceeds t_total/sp ({t_local}); "
                "use fewer sp shards for this geometry")
        u8 = in_dtype in U8_ENCODINGS
        # u8 wires expand after the exchange, so the packer sees float32
        packer, _ = make_score_packer_planes(
            self.key, t_local, "float32" if u8 else in_dtype)
        mega = MegaRx(MegaStatics.build(self.key, t_total, self.rx_one,
                                        self.compact))
        # the last shard scores into the silence the unsharded receiver
        # pads with past t_total: for u8 wires the silence CODEWORD, not
        # byte 0, which would expand to DC
        silence = wire_pad(in_dtype)
        start = mesh.get_local_rank("sp") * t_local
        sp_group = mesh.get_group("sp")

        def fn(x, totals, thr, carry_i, carry_f):
            x = torch.cat([x, right_halo(x[:, :halo], mesh, silence)], dim=1)
            if u8:
                # the tail mask at shard-absolute positions: column j of
                # this shard holds sample start + j
                x = expand_wire(x, totals - start, in_dtype)
            planes = gather_cat(packer(x), sp_group, 2)
            return mega(planes, totals, thr, carry_i, carry_f, True)

        self._fns[cache_key] = fn
        return fn

    def run_events_batch(self, samples: np.ndarray, totals,
                         conf_threshold: float = 1.5,
                         conf_search_limit: float = 2.3,
                         in_encoding: str = None):
        """samples: [B, L] (int16, float32, or uint8 with in_encoding in
        U8_ENCODINGS — telephony bytes expand on each device); totals:
        [B] valid lengths; the same on every rank.  B is padded up to a
        multiple of the dp axis; padded rows decode silence and are
        dropped.  Returns (events, stats) on every rank — events like
        DeviceReceiver's (per-stream tuples), stats a dict of fleet
        aggregates."""
        from ..ops.device_rx import (
            EV_NOCARRIER, _collect, _round_up_pow2, geo_from_key, wire_dtype,
            wire_pad, wire_stager)

        mesh = self.mesh
        dev = self.rank_device()
        dp, sp = mesh.size(0), mesh.size(1)
        b, L = samples.shape
        totals = np.asarray(totals, np.int32)
        bl = -(-b // dp)
        need = int(totals.max(initial=0)) + self.cfg.nsamples_overscan + 1
        if sp > 1:
            # each shard's t_local must itself be a valid scored length;
            # the time axis splits evenly, with no trailing halo region
            t_total = sp * _round_up_pow2(-(-need // sp))
            width = t_total // sp
            c0 = mesh.get_local_rank("sp") * width
        else:
            t_total = _round_up_pow2(need)
            width = t_total + geo_from_key(self.key).halo
            c0 = 0
        in_dtype = wire_dtype(samples, in_encoding)
        run = self._program(t_total, in_dtype)

        r0 = mesh.get_local_rank("dp") * bl
        rows = max(0, min(b - r0, bl))
        n = max(0, min(L - c0, width))
        # six spans over the call (utils/trace.py: recorded only under
        # torch.profiler), the rx.* ones as MegaReceiver.run_events_batch
        # names them.  The rank's block goes through the device's
        # stager; the ragged last dp rank's rows past the batch are
        # silence, made on the device
        stager = wire_stager(dev)
        with _trace.span("rx.wire") as span:
            x, chunks = stager.wire(samples[r0:r0 + rows, c0:c0 + n],
                                    width, in_encoding)
            span.count(bytes=x.nbytes, chunks=chunks)
        with _trace.span("rx.upload") as span:
            stager.join(x)
            if rows < bl:
                x = torch.nn.functional.pad(x, (0, 0, 0, bl - rows),
                                            value=wire_pad(in_encoding))
            tot = np.zeros((bl,), np.int32)
            tot[:rows] = totals[r0:r0 + rows]
            ci = torch.zeros((bl, 8), dtype=torch.int32, device=dev)
            cf = torch.zeros((bl, 4), dtype=torch.float32, device=dev)
            tot_d = torch.from_numpy(tot).to(dev)
            span.count(bytes=tot.nbytes)    # the carry is made on the card
        with _trace.span("rx.enqueue"):
            out = run(x, tot_d, (conf_threshold, conf_search_limit), ci,
                      cf)
            ev, n_ev = out[0], out[1]
            # fleet stats from the records (EV codes: ops/device_rx.py; a
            # NOCARRIER record's lanes 0-1 are nframes and conf_total)
            live = (torch.arange(ev.shape[1], device=dev)[None, :]
                    < n_ev[:, None])
            is_rep = live & (ev[:, :, 6] == EV_NOCARRIER)
            nframes = torch.where(is_rep, ev[:, :, 0], 0)
            conf = torch.where(is_rep, ev[:, :, 1].view(torch.float32),
                               0.0)
            stats = torch.stack([n_ev.sum().double(),
                                 nframes.sum().double(),
                                 conf.sum(dtype=torch.float64)])
        # the reduce's .cpu() waits for this rank's card and, through the
        # collective, for the slowest rank of the group
        group = mesh.get_group("dp")
        with _trace.span("fleet.reduce") as span:
            # sp ranks hold equal copies: reduce over dp only
            dist.all_reduce(stats, group=group)
            s = stats.cpu().numpy()
            span.count(ranks=dist.get_world_size(group))
        with _trace.span("rx.collect"):
            local = _collect(out[:4], bl, self.compact)
        with _trace.span("fleet.gather") as span:
            if _trace.enabled():
                span.count(streams=len(local),
                          bytes=sum(a.nbytes for e in local for a in e))
            events = _gather_streams(local, mesh)[:b]
        return events, {
            "devices": dp,
            "events_total": int(s[0]),
            "frames_total": int(s[1]),
            "mean_confidence": float(s[2] / s[1]) if s[1] else 0.0,
        }

    def decode_batch(self, streams, conf_threshold: float = 1.5,
                     conf_search_limit: float = 2.3,
                     codec: str = None):
        """Decode a list of 1-D sample arrays -> (list of bytes, stats).
        codec: databits codec name (codecs.get_codec); defaults to ascii
        for byte-sized words, raw bit lines otherwise."""
        from ..codecs import get_codec
        from ..config import RxOptions
        from ..rx.engine import Receiver

        b = len(streams)
        L = max((len(s) for s in streams), default=0)
        dtype = streams[0].dtype if b else np.float32
        x = np.zeros((b, L), dtype)
        for i, s in enumerate(streams):
            x[i, :len(s)] = s
        events, stats = self.run_events_batch(
            x, [len(s) for s in streams], conf_threshold,
            conf_search_limit)
        # Ascii8Codec handles any word <= 8 bits (7-bit ascii included);
        # 5-bit words are Baudot in every shipped mode (rtty/tdd)
        if codec is None:
            codec = ("baudot" if self.cfg.n_data_bits == 5 else
                     "ascii8" if self.cfg.n_data_bits <= 8 else "binary")
        outs = []
        for ev in events:
            sink = io.BytesIO()
            rxer = Receiver(
                self.cfg,
                RxOptions(confidence_threshold=conf_threshold,
                          confidence_search_limit=conf_search_limit,
                          quiet=True),
                get_codec(codec), sink.write, lambda _line: None)
            rxer.render_events(*ev)
            outs.append(sink.getvalue())
        return outs, stats


class ShardedLoopback(_LazyMesh):
    """dp-sharded DeviceLoopback: B bit schedules synthesize AND decode
    across the ranks of a mesh, B/N streams per rank, each rank running
    the exact single-card program (DeviceLoopback.build_loop: on-card
    synthesis, K1, K2) on its block.  Every rank returns every stream's
    results.

    This is the serving-fleet configuration of the reference's RX loop
    (src/minimodem.c:1137-1463) with on-device TX (the bench shape)."""

    def __init__(self, cfg: ModemConfig, mesh=None,
                 precision: str = "auto", amplitude: float = 1.0,
                 rx_one: bool = False, device=_device.DEFAULT):
        from ..ops.device_rx import DeviceLoopback

        if mesh is not None and mesh.size(1) != 1:
            raise ValueError("ShardedLoopback shards streams only (dp)")
        super().__init__(mesh, device)
        self.cfg = cfg
        self.lb = DeviceLoopback(cfg, precision, amplitude, rx_one,
                                 device=self.rank_device())

    def run_events_batch(self, sched_list, conf_threshold: float = 1.5,
                         conf_search_limit: float = 2.3):
        """sched_list: list of uint8 bit schedules (one per stream), the
        same on every rank; the list is padded up to a multiple of dp with
        empty streams, which decode silence and are dropped.  Returns
        per-stream event tuples exactly like
        DeviceLoopback.run_events_batch."""
        from ..ops.device_rx import _sched_pad

        lb = self.lb
        assert lb.uniform, "flat bit schedules need uniform bit segments"
        mesh = self.mesh
        dp = mesh.size(0)
        b = len(sched_list)
        bl = -(-b // dp)
        # one schedule width on every rank: the global pad bucket
        b_pad = _sched_pad(max((len(s) for s in sched_list), default=0))
        empty = np.zeros(0, np.uint8)
        scheds = list(sched_list) + [empty] * (bl * dp - b)
        r0 = mesh.get_local_rank("dp") * bl
        parts = lb._flat_parts([scheds[r0:r0 + bl]], b_pad)
        events = lb.collect_events_batch(lb._dispatch(
            parts, b_pad, conf_threshold, conf_search_limit))
        return _gather_streams(events, mesh)[:b]
