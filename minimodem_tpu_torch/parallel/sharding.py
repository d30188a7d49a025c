"""Multi-device sharded demodulation on torch.distributed.

Counterpart of minimodem_tpu/parallel/sharding.py.  The reference is
single-threaded C with no distributed layer (SURVEY.md section 2), so
nothing here is required for parity; it scales decode across devices.

The JAX module runs one controller over a ("dp", "sp") Mesh with
shard_map.  Here every process is one rank of a torch.distributed process
group (one per device, as torchrun starts them) holding a ("dp", "sp")
DeviceMesh, and each rank runs its own shard:

- "dp"  (data parallel): independent audio streams (batch rows).  No
  communication: each rank scores its rows.
- "sp"  (sequence parallel): the time axis of each stream is split across
  ranks.  Scoring offset t needs samples [t, t + halo), so each rank takes
  the first `halo` columns of its right neighbour's shard.  JAX moves them
  with one ppermute; here every rank's lead is all-gathered over the sp
  group and the rank keeps its neighbour's (right_halo): all_gather is the
  one collective that NCCL and gloo share for CPU and CUDA tensors.

The "decode step" = sharded scoring + an all-reduced stats reduction; it
is the port's analogue of a training step for the multi-device dry run
(parallel/dryrun.py).

Every rank is handed the same host arrays, as every process of a
multi-controller JAX program is, and returns whole results.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModemConfig
from ..ops.demod import _build_score_fn, _unstack, geometry_from_config
from ..utils import device as _device


def rank_device(device_type: str) -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK} (the launcher's local rank,
    0 without one) for "cuda", else the CPU.  Touches no card."""
    if torch.device(device_type).type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def _init_world(dev: torch.device) -> None:
    """The default process group, made once per process: from the
    torchrun variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) where
    they are set, else a world of this one process on a localhost store.
    The backend follows the device (nccl for cuda, gloo for cpu); a group
    that exists already is used as it is."""
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    # NCCL builds its communicator at init on this device (a failed init
    # raises here, not at the first collective)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kw)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: Optional[int] = None, device=_device.DEFAULT):
    """Build a ("dp", "sp") DeviceMesh over the world's ranks (JAX
    make_mesh's dp/sp resolution).  Creates the default process group
    when there is none (_init_world).  n_devices defaults to the world
    size, and every rank of the world is in the mesh.  The mesh's groups
    are made collectively: every rank calls make_mesh, in the same
    order."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(_device.require(device).type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)    # before NCCL and all_gather_object
    _init_world(dev)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a world of {n} ranks, one per "
            f"device; this world has {world}")
    if dp is None and sp is None:
        # favor sequence parallelism for single-stream decode throughput
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise AssertionError(f"dp({dp}) * sp({sp}) != n({n})")
    return init_device_mesh(dev.type, (dp, sp), mesh_dim_names=("dp", "sp"))


def right_halo(lead: torch.Tensor, mesh, fill) -> torch.Tensor:
    """The right neighbour's `lead` along "sp" ([B, halo], any dtype), by
    an all_gather of every rank's lead as bytes (NCCL has no int16, gloo
    no int16 either).  The last shard has no right neighbour: its halo is
    `fill`, the value the unsharded scorer pads with past the stream, not
    shard 0's lead."""
    sp, r = mesh.size(1), mesh.get_local_rank("sp")
    if sp > 1:
        raw = lead.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(sp)]
        dist.all_gather(parts, raw, group=mesh.get_group("sp"))
        if r < sp - 1:
            return parts[r + 1].view(lead.dtype)
    return torch.full_like(lead, fill)


def gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `t` of `group`, concatenated along `dim` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def sharded_score_fn(cfg: ModemConfig, mesh, t_local: int,
                     precision: str = "auto"):
    """Build this rank's sharded scorer.

    Input:  x_local [B / dp, t_local] float32, this rank's block of the
            samples [B, sp * t_local] (rows by "dp", time by "sp").
    Output: dict of [B, sp * t_local] numpy arrays (conf/ampl float32,
            bits uint32), whole on every rank, plus "mean_conf", the conf
            sum all-reduced over the world over the all-reduced offset
            count.

    Each shard scores t_local offsets through ops/demod.py::_build_score_fn
    (stage 1 by correlator_for: K3 for Bell-202's 40 taps) over its
    samples and the `halo` samples of overlap from its right neighbour."""
    geo = geometry_from_config(cfg, precision)
    halo = geo.halo
    if halo > t_local:
        raise ValueError(
            f"halo ({halo}) exceeds the per-shard length t_local "
            f"({t_local}): the single-neighbor halo exchange cannot "
            "serve this geometry — increase t_local")
    score = _build_score_fn(geo, t_local,
                            str(rank_device(mesh.device_type)))

    def local_fn(x_local: torch.Tensor) -> dict:
        x_ext = torch.cat([x_local, right_halo(x_local[:, :halo], mesh, 0.0)],
                          dim=1)
        out = score(x_ext)                            # [Bl, 6, t_local] i32
        conf = out[:, 0].view(torch.float32)
        stats = torch.stack([conf.sum(dtype=torch.float64),
                             torch.tensor(float(conf.numel()),
                                          dtype=torch.float64,
                                          device=conf.device)])
        dist.all_reduce(stats)                        # the mesh is the world
        full = gather_cat(gather_cat(out, mesh.get_group("sp"), 2),
                          mesh.get_group("dp"), 0)
        res = _unstack(full.cpu().numpy())
        s = stats.cpu().numpy()
        res["mean_conf"] = np.float32(s[0] / s[1])
        return res

    return local_fn


_SCORE_FN_CACHE: dict = {}


def _cached_sharded_score_fn(cfg: ModemConfig, mesh, t_local: int,
                             precision: str):
    """Per-(geometry, mesh, shard length) cache of the rank's scorer, so
    looping decode steps derive the geometry and check the halo once."""
    from ..ops.device_rx import device_rx_key

    key = (device_rx_key(cfg, precision), mesh, t_local)
    fn = _SCORE_FN_CACHE.get(key)
    if fn is None:
        fn = sharded_score_fn(cfg, mesh, t_local, precision)
        _SCORE_FN_CACHE[key] = fn
    return fn


def sharded_decode_step(cfg: ModemConfig, mesh, samples: np.ndarray,
                        t_local: int = 1 << 12, precision: str = "auto"):
    """One full sharded decode scoring step over a batch of audio streams.

    samples: [B, L] float32 with L <= sp * t_local (padded up; the halo
    is taken from padding), the same on every rank; B divides over "dp".
    Longer streams must be segmented by the caller — silent truncation
    would read as full coverage.  Uploads only this rank's block and
    returns host numpy arrays."""
    dp, sp = mesh.size(0), mesh.size(1)
    want = sp * t_local
    b, L = samples.shape
    if L > want:
        raise ValueError(
            f"stream length {L} exceeds the sharded window sp*t_local "
            f"= {want}; segment the input or raise t_local")
    if b % dp:
        raise ValueError(f"batch {b} does not divide over dp = {dp}")
    fn = _cached_sharded_score_fn(cfg, mesh, t_local, precision)
    bl = b // dp
    r_dp, r_sp = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    x = np.zeros((bl, t_local), np.float32)
    t0 = r_sp * t_local
    n = max(0, min(L - t0, t_local))
    x[:, :n] = samples[r_dp * bl:(r_dp + 1) * bl, t0:t0 + n]
    return fn(torch.from_numpy(x).to(rank_device(mesh.device_type)))
