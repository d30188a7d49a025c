"""The multi-device dry run: the port's counterpart of
__graft_entry__.py::dryrun_multichip.

    python -m minimodem_tpu_torch.parallel.dryrun 4 --device cpu
    torchrun --nproc-per-node 1 -m minimodem_tpu_torch.parallel.dryrun 1

Runs the three steps of the JAX dry run on an n-rank world and prints
one `dryrun_multichip OK: ...` line:

  1. the dp x sp sharded scoring step (all-gathered halo, all-reduced
     stats) on tiny shapes;
  2. the dp full decode (ShardedReceiver: scoring, K2, all-reduced fleet
     stats), one stream per rank;
  3. the (dp x sp) full decode (sp-sharded scoring, the planes gathered
     along sp, K2 replicated), with byte parity to the dp decode.

It runs on the card unless the caller asks for the CPU: device="cuda"
(the default) takes one NCCL rank a card and raises on a host with fewer
than n cards; device="cpu" (`--device cpu`) takes n gloo ranks on the
CPU.  Inside a world of n ranks (torchrun --nproc-per-node n) it runs in
place; otherwise it starts one (parallel/launch.py).  The OK line ends
with the device.
"""

from __future__ import annotations

import numpy as np

from ..utils import device as _device


def dryrun_impl(n_devices: int, device: str) -> str:
    """The three steps on this rank -> the OK line (the same on every
    rank)."""
    import torch.distributed as dist

    from ..models.modem import FskModem
    from ..ops.demod import geometry_from_config
    from .service import ShardedReceiver
    from .sharding import make_mesh, sharded_decode_step

    mesh = make_mesh(n_devices, device=device)
    assert dist.get_world_size() == n_devices
    m = FskModem("1200", device=device)
    cfg = m.cfg
    dp, sp = mesh.size(0), mesh.size(1)

    # --- step 1: dp x sp sharded scoring (halo exchange + stats) ---
    geo = geometry_from_config(cfg, "float32")
    t_local = 1 << 10
    while t_local < geo.halo:        # t_local must cover the halo
        t_local *= 2
    rng = np.random.default_rng(0)
    samples = rng.standard_normal((dp * 2, sp * t_local), dtype=np.float32)
    out = sharded_decode_step(cfg, mesh, samples, t_local, "float32")
    assert out["conf_data"].shape == samples.shape

    # --- step 2: dp-sharded full decode, one stream per rank ---
    dp_mesh = make_mesh(n_devices, dp=n_devices, sp=1, device=device)
    texts = [b"chip %d" % i for i in range(n_devices)]
    streams = [m.modulate(t) for t in texts]
    decoded, stats = ShardedReceiver(cfg, dp_mesh,
                                     device=device).decode_batch(streams)
    assert decoded == texts, (decoded, texts)
    assert stats["frames_total"] == sum(len(t) for t in texts)

    # --- step 3: (dp x sp) full decode, parity with step 2 ---
    sp2 = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    if sp2 > 1:
        mix_mesh = make_mesh(n_devices, dp=n_devices // sp2, sp=sp2,
                             device=device)
        decoded_sp, stats_sp = ShardedReceiver(
            cfg, mix_mesh, device=device).decode_batch(streams)
        assert decoded_sp == texts, (decoded_sp, texts)
        assert stats_sp["frames_total"] == stats["frames_total"]

    return (f"dryrun_multichip OK: mesh={{'dp': {dp}, 'sp': {sp}}} "
            f"conf={out['conf_data'].shape} mean_conf="
            f"{out['mean_conf']:.4f} full-decode dp={n_devices} "
            f"frames={stats['frames_total']} "
            f"mean_conf={stats['mean_confidence']:.3f} "
            + (f"dpxsp=({n_devices // sp2},{sp2}) full-decode parity OK"
               if sp2 > 1 else ""))


def dryrun_multichip(n_devices: int, device=_device.DEFAULT) -> str:
    """Run the dry run on an n-rank world on `device` and print (and
    return) its OK line."""
    import os

    import torch
    import torch.distributed as dist

    from .launch import spawn_world

    dev = _device.require(device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        # a rank of a world already (torchrun): run in place; make_mesh
        # raises unless the world has n_devices ranks
        line = f"{dryrun_impl(n_devices, dev.type)} device={dev.type}"
        if dist.get_rank() == 0:
            print(line, flush=True)
        return line
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on cuda takes one rank a card; "
            f"this host has {torch.cuda.device_count()} (pass "
            f'device="cpu" to run {n_devices} gloo ranks on the CPU)')
    backend = "nccl" if dev.type == "cuda" else "gloo"
    line = spawn_world(dryrun_impl, n_devices, (n_devices, dev.type),
                       backend)[0]
    line = f"{line} device={dev.type}"
    print(line, flush=True)
    return line


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m minimodem_tpu_torch.parallel.dryrun",
        description="the multi-device dry run on an n-rank world")
    ap.add_argument("n", type=int, nargs="?", default=1,
                    help="ranks (default 1)")
    ap.add_argument("--device", default=_device.DEFAULT,
                    help='"cuda" (default: one NCCL rank a card) or "cpu" '
                         "(gloo ranks)")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
