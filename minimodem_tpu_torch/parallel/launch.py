"""Start a world of ranks on this host: one process per rank, the spawn
start method (torch.multiprocessing.start_processes), a file store in a
temporary directory for the rendezvous (no port to clash with another
world on the host).

    spawn_world(fn, n, args, backend) -> [fn(*args) of rank 0, ..., n - 1]

Each child sets RANK, WORLD_SIZE and LOCAL_RANK (the rank modulo the
host's CUDA cards, so ranks share a card when there are fewer cards than
ranks), takes one PyTorch thread (several worlds may share the host's
cores), joins the process group with `backend` and runs fn(*args); fn and
its arguments are pickled by import path, so fn is a module-level
function.  A rank that raises fails the whole world: start_processes'
join stops the others and raises ProcessRaisedException with the rank's
traceback (ProcessExitedException for a rank that died).

The kernel library (ops/_kernels.py) is built into a hash-named file and
moved into place atomically, so ranks that build it at the same first
use are safe; a parent that loaded it first leaves them only the load.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time


def _rank_main(rank: int, fn, args, n: int, backend: str, store: str, q):
    import torch
    import torch.distributed as dist

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = rank % cards if cards else rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(local))
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=n)
    try:
        q.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn_world(fn, n: int, args: tuple = (), backend: str = "gloo",
                timeout: float = 600.0) -> list:
    """Run fn(*args) on every rank of a new world of n processes; return
    the ranks' results in rank order.  Raises as start_processes' join
    does when a rank fails or dies, TimeoutError after `timeout`
    seconds."""
    import torch.multiprocessing as mp

    results = {}
    q = mp.get_context("spawn").Queue()

    def drain(wait: float = 0.0):
        # a rank exits only once its result has left its queue's buffer
        try:
            while len(results) < n:
                rank, val = q.get(timeout=wait) if wait else q.get_nowait()
                results[rank] = val
        except queue.Empty:
            pass

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, (fn, args, n, backend, os.path.join(tmp, "store"), q),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {n} ranks: no result after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
    drain(30.0)
    return [results[r] for r in range(n)]
