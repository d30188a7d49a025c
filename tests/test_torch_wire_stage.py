"""The wire's staging (minimodem_tpu_torch/ops/device_rx.py WireStager),
driven on the CPU with small chunks.

On a card MegaReceiver.run_events_batch builds its wire through the
device's WireStager: the samples go through reused host chunks, the pad
columns are set on the device.  Whatever the chunks held before, the
wire must be byte for byte the host wire of the CPU route: alloc_wire's
silence with samples[:, :row] copied in.  Cases: int16, float32, u-law
(its pad byte 0xFF) and a delta-bitpacked row passed through at its own
width; rows shorter and longer (truncated) than the samples, widths that
are and are not a multiple of the chunk, B = 1 and B = 16; and a long
call followed by a short one through the same chunks.  The chunks are
allocated once (the trace's `alloc_bytes`) and reused after.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minimodem_tpu_torch.ops import device_rx, wirepack
from minimodem_tpu_torch.utils import trace

CHUNK = 256                      # bytes: 128 int16, 64 float32, 256 u-law


def _e_cap(n):
    """An exception capacity no row of n samples exceeds."""
    return wirepack.exc_capacity(n)


def _samples(enc, b, n, seed):
    rng = np.random.default_rng(seed)
    if enc == "float32":
        return rng.standard_normal((b, n)).astype(np.float32)
    if enc == "ulaw":
        # no silence codeword among the samples, so a pad left unset shows
        return rng.integers(0, 0xFF, (b, n), dtype=np.uint8)
    if enc == "dpack":
        t = np.arange(n)
        rows = []
        for r in range(b):
            x = (3000 * np.sin(0.05 * t + r)
                 + rng.integers(-40, 40, n)).astype(np.int16)
            rows.append(wirepack.pack(x, n, 3, 8, _e_cap(n)).view(np.int16))
        return np.stack(rows)
    # nonzero everywhere, so a pad left unset shows
    return rng.integers(1, 1 << 15, (b, n), dtype=np.int16)


def _call(stager, enc, b, n, row, seed):
    """One call under a span "call": the stager's wire against alloc_wire
    + the copy; returns the chunk count."""
    x = _samples(enc, b, n, seed)
    in_encoding = {"ulaw": "ulaw",
                   "dpack": wirepack.spec_str(3, 8, n, _e_cap(n))}.get(enc)
    if enc == "dpack":
        row = x.shape[1]                # passed through at its own width
    want = device_rx.alloc_wire((b, row), x.dtype, in_encoding)
    want[:, :min(x.shape[1], row)] = x[:, :row]
    with trace.span("call") as sp:
        got, chunks = stager.wire(x, row,
                                  device_rx.PAD_BYTE.get(in_encoding, 0))
        stager.join(got)
        sp.count(chunks=chunks)
    assert got.device.type == "cpu"
    assert got.dtype == torch.from_numpy(want).dtype
    assert got.numpy().tobytes() == want.tobytes()
    m = min(x.shape[1], row)
    assert chunks == -(-b * m * x.itemsize // CHUNK)


@pytest.mark.parametrize("calls", [
    # (encoding, B, samples, row) a call, in order, through one stager
    [("int16", 16, 700, 1000)],                     # 1400 B a row: 5.5 chunks
    [("int16", 1, 1000, 640)],                      # truncated at the row
    [("int16", 1, 128, 300)],                       # one whole chunk
    [("int16", 16, 64, 64)],                        # no pad, 4 rows a chunk
    [("float32", 16, 333, 512)],
    [("float32", 1, 999, 512)],                     # truncated
    [("ulaw", 16, 300, 700)],
    [("ulaw", 1, 1000, 900)],                       # truncated
    [("dpack", 1, 4096, None)],
    [("dpack", 16, 1024, None)],
    # a long call, then short ones: nothing of the chunks' earlier bytes
    # reaches the later wires' pads
    [("int16", 16, 2000, 2048), ("int16", 2, 90, 1000),
     ("ulaw", 16, 40, 512), ("float32", 1, 10, 96)],
], ids=lambda calls: "-".join(f"{e}x{b}x{n}" for e, b, n, _ in calls))
def test_staged_wire_is_the_host_wire(monkeypatch, calls):
    monkeypatch.setattr(device_rx, "STAGE_CHUNK_BYTES", CHUNK)
    stager = device_rx.WireStager(torch.device("cpu"))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, (enc, b, n, row) in enumerate(calls):
            _call(stager, enc, b, n, row, seed=i)
    recs = [r for r in trace.records() if r.name == "call"]
    trace.clear()
    # the chunks are allocated by the calls that first use them, and then
    # reused: no call allocates more than the slots
    used = 0
    for r in recs:
        fresh = min(r.counts["chunks"], device_rx.STAGE_SLOTS) - used
        assert r.counts.get("alloc_bytes", 0) == max(fresh, 0) * CHUNK
        used = max(used, min(r.counts["chunks"], device_rx.STAGE_SLOTS))


def test_threads_share_one_stager(monkeypatch):
    """Receivers on one device share its stager: 8 threads staging at
    once, switching every few microseconds, each get their own wire."""
    import sys
    import threading

    monkeypatch.setattr(device_rx, "STAGE_CHUNK_BYTES", CHUNK)
    stager = device_rx.WireStager(torch.device("cpu"))
    wrong, done = [], []

    def work(seed):
        for i in range(20):
            x = _samples("int16", 3, 300 + seed, seed * 100 + i)
            got, _ = stager.wire(x, 400 + seed, 0)
            want = device_rx.alloc_wire((3, 400 + seed), x.dtype)
            want[:, :x.shape[1]] = x
            if got.numpy().tobytes() != want.tobytes():
                wrong.append((seed, i))
        done.append(seed)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and wrong == []
