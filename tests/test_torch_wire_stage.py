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

From PARALLEL_FILL_BYTES of samples up the host fills the chunks with
ATen's copy from a tensor view of the samples (the trace's
`parallel_bytes`, the bytes so filled), below it and where torch cannot
view them with NumPy's.  Sources: contiguous, read-only (a WAV reader's
np.frombuffer: no warning, no copy), column-strided, and negative-stride
(NumPy's fill, `parallel_bytes` 0); at the small chunks above with every
call through ATen's copy, and at the real 4 MiB chunk and threshold on
several intra-op threads.
"""

import os
import subprocess
import sys
import tracemalloc
import warnings

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


def _source(x, layout):
    """x's values in the given memory layout (None: x itself)."""
    if layout == "readonly":
        src = np.frombuffer(x.tobytes(), x.dtype).reshape(x.shape)
        assert not src.flags.writeable
        return src
    if layout == "strided":             # every other column of a wider one
        w = np.zeros((x.shape[0], 2 * x.shape[1]), x.dtype)
        w[:, ::2] = x
        w[:, 1::2] = x[:, ::-1]
        return w[:, ::2]
    if layout == "reversed":            # a negative column stride
        return np.ascontiguousarray(x[:, ::-1])[:, ::-1]
    return x


def _call(stager, enc, b, n, row, seed, layout=None):
    """One call under a span "call": the stager's wire against alloc_wire
    + the copy, from x in the given layout; it raises no warning, leaves
    the warning filters as they were and copies no source.  Returns the
    chunk count."""
    x = _samples(enc, b, n, seed)
    src = _source(x, layout)
    in_encoding = {"ulaw": "ulaw",
                   "dpack": wirepack.spec_str(3, 8, n, _e_cap(n))}.get(enc)
    if enc == "dpack":
        row = x.shape[1]                # passed through at its own width
    want = device_rx.alloc_wire((b, row), x.dtype, in_encoding)
    want[:, :min(x.shape[1], row)] = x[:, :row]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        filters = list(warnings.filters)
        with trace.span("call") as sp:
            tracemalloc.start()
            try:
                got, chunks = stager.wire(
                    src, row, device_rx.PAD_BYTE.get(in_encoding, 0))
                peak = tracemalloc.get_traced_memory()[1]
            finally:
                tracemalloc.stop()
            stager.join(got)
            sp.count(chunks=chunks)
        assert warnings.filters == filters
    assert [str(w.message) for w in caught] == []
    # NumPy's allocations are traced, torch's chunks and wire are not
    assert peak < max(x.nbytes // 2, 32 << 10)
    assert got.device.type == "cpu"
    assert got.dtype == torch.from_numpy(want).dtype
    assert got.numpy().tobytes() == want.tobytes()
    m = min(x.shape[1], row)
    assert chunks == -(-b * m * x.itemsize // device_rx.STAGE_CHUNK_BYTES)
    if isinstance(sp, trace.Record):
        n_bytes = b * m * x.itemsize
        assert sp.counts.get("parallel_bytes", 0) == (
            0 if layout == "reversed"
            or n_bytes < device_rx.PARALLEL_FILL_BYTES else n_bytes)


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
    # sources of other layouts, each past 64 KiB, so a copy of it shows
    [("int16", 16, 2100, 3000, "readonly")],
    [("float32", 16, 1500, 1024, "readonly")],      # truncated
    [("int16", 16, 2100, 3000, "strided")],
    [("ulaw", 16, 4500, 5000, "strided")],
    [("int16", 16, 2100, 3000, "reversed")],        # NumPy's fill
    [("float32", 1, 20000, 16384, "reversed")],     # truncated
    # NumPy's fill, then ATen's, through the same chunks
    [("int16", 16, 2100, 3000, "reversed"), ("int16", 16, 2100, 2500),
     ("ulaw", 2, 900, 1000, "readonly")],
], ids=lambda calls: "-".join(
    f"{c[0]}x{c[1]}x{c[2]}" + "".join(f"_{s}" for s in c[4:])
    for c in calls))
def test_staged_wire_is_the_host_wire(monkeypatch, calls):
    monkeypatch.setattr(device_rx, "STAGE_CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(device_rx, "PARALLEL_FILL_BYTES", 0)
    stager = device_rx.WireStager(torch.device("cpu"))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, call in enumerate(calls):
            _call(stager, *call[:4], i, *call[4:])
    recs = [r for r in trace.records() if r.name == "call"]
    trace.clear()
    # the chunks are allocated by the calls that first use them, and then
    # reused: no call allocates more than the slots
    used = 0
    for r in recs:
        fresh = min(r.counts["chunks"], device_rx.STAGE_SLOTS) - used
        assert r.counts.get("alloc_bytes", 0) == max(fresh, 0) * CHUNK
        used = max(used, min(r.counts["chunks"], device_rx.STAGE_SLOTS))


@pytest.mark.parametrize("call", [
    ("int16", 16, 400_000, 400_500, None),
    ("int16", 16, 400_000, 400_500, "readonly"),
    ("int16", 16, 400_000, 400_500, "strided"),
    ("int16", 16, 400_000, 400_500, "reversed"),
    # a streaming segment's wire, below the threshold: NumPy's fill
    ("float32", 1, 65_976, 65_976, None),
    # exactly the threshold, read-only: ATen's
    ("int16", 1, device_rx.PARALLEL_FILL_BYTES // 2,
     device_rx.PARALLEL_FILL_BYTES // 2 + 440, "readonly"),
], ids=["contiguous", "readonly", "strided", "reversed", "segment",
        "threshold"])
def test_staged_wire_at_the_real_chunk(call):
    """At the real 4 MiB chunk, the real threshold and 4 intra-op threads
    each piece ATen copies is past its grain, so the copy is split across
    threads: 16 rows of 400,000 int16 in 4 chunks, the first slot's
    reused."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        stager = device_rx.WireStager(torch.device("cpu"))
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            _call(stager, *call[:4], 0, call[4])
        trace.clear()
    finally:
        torch.set_num_threads(threads)


def test_read_only_source_warns_nothing_in_a_fresh_process():
    """torch warns once a process on a read-only array it views: in a
    fresh process, with every warning an error, a read-only source
    (np.frombuffer) stages without one, and the filters stay as they
    were."""
    code = (
        "import warnings\n"
        "import numpy as np, torch\n"
        "from minimodem_tpu_torch.ops import device_rx\n"
        "warnings.simplefilter('error')\n"
        "filters = list(warnings.filters)\n"
        "x = np.frombuffer(np.arange(2 * 5000, dtype=np.int16).tobytes(),\n"
        "                  np.int16).reshape(2, 5000)\n"
        "device_rx.PARALLEL_FILL_BYTES = 0\n"
        "st = device_rx.WireStager(torch.device('cpu'))\n"
        "got, _ = st.wire(x, 6000, 0)\n"
        "want = device_rx.alloc_wire((2, 6000), x.dtype)\n"
        "want[:, :5000] = x\n"
        "assert got.numpy().tobytes() == want.tobytes()\n"
        "assert warnings.filters == filters\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()


def test_threads_share_one_stager(monkeypatch):
    """Receivers on one device share its stager: 8 threads staging at
    once, switching every few microseconds, each get their own wire,
    with the fill's copies on 4 intra-op threads."""
    import threading

    monkeypatch.setattr(device_rx, "STAGE_CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(device_rx, "PARALLEL_FILL_BYTES", 0)
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
    intra = torch.get_num_threads()
    sys.setswitchinterval(1e-6)
    torch.set_num_threads(4)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        torch.set_num_threads(intra)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and wrong == []
