"""Spans of the program's own work, recorded only while torch.profiler
records.

    with span("rx.wire") as s:
        x, chunks = stager.wire(...)  # add(alloc_bytes=...) where it allocates
        ...
        s.count(bytes=x.nbytes, chunks=chunks)

Outside a profiler a span costs one check,
torch.autograd._profiler_enabled(), and returns a shared object that does
nothing: no annotation, no record, no allocation; add() costs the same
check.  So tracing is on exactly while someone traces: a torch.profiler
window (the benchmark's `--trace 1`) or the CLI's `--Xprofile`.

Under a profiler a span is a torch.profiler.record_function annotation
"mm.<name>", in the profiler's trace on the same clock as the kernels
and copies, and a `Record` in a bounded in-memory log: the name, start and
end in time.perf_counter_ns(), and its integer counts, set inside it
(`count`) or added by the code it runs (`add`, to the innermost open
span of the thread).  The log is for the benchmark's readers (mmbench/),
which take records() in process after a traced window and clear() it
between runs; nothing else reads, clears or writes it out, so it holds
what one traced window needs and drops (and counts) the rest.  A span
never synchronises the device and changes nothing that is launched.
"""

from __future__ import annotations

import threading
import time

import torch

PREFIX = "mm."
CAPACITY = 1 << 16          # records kept; later spans are counted, dropped

_enabled = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_log = []
_dropped = 0


class _Off:
    """The span outside a profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Record:
    """One span: `name`, `start` and `end` (perf_counter_ns; `end` is None
    while it is open) and `counts`."""

    __slots__ = ("name", "start", "end", "counts", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = None
        self.counts = {}

    def __enter__(self):
        global _dropped
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        self.start = time.perf_counter_ns()
        with _lock:
            if len(_log) < CAPACITY:
                _log.append(self)
            else:
                _dropped += 1
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _stack().pop()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return False

    def count(self, **counts) -> None:
        """Set integer counts on this span's record."""
        self.counts.update(counts)


def enabled() -> bool:
    """Whether spans record now: a torch.profiler records."""
    return _enabled()


def span(name: str):
    """A context manager over the work of `name`, recorded only while
    torch.profiler records."""
    if not _enabled():
        return _OFF
    return Record(name)


def add(**counts) -> None:
    """Add integer counts to the innermost open span of this thread (none
    open, or no profiler: nothing)."""
    if not _enabled():
        return
    stack = getattr(_local, "stack", None)
    if stack:
        mine = stack[-1].counts
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v


def records() -> list:
    """The log's records in the order their spans started."""
    with _lock:
        return list(_log)


def dropped() -> int:
    """Spans not recorded since the last clear(): the log was full."""
    return _dropped


def clear() -> None:
    """Empty the log (between runs: not inside an open span)."""
    global _dropped
    with _lock:
        _log.clear()
        _dropped = 0
