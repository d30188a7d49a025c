"""Null benchmark backend: counts frames, reports throughput on close
(reference: src/simpleaudio-benchmark.c:47-110)."""

from __future__ import annotations

import sys
import time

import numpy as np

from . import Direction, SampleFormat, Stream


class BenchmarkStream(Stream):
    def __init__(self, stream_name: str, direction: Direction,
                 fmt: SampleFormat, rate: int, channels: int):
        super().__init__(fmt, rate, channels)
        self.stream_name = stream_name
        self.total_nframes = 0
        print(f"  {stream_name}")
        sys.stdout.flush()
        self._t_start = time.monotonic()

    def _read(self, nframes: int) -> np.ndarray:
        self.total_nframes += nframes
        return np.zeros(nframes * self.channels, dtype=self.format.dtype)

    def _write(self, buf: np.ndarray) -> int:
        nframes = buf.size // self.channels if self.channels else buf.size
        self.total_nframes += nframes
        return nframes

    def _close(self) -> None:
        runtime = time.monotonic() - self._t_start
        runtime_usec = max(1, int(runtime * 1e6))
        playtime_usec = self.total_nframes * 1_000_000 // max(1, self.rate)
        performance = self.total_nframes * 1_000_000 // runtime_usec
        print(f"    frames count:    \t{self.total_nframes}")
        print("    audio playtime:  \t%2d.%06d sec"
              % (playtime_usec // 1_000_000, playtime_usec % 1_000_000))
        print("    elapsed runtime: \t%2d.%06d sec"
              % (runtime_usec // 1_000_000, runtime_usec % 1_000_000))
        print(f"    performance:     \t{performance} samples/sec")
        sys.stdout.flush()
