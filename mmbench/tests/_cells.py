"""Tiny versions of the benchmark's cells for CPU tests: the same
configurations, drivers and comparisons, a few short streams.  The file
and fleet traffics are no cells of BENCHMARK.json yet (PERF.md, Open
questions); their drivers are kept and tested here from their files."""

import json
from pathlib import Path

from mmbench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "bell202.loopback8": dict(streams=3, payload_bytes=60, payload_sets=1,
                              in_flight=2, check_streams=4),
    "uic_train.batch16": dict(channels=3, batches=2, bursts=2,
                              frames_per_burst=4, gap_s=0.05,
                              check_streams=4),
    "bell202.file": dict(files=2, bytes_per_file=120, check_files=2),
    "bell202.fleet4": dict(channels=8, batches=2, bytes_per_channel=40,
                           check_streams=8, cpu_world=4),
}
UNLISTED = {"bell202.file": ("bell202", "file", 1),
            "bell202.fleet4": ("bell202", "fleet4", 4)}


def tiny_cell(name: str):
    if name in UNLISTED:
        config, traffic, chips = UNLISTED[name]
        cell = harness.Cell(
            name, chips, config, traffic,
            json.loads((ROOT / f"mmbench/configs/{config}.json").read_text()),
            json.loads((ROOT / f"mmbench/traffic/{traffic}.json")
                       .read_text()), [], [])
    else:
        cell = harness.resolve(harness.load_manifest(ROOT), name, ROOT)
    cell.traffic.update(TINY[name])
    return cell
