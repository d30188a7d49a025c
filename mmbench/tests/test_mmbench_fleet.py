"""The four-card fleet cell, bell202.fleet512, on the CPU: its two
readers (fleet_reduce_ms: the median, fleet_gather_ms) against hand
values, None without what they read, and the cell at a tiny size as a
world of four gloo processes, traced: correct, and every per-layer
metric whose reader finds something on the CPU printed.

The tiny cell is built here from the cell's own traffic file
(mmbench/traffic/fleet512.json) with a few short channels."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from mmbench import harness
from mmbench.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
NAME = "bell202.fleet512"
# one batch: every call returns every sampled channel, so a window that
# a loaded host lets hold only one call still checks them all
TINY = dict(channels=8, batches=1, bytes_per_channel=40, check_streams=8,
            cpu_world=4)
T0 = 10.0                      # the driver's window, perf_counter seconds
MS = 1_000_000                 # ns a millisecond


def _rec(name, start_ms, dur_ms):
    s = int(T0 * 1e9) + int(start_ms * MS)
    return SimpleNamespace(name=name, start=s,
                           end=None if dur_ms is None else s + int(dur_ms
                                                                   * MS),
                           counts={})


LOG = [
    _rec("fleet.reduce", -20, 30),                     # before t0: out
    # the window's first reduce waits for the other ranks' profilers
    _rec("fleet.reduce", 0, 4000), _rec("fleet.reduce", 100, 12),
    _rec("fleet.reduce", 200, 18),
    _rec("fleet.gather", 15, 4), _rec("fleet.gather", 120, 6),
    _rec("fleet.gather", 1000, 50),                    # at t1: out
    _rec("fleet.gather", 500, None),                   # open: out
]
HAND = {"fleet_reduce_ms": 18.0, "fleet_gather_ms": 5.0}


def _run(trace=True):
    tr = None
    if trace:
        tr = Trace()
        tr.window_us = (0.0, 1e6)
    return harness.Run(cell=None, seed=0, setup_s=1.0,
                       window={"seconds": 1.0, "t0": T0, "t1": T0 + 1.0,
                               "audio_s": 1.0},
                       spans=Spans(), shapes={}, trace=tr,
                       extra={})


@pytest.fixture
def log(monkeypatch):
    from minimodem_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", lambda: list(LOG))


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_reads_its_hand_value(log, name):
    assert harness.load_reader(name)(_run()) == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_without_a_trace_reads_nothing(log, name):
    assert harness.load_reader(name)(_run(trace=False)) is None


def test_the_fleet_metrics_are_the_manifests():
    """The cell names its eight per-layer metrics and audio_rate.batch,
    and the suffixed ones are read by the existing readers."""
    cell = harness.resolve(harness.load_manifest(ROOT), NAME, ROOT)
    assert cell.chips == 4 and cell.traffic["driver"] == "fleet"
    assert [m["name"] for m in cell.end_to_end] == ["audio_rate.batch",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.fleet", "h2d_gbps.fleet", "wire_copy_ms.fleet",
        "fleet_reduce_ms", "fleet_gather_ms", "upload_ms.fleet",
        "collect_ms.fleet", "k1_halo_pct.fleet"}
    for base in ("device_idle_pct", "h2d_gbps", "wire_copy_ms", "upload_ms",
                 "collect_ms", "k1_halo_pct"):
        assert harness.reader_path(base + ".fleet").stem == base


def test_tiny_cell_traced_on_four_cpu_ranks():
    """Four gloo processes, one torch thread each: correct, and under
    tracing every per-layer metric that a CPU world can read (the spans
    of rank 0 and the cards' idle share; h2d_gbps reads a card's copies,
    which a CPU trace has none of, and k1_halo_pct the counts of K1's
    launch on a card)."""
    import torch

    torch.set_num_threads(1)
    cell = harness.resolve(harness.load_manifest(ROOT), NAME, ROOT)
    cell.traffic.update(TINY)
    res, _ = harness.run_cell(cell, 2**33 + 29, 6.0, True, "cpu")
    assert res["correct"], res["check"]
    assert res["check"]["streams_differing"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    assert set(got) == {"device_idle_pct.fleet", "wire_copy_ms.fleet",
                        "fleet_reduce_ms", "fleet_gather_ms",
                        "upload_ms.fleet", "collect_ms.fleet"}
    assert all(v["value"] > 0 for v in got.values())
    assert got["device_idle_pct.fleet"]["value"] == 100.0
