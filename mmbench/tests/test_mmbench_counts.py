"""The roofline readers' byte and FLOP counts against hand counts at the
cells' own shapes, and the readers on a made-up trace."""

import importlib.util
import json
from pathlib import Path

import pytest

from mmbench import harness
from mmbench.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[2]


def _metric(name):
    path = harness.reader_path(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(cell_name):
    cell = harness.resolve(harness.load_manifest(ROOT), cell_name, ROOT)
    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell, 1, "cpu", Spans())
    return drv.shapes()


# Bell-202 at 48 kHz: 40 samples a bit, 11 frame bits, halo 440, 3 planes;
# a stream of 7716 bytes is 2 + 77160 + 2 bits = 3,086,560 samples.
# UIC: 80 samples a bit, 47 frame bits, 4 planes; a channel is 12 bursts
# of (16 + 60 * 47 + 8) bits and 0.2 s of silence = 2,845,440 samples,
# scored over 11 tiles of 2^18 offsets.
N_LB, N_UIC = 3_086_560, 2_845_440
HAND = {
    ("bell202.loopback8", "k1_roofline", "score"): (
        128 * (N_LB + 440) * 4 + 128 * N_LB * 3 * 4,
        128 * N_LB * (8 * 40 + 10 + 6 * 11 + 6)),
    ("bell202.loopback8", "k4_roofline", "synthesis"): (
        128 * (N_LB * 4 + 77164 / 8), 2 * 128 * N_LB),
    ("bell202.loopback8", "k2_roofline", "statemachine"): (
        128 * (7716 * (3 + 2) * 4 + 7716), 0),
    ("uic_train.batch16", "k3_roofline", "stage1"): (
        16 * (N_UIC / 11 + 79) * 4 + 16 * N_UIC / 11 * 16,
        16 * N_UIC / 11 * 8 * 80),
    ("uic_train.batch16", "k5_roofline", "channels"): (
        16 * N_UIC / 11 * 32, 16 * N_UIC / 11 * (10 + 6 * 47 + 6)),
    ("uic_train.batch16", "k2_roofline.batch", "statemachine"): (
        16 * (720 * (3 + 2) * 4 + 720 * 32), 0),
}


@pytest.mark.parametrize("cell,metric,stage", sorted(HAND))
def test_counts_at_cell_shapes(cell, metric, stage):
    nbytes, flops = _metric(metric).work(_shapes(cell)[stage])
    assert nbytes == pytest.approx(HAND[cell, metric, stage][0], rel=1e-12)
    assert flops == pytest.approx(HAND[cell, metric, stage][1], rel=1e-12)


def _run(records, shapes, window=(0.0, 1000.0), spans=None):
    tr = Trace()
    tr.records, tr.window_us = records, window
    return harness.Run(cell=None, seed=0, setup_s=1.0,
                       window={"seconds": 1.0, "t0": 0.0, "t1": 1.0,
                               "latencies_s": [0.1, 0.2]},
                       spans=spans or Spans(), shapes=shapes, trace=tr,
                       peaks=json.loads((ROOT / "mmbench" / "peaks.json")
                                        .read_text())["NVIDIA H100 80GB HBM3"])


def test_roofline_reader_on_a_made_up_trace():
    shape = {"streams": 1, "offsets": 1000, "nb": 40, "n_bits": 11,
             "planes": 3, "halo": 440}
    nbytes, flops = _metric("k1_roofline").work(shape)
    bound_us = max(nbytes / 3.35e12, flops / 6.7e13) * 1e6
    recs = [("void fused_score_kernel<3>(P)", "kernel", 10.0, 4 * bound_us,
             0), ("void fused_score_kernel<3>(P)", "kernel", 500.0,
                  4 * bound_us, 0), ("other", "kernel", 20.0, 5.0, 0)]
    v = _metric("k1_roofline").read(_run(recs, {"score": shape}))
    assert v == pytest.approx(25.0)
    # not in the cell: nothing to read
    assert _metric("k1_roofline").read(_run(recs, {})) is None


def test_idle_and_copy_readers():
    recs = [("k", "kernel", 0.0, 100.0, 0), ("k", "kernel", 50.0, 100.0, 0),
            ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 400.0, 100.0,
             2_000_000)]
    run = _run(recs, {})
    assert _metric("device_idle_pct.rate").read(run) == pytest.approx(75.0)
    assert _metric("h2d_gbps").read(run) == pytest.approx(20.0)
    assert _metric("launches_per_file").read(run) == pytest.approx(1.0)
