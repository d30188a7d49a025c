"""NOAA SAME (520.83 baud, 8-N-0 after a 0xAB sync byte) on the port's
loopback, on the CPU (the kernels' plain versions), and the scorer's
layout by preset.

DeviceLoopback.run_events_batch of two seeded streams of one EAS alert
each, keyed as `minimodem --tx --tx-carrier` keys them by the benchmark's
schedule maker (`mmbench/drivers/loopback_sync.py`), equals the
benchmark's plain reference (`mmbench/reference/sync.py`: audio -> the
five dual planes -> the state machine that acquires on the sync byte and
drops it) event for event and byte for byte, and decodes each header and
NNNN without the preambles.  SAME is the preset whose sync expectation
differs from its data one, so its scorer writes the five planes of the
dual layout; the presets without a sync byte write three.
"""

from pathlib import Path

import numpy as np
import pytest

from minimodem_tpu_torch.models.presets import PRESETS
from minimodem_tpu_torch.ops import fused_score
from minimodem_tpu_torch.ops.demod import geometry_from_config
from minimodem_tpu_torch.ops import device_rx
from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
from mmbench import harness
from mmbench.trace import Spans

ROOT = Path(__file__).resolve().parents[1]
THR, LIM = 1.5, 2.3


def _driver(**traffic):
    """The benchmark cell's driver over 2 streams of one set."""
    cell = harness.resolve(harness.load_manifest(ROOT), "same.alerts128",
                           ROOT)
    cell.traffic.update(streams=2, payload_sets=1, check_streams=2,
                        **traffic)
    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell, 2**33 + 5, "cpu", Spans())
    drv.make_inputs()
    return drv


def test_same_loopback_equals_the_reference():
    drv = _driver(alerts_per_stream=1)
    scheds = drv.scheds[0]
    assert [len(s) for s in scheds] == [5840, 5840]
    cfg = PRESETS["same"](sample_rate=48000).cfg
    got = DeviceLoopback(cfg, device="cpu").run_events_batch(scheds, THR,
                                                             LIM)
    want = drv.reference()
    assert sorted(want) == [(0, 0), (0, 1)]
    for i, res in enumerate(got):
        ref = want[0, i]
        assert len(res) == len(ref) == 3
        for a, b in zip(res, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # acquired once, on the first preamble, held to the end
        assert list(res[0]) == [1, 2]
        data = bytes(res[2])
        head = np.packbits(scheds[i][128:128 + 616],
                           bitorder="little").tobytes()
        assert head.startswith(b"ZCZC-") and len(head) == 77
        assert data.startswith(head) and data.count(head) == 3
        assert b"NNNN" in data and b"\xab" not in data


# mode -> the scorer's planes: SAME's sync pattern 11010101 differs from
# its data pattern dddddddd (the dual layout); the others have no sync byte
PLANES = {"same": ("conf_data", "ampl_data", "bits_lo", "conf_sync",
                   "ampl_sync"),
          "1200": ("conf_data", "ampl_data", "bits_lo"),
          "rtty": ("conf_data", "ampl_data", "bits_lo"),
          "tdd": ("conf_data", "ampl_data", "bits_lo")}


@pytest.mark.parametrize("mode", sorted(PLANES))
def test_scorer_layout_by_preset(mode):
    geo = geometry_from_config(PRESETS[mode](sample_rate=48000).cfg)
    assert fused_score.plane_rows(geo) == len(PLANES[mode])
    assert tuple(device_rx.plane_names(geo)) == PLANES[mode]
