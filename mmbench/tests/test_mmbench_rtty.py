"""The RTTY skimmer cell (rtty.skimmer32) on the CPU: the frame keyer's
frames (7,920 samples, a 1,584-sample stop, continuous phase, equal to
tones.keyed_audio where the stop is whole), a tiny cell built from the
cell's own files run through harness.run_cell (correct; not correct with
one returned byte altered), k1_halo_pct on a made-up span log, and the
roofline's counts at the cell's shape."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmbench import harness, tones, tones_frames
from mmbench.reference import modem
from mmbench.trace import Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "rtty.skimmer32"
# a call takes seconds on the CPU (the plain 1056-tap correlation): the
# window is longer than one
TINY = dict(channels=2, batches=1, bursts=2, frames_per_burst=1,
            leader_bits=4, trailer_bits=2, gap_s=0.01, check_streams=2)
SECONDS = 6.0


def _config(name, **modem_kw):
    cfg = json.loads((ROOT / f"mmbench/configs/{name}.json").read_text())
    cfg["modem"].update(modem_kw)
    return cfg


def _geometry(name, **modem_kw):
    return modem.geometry(_config(name, **modem_kw))


def test_frames_and_stop():
    g = _geometry("rtty")
    assert (g.bit_nsamples_tx, tones_frames.stop_nsamples(g),
            tones_frames.frame_nsamples_tx(g)) == (1056, 1584, 7920)
    words = np.array([[0b10110, 0b00001, 0b11111]], np.uint64)
    a = tones_frames.keyed_burst(words, g, 2, 1, "cpu")
    assert a.shape == (1, 3 * 1056 + 3 * 7920)


@pytest.mark.parametrize("name,stop", [("rtty", 1.5), ("rtty", 2.0),
                                       ("bell202", 1.0), ("uic_train", 0.0)])
def test_phase_is_continuous(name, stop):
    """Every sample is sin(2 pi phase), the phase the sum of the tones'
    steps of all samples before it: no jump at a segment's edge, the
    fractional stop's included."""
    g = _geometry(name, nstopbits=stop)
    words = np.random.default_rng(3).integers(
        0, 1 << min(g.n_data_bits, 16), (2, 3), dtype=np.uint64)
    a = tones_frames.keyed_burst(words, g, 3, 2, "cpu").numpy()
    idx, lens = tones_frames.frame_segments(g)
    tpl = np.stack([tones.frame_bits(w, g).reshape(3, -1) for w in words])
    seg_bits = np.concatenate([np.ones((2, 3)), tpl[:, :, idx].reshape(2, -1),
                               np.ones((2, 2))], axis=1)
    seg_lens = np.concatenate([[g.bit_nsamples_tx] * 3, np.tile(lens, 3),
                               [g.bit_nsamples_tx] * 2]).astype(int)
    f = np.where(np.repeat(seg_bits, seg_lens, axis=1) == 1,
                 float(g.mark_f), float(g.space_f)) / g.sample_rate
    ph = np.cumsum(f, axis=1) - f
    assert a.shape == ph.shape
    np.testing.assert_allclose(a, np.sin(2 * np.pi * ph), rtol=0, atol=1e-9)
    if stop == 1.5:
        assert list(lens[-2:]) == [1056, 528]


@pytest.mark.parametrize("name,stop", [("rtty", 1.0), ("rtty", 2.0),
                                       ("bell202", 1.0), ("uic_train", 0.0)])
def test_whole_stop_equals_keyed_audio(name, stop):
    """With a whole stop, the keyer is tones.keyed_audio of the frame
    bits with that many stop bits, bit for bit."""
    g = _geometry(name, nstopbits=stop)
    words = np.random.default_rng(4).integers(
        0, 1 << min(g.n_data_bits, 16), (2, 4), dtype=np.uint64)
    got = tones_frames.keyed_burst(words, g, 5, 3, "cpu")
    n_stop = int(stop)
    rows = []
    for w in words:
        fb = tones.frame_bits(w, g).reshape(len(w), -1)
        if n_stop > 1:
            fb = np.concatenate([fb] + [fb[:, -1:]] * (n_stop - 1), axis=1)
        rows.append(np.concatenate([np.ones(5, np.uint8), fb.reshape(-1),
                                    np.ones(3, np.uint8)]))
    want = tones.keyed_audio(np.stack(rows), g, "cpu")
    assert torch.equal(got, want)


def _tiny():
    cell = harness.resolve(harness.load_manifest(ROOT), CELL, ROOT)
    assert cell.traffic["driver"] == "recorded_frames"
    cell.traffic.update(TINY)
    return cell


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_files_and_shapes():
    """The cell as its files give it: 32 channels of 3,044,352 samples
    (63.4 s), 320 frames each, K1's shape at nb 1056 and halo 8448."""
    cell = harness.resolve(harness.load_manifest(ROOT), CELL, ROOT)
    drv = harness.load_driver(cell.traffic["driver"]).Driver(
        cell, 1, "cpu", Spans())
    assert drv.samples() == 3_044_352
    assert drv.samples() / 48000 == pytest.approx(63.424)
    s = drv.shapes()
    assert s["score"] == {"streams": 32, "offsets": 3_044_352, "nb": 1056,
                          "n_bits": 8, "planes": 3, "halo": 8448}
    assert s["statemachine"]["frames"] == 320
    assert [m["name"] for m in cell.per_layer] == [
        "k1_halo_pct", "k1_roofline.skimmer", "device_idle_pct.skimmer"]
    assert [m["name"] for m in cell.end_to_end] == ["audio_rate.batch",
                                                    "setup_s"]


def test_roofline_counts_at_the_cell_shape():
    cell = harness.resolve(harness.load_manifest(ROOT), CELL, ROOT)
    shape = harness.load_driver(cell.traffic["driver"]).Driver(
        cell, 1, "cpu", Spans()).shapes()["score"]
    path = harness.reader_path("k1_roofline.skimmer")
    assert path.name == "k1_roofline.py"
    import importlib.util

    spec = importlib.util.spec_from_file_location("k1r", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n = 3_044_352
    assert mod.work(shape) == (32 * (n + 8448) * 4 + 32 * n * 3 * 4,
                               32 * n * (8 * 1056 + 10 + 6 * 8 + 6))


def test_tiny_cell_runs_correct(one_thread):
    res, lines = harness.run_cell(_tiny(), 2**32 + 91, SECONDS, False, "cpu")
    assert res["correct"], lines
    assert res["check"]["channels_differing"] == {"value": 0, "limit": 0}
    assert res["attempted"] >= 2 and set(res["metrics"]) == {
        "audio_rate.batch", "setup_s"}


def test_tiny_cell_one_byte_altered_not_correct(one_thread, monkeypatch):
    from minimodem_tpu_torch.ops import device_rx

    run = device_rx.DeviceReceiver.run_events_batch

    def altered(self, *a, **k):
        ev, rest = run(self, *a, **k)
        ev = [tuple(np.array(x, copy=True) for x in e) for e in ev]
        for e in ev:
            assert len(e[2]) > 0
            e[2][-1] ^= 1
        return ev, rest

    monkeypatch.setattr(device_rx.DeviceReceiver, "run_events_batch",
                        altered)
    res, _ = harness.run_cell(_tiny(), 2**32 + 91, SECONDS, False, "cpu")
    assert not res["correct"]
    assert res["check"]["channels_differing"]["value"] == 2


def _rec(name, start_s, counts):
    s = int(start_s * 1e9)
    return SimpleNamespace(name=name, start=s, end=s + 1000, counts=counts)


def test_k1_halo_pct_reads_the_span_log(monkeypatch):
    from minimodem_tpu_torch.utils import trace

    rtty = {"k1_offsets": 32 * 3_145_728, "k1_correlated": 32 * 768 * 11488}
    log = [_rec("rx.enqueue", 9.5, {"k1_offsets": 1, "k1_correlated": 99}),
           _rec("rx.enqueue", 10.1, rtty), _rec("rx.enqueue", 10.5, rtty),
           _rec("rx.wire", 10.6, {"k1_offsets": 1, "k1_correlated": 99}),
           _rec("rx.enqueue", 11.0, {"k1_offsets": 1})]      # at t1: out
    run = harness.Run(cell=None, seed=0, setup_s=1.0,
                      window={"seconds": 1.0, "t0": 10.0, "t1": 11.0},
                      spans=Spans(), shapes={}, trace=Trace())
    read = harness.load_reader("k1_halo_pct")
    monkeypatch.setattr(trace, "records", lambda: list(log))
    assert read(run) == 180.46875
    # the parent's program: rx.enqueue spans without the counts
    monkeypatch.setattr(trace, "records", lambda: [
        _rec("rx.enqueue", 10.2, {})])
    assert read(run) is None
    monkeypatch.setattr(trace, "records", lambda: list(log))
    assert read(harness.Run(cell=None, seed=0, setup_s=1.0,
                            window=run.window, spans=Spans(), shapes={},
                            trace=None)) is None
