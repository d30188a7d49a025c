"""RTTY (45.45 baud Baudot 5-N-1.5) recorded channels on the port's batch
receiver, on the CPU (the kernels' plain versions), and K1's launch
counts.

DeviceReceiver.run_events_batch of two short seeded channels, each two
bursts of whole frames keyed with the 1,584-sample stop that minimodem
transmits (the benchmark's `mmbench/tones_frames.py`), equals the
benchmark's plain reference (`mmbench/reference/`: PCM16 -> score
planes -> state machine) event for event and byte for byte, and decodes
the keyed words.  `fused_score.launch_counts`, the counts K1's launch
adds to the enclosing span, gives the hand counts of
csrc/fused_score.cu's tiles at Bell-202, RTTY and SAME, one CTA a tile
and walking runs of tiles; `fused_score.pick_run` gives the runs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from minimodem_tpu_torch.models.presets import PRESETS
from minimodem_tpu_torch.ops import fused_score
from minimodem_tpu_torch.ops.demod import geometry_from_config
from minimodem_tpu_torch.ops.device_rx import DeviceReceiver
from mmbench import tones, tones_frames
from mmbench.reference import modem, score, statemachine

ROOT = Path(__file__).resolve().parents[1]
THR, LIM = 1.5, 2.3


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channels(g, rows, bursts, frames, seed):
    """rows PCM16 channels of `bursts` bursts of `frames` seeded words
    (8 leader and 4 trailer mark bits, 20 ms of silence after each),
    uniform noise 0.3, and the words."""
    rng = np.random.default_rng(seed)
    parts, words = [], []
    for _ in range(bursts):
        w = rng.integers(0, 1 << g.n_data_bits, (rows, frames),
                         dtype=np.uint64)
        words.append(w)
        parts += [tones_frames.keyed_burst(w, g, 8, 4, "cpu"),
                  tones.silence(rows, 0.02, g, "cpu")]
    x = torch.cat(parts, dim=1)
    return (tones.noisy_pcm16(x, tones.generator(seed, "cpu"), 0.3),
            np.concatenate(words, axis=1))


def test_rtty_batch_equals_the_reference(one_thread):
    g = modem.geometry(json.loads(
        (ROOT / "mmbench/configs/rtty.json").read_text()))
    s16, words = _channels(g, 2, 2, 2, 2**33 + 19)
    n = s16.shape[1]
    assert n == 2 * (12 * 1056 + 2 * 7920 + 960)
    cfg = PRESETS["rtty"](sample_rate=48000).cfg
    events, _ = DeviceReceiver(cfg, device="cpu").run_events_batch(
        s16, [n, n], THR, LIM)

    t_total = modem.round_up_bucket(n + g.overscan + 1)
    x = np.zeros((2, t_total + g.halo), np.float32)
    x[:, :n] = s16.astype(np.float32) / np.float32(32768.0)
    planes = score.planes(torch.from_numpy(x), g, t_total).numpy()
    st = modem.statics(g, t_total, True)
    for row, got in enumerate(events):
        rec, by = statemachine.run_stream(g, st, planes[row], n, THR, LIM)
        want = (*statemachine.events(rec), by)
        assert len(got) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # the keyed Baudot words, LSB first, one byte each
        assert np.array_equal(got[2], words[row].astype(np.uint8))


# (geometry, rows, t_len) -> (scored, correlated), by hand from
# csrc/fused_score.cu: one CTA a 4096-offset tile correlating its n_t
# offsets plus max_begin, in tasks of 8 offsets
HAND = {
    ("1200", 3, 1 << 21): (3 * (1 << 21), 3 * 512 * (4096 + 400)),
    ("rtty", 32, 12 << 18): (32 * (12 << 18), 32 * 768 * (4096 + 7392)),
    # a last tile of 100 offsets: 7492 correlated, in tasks of 8 -> 7496
    ("rtty", 2, 2 * 4096 + 100): (2 * 8292, 2 * (2 * 11488 + 7496)),
}


@pytest.mark.parametrize("mode,rows,t_len", sorted(HAND))
def test_k1_launch_counts_by_hand(mode, rows, t_len):
    geo = geometry_from_config(PRESETS[mode](sample_rate=48000).cfg)
    assert (fused_score.pick_tile(geo), geo.max_begin) == (
        4096, {"1200": 400, "rtty": 7392}[mode])
    c = fused_score.launch_counts(geo, rows, t_len, 1)
    assert (c["k1_offsets"], c["k1_correlated"]) == HAND[mode, rows, t_len]
    assert c["k1_carried"] == 0


def test_rtty_halo_share():
    """RTTY's K1 correlates 2.8047 offsets a scored offset: k1_halo_pct
    180.46875 at any number of whole tiles, one CTA a tile."""
    geo = geometry_from_config(PRESETS["rtty"](sample_rate=48000).cfg)
    c = fused_score.launch_counts(geo, 32, 12 << 18, 1)
    assert 100.0 * (c["k1_correlated"] / c["k1_offsets"] - 1.0) == 180.46875


# (geometry, rows, t_len, run) -> (correlated, carried), by hand: a tile
# that is not its run's first takes over max_begin rounded up to 8
# offsets (Bell-202 400, RTTY 7392, SAME 645 -> 648) and correlates the
# rest of its round8(n_t + max_begin)
WALKED = {
    # skimmer32: 768 tiles in 34 runs of 23 (the last 9): 734 carry
    ("rtty", 32, 12 << 18, 23): (32 * (768 * 11488 - 734 * 7392),
                                 32 * 734 * 7392),
    # two runs of 2 tiles and 1, the second tile full, the third of 100
    # offsets its own run's first
    ("rtty", 2, 2 * 4096 + 100, 2): (2 * (2 * 11488 + 7496 - 7392),
                                     2 * 7392),
    # one run of all three tiles: the last, partial, carried too
    ("rtty", 2, 2 * 4096 + 100, 3): (2 * (2 * 11488 + 7496 - 2 * 7392),
                                     2 * 2 * 7392),
    # 512 tiles in 103 runs of 5 (the last 2): 409 carry
    ("1200", 3, 1 << 21, 5): (3 * (512 * 4496 - 409 * 400), 3 * 409 * 400),
    # alerts128: 832 tiles in 17 runs of 51 (the last 16): 815 carry 648
    # for SAME's 645, each tile then correlating round8(4096 + 645) - 648
    # = 4096
    ("same", 128, 3407872, 51): (128 * (832 * 4744 - 815 * 648),
                                 128 * 815 * 648),
}


@pytest.mark.parametrize("mode,rows,t_len,run", sorted(WALKED))
def test_k1_launch_counts_walked(mode, rows, t_len, run):
    """A CTA walking `run` tiles: the offsets stage 1 correlates and those
    it carries, by hand, summing to the one-tile-run count."""
    geo = geometry_from_config(PRESETS[mode](sample_rate=48000).cfg)
    c = fused_score.launch_counts(geo, rows, t_len, run)
    assert (c["k1_correlated"], c["k1_carried"]) == WALKED[
        mode, rows, t_len, run]
    one = fused_score.launch_counts(geo, rows, t_len, 1)
    assert c["k1_correlated"] + c["k1_carried"] == one["k1_correlated"]
    assert (c["k1_offsets"], c["k1_reg_offsets"]) == (
        one["k1_offsets"], one["k1_reg_offsets"])


@pytest.mark.parametrize("mode", ["1200", "300", "same", "rtty", "tdd",
                                  "callerid"])
def test_k1_carried_completes_the_one_tile_count(mode):
    """k1_correlated + k1_carried equals the one-tile-run count at every
    run, for lengths of whole tiles and with a partial last tile."""
    geo = geometry_from_config(PRESETS[mode](sample_rate=48000).cfg)
    tile = fused_score.pick_tile(geo)
    for t_len in (1, tile, 7 * tile, 7 * tile + 12, 40 * tile - 3):
        one = fused_score.launch_counts(geo, 3, t_len, 1)
        for run in (1, 2, 3, 7, 40, 41):
            c = fused_score.launch_counts(geo, 3, t_len, run)
            assert c["k1_correlated"] + c["k1_carried"] == \
                one["k1_correlated"], (t_len, run)
            assert c["k1_carried"] % (3 * 8) == 0


def test_rtty_halo_share_walked():
    """skimmer32's shape on an H100 (132 SMs, RTTY's 159 KB CTA alone on
    its SM): runs of 23 tiles, k1_halo_pct 7.99 against 180.47."""
    geo = geometry_from_config(PRESETS["rtty"](sample_rate=48000).cfg)
    run = fused_score.pick_run(geo, 32, 12 << 18, 132)
    assert run == 23
    c = fused_score.launch_counts(geo, 32, 12 << 18, run)
    assert 100.0 * (c["k1_correlated"] / c["k1_offsets"] - 1.0) == \
        7.989501953125


# (geometry, rows, t_len, slots) -> run at RUN_WAVES 8; slots an H100's
# 132 SMs x the CTAs an SM holds (RTTY 1, SAME 3, Bell-202 4; SAME 2 at
# the 121 registers of its bucket before the tile loop)
RUNS = {
    ("rtty", 32, 12 << 18, 132): 23,             # skimmer32: 1,088 CTAs
    ("1200", 128, 3146168, 528): 24,             # loopback8: 4,224
    ("same", 128, 3407872, 264): 51,             # alerts128: 2,176
    ("same", 128, 3407872, 396): 34,             # 3,200
    ("1200", 1, 1 << 21, 528): 1,                # the file decode segment
    ("1200", 1, 1 << 16, 528): 1,                # a streaming segment
    ("1200", 16, 1 << 21, 528): 1,               # 8,192 CTAs, 15.5 waves
    ("rtty", 1, 1 << 16, 132): 1,
}


@pytest.mark.parametrize("mode,rows,t_len,slots", sorted(RUNS))
def test_k1_pick_run(mode, rows, t_len, slots):
    geo = geometry_from_config(PRESETS[mode](sample_rate=48000).cfg)
    assert fused_score.RUN_WAVES == 8
    assert fused_score.pick_run(geo, rows, t_len, slots) == RUNS[
        mode, rows, t_len, slots]


def test_k1_pick_run_is_the_largest_that_keeps_the_waves():
    """pick_run against a search over every run: the largest that leaves
    rows x ceil(tiles / run) >= RUN_WAVES x slots, else 1."""
    geo = geometry_from_config(PRESETS["same"](sample_rate=48000).cfg)
    tile = fused_score.pick_tile(geo)
    rng = np.random.default_rng(25)
    for _ in range(300):
        rows = int(rng.integers(1, 300))
        t_len = int(rng.integers(1, 900)) * tile - int(rng.integers(0, 2)) \
            * int(rng.integers(0, tile))
        slots = int(rng.integers(1, 1200))
        tiles = -(-t_len // tile)
        keep = [r for r in range(1, tiles + 1) if rows * -(-tiles // r)
                >= fused_score.RUN_WAVES * slots]
        assert fused_score.pick_run(geo, rows, t_len, slots) == max(
            keep, default=1), (rows, t_len, slots)
