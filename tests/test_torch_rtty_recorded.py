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
csrc/fused_score.cu's tiles at Bell-202 and RTTY.
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
    c = fused_score.launch_counts(geo, rows, t_len)
    assert (c["k1_offsets"], c["k1_correlated"]) == HAND[mode, rows, t_len]


def test_rtty_halo_share():
    """RTTY's K1 correlates 2.8047 offsets a scored offset: k1_halo_pct
    180.46875 at any number of whole tiles."""
    geo = geometry_from_config(PRESETS["rtty"](sample_rate=48000).cfg)
    c = fused_score.launch_counts(geo, 32, 12 << 18)
    assert 100.0 * (c["k1_correlated"] / c["k1_offsets"] - 1.0) == 180.46875
