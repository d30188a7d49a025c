"""The benchmark's plain reference against minimodem_tpu_torch's own plain
versions on the CPU, at a small size: geometry and candidate tables, the
bit schedules and loopback audio, the score planes, and the state machine
in both record forms."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mmbench import tones
from mmbench.reference import modem, score, statemachine, synth

ROOT = Path(__file__).resolve().parents[2]
MODES = {"bell202": "1200", "uic_train": "uic-train"}


def _cfg(name):
    return json.loads((ROOT / "mmbench" / "configs" / f"{name}.json")
                      .read_text())


def _program(name):
    from minimodem_tpu_torch.models.presets import PRESETS
    from minimodem_tpu_torch.ops.device_rx import device_rx_key

    cfg = PRESETS[MODES[name]](sample_rate=48000).cfg
    return cfg, device_rx_key(cfg)


@pytest.mark.parametrize("name", sorted(MODES))
def test_geometry_and_tables(name):
    from minimodem_tpu_torch.ops.device_rx import geo_from_key
    from minimodem_tpu_torch.ops.mega_rx import MegaStatics

    g = modem.geometry(_cfg(name))
    cfg, key = _program(name)
    pg = geo_from_key(key)
    assert (g.nb, g.bit_begin, g.b_mark, g.b_space, g.fftsize, g.req) == (
        pg.nb, pg.bit_begin, pg.b_mark, pg.b_space, pg.fftsize, pg.req_data)
    assert float(g.magscalar) == pg.magscalar
    assert (g.frame_nsamples, g.overscan, g.expect_nsamples,
            g.bit_nsamples_tx) == (cfg.frame_nsamples, cfg.nsamples_overscan,
                                   cfg.expect_nsamples, cfg.bit_nsamples_tx)
    compact = g.n_data_bits <= 8
    for t_total in (1 << 14, 1 << 18, 12 << 18):
        ms = MegaStatics.build(key, t_total, False, compact)
        st = modem.statics(g, t_total, compact)
        assert (ms.try_max, ms.coarse_step, ms.cand_c, ms.cand_f,
                ms.max_events, ms.b_cap, ms.data_shift) == (
            st.try_max, st.coarse_step, st.cand_c, st.cand_f, st.max_events,
            st.b_cap, st.data_shift)


def test_schedules_and_audio():
    from minimodem_tpu_torch.codecs import Ascii8Codec
    from minimodem_tpu_torch.ops.tx_device import (device_synthesize,
                                                   tx_bit_schedule)

    g = modem.geometry(_cfg("bell202"))
    cfg, _ = _program("bell202")
    pay = np.random.default_rng(3).integers(32, 127, (2, 40), dtype=np.uint8)
    sched = synth.bit_schedules(pay, g)
    for row, p in zip(sched, pay):
        assert np.array_equal(row, tx_bit_schedule(bytes(p), cfg,
                                                   Ascii8Codec()))
    bits = torch.from_numpy(sched)
    assert torch.equal(synth.audio(bits, g), device_synthesize(bits, cfg))
    # the recorded traffic's frames are the same keying
    assert np.array_equal(tones.frame_bits(pay[0], g), sched[0][2:-2])


def _noisy(name, n, seed=5):
    rng = np.random.default_rng(seed)
    g = modem.geometry(_cfg(name))
    words = rng.integers(0, 1 << g.n_data_bits, 12, dtype=np.uint64)
    bits = np.concatenate([np.ones(16, np.uint8), tones.frame_bits(words, g),
                           np.ones(8, np.uint8)])
    x = torch.cat([tones.silence(1, 0.05, g, "cpu"),
                   tones.keyed_audio(bits[None], g, "cpu"),
                   tones.silence(1, 0.05, g, "cpu")], dim=1)
    s16 = tones.noisy_pcm16(x, tones.generator(seed, "cpu"), 0.3)[:, :n]
    return g, s16


@pytest.mark.parametrize("name", sorted(MODES))
def test_planes_and_state_machine(name):
    from minimodem_tpu_torch.ops.demod import (correlate, make_basis,
                                               score_frame_channels)
    from minimodem_tpu_torch.ops.device_rx import (DeviceReceiver,
                                                   geo_from_key)

    g, s16 = _noisy(name, 40000)
    cfg, key = _program(name)
    geo = geo_from_key(key)
    n = s16.shape[1]
    t_total = modem.round_up_bucket(n + g.overscan + 1)
    x = np.zeros((1, t_total + g.halo), np.float32)
    x[0, :n] = s16[0].astype(np.float32) / np.float32(32768.0)
    xt = torch.from_numpy(x)
    planes = score.planes(xt, g, t_total)
    corr = correlate(xt[:, :t_total + geo.halo],
                     torch.from_numpy(make_basis(geo, np.float32)),
                     t_total + geo.max_begin)
    ch = score_frame_channels(corr, geo, t_total)
    want = [ch["conf_data"].view(torch.int32),
            ch["ampl_data"].view(torch.int32), ch["bits_lo"], ch["bits_hi"]]
    assert torch.equal(planes, torch.stack(want[:g.n_planes], dim=1))

    compact = g.n_data_bits <= 8
    st = modem.statics(g, t_total, compact)
    rec, by = statemachine.run_stream(g, st, planes[0].numpy(), n, 1.5, 2.3)
    ref = statemachine.events(rec)
    events, _ = DeviceReceiver(cfg, device="cpu").run_events_batch(
        s16, [n], 1.5, 2.3)
    got = events[0]
    assert np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1])
    assert len(ref[0]) >= 2            # the stream decoded something
    if compact:
        assert np.array_equal(by, got[2])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    y = score.to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0             # a tie, to even
    assert y[2] == 1.0 + 2 ** -9                   # a tie, to even
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
