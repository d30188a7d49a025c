"""Streaming decode on the port (minimodem_tpu_torch/ops/device_rx.py
DeviceStreamReceiver) against the JAX package's DeviceStreamReceiver and
against the port's own one-shot decode, on the CPU (device="cpu": the
kernels' plain versions).

The four cases of tests/test_streaming.py: audio fed in pieces of 4096,
20000 and 30000 samples gives, segment after segment, the events of the
one-shot decode.  Against the port's one-shot DeviceReceiver the wide
records are equal bit for bit; against the JAX stream on the same feeds
every record's decisions (types, frame bits, frame starts, scan positions,
counts) and bytes are identical and its float lanes (confidence and
amplitude) agree within rtol 2e-6, atol 1e-5, the scorers' stated
last-bit drift (tests/test_torch_device_rx_wide.py).  The rendered stdout
and stderr are byte-identical to the JAX package's.  Then: stop on
overflow from a seeded carry with lane 5 rebased by consumed_total (the
live -a path's receiver), a geometry K1 does not serve (uic-train, scored
through make_score_packer), and the runner cache over a long feed.
"""

import io

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem

from .test_torch_device_rx_wide import (
    _geometry,
    _uic_burst,
    assert_carry_equal,
    assert_events_equal,
)

SEG = 1 << 15


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def sequential_xla():
    from minimodem_tpu.ops import device_rx as D

    mp = pytest.MonkeyPatch()
    mp.setenv("MINIMODEM_TPU_HYBRID", "0")
    D._build_device_rx.cache_clear()
    yield
    D._build_device_rx.cache_clear()
    mp.undo()


def _cfgs(mode="1200"):
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem

    m = FskModem(mode)
    return m, TorchModem(mode, device="cpu").cfg


def _render(pkg, cfg, parts, codec="ascii8"):
    """Render event tuples through one Receiver of `pkg` ("jax" or
    "torch") -> (stdout bytes, stderr text)."""
    if pkg == "jax":
        from minimodem_tpu.codecs import get_codec
        from minimodem_tpu.config import RxOptions
        from minimodem_tpu.rx.engine import Receiver
        kw = {}
    else:
        from minimodem_tpu_torch.codecs import get_codec
        from minimodem_tpu_torch.config import RxOptions
        from minimodem_tpu_torch.rx.engine import Receiver
        kw = {"device": "cpu"}
    out, err = io.BytesIO(), io.StringIO()
    rx = Receiver(cfg, RxOptions(), get_codec(codec), out.write, err.write,
                  **kw)
    for p in parts:
        rx.render_events(*p)
    return out.getvalue(), err.getvalue()


def _stream(sr, samples, feed_size):
    parts = [sr.feed(samples[off:off + feed_size])
             for off in range(0, len(samples), feed_size)]
    parts.append(sr.finish())
    return parts


def _both_streams(samples, feed_size, jcfg, cfg, wide=False, **kw):
    """The same feeds through the JAX and the port's DeviceStreamReceiver
    -> (jax parts, port parts, port receiver)."""
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops import device_rx as TD

    js = D.DeviceStreamReceiver(jcfg, segment_len=SEG, **kw)
    ts = TD.DeviceStreamReceiver(cfg, segment_len=SEG, device="cpu", **kw)
    if wide:
        js.rx = D.DeviceReceiver(jcfg, compact=False)
        js.compact = False
        ts.rx = TD.DeviceReceiver(cfg, compact=False, device="cpu")
        ts.compact = False
    assert ts.segment_len == js.segment_len
    assert ts._lookahead == js._lookahead
    return _stream(js, samples, feed_size), _stream(ts, samples,
                                                    feed_size), ts


def _wide_oneshot(cfg, samples):
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

    (ev,), _ = DeviceReceiver(cfg, compact=False, device="cpu"
                              ).run_events_batch(samples[None], [len(samples)],
                                                 1.5, 2.3)
    return ev


def _cat(parts):
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("feed_size", [4096, 30000])
def test_streaming_matches_oneshot(feed_size):
    """Compact streaming (the live RX mode): per feed, the JAX stream's
    events and bytes; rendered, the port's one-shot wide decode and the
    JAX package's output byte for byte."""
    m, cfg = _cfgs()
    payload = bytes((33 + (i % 94)) for i in range(600))
    samples = m.modulate(payload)
    jparts, tparts, ts = _both_streams(samples, feed_size, m.cfg, cfg)
    assert ts.compact and len(samples) > 3 * ts.segment_len
    assert_events_equal(tparts, jparts, False)
    one = _render("torch", cfg, [_wide_oneshot(cfg, samples)])
    got = _render("torch", cfg, tparts)
    assert got == _render("jax", m.cfg, jparts) == one
    assert got[0] == payload and got[1].count("NOCARRIER") == 1


@pytest.mark.parametrize("feed_size", [4096, 30000])
def test_streaming_wide_matches_oneshot(feed_size):
    """The wide streaming path (stop on overflow and wide-word
    geometries): the concatenated records equal the port's one-shot
    decode bit for bit, and the JAX stream's records."""
    m, cfg = _cfgs()
    payload = bytes((33 + (i % 94)) for i in range(600))
    samples = m.modulate(payload)
    jparts, tparts, _ = _both_streams(samples, feed_size, m.cfg, cfg,
                                      wide=True)
    et, ep = _cat(tparts)
    ot, op = _wide_oneshot(cfg, samples)
    np.testing.assert_array_equal(et, ot)
    assert ep.dtype == op.dtype == np.uint32
    np.testing.assert_array_equal(ep, op)
    assert_events_equal([(et, ep)], [_cat(jparts)], False)
    assert _render("torch", cfg, tparts) == _render("jax", m.cfg, jparts)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, "alaw",
                                   "int16-chunks"])
def test_pipelined_matches_oneshot(monkeypatch, dtype):
    """PipelinedReceiver across segments (a carrier gap spans a segment
    boundary) renders what its one-shot path renders and what the JAX
    package's PipelinedReceiver renders, on float32, int16 and the raw
    A-law wire; and on int16 through a stager of 4 KiB chunks, so that
    each segment's wire spans several chunks and the slots wrap."""
    from minimodem_tpu.ops.device_rx import PipelinedReceiver as JaxPR
    from minimodem_tpu_torch.ops import device_rx, mega_rx
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver

    if dtype == "int16-chunks":
        dtype = np.int16
        monkeypatch.setattr(device_rx, "STAGE_CHUNK_BYTES", 4096)
        stager = device_rx.WireStager(torch.device("cpu"))
        for mod in (device_rx, mega_rx):
            monkeypatch.setattr(mod, "wire_stager", lambda dev: stager)
    m, cfg = _cfgs()
    p1 = bytes((33 + (i % 94)) for i in range(400))
    p2 = b"after the gap"
    samples = np.concatenate([m.modulate(p1), np.zeros(48000, np.float32),
                              m.modulate(p2)])
    enc = None
    if dtype == np.int16:
        samples = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
    elif dtype == "alaw":
        from minimodem_tpu.sigio.containers import _alaw_encode

        enc = "alaw"
        samples = _alaw_encode(np.clip(
            np.rint(samples * 32768.0), -32768, 32767).astype(np.int16))
    one = _render("torch", cfg, PipelinedReceiver(cfg, device="cpu").run(
        samples, 1.5, 2.3, in_encoding=enc))
    seg = PipelinedReceiver(cfg, segment_len=1 << 16, device="cpu")
    assert len(samples) > 3 * seg.segment_len
    got = _render("torch", cfg, seg.run(samples, 1.5, 2.3, in_encoding=enc))
    ref = _render("jax", m.cfg, JaxPR(m.cfg, segment_len=1 << 16).run(
        samples, 1.5, 2.3, in_encoding=enc))
    assert got == one == ref
    if device_rx.STAGE_CHUNK_BYTES == 4096:        # every slot was staged
        assert [c.numel() for c in stager._chunks] == [4096] * 3
    if enc is None:
        assert got[0] == p1 + p2
    else:
        assert len(got[0]) > 0        # G.711 is lossy


def test_streaming_multiple_carriers():
    """Silence gaps drop the carrier; the stream gives the one-shot
    decode's CARRIER / NOCARRIER sequence, as the JAX stream does."""
    m, cfg = _cfgs()
    p1, p2 = b"first burst", b"second burst"
    samples = np.concatenate([m.modulate(p1), np.zeros(48000, np.float32),
                              m.modulate(p2)])
    jparts, tparts, _ = _both_streams(samples, 20000, m.cfg, cfg)
    assert_events_equal(tparts, jparts, False)
    got = _render("torch", cfg, tparts)
    assert got == _render("torch", cfg, [_wide_oneshot(cfg, samples)])
    assert got == _render("jax", m.cfg, jparts)
    assert got[0] == p1 + p2 and got[1].count("NOCARRIER") == 2


def _seeded_carry(cfg, samples):
    """A mid-stream carry: the port's state after a first burst, with the
    position reset to 0 and stop cleared (as the live -a handoff seeds its
    receiver)."""
    from minimodem_tpu_torch.ops.device_rx import DeviceReceiver

    _, carry = DeviceReceiver(cfg, compact=False, stop_on_overflow=True,
                              device="cpu").run_events_batch(
        samples[None], [len(samples)], 1.5, 2.3, finalize=False)
    carry = {k: np.asarray(v).copy() for k, v in carry.items()}
    carry["pos"][0] = 0
    carry["stop"][0] = False
    return carry


def test_stop_on_overflow_with_seeded_carry_matches_jax():
    """stop_on_overflow streaming from an initial_carry (the live -a
    receiver): events with lane 5 rebased by consumed_total, the stop
    flag, abs_pos and the carry as the JAX stream's on the same feeds."""
    m, cfg = _cfgs()
    first = m.modulate(b"seed")
    burst = m.modulate(bytes(48 + i % 40 for i in range(300)))
    samples = np.concatenate([burst, np.zeros(60000, np.float32), burst])
    seed = _seeded_carry(cfg, first)
    assert seed["noconfidence"][0] > 0 or seed["nframes"][0] > 0
    jparts, tparts, ts = _both_streams(
        samples, 7000, m.cfg, cfg, stop_on_overflow=True,
        initial_carry={k: v.copy() for k, v in seed.items()})
    assert not ts.compact and ts.consumed_total > 0
    assert_events_equal(tparts, jparts, False)
    et, ep = _cat(tparts)
    frames = et == 0
    pos = ep[frames, 5].astype(np.int64)
    # lane 5 in fed-stream coordinates: past the first segment, rising
    assert pos.max() > ts.segment_len and (np.diff(pos) > 0).all()
    assert ts.stopped
    from minimodem_tpu.ops.device_rx import DeviceStreamReceiver as JS

    js = JS(m.cfg, segment_len=SEG, stop_on_overflow=True,
            initial_carry={k: v.copy() for k, v in seed.items()})
    for off in range(0, len(samples), 7000):
        js.feed(samples[off:off + 7000])
    js.finish()
    assert ts.abs_pos == js.abs_pos and ts.stopped == js.stopped
    assert_carry_equal(ts._carry, {k: np.asarray(v)
                                   for k, v in js._carry.items()}, False)


def test_unserved_geometry_streams_through_the_score_packer():
    """uic-train (47-bit frames, wide records; K1 does not serve it, so
    each segment scores through make_score_packer): the stream equals the
    port's one-shot decode bit for bit and the JAX stream's records."""
    from minimodem_tpu_torch.ops import fused_score
    from minimodem_tpu_torch.ops.device_rx import geometry_from_config

    jcfg, cfg, _ = _geometry("uic-train")
    assert not fused_score.serves(geometry_from_config(cfg))
    rng = np.random.default_rng(41)
    samples = np.concatenate([_uic_burst(cfg, 12, rng),
                              np.zeros(20000, np.float32),
                              _uic_burst(cfg, 9, rng)]).astype(np.float32)
    jparts, tparts, ts = _both_streams(samples, 9000, jcfg, cfg)
    assert not ts.compact and len(samples) > 3 * ts.segment_len
    et, ep = _cat(tparts)
    ot, op = _wide_oneshot(cfg, samples)
    np.testing.assert_array_equal(et, ot)
    np.testing.assert_array_equal(ep, op)
    assert_events_equal([(et, ep)], [_cat(jparts)], False)
    got = _render("torch", cfg, tparts, "uic-train")
    assert got == _render("jax", jcfg, jparts, "uic-train")
    assert got[0].count(b"Train ID") == 21


def test_runner_cache_holds_over_a_long_feed_and_retunes():
    """A long live feed builds one non-final runner per geometry, however
    many segments it decodes; retunes to new bands add one each."""
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.ops.device_rx import DeviceStreamReceiver
    from minimodem_tpu_torch.ops.mega_rx import mega_runner

    m, _ = _cfgs("300")
    audio = np.concatenate([m.modulate(b"runner cache " * 12),
                            np.zeros(30000, np.float32)])
    mega_runner.cache_clear()
    segments = []
    for mark in (1200, 1500, 1800):
        cfg = bell_like(300, 48000, mark_f=np.float32(mark),
                        space_f=np.float32(mark + 200)).cfg
        sr = DeviceStreamReceiver(cfg, segment_len=1 << 14, device="cpu")
        run = sr.rx.run_events_batch
        sr.rx.run_events_batch = lambda *a, **k: (segments.append(1),
                                                  run(*a, **k))[1]
        for rep in range(3):
            for off in range(0, len(audio), 24000):
                sr.feed(audio[off:off + 24000])
        sr.finish()
    info = mega_runner.cache_info()
    assert len(segments) > 30
    # per band: one non-final runner and one for the tail
    assert info.misses == 6, info
