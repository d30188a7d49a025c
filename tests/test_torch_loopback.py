"""On-device loopback parity: the port's DeviceLoopback
(minimodem_tpu_torch/ops/device_rx.py) against the JAX package's, on the
CPU, where the port runs the kernels' plain versions and the JAX package
its XLA receiver (with the hybrid harvester off, MINIMODEM_TPU_HYBRID=0,
as in tests/test_torch_mega_rx.py).

Event types, positions, frame bits and decoded bytes must be equal; the
float lanes of NOCARRIER records (confidence and amplitude totals) agree
within rtol 2e-6, atol 1e-5 (the synthesized audio differs by a float32
ulp here and there: tests/test_torch_tx_device.py); each stream renders
to its payload.  Modes: 1200 and NOAA SAME (sync bytes) in flat
mode; rtty (1.5 stop bits) and Bell-202 with 1.5 stop bits in frames
mode.
"""

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem

RTOL, ATOL = 2e-6, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequential_xla():
    from minimodem_tpu.ops import device_rx as D

    mp = pytest.MonkeyPatch()
    mp.setenv("MINIMODEM_TPU_HYBRID", "0")
    D._build_device_rx.cache_clear()
    yield
    D._build_device_rx.cache_clear()
    mp.undo()


def _payloads(n, k=200):
    return [bytes(33 + (i * 7 + 13 * j) % 94 for i in range(k))
            for j in range(n)]


@pytest.fixture(scope="module")
def flat(sequential_xla):
    """Per mode: (cfg, payloads, schedules, the JAX loopback's events),
    one JAX DeviceLoopback (one XLA compile) per mode."""
    from minimodem_tpu.codecs import Ascii8Codec
    from minimodem_tpu.ops.device_rx import DeviceLoopback
    from minimodem_tpu.ops.tx_device import tx_bit_schedule

    out = {}
    for mode in ("1200", "same"):
        m = FskModem(mode)
        payloads = _payloads(2)
        scheds = [tx_bit_schedule(p, m.cfg, Ascii8Codec()) for p in payloads]
        out[mode] = (m.cfg, payloads, scheds,
                     DeviceLoopback(m.cfg).run_events_batch(scheds))
    return out


def assert_events_match(got, ref):
    """Types, integer payload lanes and bytes equal; NOCARRIER float lanes
    (1: confidence total, 2: amplitude total) within RTOL / ATOL."""
    assert len(got) == len(ref)
    for (tt, tp, tb), (jt, jp, jb) in zip(got, ref):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tb, jb)
        nc = tt == 2
        for lane in range(6):
            if lane in (1, 2):
                np.testing.assert_array_equal(tp[~nc, lane], jp[~nc, lane])
                np.testing.assert_allclose(
                    tp[nc, lane].view(np.float32),
                    jp[nc, lane].view(np.float32), rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(tp[:, lane], jp[:, lane])


def _render_ok(cfg, dec, payloads, events):
    from minimodem_tpu_torch.bench import _render_ok

    return _render_ok(cfg, dec, payloads, events)


@pytest.mark.parametrize("mode", ["1200", "same"])
def test_flat_loopback_matches_jax(flat, mode):
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    cfg, payloads, scheds, ref = flat[mode]
    got = DeviceLoopback(cfg, device="cpu").run_events_batch(scheds)
    assert_events_match(got, ref)
    assert [e[0].tolist() for e in got] == [[1, 2]] * 2
    assert _render_ok(cfg, "ascii8", payloads, got)


def test_pipelined_and_chain_equal_the_synchronous_call(flat):
    """dispatch / prefetch / collect in a depth-2 loop, and a chain of two
    sub-batches, give the synchronous call's results."""
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    cfg, payloads, scheds, ref = flat["1200"]
    lb = DeviceLoopback(cfg, device="cpu")
    sync = lb.run_events_batch(scheds)
    rev = scheds[::-1]
    h1 = lb.dispatch_events_batch(scheds)
    h2 = lb.dispatch_events_batch(rev)
    lb.prefetch_events_batch(h1)
    a = lb.collect_events_batch(h1)
    b = lb.collect_events_batch(h2)
    chained = lb.run_events_chain([scheds, rev])
    for res in (a, b[::-1], chained[:2], chained[2:][::-1]):
        assert_events_match(res, sync)
    assert lb.run_events(scheds[1])[2].tobytes() == payloads[1]


def test_chain_of_one_is_refused(flat):
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    cfg, _, scheds, _ = flat["1200"]
    lb = DeviceLoopback(cfg, device="cpu")
    with pytest.raises(AssertionError, match=">= 2 sub-batches"):
        lb.dispatch_events_chain([scheds])
    with pytest.raises(AssertionError, match="equal width"):
        lb.dispatch_events_chain([scheds, scheds[:1]])


def _frames_case(mode, texts):
    from minimodem_tpu.codecs import get_codec
    from minimodem_tpu.ops.tx_device import tx_frame_schedule

    m = FskModem(mode)
    if mode == "1200":                 # Bell-202 with 1.5 stop bits
        m.cfg.nstopbits = np.float32(1.5)
        m.cfg.finalize()
        enc = get_codec("ascii8")
    else:
        enc = get_codec("baudot", usos=True)
    rows = []
    for t in texts:
        fb, lead, trail = tx_frame_schedule(t, m.cfg, enc)
        rows.append(fb)
    return m, rows, (lead, trail)


def test_frames_loopback_fractional_stop_matches_jax(sequential_xla):
    """run_events_frames_batch, the fractional-stop-bit path, at Bell-202
    with 1.5 stop bits: the JAX package's frame pad (512 frames) stays
    cheap at 40-tap bits."""
    from minimodem_tpu.ops.device_rx import DeviceLoopback as JaxLoopback
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback

    texts = _payloads(2, 120)
    m, rows, lt = _frames_case("1200", texts)
    ref = JaxLoopback(m.cfg).run_events_frames_batch(rows, lt)
    lb = DeviceLoopback(m.cfg, device="cpu")
    assert not lb.uniform
    got = lb.run_events_frames_batch(rows, lt)
    assert_events_match(got, ref)
    assert _render_ok(m.cfg, "ascii8", texts, got)


def test_frames_loopback_rtty_matches_jax(sequential_xla):
    """rtty in frames mode through both packages' build_loop at a frame
    pad of 7, past both streams' real frames (the public call pads to 512
    frames, ~4 M samples a stream, too slow for the CPU plain versions of
    1056-tap bits)."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback, _collect

    texts = [b"RYRY", b"CQ 73"]
    m, rows, lt = _frames_case("rtty", texts)
    f_pad = 7
    bits = np.zeros((2, f_pad, m.cfg.n_data_bits), np.uint8)
    for i, fb in enumerate(rows):
        bits[i, :len(fb)] = fb
    nf = np.asarray([len(fb) for fb in rows], np.int32)
    lb = DeviceLoopback(m.cfg, device="cpu")
    totals = np.asarray([(lt[0] + lt[1]) * lb.bit_ns + n * lb.frame_len
                         for n in nf], np.int32)
    run, compact, _ = D.DeviceLoopback(m.cfg).build_loop(f_pad, 2, True, lt)
    ref = D._collect_results(jax.jit(run)(
        jnp.asarray(bits), jnp.asarray(totals), np.float32(1.5),
        np.float32(2.3), D.zero_carry(2), jnp.asarray(nf)), 2, compact)
    got = _collect(lb.build_loop(f_pad, True, lt)(
        torch.from_numpy(bits), torch.from_numpy(totals), (1.5, 2.3),
        torch.from_numpy(nf)), 2)
    assert_events_match(got, ref)
    assert _render_ok(m.cfg, "baudot", texts, got)


def test_sched_pad_matches_jax():
    from minimodem_tpu.ops.device_rx import _sched_pad as jax_pad
    from minimodem_tpu_torch.ops.device_rx import _sched_pad

    for n in (1, 300, 511, 512, 513, 4095, 4096, 4097, 77160, 123456):
        assert _sched_pad(n) == jax_pad(n)


def _uic_schedule(rng, n_frames):
    """Raw UIC-751-3 bits: mark leader, n_frames telegrams (the sync
    pattern 11110010, then 39 seeded data bits), mark trailer."""
    bits = [1] * 8
    for _ in range(n_frames):
        data = int(rng.integers(0, 1 << 39))
        bits += [1, 1, 1, 1, 0, 0, 1, 0] + [(data >> i) & 1
                                            for i in range(39)]
    return np.asarray(bits + [1] * 8, np.uint8)


def test_uic_loopback_matches_jax(sequential_xla):
    """UIC-751-3 (39 data bits, 47 frame bits), which the loopback once
    refused: wide records with the bits_hi plane, as the JAX loopback
    returns them.  Types, frame bits, starts and counts equal, the float
    lanes (frame confidence and amplitude, NOCARRIER totals) within RTOL /
    ATOL, and both render the same telegrams."""
    import io

    from minimodem_tpu.ops.device_rx import DeviceLoopback as JaxLoopback
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem
    from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
    from minimodem_tpu_torch.rx.engine import Receiver

    cfg = TorchModem("uic-train", device="cpu").cfg
    rng = np.random.default_rng(7)
    scheds = [_uic_schedule(rng, 12), _uic_schedule(rng, 9)]
    ref = JaxLoopback(FskModem("uic-train").cfg).run_events_batch(scheds)
    got = DeviceLoopback(cfg, device="cpu").run_events_batch(scheds)
    assert len(got) == len(ref) == 2
    rendered = []
    for (tt, tp), (jt, jp) in zip(got, ref):
        np.testing.assert_array_equal(tt, jt)
        floats = np.zeros(tp.shape, bool)
        floats[tt == 2, 1:3] = True
        floats[tt == 0, 2:4] = True
        np.testing.assert_array_equal(tp[~floats], jp[~floats])
        np.testing.assert_allclose(tp[floats].view(np.float32),
                                   jp[floats].view(np.float32),
                                   rtol=RTOL, atol=ATOL)
        outs = []
        for ev in ((tt, tp), (jt, jp)):
            out, err = io.BytesIO(), io.StringIO()
            Receiver(cfg, RxOptions(), get_codec("uic-train"), out.write,
                     err.write, device="cpu").render_events(*ev)
            outs.append((out.getvalue(), err.getvalue()))
        assert outs[0] == outs[1]
        rendered.append(outs[0][0])
    assert [r.count(b"Train ID") for r in rendered] == [12, 9]
