"""The host engines of the port (minimodem_tpu_torch/rx/engine.py: "host",
"host-native", -a on "host") and their chunked scorer (ops/demod.py
DemodScorer) against the JAX package on the CPU, where the stage-1
kernel's wrapper runs its plain version.

Tolerances:
  - score channels: frame bits exact, NaN / +inf / -inf at the same
    offsets, finite conf/ampl within rtol 2e-6, atol 1e-5 (the JAX
    package's own bar between its two scorers, tests/test_pallas_score.py:
    93): the port takes magnitudes as sqrt(c*c + s*s) where the JAX XLA
    path uses hypot, and sums the comb taps in ascending order;
  - decodes: stdout and stderr byte-identical.
"""

import io

import numpy as np
import pytest
import torch

from minimodem_tpu import cli as jax_cli
from minimodem_tpu.models.modem import FskModem
from minimodem_tpu.models.presets import bell_like
from minimodem_tpu.utils.cfloat import f32
from minimodem_tpu_torch import cli as torch_cli

from .helpers import _redirect

RTOL, ATOL = 2e-6, 1e-5
PERFECT_ARGS = ["1200", "--samplerate", "24000", "-M", "1200", "-S", "2400"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modem(mode):
    """The JAX modem for a mode; "perfect" is Bell-202 at 24 kHz with
    1200/2400 Hz tones, the float64-scored geometry of
    tests/test_perfect.py."""
    if mode == "perfect":
        m = FskModem("1200", sample_rate=24000)
        m.preset = bell_like(1200, 24000, mark_f=f32(1200), space_f=f32(2400))
        m.cfg = m.preset.cfg
        return m
    return FskModem(mode)


def _port_cfg(jax_cfg):
    """The same ModemConfig as a port object (the config module is a
    copy, so the fields carry over one for one)."""
    import dataclasses

    from minimodem_tpu_torch.config import ModemConfig

    return ModemConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(jax_cfg)})


def _assert_channels(port: dict, ref: dict):
    for k in ("bits_lo", "bits_hi"):
        assert port[k].dtype == np.uint32
        np.testing.assert_array_equal(port[k], np.asarray(ref[k], np.uint32),
                                      err_msg=k)
    for k in ("conf_data", "conf_sync", "ampl_data", "ampl_sync"):
        o, r = port[k], np.asarray(ref[k])
        assert o.dtype == np.float32, k
        assert np.array_equal(np.isnan(o), np.isnan(r)), k
        assert np.array_equal(np.isposinf(o), np.isposinf(r)), k
        assert np.array_equal(np.isneginf(o), np.isneginf(r)), k
        fin = np.isfinite(r)
        np.testing.assert_allclose(o[fin], r[fin], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_score_frame_channels_f64_matches_jax(noise):
    """A float64 correlation (the perfect geometry's route) gives float32
    channels with the JAX package's bits; magnitudes are rounded to
    float32 before any decision."""
    import jax
    import jax.numpy as jnp

    from minimodem_tpu.ops import demod as JD
    from minimodem_tpu_torch.ops import demod as TD

    m = _modem("perfect")
    geo = JD.geometry_from_config(m.cfg)
    assert geo.use_f64
    rng = np.random.default_rng(3)
    wav = m.modulate(rng.integers(32, 127, size=40, dtype=np.uint8).tobytes())
    t_len = 4096
    x = np.zeros(t_len + geo.halo, np.float32)
    x[:min(len(wav), x.size)] = wav[:x.size]
    x += (rng.random(x.size, dtype=np.float32) - np.float32(0.5)) \
        * np.float32(2 * noise)
    s_len = t_len + geo.max_begin
    basis = JD.make_basis(geo, np.float64)
    corr = np.array(jax.jit(lambda v: JD._correlate_direct(
        v.astype(jnp.float64), jnp.asarray(basis), s_len))(x))
    ref = jax.jit(lambda c: JD.score_frame_channels(
        c, geo, t_len, jnp.float64))(corr)
    out = TD.score_frame_channels(torch.from_numpy(corr),
                                  TD.DemodGeometry(**geo.__dict__), t_len)
    port = {k: v.numpy().view(np.uint32 if k.startswith("bits")
                              else np.float32) for k, v in out.items()}
    _assert_channels(port, {k: np.asarray(v) for k, v in ref.items()})
    if noise == 0.0:
        assert np.isposinf(port["conf_data"]).any()


@pytest.mark.parametrize("mode", ["1200", "300", "same", "rtty", "perfect"])
def test_demod_scorer_matches_jax(mode):
    """DemodScorer.score (one chunk, the K3a form) against the JAX
    package's on noisy audio longer than the chunk."""
    from minimodem_tpu.ops.demod import DemodScorer as JaxScorer
    from minimodem_tpu_torch.ops.demod import DemodScorer

    m = _modem(mode)
    rng = np.random.default_rng(21)
    text = rng.integers(65, 91, size=30, dtype=np.uint8).tobytes()
    wav = m.modulate(text)
    wav = wav + (rng.random(wav.size, dtype=np.float32)
                 - np.float32(0.5)) * np.float32(0.6)
    jsc = JaxScorer(m.cfg, chunk_len=8192)
    tsc = DemodScorer(_port_cfg(m.cfg), chunk_len=8192, device="cpu")
    assert tsc.chunk_len == jsc.chunk_len and tsc.geo.use_f64 == (
        mode == "perfect")
    c0 = 3000
    seg = wav[c0:c0 + tsc.chunk_len + tsc.geo.halo]
    _assert_channels(tsc.score(seg), jsc.score(seg))


def test_score_chunks_equals_score(monkeypatch):
    """score_chunks (overlapping chunk rows of one stream in batched calls,
    the K3b form) is bit-identical with score() chunk by chunk, across
    batch boundaries and the zero-padded tail."""
    from minimodem_tpu_torch.ops.correlate import correlate_plain
    from minimodem_tpu_torch.ops.demod import DemodScorer

    m = _modem("1200")
    rng = np.random.default_rng(22)
    wav = m.modulate(rng.integers(32, 127, size=45, dtype=np.uint8)
                     .tobytes())
    wav = (wav + (rng.random(wav.size, dtype=np.float32)
                  - np.float32(0.5)) * np.float32(0.6)).astype(np.float32)
    sc = DemodScorer(_port_cfg(m.cfg), chunk_len=4096, device="cpu")
    monkeypatch.setattr(DemodScorer, "BATCH", 2)
    n_chunks = -(-len(wav) // sc.chunk_len)
    assert n_chunks >= 5 and n_chunks % 2 == 1
    calls = correlate_plain.calls
    allc = sc.score_chunks(wav)
    assert correlate_plain.calls == calls + (n_chunks + 1) // 2
    for k, v in allc.items():
        assert v.shape == (n_chunks * sc.chunk_len,)
    for i in range(n_chunks):
        one = sc.score(wav[i * sc.chunk_len:])
        for k in one:
            np.testing.assert_array_equal(
                allc[k][i * sc.chunk_len:(i + 1) * sc.chunk_len].view(
                    np.uint32), one[k].view(np.uint32), err_msg=k)


def _decode(package, cfg, samples, engine, codec_name="ascii8", **optkw):
    if package == "jax":
        from minimodem_tpu.codecs import get_codec
        from minimodem_tpu.config import RxOptions
        from minimodem_tpu.rx.engine import Receiver
        kw = {}
    else:
        from minimodem_tpu_torch.codecs import get_codec
        from minimodem_tpu_torch.config import RxOptions
        from minimodem_tpu_torch.rx.engine import Receiver
        cfg = _port_cfg(cfg)
        kw = {"device": "cpu"}
    sink, err = io.BytesIO(), io.StringIO()
    rx = Receiver(cfg, RxOptions(**optkw), get_codec(codec_name), sink.write,
                  err.write, **kw)
    rx.run(samples.copy(), engine=engine)
    return sink.getvalue(), err.getvalue()


def _engine_case(name):
    """The signals of tests/test_engines.py (rtty with a shorter line),
    and 10 baud at 48 kHz, whose 4800-sample bit window takes the FFT
    route."""
    if name == "10":
        m = FskModem("10")
        return m, m.modulate(b"ok\n"), b"ok\n", "ascii8"
    if name == "noisy1200":
        m = FskModem("1200")
        payload = bytes(range(33, 127)) * 3
        samples = m.modulate(payload)
        rng = np.random.default_rng(7)
        samples = samples + rng.uniform(-0.4, 0.4, len(samples)).astype(
            np.float32)
        return m, samples, None, "ascii8"
    m = FskModem(name)
    if name == "rtty":
        payload = b"RYRY CQ 73\n"
    else:
        payload = bytes((33 + (i % 94)) for i in range(200)) + b"\n"
    return m, m.modulate(payload), payload, (
        "baudot" if name == "rtty" else "ascii8")


@pytest.mark.parametrize("engine", ["host", "host-native"])
@pytest.mark.parametrize("case", ["1200", "300", "same", "rtty",
                                  "noisy1200", "10"])
def test_receiver_matches_jax(case, engine):
    from minimodem_tpu_torch.ops.demod import geometry_from_config

    m, samples, payload, codec = _engine_case(case)
    assert (geometry_from_config(_port_cfg(m.cfg)).nb > 4096) == (
        case == "10")
    ref = _decode("jax", m.cfg, samples, engine, codec)
    got = _decode("port", m.cfg, samples, engine, codec)
    assert got == ref
    assert "NOCARRIER" in got[1]
    if payload is not None:
        assert got[0] == payload


def _burst(mark, space, text, rate=24000, baud=300):
    m = FskModem(str(baud), sample_rate=rate)
    m.preset = bell_like(baud, rate, mark_f=f32(mark), space_f=f32(space))
    m.cfg = m.preset.cfg
    return m.modulate(text)


def _autodetect_case(name):
    """The signals of tests/test_autodetect_device.py -> (stream, rx_one,
    expected stdout)."""
    if name == "single":
        w = _burst(1200, 2400, b"HELLO DEVICE AUTODETECT")
        return (np.concatenate([np.zeros(30000, np.float32), w]), False,
                b"HELLO DEVICE AUTODETECT")
    if name == "three":
        parts = []
        for i, txt in enumerate([b"BURST ONE ", b"BURST TWO ",
                                 b"BURST THREE"]):
            parts.append(_burst(1200, 2400, txt))
            parts.append(np.zeros(24000 + 1111 * i, np.float32))
        return np.concatenate(parts), False, None
    if name == "retune":
        w1 = _burst(1200, 2400, b"AT 1200")
        w2 = _burst(1800, 3000, b"AT 1800")
        return (np.concatenate([w1, np.zeros(24000, np.float32), w2]), False,
                b"AT 1200AT 1800")
    if name == "rx_one":
        w1 = _burst(1200, 2400, b"FIRST")
        w2 = _burst(1200, 2400, b"SECOND")
        return (np.concatenate([w1, np.zeros(24000, np.float32), w2]), True,
                b"FIRST")
    return np.zeros(60000, np.float32), False, b""


@pytest.mark.parametrize("case", ["single", "three", "retune", "rx_one",
                                  "none"])
def test_autodetect_host_matches_jax(case):
    stream, rx_one, expect = _autodetect_case(case)
    cfg = bell_like(300, 24000).cfg
    kw = dict(carrier_autodetect_threshold=0.001, rx_one=rx_one)
    ref = _decode("jax", cfg, stream, "host", **kw)
    got = _decode("port", cfg, stream, "host", **kw)
    assert got == ref
    if expect is not None:
        assert got[0] == expect
    if case == "retune":
        assert "@ 1200.0 Hz" in got[1] and "@ 1800.0 Hz" in got[1]
    # host-native reroutes -a to the host engine
    if case == "retune":
        assert _decode("port", cfg, stream, "host-native", **kw) == got


def _run(mod, argv, stdin=b""):
    with _redirect(stdin) as (out, err):
        try:
            code = mod.main(list(argv))
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        return code, out.buffer.getvalue(), err.getvalue()


@pytest.mark.parametrize("args,flags", [
    (["1200"], ["--engine", "host"]),
    (["1200"], ["--engine", "host-native"]),
    (["1200"], ["-a", "--engine", "host"]),
    (PERFECT_ARGS, ["--engine", "host"]),
    (PERFECT_ARGS, ["--engine", "host-native"]),
], ids=["host", "host-native", "autodetect-host", "perfect-host",
        "perfect-host-native"])
def test_cli_host_engines_match_jax_cli(tmp_path, args, flags):
    text = bytes((33 + (i * 7) % 94) for i in range(150)) + b"\n"
    path = str(tmp_path / "f.wav")
    assert _run(jax_cli, ["--tx", "--file", path, *args], text)[0] == 0
    ref = _run(jax_cli, ["--rx", "--file", path, *args, *flags])
    got = _run(torch_cli, ["--rx", "--file", path, *args, *flags,
                           "--device", "cpu"])
    assert ref[0] == 0, ref[2]
    assert got == ref
    if "-a" not in flags:        # autodetect may slip a frame, as in JAX
        assert got[1] == text
    if args is PERFECT_ARGS:
        assert "confidence=inf" in got[2] and "(rate perfect)" in got[2]
