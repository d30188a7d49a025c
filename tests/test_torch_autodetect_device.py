"""Carrier autodetect (-a) on the port's device engine
(minimodem_tpu_torch/rx/engine.py Receiver._run_device_autodetect)
against the JAX package's device -a and the port's own host replay.

The five file cases of tests/test_autodetect_device.py (a single burst
after leading silence, three bursts on one band, a re-arm with a retune,
--rx-one, no carrier at all): the port's Receiver on device="cpu" must
write the JAX Receiver's stdout and stderr byte for byte, and the same as
the port's --engine host.  The JAX side runs its XLA receiver on CPU jax
with the hybrid harvester off (MINIMODEM_TPU_HYBRID=0, as in
tests/test_torch_mega_rx.py).  One CLI case holds the port's
`minimodem-tpu-torch -a` to `minimodem-tpu -a`, stderr included, whose
CARRIER lines name the detected band.
"""

import io

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem

RATE, BAUD = 24000, 300


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


def burst(mark, space, text):
    from minimodem_tpu.models.presets import bell_like
    from minimodem_tpu.utils.cfloat import f32

    m = FskModem(str(BAUD), sample_rate=RATE)
    m.preset = bell_like(BAUD, RATE, mark_f=f32(mark), space_f=f32(space))
    m.cfg = m.preset.cfg
    return m.modulate(text)


def _silence(n):
    return np.zeros(n, np.float32)


def _case(name):
    """(stream, rx_one) of tests/test_autodetect_device.py's file cases."""
    if name == "single_burst":
        return np.concatenate([_silence(30000), burst(
            1200, 2400, b"HELLO DEVICE AUTODETECT")]), False
    if name == "three_bursts":
        parts = []
        for i, txt in enumerate([b"BURST ONE ", b"BURST TWO ",
                                 b"BURST THREE"]):
            parts += [burst(1200, 2400, txt), _silence(24000 + 1111 * i)]
        return np.concatenate(parts), False
    if name == "rearm_retune":
        return np.concatenate([burst(1200, 2400, b"AT 1200"), _silence(24000),
                               burst(1800, 3000, b"AT 1800")]), False
    if name == "rx_one":
        return np.concatenate([burst(1200, 2400, b"FIRST"), _silence(24000),
                               burst(1200, 2400, b"SECOND")]), True
    if name == "no_carrier":
        return _silence(60000), False
    raise KeyError(name)


def run_jax(stream, rx_one):
    from minimodem_tpu.codecs import get_codec
    from minimodem_tpu.config import RxOptions
    from minimodem_tpu.models.presets import bell_like
    from minimodem_tpu.rx.engine import Receiver

    opts = RxOptions(carrier_autodetect_threshold=0.001, rx_one=rx_one)
    out, err = io.BytesIO(), io.StringIO()
    Receiver(bell_like(BAUD, RATE).cfg, opts, get_codec("ascii8"), out.write,
             err.write).run(stream.copy(), engine="device")
    return out.getvalue(), err.getvalue()


def run_port(stream, engine, rx_one):
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.rx.engine import Receiver

    opts = RxOptions(carrier_autodetect_threshold=0.001, rx_one=rx_one)
    out, err = io.BytesIO(), io.StringIO()
    Receiver(bell_like(BAUD, RATE).cfg, opts, get_codec("ascii8"), out.write,
             err.write, device="cpu").run(stream.copy(), engine=engine)
    return out.getvalue(), err.getvalue()


_EXPECT = {
    "single_burst": (b"HELLO DEVICE AUTODETECT", 1),
    "three_bursts": (b"BURST ONE BURST TWO", 2),
    "rearm_retune": (b"AT 1200AT 1800", 2),
    "rx_one": (b"FIRST", 1),
    "no_carrier": (b"", 0),
}


@pytest.mark.parametrize("name", list(_EXPECT))
def test_device_autodetect_matches_jax_and_host(name):
    stream, rx_one = _case(name)
    dev = run_port(stream, "device", rx_one)
    assert dev == run_jax(stream, rx_one)
    assert dev == run_port(stream, "host", rx_one)
    text, carriers = _EXPECT[name]
    assert dev[0].startswith(text)
    assert dev[1].count("### CARRIER") >= carriers
    if name == "rearm_retune":
        assert "@ 1200.0 Hz" in dev[1] and "@ 1800.0 Hz" in dev[1]


def test_device_autodetect_stops_at_every_overflow():
    """Each burst decodes in device calls that stop at a no-confidence
    overflow (stop_on_overflow), in wide records: two bursts on two
    bands, calls on more than one band."""
    from minimodem_tpu_torch.ops import device_rx as TD

    calls = []
    run = TD.DeviceReceiver.run_events_batch

    def spy(self, *a, **k):
        calls.append((self.cfg.b_mark, self.compact, self.stop_on_overflow))
        return run(self, *a, **k)

    stream, _ = _case("rearm_retune")
    mp = pytest.MonkeyPatch()
    mp.setattr(TD.DeviceReceiver, "run_events_batch", spy)
    try:
        run_port(stream, "device", False)
    finally:
        mp.undo()
    assert {c[1:] for c in calls} == {(False, True)}
    assert len({c[0] for c in calls}) >= 2


def test_cli_autodetect_matches_jax(tmp_path):
    """minimodem-tpu-torch --rx -a on --device cpu (the device engine,
    the default) against minimodem-tpu --rx -a: the same stdout and a
    byte-identical stderr, whose CARRIER lines name the detected band."""
    from minimodem_tpu import cli as jax_cli
    from minimodem_tpu_torch import cli as torch_cli

    from .test_torch_slice import _run, _write_wav

    stream, _ = _case("rearm_retune")
    path = str(tmp_path / "a.wav")
    _write_wav(path, stream, "pcm16", RATE)
    args = ["--rx", "--file", path, str(BAUD), "--samplerate", str(RATE),
            "-a"]
    jax = _run(jax_cli, args)
    port = _run(torch_cli, args + ["--device", "cpu"])
    assert port == jax
    assert port[0] == 0 and port[1] == b"AT 1200AT 1800"
    assert "@ 1200.0 Hz" in port[2] and "@ 1800.0 Hz" in port[2]
