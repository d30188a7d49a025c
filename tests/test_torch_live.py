"""Live audio on the port: minimodem-tpu-torch without --file (live RX,
live -a, interactive TX) and its PulseAudio / ALSA / sndio backends
(minimodem_tpu_torch/sigio/{pulse,alsa,sndio}.py), on the CPU.

The client libraries are the JAX tests' stand-ins (FakeAsound, FakePulse,
FakeSndio), installed on the port's sigio modules for the port and on the
JAX package's for minimodem-tpu, each with the same capture.  On the same
capture the port with --device cpu writes minimodem-tpu's stdout and
stderr byte for byte, plays the same samples, and exits with the same
code; live -a through Receiver.run_live_autodetect renders exactly what
the JAX package's renders on the same chunks, and what the port's
file-mode device -a renders on the whole stream.  The interactive TX
cases of tests/test_tx_interactive.py run on the port's Transmitter, and
the backends' round trips and error paths on the port's copies, which
are the JAX package's files byte for byte.
"""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch

import minimodem_tpu.sigio as jax_sigio
import minimodem_tpu_torch.sigio as torch_sigio
from minimodem_tpu import cli as jax_cli
from minimodem_tpu.models.modem import FskModem
from minimodem_tpu_torch import cli as torch_cli
from minimodem_tpu_torch.sigio import Direction, SampleFormat, open_stream

from .test_alsa import FakeAsound
from .test_pulse import FakePulse
from .test_sndio import FakeSndio
from .test_torch_slice import _run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("alsa", "pulse", "sndio")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_modem(mode="1200", **kw):
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem

    return TorchModem(mode, device="cpu", **kw)


def _install(monkeypatch, pkg_sigio, libs):
    """libs: {"alsa" | "pulse" | "sndio": fake or None}; every backend not
    named has no client library."""
    import importlib

    for name in BACKENDS:
        mod = importlib.import_module(f"{pkg_sigio.__name__}.{name}")
        monkeypatch.setattr(mod, "_lib", libs.get(name))
        monkeypatch.setattr(mod, "_tried", True)


def _both(monkeypatch, argv, make_libs, stdin=b""):
    """argv through minimodem-tpu and minimodem-tpu-torch --device cpu, each
    on its own fresh stand-in libraries -> ((code, stdout, stderr),
    libs) per package."""
    from .helpers import _redirect

    res = []
    for pkg, mod, extra in ((jax_sigio, jax_cli, []),
                            (torch_sigio, torch_cli, ["--device", "cpu"])):
        libs = make_libs()
        _install(monkeypatch, pkg, libs)
        with _redirect(stdin) as (out, err):
            try:
                code = mod.main(list(argv) + extra)
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
            res.append(((code, out.buffer.getvalue(), err.getvalue()), libs))
    return res


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_copies_are_the_jax_files(name):
    with open(os.path.join(ROOT, "minimodem_tpu", "sigio", name + ".py"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "minimodem_tpu_torch", "sigio", name + ".py"),
              "rb") as f:
        assert f.read() == ref


# ----------------------------------------------------------------------
# the live CLI against minimodem-tpu (tests/test_cli_live.py:104-205)
# ----------------------------------------------------------------------

class InterruptingAsound(FakeAsound):
    """Drains the capture (one short read), then raises KeyboardInterrupt
    on the next read, as ^C on a quiet line after a burst."""
    drained = False

    def snd_pcm_readi(self, pcm, ptr, count):
        if len(self.capture) // self.channels - self.rpos <= 0:
            if self.drained:
                raise KeyboardInterrupt
            self.drained = True
            return 0
        return super().snd_pcm_readi(pcm, ptr, count)


class EndingPulse(FakePulse):
    """A pulse capture that ends: a blocking pa_simple_read fills every
    read, so the stream ends on the read error after the capture."""

    def pa_simple_read(self, s, ptr, nbytes, errp):
        if self.rpos >= len(self.capture):
            self.read_errors = 1
        return super().pa_simple_read(s, ptr, nbytes, errp)


def _bell_capture(payload=b"live alsa rx", gap=30000):
    m = FskModem("1200")
    return np.concatenate([m.modulate(payload), np.zeros(gap, np.float32),
                           m.modulate(payload[::-1])])


def _autodetect_capture():
    w = FskModem("300", sample_rate=24000).modulate(b"LIVE AUTODETECT")
    return np.concatenate([np.zeros(30000, np.float32), w])


_LIVE_RX = {
    # name: (argv, libs factory, expected stdout or None, exit code)
    "attached_alsa": (["--rx", "-Aplughw:1,0", "1200"],
                      lambda: {"alsa": FakeAsound(capture=_bell_capture())},
                      b"live alsa rx" + b"live alsa rx"[::-1], 0),
    "clustered_alsa": (["-qAplughw:0,3", "1200"],
                       lambda: {"alsa": FakeAsound(
                           capture=_bell_capture(b"cluster"))},
                       b"cluster" + b"retsulc", 0),
    "sigint": (["--rx", "-A", "1200"],
               lambda: {"alsa": InterruptingAsound(
                   capture=_bell_capture(b"interrupted session"))},
               b"interrupted session" + b"noisses detpurretni", 0),
    "autodetect": (["--rx", "-a", "-A", "-R", "24000", "300"],
                   lambda: {"alsa": FakeAsound(capture=_autodetect_capture())},
                   b"LIVE AUTODETECT", 0),
    "pulse_sysdefault": (["--rx", "1200"],
                         lambda: {"pulse": EndingPulse(capture=_bell_capture(
                             b"pulse rx", 9000)),
                             "alsa": FakeAsound()},
                         None, 0),
    "sndio_rx": (["--rx", "-sdev0", "1200"],
                 lambda: {"sndio": FakeSndio(capture=_bell_capture())},
                 b"", 1),
    "alsa_missing": (["--rx", "-Aplughw:1,0", "1200"], lambda: {}, b"", 1),
    "no_system_audio": (["--rx", "1200"], lambda: {}, b"", 1),
}


@pytest.mark.parametrize("name", list(_LIVE_RX))
def test_live_rx_cli_matches_jax(monkeypatch, name):
    """Live RX (streaming decode at 2^16-sample segments, -a, SIGINT with
    the final stats) and its error paths: the same exit code, stdout and
    stderr as minimodem-tpu on the same capture, and the same device
    opened."""
    argv, libs, text, code = _LIVE_RX[name]
    (ref, jlibs), (got, tlibs) = _both(monkeypatch, argv, libs)
    assert got == ref
    assert got[0] == code, got[2]
    if text is not None:
        assert got[1] == text
    for k, fake in tlibs.items():
        assert getattr(fake, "device", None) == getattr(jlibs[k], "device",
                                                        None)
    if name == "attached_alsa":
        assert tlibs["alsa"].device == b"plughw:1,0" and tlibs["alsa"].closed
        assert got[2].count("### NOCARRIER") == 2
    elif name == "sigint":
        assert "### NOCARRIER" in got[2]
    elif name == "clustered_alsa":
        assert "NOCARRIER" not in got[2]
    elif name == "pulse_sysdefault":
        assert got[1] == b"pulse rx" + b"xr eslup" and tlibs["pulse"].freed
        assert "pa_simple_read: mock pulse error" in got[2]
    elif name == "alsa_missing":
        assert "alsa client library is not available" in got[2]
    elif name == "no_system_audio":
        assert got[2].startswith("E: no system audio available")


def test_live_rx_on_cuda_without_a_card_exits_1(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    fake = FakeAsound(capture=_bell_capture())
    _install(monkeypatch, torch_sigio, {"alsa": fake})
    code, out, err = _run(torch_cli, ["--rx", "-A", "1200",
                                      "--device", "cuda"])
    assert code == 1 and out == b""
    assert err.startswith("E: ") and err.count("\n") == 1
    assert not hasattr(fake, "device")           # no stream was opened


@pytest.mark.parametrize("flags,lib", [
    (["-sdev0"], "sndio"),
    (["-sdev0", "--synth-backend", "jax"], "sndio"),
    (["-A", "--float-samples"], "alsa"),
    (["--synth-backend", "jax", "--float-samples"], "pulse"),
])
def test_interactive_tx_matches_jax(monkeypatch, flags, lib):
    """--tx without --file: the interactive transmitter (trailer with the
    0.5 s flush) plays into the live stream the samples minimodem-tpu
    plays, with the NumPy and the device synthesis (--device cpu); the
    played audio decodes back to stdin."""
    payload = b"interactive tx"
    fakes = {"sndio": FakeSndio, "alsa": FakeAsound, "pulse": FakePulse}
    (ref, jlibs), (got, tlibs) = _both(
        monkeypatch, ["--tx", *flags, "1200"], lambda: {lib: fakes[lib]()},
        stdin=payload)
    assert got == ref == (0, b"", "")
    played = np.concatenate(tlibs[lib].written)
    np.testing.assert_array_equal(played, np.concatenate(jlibs[lib].written))
    if played.dtype == np.int16:
        played = played.astype(np.float32) / np.float32(32768.0)
    assert (played[-24000:] == 0).all()           # the interactive flush
    assert _port_modem().demodulate(played) == payload
    if lib == "sndio":
        assert tlibs[lib].device == b"dev0"
        assert tlibs[lib].stopped and tlibs[lib].closed


# ----------------------------------------------------------------------
# the Transmitter's stdin loop (tests/test_tx_interactive.py)
# ----------------------------------------------------------------------

class CaptureStream:
    def __init__(self):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.float32))

    def samples(self):
        return (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, np.float32))


def _transmitter(**opts):
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import TxOptions
    from minimodem_tpu_torch.ops.tx import Transmitter

    return Transmitter(_port_modem().cfg, TxOptions(**opts),
                       get_codec("ascii8"), SampleFormat.FLOAT)


def _tx_pipe(interactive, tx_carrier, writes, gap_sec):
    """transmit_stdin over a real pipe whose writer pauses gap_sec
    between writes."""
    txer = _transmitter(interactive=interactive, tx_carrier=tx_carrier)
    r, w = os.pipe()

    def writer():
        for i, chunk in enumerate(writes):
            if i:
                time.sleep(gap_sec)
            os.write(w, chunk)
        os.close(w)

    th = threading.Thread(target=writer)
    th.start()
    stream = CaptureStream()
    with os.fdopen(r, "rb", buffering=0) as stdin:
        txer.transmit_stdin(stdin, stream, interactive, tx_carrier)
    th.join()
    return stream.samples()


def _baseline_len(payload: bytes) -> int:
    stream = CaptureStream()
    _transmitter().transmit_bytes(payload, stream)
    return len(stream.samples())


def test_idle_carrier_between_writes():
    """File mode: a stalled pipe gets idle carrier between the bursts
    (reference: src/minimodem.c:230-237); the bytes are unchanged."""
    samples = _tx_pipe(False, False, [b"AB", b"CD"], gap_sec=0.3)
    idle_unit = 48000 // 25
    assert len(samples) >= _baseline_len(b"ABCD") + 2 * idle_unit
    assert _port_modem().demodulate(samples) == b"ABCD"


def test_txcarrier_idle_before_data():
    """--tx-carrier, interactive: carrier while stdin has no data yet
    (reference: src/minimodem.c:156, 230-237)."""
    samples = _tx_pipe(True, True, [b"", b"XY"], gap_sec=0.1)
    assert len(samples) > _baseline_len(b"XY")
    assert _port_modem().demodulate(samples) == b"XY"


def test_interactive_sigalrm_trailer():
    """Interactive without --tx-carrier: a stdin gap fires the SIGALRM
    trailer and the 0.5 s flush (reference: src/minimodem.c:59-74,
    139-158); the next byte restarts with a fresh leader."""
    samples = _tx_pipe(True, False, [b"AB", b"CD"], gap_sec=0.3)
    flush = 48000 // 2
    assert len(samples) >= _baseline_len(b"ABCD") + flush
    z = (samples == 0.0).astype(np.int8)
    edges = np.diff(np.concatenate([[0], z, [0]]))
    runs = np.where(edges == -1)[0] - np.where(edges == 1)[0]
    assert runs.max(initial=0) >= flush
    assert _port_modem().demodulate(samples) == b"ABCD"


def test_bulk_fallback_matches_transmit_bytes():
    """A stdin without a descriptor takes the bulk path: the samples of
    transmit_bytes, and of the JAX package's Transmitter."""
    from minimodem_tpu.codecs import get_codec as jax_codec
    from minimodem_tpu.config import TxOptions as JaxTxOptions
    from minimodem_tpu.ops.tx import Transmitter as JaxTransmitter

    s1, s2, s3 = CaptureStream(), CaptureStream(), CaptureStream()
    _transmitter().transmit_stdin(io.BytesIO(b"hello"), s1, False, False)
    _transmitter().transmit_bytes(b"hello", s2)
    JaxTransmitter(FskModem("1200").cfg, JaxTxOptions(), jax_codec("ascii8"),
                   SampleFormat.FLOAT).transmit_bytes(b"hello", s3)
    np.testing.assert_array_equal(s1.samples(), s2.samples())
    np.testing.assert_array_equal(s1.samples(), s3.samples())


# ----------------------------------------------------------------------
# live -a (tests/test_autodetect_device.py:108-177)
# ----------------------------------------------------------------------

def _burst(mark, space, text, rate=24000, baud=300):
    from minimodem_tpu.models.presets import bell_like
    from minimodem_tpu.utils.cfloat import f32

    m = FskModem(str(baud), sample_rate=rate)
    m.preset = bell_like(baud, rate, mark_f=f32(mark), space_f=f32(space))
    m.cfg = m.preset.cfg
    return m.modulate(text)


def _chunks(stream, sizes):
    i = k = 0
    while i < len(stream):
        n = sizes[k % len(sizes)]
        yield stream[i:i + n]
        i += n
        k += 1


def _receiver(pkg, rx_one, rate=24000, baud=300):
    if pkg == "jax":
        from minimodem_tpu.codecs import get_codec
        from minimodem_tpu.config import RxOptions
        from minimodem_tpu.models.presets import bell_like
        from minimodem_tpu.rx.engine import Receiver
        kw = {}
    else:
        from minimodem_tpu_torch.codecs import get_codec
        from minimodem_tpu_torch.config import RxOptions
        from minimodem_tpu_torch.models.presets import bell_like
        from minimodem_tpu_torch.rx.engine import Receiver
        kw = {"device": "cpu"}
    out, err = io.BytesIO(), io.StringIO()
    opts = RxOptions(carrier_autodetect_threshold=0.001, rx_one=rx_one)
    rx = Receiver(bell_like(baud, rate).cfg, opts, get_codec("ascii8"),
                  out.write, err.write, **kw)
    return rx, lambda: (out.getvalue(), err.getvalue())


def _live(pkg, stream, sizes, rx_one=False):
    rx, result = _receiver(pkg, rx_one)
    rx.run_live_autodetect(_chunks(stream, sizes))
    return result()


def _file(stream, rx_one=False):
    rx, result = _receiver("torch", rx_one)
    rx.run(stream.copy(), engine="device")
    return result()


@pytest.mark.parametrize("case,sizes", [
    ("two_bursts", [12000]), ("two_bursts", [7777, 1234, 50000]),
    ("retune", [9000]), ("rx_one", [8000])])
def test_live_autodetect_matches_jax_and_file(case, sizes):
    """run_live_autodetect: the JAX package's live -a output on the same
    chunks byte for byte, and the port's file-mode device -a output on
    the whole stream (test_live_matches_file, test_live_retune,
    test_live_rx_one)."""
    gap = np.zeros(26000, np.float32)
    rx_one = case == "rx_one"
    if case == "two_bursts":
        stream = np.concatenate([_burst(1200, 2400, b"LIVE ONE "), gap,
                                 _burst(1200, 2400, b"LIVE TWO")])
        text, carriers = b"LIVE ONE LIVE TWO", 2
    elif case == "retune":
        stream = np.concatenate([_burst(1200, 2400, b"L1200"), gap,
                                 _burst(1800, 3000, b"L1800")])
        text, carriers = b"L1200L1800", 2
    else:
        stream = np.concatenate([_burst(1200, 2400, b"ONLY"), gap,
                                 _burst(1200, 2400, b"NOT THIS")])
        text, carriers = b"ONLY", 1
    got = _live("torch", stream, sizes, rx_one)
    assert got == _live("jax", stream, sizes, rx_one)
    assert got[0] == text and got[1].count("### CARRIER") == carriers
    assert got[0] == _file(stream, rx_one)[0]
    if case == "two_bursts":
        assert got[1] == _file(stream)[1]
        assert got[1].count("NOCARRIER") == 2
    if case == "retune":
        assert "@ 1200.0 Hz" in got[1] and "@ 1800.0 Hz" in got[1]


def test_cli_live_alsa_autodetect(monkeypatch):
    """`--rx -a -A` on a 48 kHz capture: minimodem-tpu's output."""
    w = np.asarray(_burst(1200, 2400, b"LIVE ALSA AUTODETECT", rate=48000),
                   np.float32)
    (ref, _), (got, _) = _both(
        monkeypatch, ["--rx", "-a", "-A", "--samplerate", "48000", "300",
                      "-M", "1200", "-S", "2400"],
        lambda: {"alsa": FakeAsound(capture=w)})
    assert got == ref
    assert got[0] == 0 and got[1] == b"LIVE ALSA AUTODETECT"
    assert "### CARRIER" in got[2]


def test_live_autodetect_device_defaults_to_the_card():
    """run_live_autodetect on the default device raises at first use
    without a card, naming device="cpu"."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.presets import bell_like
    from minimodem_tpu_torch.rx.engine import Receiver

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rx = Receiver(bell_like(300, 24000).cfg,
                  RxOptions(carrier_autodetect_threshold=0.001),
                  get_codec("ascii8"), lambda b: None, lambda s: None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rx.run_live_autodetect(iter([np.zeros(100, np.float32)]))


# ----------------------------------------------------------------------
# the backends: round trips and error paths (tests/test_alsa.py,
# test_pulse.py, test_sndio.py) on the port's copies
# ----------------------------------------------------------------------

def _stream_cls(name):
    from minimodem_tpu_torch.sigio.alsa import AlsaStream
    from minimodem_tpu_torch.sigio.pulse import PulseStream
    from minimodem_tpu_torch.sigio.sndio import SndioStream

    return {"alsa": (AlsaStream, FakeAsound), "pulse": (PulseStream,
                                                        FakePulse),
            "sndio": (SndioStream, FakeSndio)}[name]


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_modem_loopback(name):
    """The port's Transmitter into the stand-in device, then its receiver
    on what was played (sndio plays S16, the others FLOAT)."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import TxOptions
    from minimodem_tpu_torch.ops.tx import Transmitter

    cls, fake_cls = _stream_cls(name)
    fmt = SampleFormat.S16 if name == "sndio" else SampleFormat.FLOAT
    fake = fake_cls()
    st = cls(None, Direction.PLAYBACK, fmt, 48000, 1, lib=fake)
    m = _port_modem()
    Transmitter(m.cfg, TxOptions(), get_codec("ascii8"), fmt).transmit_bytes(
        name.encode() + b" loopback", st)
    st.close()
    assert m.demodulate(np.concatenate(fake.written)) == (
        name.encode() + b" loopback")


@pytest.mark.parametrize("name,backend", [
    ("alsa", "alsa"), ("pulse", "pulseaudio"), ("sndio", "sndio")])
def test_open_stream_errors_without_the_library(monkeypatch, name, backend):
    import importlib

    mod = importlib.import_module(f"minimodem_tpu_torch.sigio.{name}")
    loader = {"alsa": "load_libasound", "pulse": "load_libpulse",
              "sndio": "load_libsndio"}[name]
    monkeypatch.setattr(mod, loader, lambda: None)
    with pytest.raises(RuntimeError, match="no system audio"):
        open_stream(backend, None, Direction.RECORD, SampleFormat.S16, 48000,
                    1)


def test_sysdefault_priority(monkeypatch):
    """sysdefault resolves pulse > alsa > sndio (src/simpleaudio.c:83-93)."""
    from minimodem_tpu_torch.sigio import alsa, pulse, sndio, system_backend

    monkeypatch.setattr(pulse, "load_libpulse", lambda: object())
    monkeypatch.setattr(alsa, "load_libasound", lambda: object())
    monkeypatch.setattr(sndio, "load_libsndio", lambda: object())
    assert system_backend() == "pulseaudio"
    monkeypatch.setattr(pulse, "load_libpulse", lambda: None)
    assert system_backend() == "alsa"
    monkeypatch.setattr(alsa, "load_libasound", lambda: None)
    assert system_backend() == "sndio"
    monkeypatch.setattr(sndio, "load_libsndio", lambda: None)
    assert system_backend() is None


def test_alsa_devices_params_and_recovery():
    """Device aliasing (src/simpleaudio-alsa.c:116-127), the S16/FLOAT
    params, drain on close, the write underrun recover-and-retry and the
    read overrun prepare (:55-58, :76-86)."""
    from minimodem_tpu_torch.sigio.alsa import (
        EPIPE,
        SND_PCM_FORMAT_FLOAT_LE,
        SND_PCM_FORMAT_S16_LE,
        AlsaStream,
        resolve_device,
    )

    assert [resolve_device(d) for d in (None, "plughw:1,0", "1,2", "2")] == [
        b"default", b"plughw:1,0", b"plughw:1,2", b"plughw:2,0"]
    for fmt, pcm in ((SampleFormat.S16, SND_PCM_FORMAT_S16_LE),
                     (SampleFormat.FLOAT, SND_PCM_FORMAT_FLOAT_LE)):
        fake = FakeAsound()
        AlsaStream(None, Direction.PLAYBACK, fmt, 48000, 1, lib=fake).close()
        assert (fake.fmt, fake.rate) == (pcm, 48000)
        assert fake.drained and fake.closed
    fake = FakeAsound(write_plan=[-EPIPE])
    st = AlsaStream(None, Direction.PLAYBACK, SampleFormat.FLOAT, 48000, 1,
                    lib=fake)
    data = np.linspace(-1, 1, 1000).astype(np.float32)
    assert st.write(data) == 1000 and fake.recovered == 1
    np.testing.assert_array_equal(np.concatenate(fake.written), data)
    cap = np.arange(4000, dtype=np.float32) / 4000.0
    fake = FakeAsound(capture=cap, read_plan=[1500, -EPIPE, 1500])
    st = AlsaStream(None, Direction.RECORD, SampleFormat.FLOAT, 48000, 1,
                    lib=fake)
    np.testing.assert_array_equal(st.read(4000), cap)
    assert fake.prepared == 1


def test_pulse_spec_attrs_and_errors(capsys):
    """The sample spec, the lowest-latency buffer attributes
    (src/simpleaudio-pulse.c:116-127), reads, and the open / read / write
    error paths."""
    from minimodem_tpu_torch.sigio.pulse import (
        PA_SAMPLE_FLOAT32LE,
        PA_SAMPLE_S16LE,
        PA_STREAM_PLAYBACK,
        PA_STREAM_RECORD,
        PulseStream,
    )

    for fmt, pafmt in ((SampleFormat.S16, PA_SAMPLE_S16LE),
                       (SampleFormat.FLOAT, PA_SAMPLE_FLOAT32LE)):
        fake = FakePulse()
        PulseStream(None, Direction.PLAYBACK, fmt, 48000, 1, lib=fake).close()
        assert (fake.ss.format, fake.ss.rate, fake.ss.channels) == (
            pafmt, 48000, 1)
        assert fake.direction == PA_STREAM_PLAYBACK
        assert fake.drained and fake.freed
    cap = np.arange(4000, dtype=np.float32) / 4000.0
    fake = FakePulse(capture=cap)
    st = PulseStream(None, Direction.RECORD, SampleFormat.FLOAT, 48000, 1,
                     lib=fake)
    assert fake.direction == PA_STREAM_RECORD
    a = fake.attr
    assert (a.fragsize, a.tlength) == (0, 0)
    assert a.prebuf == a.maxlength == a.minreq == 0xFFFFFFFF
    np.testing.assert_array_equal(st.read(4000), cap)
    with pytest.raises(RuntimeError, match="Cannot create PulseAudio"):
        PulseStream(None, Direction.PLAYBACK, SampleFormat.S16, 48000, 1,
                    lib=FakePulse(fail_new=True))
    st = PulseStream(None, Direction.RECORD, SampleFormat.FLOAT, 48000, 1,
                     lib=FakePulse(read_errors=1))
    assert st.read(100).size == 0
    st = PulseStream(None, Direction.PLAYBACK, SampleFormat.FLOAT, 48000, 1,
                     lib=FakePulse(write_errors=1))
    assert st.write(np.zeros(10, np.float32)) == -1
    err = capsys.readouterr().err
    assert "pa_simple_read" in err and "pa_simple_write" in err


def test_sndio_par_reads_and_errors():
    """The par (S16 native-endian, xrun=SIO_IGNORE,
    src/simpleaudio-sndio.c:84-111), the device passthrough, S16 reads to
    the end, FLOAT refused (:96-98) and the open / setpar / start
    failures."""
    from minimodem_tpu_torch.sigio.sndio import (
        SIO_DEVANY,
        SIO_IGNORE,
        SIO_LE_NATIVE,
        SIO_PLAY,
        SIO_REC,
        SndioStream,
        sio_bps,
    )

    fake = FakeSndio()
    st = SndioStream(None, Direction.PLAYBACK, SampleFormat.S16, 48000, 1,
                     lib=fake)
    assert (fake.device, fake.mode, fake.nbio) == (SIO_DEVANY, SIO_PLAY, 0)
    p = fake.par
    assert (p["bits"], p["bps"], p["sig"], p["le"]) == (16, sio_bps(16), 1,
                                                        SIO_LE_NATIVE)
    assert (p["rate"], p["xrun"], p["rchan"], p["pchan"]) == (
        48000, SIO_IGNORE, 1, 1)
    assert fake.started
    st.close()
    assert fake.stopped and fake.closed
    cap = (np.arange(4000) - 2000).astype(np.int16)
    fake = FakeSndio(capture=cap)
    st = SndioStream("rsnd/0", Direction.RECORD, SampleFormat.S16, 44100, 1,
                     lib=fake)
    assert (fake.device, fake.mode) == (b"rsnd/0", SIO_REC)
    out = st.read(4000)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, cap)
    assert st.read(100).size == 0
    with pytest.raises(RuntimeError, match="S16"):
        SndioStream(None, Direction.PLAYBACK, SampleFormat.FLOAT, 48000, 1,
                    lib=FakeSndio())
    for kw, msg in (("fail_open", "Cannot open"), ("fail_setpar",
                                                   "sio_setpar"),
                    ("fail_start", "sio_start")):
        with pytest.raises(RuntimeError, match=msg):
            SndioStream(None, Direction.PLAYBACK, SampleFormat.S16, 48000, 1,
                        lib=FakeSndio(**{kw: True}))


def test_alsa_reads_of_any_size():
    """A FLOAT capture read through the port's AlsaStream in reads of
    several sizes comes back as the samples."""
    from minimodem_tpu_torch.sigio.alsa import AlsaStream

    cap = np.random.default_rng(3).random(10007, dtype=np.float32)
    st = AlsaStream(None, Direction.RECORD, SampleFormat.FLOAT, 48000, 1,
                    lib=FakeAsound(capture=cap))
    parts = [st.read(n) for n in (1, 4096, 5000, 4096)]
    np.testing.assert_array_equal(np.concatenate(parts), cap)
