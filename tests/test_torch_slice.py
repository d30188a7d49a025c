"""The port's main path end to end: `minimodem-tpu-torch --rx --file f.wav`
against `minimodem-tpu` on the same WAV, on the CPU (--device cpu runs
the kernels' plain versions).  stdout and stderr must be byte-identical.
Also: a multi-segment decode through both packages' PipelinedReceiver,
the port importing with jax blocked, and the error paths.
"""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from .helpers import _redirect
from minimodem_tpu import cli as jax_cli
from minimodem_tpu.models.modem import FskModem
from minimodem_tpu_torch import cli as torch_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, argv):
    with _redirect(b"") as (out, err):
        try:
            code = mod.main(list(argv))
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        return code, out.buffer.getvalue(), err.getvalue()


def _write_wav(path, samples, fmt, rate=48000):
    """Mono WAV of float samples as PCM16, float32 or G.711 u-law."""
    if fmt == "float":
        data = np.asarray(samples, "<f4").tobytes()
        tag, bits, extra = 3, 32, b""
    else:
        s16 = np.clip(np.rint(samples * 32768.0), -32768, 32767).astype(
            np.int16)
        if fmt == "pcm16":
            data = s16.astype("<i2").tobytes()
            tag, bits, extra = 1, 16, b""
        else:
            from minimodem_tpu.sigio.containers import _ulaw_encode

            data = _ulaw_encode(s16).tobytes()
            tag, bits = 7, 8
            extra = struct.pack("<4sII", b"fact", 4, len(data))
    nbytes = bits // 8
    fmt_chunk = struct.pack("<4sIHHIIHHH", b"fmt ", 18, tag, 1, rate,
                            rate * nbytes, nbytes, bits, 0)
    body = fmt_chunk + extra + struct.pack("<4sI", b"data", len(data)) + data
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE") + body)


def _signal(mode, seed):
    rng = np.random.default_rng(seed)
    if mode == "noise":                      # no carrier at all
        wav = rng.random(96000, dtype=np.float32) - np.float32(0.5)
        return "1200", b"", wav
    noisy = mode.startswith("noisy")
    mode = mode.removeprefix("noisy")
    text = rng.integers(32, 127, size=60, dtype=np.uint8).tobytes() + b"\n"
    if mode == "rtty":
        text = b"RYRY CQ 73\n"
    wav = FskModem(mode).modulate(text)
    if noisy:
        wav = wav * np.float32(0.6) + (rng.random(wav.size, dtype=np.float32)
                                       - np.float32(0.5)) * np.float32(0.6)
    return mode, text, wav.astype(np.float32)


@pytest.mark.parametrize("mode,fmt,seed,flags", [
    ("1200", "pcm16", 1, []), ("1200", "float", 2, []),
    ("1200", "ulaw", 3, []), ("300", "float", 4, []),
    ("rtty", "pcm16", 5, []), ("same", "ulaw", 6, []),
    ("noisy1200", "pcm16", 7, []), ("noisy1200", "float", 8, []),
    ("noise", "pcm16", 9, ["--rx-one"]),
    ("1200", "pcm16", 10, ["-7", "--msb-first", "--binary-output"]),
])
def test_cli_matches_jax_cli(tmp_path, mode, fmt, seed, flags):
    tag = mode
    mode, text, wav = _signal(mode, seed)
    path = str(tmp_path / f"in_{fmt}.wav")
    _write_wav(path, wav, fmt)
    ref = _run(jax_cli, ["--rx", "--file", path, mode, *flags])
    got = _run(torch_cli, ["--rx", "--file", path, mode, "--device", "cpu",
                           *flags])
    assert ref[0] == 0, ref[2]
    assert got == ref
    assert "NOCARRIER" in got[2]
    if tag in ("1200", "300", "rtty", "same") and fmt != "ulaw" and not flags:
        assert got[1] == text


def test_multi_segment_matches_jax_pipelined_receiver():
    """Both packages' PipelinedReceiver at segment_len 1 << 16 (a carried
    state across segments), rendered through each package's Receiver."""
    from minimodem_tpu.codecs import get_codec as jax_codec
    from minimodem_tpu.config import RxOptions as JaxRxOptions
    from minimodem_tpu.ops.device_rx import PipelinedReceiver as JaxPR
    from minimodem_tpu.rx.engine import Receiver as JaxReceiver
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.ops.device_rx import PipelinedReceiver
    from minimodem_tpu_torch.rx.engine import Receiver

    m = FskModem("1200")
    p1 = bytes(33 + (i % 94) for i in range(300))
    p2 = b"tail burst"
    samples = np.concatenate([m.modulate(p1), np.zeros(48000, np.float32),
                              m.modulate(p2)]).astype(np.float32)

    def render(rx, run):
        for seg in run:
            rx.render_events(*seg)

    sink_j, errs_j = io.BytesIO(), []
    jpr = JaxPR(m.cfg, segment_len=1 << 16)
    assert len(samples) > jpr.segment_len
    render(JaxReceiver(m.cfg, JaxRxOptions(), jax_codec("ascii8"),
                       sink_j.write, errs_j.append),
           jpr.run(samples, 1.5, 2.3))
    sink_t, errs_t = io.BytesIO(), []
    tpr = PipelinedReceiver(m.cfg, segment_len=1 << 16, device="cpu")
    segs = list(tpr.run(samples, 1.5, 2.3))
    assert len(segs) >= 3
    rx = Receiver(m.cfg, RxOptions(), get_codec("ascii8"), sink_t.write,
                  errs_t.append, device="cpu")
    for seg in segs:
        rx.render_events(*seg)
    assert sink_t.getvalue() == sink_j.getvalue() == p1 + p2
    assert "".join(errs_t) == "".join(errs_j)


def test_modem_api_matches_jax(tmp_path):
    """FskModem: the host TX is the same code (identical samples) and the
    port's demodulate returns the payload."""
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem

    payload = b"library api round trip"
    jw = FskModem("300").modulate(payload)
    tm = TorchModem("300", device="cpu")
    tw = tm.modulate(payload)
    np.testing.assert_array_equal(tw, jw)
    assert tm.demodulate(tw) == payload
    s16 = np.clip(np.rint(tw * 32767.0), -32768, 32767).astype(np.int16)
    out, events = tm.demodulate(s16, return_events=True)
    assert out == payload and "NOCARRIER" in events[-1]


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax nor minimodem_tpu: with jax blocked in
    sys.modules it still decodes a WAV, decodes on the delta-bitpack wire
    (wire_pack=True), runs the on-device loopback and the fleet service
    (a world of one) on the CPU."""
    path = str(tmp_path / "blocked.wav")
    text = b"no jax here\n"
    _write_wav(path, FskModem("1200").modulate(text), "pcm16")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import minimodem_tpu_torch.cli as c\n"
        "from minimodem_tpu_torch.codecs import Ascii8Codec\n"
        "from minimodem_tpu_torch.models.modem import FskModem\n"
        "from minimodem_tpu_torch.ops.device_rx import DeviceLoopback\n"
        "from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule\n"
        "cfg = FskModem('1200', device='cpu').cfg\n"
        "s = tx_bit_schedule(b'loopback', cfg, Ascii8Codec())\n"
        "ev = DeviceLoopback(cfg, device='cpu').run_events_batch([s, s])\n"
        "assert [e[2].tobytes() for e in ev] == [b'loopback'] * 2, ev\n"
        "import minimodem_tpu_torch.parallel.dryrun\n"
        "from minimodem_tpu_torch.parallel.service import ShardedReceiver\n"
        "w = FskModem('1200', device='cpu').modulate(b'fleet')\n"
        "outs, st = ShardedReceiver(cfg, device='cpu').decode_batch([w])\n"
        "assert outs == [b'fleet'] and st['devices'] == 1, (outs, st)\n"
        "import numpy as np\n"
        "w16 = (w * 32767).astype(np.int16)\n"
        "from minimodem_tpu_torch.ops.wirepack import choose_params\n"
        "assert choose_params(w16) is not None\n"
        "m = FskModem('1200', device='cpu')\n"
        "assert m.demodulate(w16, wire_pack=True) == b'fleet'\n"
        "rc = c.main(['--rx', '--file', sys.argv[1], '1200', "
        "'--device', 'cpu'])\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m == 'minimodem_tpu' or m.startswith(('minimodem_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == text
    assert b"### NOCARRIER ndata=12" in r.stderr


def test_device_cuda_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    code, out, err = _run(torch_cli, ["--rx", "--file", "x.wav", "1200",
                                      "--device", "cuda"])
    assert code == 1 and out == b""
    assert err.startswith("E: ") and err.count("\n") == 1


def _first_use(entry):
    """Build the port's entry point with its default device (no card is
    touched) -> a call that uses it."""
    from minimodem_tpu_torch.codecs import get_codec
    from minimodem_tpu_torch.config import RxOptions
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem
    from minimodem_tpu_torch.ops.demod import DemodScorer
    from minimodem_tpu_torch.ops.device_rx import (DeviceReceiver,
                                                   PipelinedReceiver)
    from minimodem_tpu_torch.ops.mega_rx import MegaReceiver
    from minimodem_tpu_torch.rx.engine import Receiver, ScoreProvider

    m = TorchModem("1200")
    wav = m.modulate(b"x")
    if entry == "FskModem":
        return m, lambda: m.demodulate(wav)
    if entry == "Receiver":
        rx = Receiver(m.cfg, RxOptions(), get_codec("ascii8"), lambda b: None,
                      lambda s: None)
        return rx, lambda: rx.run(wav, engine="host")
    if entry == "ScoreProvider":
        sp = ScoreProvider(wav, m.cfg)
        return sp, lambda: sp.query(0, False)
    if entry == "DemodScorer":
        sc = DemodScorer(m.cfg)
        return sc, lambda: sc.score(wav)
    if entry in ("DeviceReceiver", "MegaReceiver"):
        cls = DeviceReceiver if entry == "DeviceReceiver" else MegaReceiver
        r = cls(m.cfg)
        return r, lambda: r.run_events_batch(wav[None], [len(wav)], 1.5, 2.3)
    if entry == "DeviceStreamReceiver":
        from minimodem_tpu_torch.ops.device_rx import DeviceStreamReceiver

        sr = DeviceStreamReceiver(m.cfg)
        return sr, lambda: sr.finish()
    if entry == "DeviceLoopback":
        from minimodem_tpu_torch.ops.device_rx import DeviceLoopback
        from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule

        lb = DeviceLoopback(m.cfg)
        sched = tx_bit_schedule(b"x", m.cfg, get_codec("ascii8"))
        return lb, lambda: lb.run_events_batch([sched])
    if entry in ("ShardedReceiver", "ShardedLoopback"):
        from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule
        from minimodem_tpu_torch.parallel import service

        if entry == "ShardedReceiver":
            svc = service.ShardedReceiver(m.cfg)
            return svc, lambda: svc.decode_batch([wav])
        flb = service.ShardedLoopback(m.cfg)
        sched = tx_bit_schedule(b"x", m.cfg, get_codec("ascii8"))
        return flb, lambda: flb.run_events_batch([sched])
    if entry == "Transmitter":
        from minimodem_tpu_torch.config import TxOptions
        from minimodem_tpu_torch.ops.tx import Transmitter
        from minimodem_tpu_torch.sigio import SampleFormat

        tx = Transmitter(m.cfg, TxOptions(), get_codec("ascii8"),
                         SampleFormat.FLOAT, "jax")
        tx.send(ord("x"))
        return tx, lambda: tx.drain(None)
    pr = PipelinedReceiver(m.cfg)
    return pr, lambda: next(pr.run(wav, 1.5, 2.3))


@pytest.mark.parametrize("entry", [
    "FskModem", "Receiver", "ScoreProvider", "DemodScorer", "DeviceReceiver",
    "PipelinedReceiver", "DeviceStreamReceiver", "MegaReceiver",
    "DeviceLoopback", "Transmitter", "ShardedReceiver", "ShardedLoopback"])
def test_entry_points_default_to_the_card(entry):
    """Every public entry point defaults to device="cuda", as the JAX
    package runs on its default accelerator; without a card the first use
    raises naming device="cpu", and nothing falls back to the CPU."""
    import inspect

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    obj, use = _first_use(entry)
    assert inspect.signature(type(obj)).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        use()


def test_dryrun_defaults_to_the_card():
    """The dry run's entry point defaults to device="cuda" too: without
    a card it raises naming device="cpu" before it starts a world, and
    never takes gloo ranks on the CPU unasked."""
    import inspect

    from minimodem_tpu_torch.parallel.dryrun import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert inspect.signature(dryrun_multichip).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dryrun_multichip(2)


def test_unported_features_name_their_roadmap_item(monkeypatch):
    """Live audio is ported (tests/test_torch_live.py): --rx without
    --file on a host with no audio client library exits 1 with
    minimodem-tpu's E: lines, which name --file."""
    import importlib

    for pkg in ("minimodem_tpu", "minimodem_tpu_torch"):
        for name in ("alsa", "pulse", "sndio"):
            mod = importlib.import_module(f"{pkg}.sigio.{name}")
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    code, out, err = _run(torch_cli, ["--rx", "1200", "--device", "cpu"])
    assert (code, out, err) == _run(jax_cli, ["--rx", "1200"])
    assert code == 1 and out == b""
    assert err.startswith("E: no system audio") and "--file" in err


@pytest.mark.parametrize("flags", [["-a"], ["-a", "--engine", "device"]])
def test_autodetect_device_engine_matches_jax_cli(tmp_path, flags):
    """-a on the device engine (the default, and named): the JAX CLI's
    stdout and stderr, byte for byte."""
    path = str(tmp_path / "f.wav")
    wav = np.concatenate([np.zeros(9000, np.float32),
                          FskModem("1200").modulate(b"autodetect")])
    _write_wav(path, wav, "pcm16")
    argv = ["--rx", "--file", path, "1200", *flags]
    code, out, err = _run(torch_cli, argv + ["--device", "cpu"])
    assert (code, out, err) == _run(jax_cli, argv)
    assert code == 0 and out == b"autodetect"
    assert err.count("### CARRIER") == 1


def test_tx_matches_jax_cli(tmp_path):
    """--tx writes the same WAV bytes (the host synthesizer is a copy)."""
    text = b"tx parity\n"
    a, b = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    with _redirect(text):
        assert jax_cli.main(["--tx", "--file", a, "1200"]) == 0
    with _redirect(text):
        assert torch_cli.main(["--tx", "--file", b, "1200"]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("mode", ["1200", "300", "rtty", "tdd", "same",
                                  "callerid", "uic-train", "v.21"])
def test_geometry_key_and_basis_match_jax(mode):
    """The receiver's parameters carry over: the same geometry key tuple,
    the same correlation basis and the same megakernel route decision for
    every preset."""
    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu.ops.pallas_rx import mega_supported
    from minimodem_tpu_torch.models.modem import FskModem as TorchModem
    from minimodem_tpu_torch.ops import device_rx as TD
    from minimodem_tpu_torch.ops.demod import make_basis
    from minimodem_tpu_torch.ops.mega_rx import megakernel_route

    jkey = D.device_rx_key(FskModem(mode).cfg)
    tkey = TD.device_rx_key(TorchModem(mode).cfg)
    assert tkey == jkey
    assert megakernel_route(tkey) == mega_supported(jkey)
    np.testing.assert_array_equal(
        make_basis(TD.geo_from_key(tkey), np.float32),
        D.make_basis(D.geo_from_key(jkey), np.float32))


@pytest.mark.parametrize("enc", ["int16", "ulaw", "alaw", "pcm8"])
def test_wire_expansion_matches_jax(enc):
    """normalize_input / expand_wire give the JAX package's float32 values
    bit for bit, with the zero mask past total + extra."""
    import jax.numpy as jnp

    from minimodem_tpu.ops import device_rx as D
    from minimodem_tpu_torch.ops import device_rx as TD

    if enc == "int16":
        x = np.arange(-32768, 32768, 97, dtype=np.int16)
    else:
        x = np.tile(np.arange(256, dtype=np.uint8), 3)
    ref = np.asarray(D.normalize_input(jnp.asarray(x), enc))
    got = TD.normalize_input(torch.from_numpy(x), enc).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    if enc == "int16":
        return
    xb = np.stack([x, x[::-1].copy()])
    totals = np.asarray([100, 500], np.int32)
    ref = np.asarray(D.expand_wire(jnp.asarray(xb), jnp.asarray(totals), enc,
                                   7))
    got = TD.expand_wire(torch.from_numpy(xb), torch.from_numpy(totals), enc,
                         7).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
