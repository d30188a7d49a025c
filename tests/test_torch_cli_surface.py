"""The CLI flag surface: `minimodem-tpu-torch` against `minimodem-tpu` on
the argument sets of the JAX package's flag suites (test_features.py,
test_roundtrip.py, test_golden.py, test_edge_cases.py, test_noise.py,
test_amplitude.py, test_rate_slop.py), on the CPU.

For each case the same stdin goes through both CLIs' --tx: the WAV files
must be byte-identical, and so must (exit code, stdout, stderr).  Then
the JAX TX's file goes through both CLIs' --rx, the port's with --device
cpu (the kernels' plain versions): (exit code, stdout, stderr) must be
identical, byte for byte.  The error paths of test_edge_cases.py (a
stereo file, a truncated fmt chunk, garbage after --sync-byte) run the
same way.
"""

import re
import struct

import numpy as np
import pytest
import torch

from minimodem_tpu import cli as jax_cli
from minimodem_tpu_torch import cli as torch_cli

from .helpers import _redirect

TEXT = b"The quick brown fox, 0123456789!\n"
GOLDEN = b"golden determinism pin 0123456789\n"
BAUDOT = b"RYRY CQ 73\n"

# (mode and flags on both sides, TX-only flags, RX-only flags, stdin)
CASES = {
    "1200": (["1200"], [], [], TEXT),
    "300": (["300"], [], [], TEXT),
    "rtty": (["rtty"], [], [], BAUDOT),
    "tdd": (["tdd"], [], [], BAUDOT),
    "same": (["same"], [], [], b"ZCZC-WXR-RWT-020103+0015-\n"),
    "12000": (["12000"], [], [], TEXT),
    "float-samples": (["1200"], ["--float-samples"], [], TEXT),
    "lut=0": (["1200"], ["--lut=0"], [], TEXT),
    "lut=16": (["1200"], ["--lut=16"], [], TEXT),
    "-7": (["-7", "1200"], [], [], TEXT),
    "invert-start-stop": (["--invert-start-stop", "1200"], [], [], TEXT),
    "-i": (["-i", "300"], [], [], TEXT),
    "start/stop bits": (["--startbits", "2", "--stopbits", "1.5", "1200"],
                        [], [], TEXT),
    "mark/space": (["-M", "1300", "-S", "2100", "1200"], [], [], TEXT),
    "print-filter": (["1200"], [], ["--print-filter"],
                     b"ctl \x01\x02\x7f bytes\n"),
    "-c": (["1200"], [], ["-c", "3.5"], TEXT),
    "limit": (["1200"], [], ["--limit", "2.0"], TEXT),
    "-a 1200": (["1200"], [], ["-a"], TEXT),
    "-a 300": (["300"], [], ["-a"], TEXT),
    "volume": (["1200"], ["--volume", "0.25"], [], TEXT),
    "quiet": (["1200"], [], ["--quiet"], TEXT),
    "samplerate 44100": (["-R", "44100", "1200"], [], [], TEXT),
    "samplerate 8000": (["-R", "8000", "300"], [], [], TEXT),
    "tx-carrier": (["1200"], ["--tx-carrier"], [], TEXT),
    "sync-byte": (["--sync-byte", "0x55", "1200"], [], [], TEXT),
    "usos 0": (["--usos", "0", "rtty"], [], [], BAUDOT),
    "binary-raw": (["1200"], [], ["--binary-raw", "8"], b"raw\n"),
    "print-eot": (["1200"], [], ["--print-eot"], TEXT),
    "-8 rx-one": (["1200"], [], ["-8", "--rx-one"], TEXT),
    # tests/test_golden.py's TX argument sets, on its payload
    "golden 1200": (["1200"], [], [], GOLDEN),
    "golden 300": (["300"], [], [], GOLDEN),
    "golden rtty": (["rtty"], [], [], GOLDEN),
    "golden same": (["same"], [], [], GOLDEN),
    "golden float-samples": (["1200"], ["--float-samples"], [], GOLDEN),
    "golden lut=0": (["1200"], ["--lut=0"], [], GOLDEN),
    # tests/test_edge_cases.py
    "empty input": (["1200"], [], [], b""),
    "single char": (["1200"], [], [], b"A"),
    "sync-byte garbage": (["--sync-byte", "zz", "1200"], [], [], b"hi"),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, argv, stdin: bytes = b""):
    """mod.main(argv) in process -> (exit code, stdout bytes, stderr)."""
    with _redirect(stdin) as (out, err):
        try:
            code = mod.main(list(argv))
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        return code, out.buffer.getvalue(), err.getvalue()


def _tx(tmp_path, mod, name, argv, stdin):
    path = str(tmp_path / name)
    got = _run(mod, ["--tx", "--file", path, *argv], stdin)
    with open(path, "rb") as f:
        return got, f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_flags_match_the_jax_cli(tmp_path, case):
    both, tx_only, rx_only, stdin = CASES[case]
    jtx, jwav = _tx(tmp_path, jax_cli, "j.wav", [*tx_only, *both], stdin)
    ptx, pwav = _tx(tmp_path, torch_cli, "p.wav", [*tx_only, *both], stdin)
    assert jtx[0] == 0, jtx[2]
    assert ptx == jtx and pwav == jwav
    path = str(tmp_path / "j.wav")
    ref = _run(jax_cli, ["--rx", "--file", path, *rx_only, *both])
    got = _run(torch_cli, ["--rx", "--file", path, *rx_only, *both,
                           "--device", "cpu"])
    assert ref[0] == 0, ref[2]
    assert got == ref


def _stereo(path):
    data = np.zeros(1000, np.int16)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + data.nbytes,
                            b"WAVE", b"fmt ", 16, 1, 2, 48000, 48000 * 4, 4,
                            16, b"data", data.nbytes) + data.tobytes())


def _truncated_fmt(path):
    body = b"fmt " + struct.pack("<I", 8) + struct.pack("<HHI", 1, 1, 48000)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


@pytest.mark.parametrize("make,msg", [(_stereo, "must be 1-channel"),
                                      (_truncated_fmt, "")])
def test_cli_error_paths_match_the_jax_cli(tmp_path, make, msg):
    path = str(tmp_path / "bad.wav")
    make(path)
    ref = _run(jax_cli, ["--rx", "--file", path, "1200"])
    got = _run(torch_cli, ["--rx", "--file", path, "1200", "--device", "cpu"])
    assert got == ref
    assert got[0] == 1 and got[1] == b"" and msg in got[2]
    assert "Traceback" not in got[2]


def _mask_confidence(err: str) -> str:
    return re.sub(r"(### NOCARRIER .*)confidence=\S+", r"\1confidence=*",
                  err)


@pytest.mark.parametrize("baud,engine", [("0.5", "device"), ("0.5", "host"),
                                         ("0.5", "host-native"),
                                         ("1", "device")])
def test_fft_route_bauds_match_but_for_confidence(tmp_path, baud, engine):
    """0.5 and 1 baud (a bit of 96000 and 48000 samples: stage 1 takes the
    FFT route, nb > 4096) on a noise-free file: the same stdout, exit
    code and CARRIER lines as minimodem-tpu, and every NOCARRIER field
    but one.  NOCARRIER's confidence= is the one value outside parity on
    the FFT route: with no noise its noise term is FFT round-off, so the
    ratio is ill-conditioned (the JAX package's own device and host
    engines disagree on it too)."""
    _, wav = _tx(tmp_path, jax_cli, "j.wav", [baud], b"hi\n")
    path = str(tmp_path / "j.wav")
    argv = ["--rx", "--file", path, baud, "--engine", engine]
    ref = _run(jax_cli, argv)
    got = _run(torch_cli, [*argv, "--device", "cpu"])
    assert ref[:2] == (0, b"hi\n")
    assert got[:2] == ref[:2]
    assert "### NOCARRIER " in ref[2]
    assert _mask_confidence(got[2]) == _mask_confidence(ref[2])
