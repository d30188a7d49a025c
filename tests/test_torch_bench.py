"""The port's bench (minimodem_tpu_torch/bench.py) and `--benchmarks` on
the CPU: the tone-generator table in the JAX package's layout, each
ported throughput row at a tiny size decode-exact with the JAX row's
keys, the CLI with jax blocked, and the error path without a card.
"""

import functools
import os
import re
import subprocess
import sys

import pytest
import torch

from .helpers import _redirect
from minimodem_tpu import bench as jax_bench
from minimodem_tpu_torch import bench
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


def _layout(text: str):
    """Lines without the three header lines, every number masked."""
    return [re.sub(r"\d+", "#", line) for line in text.splitlines()[3:]]


def test_benchmarks_cli_prints_the_jax_tone_rows(monkeypatch):
    monkeypatch.setattr(bench, "run_tx_benchmarks",
                        functools.partial(bench.run_tx_benchmarks, 1))
    monkeypatch.setattr(bench, "run_decode_benchmarks",
                        functools.partial(bench.run_decode_benchmarks, 1.0))
    with _redirect(b"") as (out, err):
        code = torch_cli.main(["--benchmarks", "--device", "cpu"])
        got = out._text.getvalue()
    assert code == 0, err.getvalue()
    with _redirect(b"") as (out, _):
        jax_bench.run_tx_benchmarks(1)
        ref = out._text.getvalue()
    head = got.splitlines()[:3]
    assert head[0].startswith("minimodem-tpu-torch ")
    assert head[2] == "accelerator\t: none"
    rows = _layout(got)
    assert rows[:len(_layout(ref))] == _layout(ref)
    decode = rows[len(_layout(ref)):]
    names = ["decode-Bell#-e#e-host", "decode-Bell#-e#e-ulaw",
             "decode-Bell#-on-device"]
    assert [r.split()[0] for r in decode] == names
    assert all("x realtime" in r and "samples/sec" in r
               and "MISMATCH" not in r for r in decode)


ROWS = {
    "decode": ("decode_throughput", dict(audio_seconds=1.0)),
    "decode-ulaw": ("decode_throughput",
                    dict(audio_seconds=1.0, encoding="ulaw")),
    "batched": ("batched_loopback_throughput",
                dict(audio_seconds=1.0, batch=2)),
    "batched-pipelined": ("batched_loopback_throughput",
                          dict(audio_seconds=1.0, batch=2, pipeline=3)),
    "batched-chained": ("batched_loopback_throughput",
                        dict(audio_seconds=1.0, batch=2, pipeline=4,
                             chain=2)),
    "mode-same": ("mode_loopback_throughput",
                  dict(mode="same", audio_seconds=1.0, batch=2)),
    "callerid": ("callerid_throughput", dict(batch=3, pipeline=3)),
    "loopback": ("loopback_throughput", dict(audio_seconds=1.0)),
}


@functools.lru_cache(maxsize=None)
def _jax_row(row):
    """The JAX package's row; the pipelined and chained rows share the
    plain batched row's keys, so one JAX run per function suffices."""
    name, kw = ROWS[row]
    base = row.split("-")[0]
    if base not in ROWS:
        base = row
    return getattr(jax_bench, name)(**ROWS[base][1])


@pytest.mark.parametrize("row", sorted(ROWS))
def test_bench_row_decodes_exact_with_the_jax_keys(row):
    name, kw = ROWS[row]
    got = getattr(bench, name)(device="cpu", **kw)
    ref = _jax_row(row)
    assert got.keys() == ref.keys()
    assert got["decode_exact"] is True and ref["decode_exact"] is True
    for k in ("batch", "pipeline", "chain", "encoding", "mode"):
        assert got.get(k) == kw.get(k, ref.get(k)), k


def test_benchmarks_cli_runs_with_jax_blocked():
    code = (
        "import sys, functools\n"
        "sys.modules['jax'] = None\n"
        "import minimodem_tpu_torch.bench as b\n"
        "import minimodem_tpu_torch.cli as c\n"
        "b.run_tx_benchmarks = functools.partial(b.run_tx_benchmarks, 1)\n"
        "b.run_decode_benchmarks = functools.partial("
        "b.run_decode_benchmarks, 1.0)\n"
        "rc = c.main(['--benchmarks', '--device', 'cpu'])\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m == 'minimodem_tpu' or m.startswith(('minimodem_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    assert out.count("x realtime") == 3 and "MISMATCH" not in out


def test_benchmarks_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with _redirect(b"") as (out, err):
        code = torch_cli.main(["--benchmarks"])
        printed = out._text.getvalue()
    assert code == 1 and printed == ""
    msg = err.getvalue()
    assert msg.startswith("E: ") and msg.count("\n") == 1
