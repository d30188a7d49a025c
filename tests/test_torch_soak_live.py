"""A small soak of the port's live RX paths (tests/test_soak_live.py's
checks at 40 RX sessions and 10 -a bursts), on the CPU.

minimodem-tpu-torch --rx -A and --rx -a -A on --device cpu read a
capture made lazily of silences and carrier sessions (the JAX soak's
SessionAsound, installed on the port's sigio.alsa).  Checks: every byte
of every session in order, one CARRIER and one NOCARRIER line per
session with the ndata= fields summing to the payload bytes, and the
resident memory growth between the 10% point and the end under the JAX
soak's bound.  chip_smoke.py runs the JAX soak's full size on the card.
"""

import re

import numpy as np
import pytest
import torch

from minimodem_tpu.models.modem import FskModem
from minimodem_tpu_torch import cli as torch_cli

from .test_soak_live import RSS_BOUND_MB, SessionAsound, _payload, _rss_mb
from .test_torch_slice import _run

SESSIONS = 40
BURSTS = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several pytest workers on a few cores; PyTorch's
    own CPU thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _install(monkeypatch, fake):
    import minimodem_tpu_torch.sigio.alsa as A

    monkeypatch.setattr(A, "_lib", fake)
    monkeypatch.setattr(A, "_tried", True)


def _blocks(m, n, rate, gap_s, seed, rss):
    rng = np.random.default_rng(seed)
    for i in range(n):
        if i == max(1, n // 10):
            rss["warm"] = _rss_mb()
        yield np.zeros(int(rng.uniform(*gap_s) * rate), np.float32)
        yield m.modulate(_payload(i))
    yield np.zeros(48000, np.float32)
    rss["end"] = _rss_mb()


@pytest.mark.soak
def test_rx_live_soak_sessions(monkeypatch):
    rss = {}
    _install(monkeypatch, SessionAsound(_blocks(
        FskModem("1200"), SESSIONS, 48000, (0.4, 1.8), 0x50AC, rss)))
    code, out, err = _run(torch_cli, ["--rx", "-A", "1200", "--device",
                                      "cpu"])
    assert code == 0, err[-2000:]
    expected = b"".join(_payload(i) for i in range(SESSIONS))
    assert out == expected
    assert err.count("### CARRIER") == SESSIONS
    ndata = [int(x) for x in re.findall(r"### NOCARRIER ndata=(\d+)", err)]
    assert len(ndata) == SESSIONS and sum(ndata) == len(expected)
    assert rss["end"] - rss["warm"] < RSS_BOUND_MB


@pytest.mark.soak
def test_rx_live_autodetect_soak(monkeypatch):
    rss = {}
    _install(monkeypatch, SessionAsound(_blocks(
        FskModem("300", sample_rate=24000), BURSTS, 24000, (1.0, 2.5),
        0xA07D, rss)))
    code, out, err = _run(torch_cli, ["--rx", "-a", "-A", "-R", "24000",
                                      "300", "--device", "cpu"])
    assert code == 0, err[-2000:]
    assert out == b"".join(_payload(i) for i in range(BURSTS))
    assert err.count("### CARRIER") == BURSTS
    assert err.count("### NOCARRIER") == BURSTS
    assert rss["end"] - rss["warm"] < RSS_BOUND_MB
