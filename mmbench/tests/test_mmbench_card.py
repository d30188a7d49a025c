"""On the card: each cell's command line runs briefly and comes out
correct, and the control comes out not correct at the cell's own size.
Marked `gpu`; skips without a CUDA card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = {w["name"]: w for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]}
CELLS = sorted(WORKLOADS)


@pytest.fixture
def card(request):
    import torch

    chips = WORKLOADS[request.node.callspec.params["name"]]["chips"]
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")


def _cmd(args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = _cmd(["mmbench.run", "--workload", name, "--seed", "4294967311",
                "--seconds", "2", "--trace", "0"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_not_correct(card, name):
    out = _cmd(["mmbench.control", "--workload", name, "--seeds",
                "4294967357"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert not json.loads(out.stdout.strip().splitlines()[-1])["correct"]
