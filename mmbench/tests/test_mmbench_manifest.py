"""BENCHMARK.json against the benchmark's contract: names, units and
keys, every metric's reader, every cell's files, and each per-layer
metric's `moves` reported by every cell it lists."""

import json
import re
from pathlib import Path

import pytest

from mmbench import harness

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "mmbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)


def test_command_and_paths(bench):
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_allowed(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("http")
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    configs = {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (PKG / "drivers" / f"{traffic['driver']}.py").is_file()


def _cells_of(metric, bench):
    return metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e + bench["per_layer"]:
        extra = set(m) - {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert not extra
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert harness.reader_path(m["name"]).is_file()
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and "bound" not in m
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in _cells_of(m, bench)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells_of(m, bench)
                   for m in bench["per_layer"])


def test_moves_reported_where_listed(bench):
    """Each per-layer metric moves an end-to-end metric that every cell
    it lists reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in _cells_of(m, bench):
            assert cell in _cells_of(e2e[m["moves"]], bench), (m["name"],
                                                               cell)


def test_layers_named_alike(bench):
    """Metrics of one layer give it letter for letter alike: no two layer
    names differ only in case or spacing."""
    layers = {m["layer"] for m in bench["per_layer"]}
    squashed = {re.sub(r"\W", "", s.lower()) for s in layers}
    assert len(squashed) == len(layers)
