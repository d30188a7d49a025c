"""The harness: finds a cell's configuration, traffic and metrics by name,
runs the cell's driver once (set-up, the measured window, the check
against the plain reference) and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own:

  BENCHMARK.json                  the cells and metrics (repo root)
  mmbench/configs/<config>.json   the deployment's modem parameters
  mmbench/traffic/<traffic>.json  the mix: its driver and parameters
  mmbench/drivers/<driver>.py     a general generator and timed loop
  mmbench/metrics/<metric>.py     read(run) -> value or None

so a new cell, configuration or metric is new files and a manifest entry.
A metric named <base>.<suffix> without a file of its own is read by
<base>.py: the same reading, named apart for a cell of its own.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from .trace import WINDOW, Spans, Trace, breakdown

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "minimodem_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list          # manifest entries this cell reports
    per_layer: list


@dataclass
class Run:
    """What a metric reader sees of one run."""

    cell: Cell
    seed: int
    setup_s: float
    window: dict              # the driver's window record
    spans: Spans
    shapes: dict              # per stage: the work of one counted launch
    trace: Trace = None
    peaks: dict = None
    extra: dict = field(default_factory=dict)


def load_manifest(root: Path = None) -> dict:
    root = Path.cwd() if root is None else Path(root)
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def resolve(manifest: dict, name: str, root: Path = None) -> Cell:
    """The manifest's cell `name` with its files read."""
    root = Path.cwd() if root is None else Path(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(PKG / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config,
                traffic, e2e, per_layer)


def load_driver(name: str):
    return importlib.import_module(f"mmbench.drivers.{name}")


def reader_path(metric: str) -> Path:
    """metrics/<metric>.py, else the file of the name less its last
    ".<suffix>", and so on."""
    name = metric
    while not (PKG / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return PKG / "metrics" / f"{name}.py"


def load_reader(metric: str):
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"mmbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device_info(device: str, chips: int) -> dict:
    """The card and this process's peak; a driver over several cards
    reports the fullest card's peak itself."""
    import torch

    if device == "cuda":
        peak = torch.cuda.max_memory_allocated(0)
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None) -> tuple:
    """One run of one cell.  -> (result dict, printed check lines).
    The result's keys: correct, attempted, failed, metrics, device,
    [breakdown], check."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spans = Spans(annotate=trace)
    drv = load_driver(cell.traffic["driver"]).Driver(cell, seed, device,
                                                     spans)
    drv.setup()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        with Trace() as tr:
            with torch.profiler.record_function(WINDOW):
                win = drv.window(seconds)
            drv.drain()
            if device == "cuda":
                torch.cuda.synchronize()
    else:
        win = drv.window(seconds)
        drv.drain()
    extra = drv.extra(tr) if hasattr(drv, "extra") else {}
    dev_info = _device_info(device, cell.chips)
    if "memory_peak_bytes" in extra:
        dev_info["memory_peak_bytes"] = extra["memory_peak_bytes"]
    drv.release()
    checks = drv.check()
    correct = all(c["value"] <= c["limit"] for c in checks)
    run = Run(cell, seed, setup_s, win, spans, drv.shapes(), tr,
              _peaks(dev_info["kind"]), extra)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = load_reader(m["name"])(run)
        if v is None:
            continue
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            raise ValueError(f"metric {m['name']} read {v!r}")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if trace:
        w0, w1 = tr.window_us
        busy = run.extra.get("busy_s", _busy_s(tr))
        dev_info["busy_s"] = busy
        dev_info["window_s"] = (w1 - w0) * 1e-6
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = breakdown(tr)
    result["check"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                       for c in checks}
    lines = [f"check {c['name']} = {c['value']} (limit {c['limit']}; "
             f"{c['what']})" for c in checks]
    return result, lines


def _busy_s(tr: Trace) -> float:
    from .trace import busy_intervals

    w0, w1 = tr.window_us
    return sum(b - a for a, b in busy_intervals(tr.records, w0, w1)) * 1e-6


def _peaks(kind: str):
    with open(PKG / "peaks.json") as f:
        return json.load(f).get(kind)
