"""A configuration, a cell and a per-layer metric added as new files (and
manifest entries) in a copy of the benchmark are found by name, with no
existing file of mmbench/ edited."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "mmbench", tmp_path / "mmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "mmbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration: Bell 202 at 24 kHz
    cfg = json.loads((ROOT / "mmbench/configs/bell202.json").read_text())
    cfg["modem"]["sample_rate"] = 24000
    (tmp_path / "mmbench/configs/bell202_24k.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "bell202_24k", "source": "https://x",
                             "file": "mmbench/configs/bell202_24k.json",
                             "reduced": [], "why": "a test"})
    # a traffic mix for an existing driver, and a cell of both
    traffic = json.loads((ROOT / "mmbench/traffic/loopback8.json")
                         .read_text())
    traffic.update(streams=2, payload_bytes=30, payload_sets=1,
                   in_flight=2, check_streams=2)
    (tmp_path / "mmbench/traffic/tiny2.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": "bell202_24k.tiny2",
                               "config": "bell202_24k", "traffic": "tiny2",
                               "chips": 1, "why": "a test"})
    # a per-layer metric
    (tmp_path / "mmbench/metrics/batches_done.py").write_text(
        textwrap.dedent('''
        def read(run):
            return run.window["batches"]
        '''))
    bench["per_layer"].append({"name": "batches_done", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "audio_rate",
                               "workloads": ["bell202_24k.tiny2"]})
    bench["end_to_end"][0]["workloads"].append("bell202_24k.tiny2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "minimodem_tpu_torch").symlink_to(ROOT / "minimodem_tpu_torch")
    code = textwrap.dedent('''
        import json, time
        from mmbench import harness
        cell = harness.resolve(harness.load_manifest(), "bell202_24k.tiny2")
        assert [m["name"] for m in cell.per_layer] == ["batches_done"]
        res, _ = harness.run_cell(cell, 2**33 + 5, 4.0, True, "cpu")
        print(json.dumps(res))
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["batches_done"]["value"] >= 1, res
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_suffixed_metric_reads_its_base_file(tmp_path):
    """A metric named <base>.<suffix> with no file of its own is read by
    <base>.py; a file of its own wins."""
    from mmbench import harness

    metrics = ROOT / "mmbench" / "metrics"
    assert harness.reader_path("k2_roofline.batch") == metrics / "k2_roofline.py"
    assert harness.reader_path("device_idle_pct.a.b") == \
        metrics / "device_idle_pct.py"
    assert harness.reader_path("latency_p95_ms") == metrics / "latency_p95_ms.py"
