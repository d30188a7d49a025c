"""The port's entry points beside its CLI, on the CPU: the headline runner
(`python -m minimodem_tpu_torch.bench`) against the repository's root
bench.py, the sp scaling curve
(`python -m minimodem_tpu_torch.scripts.sp_scaling_curve`) and the live
soak (`python -m minimodem_tpu_torch.scripts.live_soak`) against
scripts/live_soak.py.

Both runners run their real rows at a tiny size (ROWS below): each row
function is wrapped to force the tiny size, pipelines of 2, and rtty's
slot run at 300 baud, since rtty's frame-schedule loopback pads to 512
frames (~4 M samples a stream), minutes on the CPU's plain scorer.  The
port's runner runs in a child process with jax blocked (which then
imports the sp curve's and the soak's modules and runs the soak's main
up to its backend, so that their import graphs are held free of jax
too), the root bench.py in this one, side by side.  Their JSON lines must have the key
tree that chip_smoke.py's phase 22 holds the card's run to
(chip_smoke.RUNNER_KEYS), with the same JSON types.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minimodem_tpu import bench as jax_bench
from minimodem_tpu_torch import bench

from .test_alsa import FakeAsound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the rows at their tiny size, and the wrapper that forces it; exec'd
# here and in the port's child process (which cannot import this file:
# it imports jax)
ROWS = '''
ROWS = {
    "batched_loopback_throughput": dict(audio_seconds=1.0, batch=1),
    "loopback_throughput": dict(audio_seconds=1.0, repeats=1),
    "fleet_loopback_throughput": dict(audio_seconds=1.0, batch=1),
    "fleet_ingest_throughput": dict(audio_seconds=1.0, batch=1, repeats=1),
    "decode_throughput": dict(audio_seconds=1.0, repeats=1),
    "mode_loopback_throughput": dict(audio_seconds=1.0, batch=1),
    "callerid_throughput": dict(batch=1),
}


def tiny(mod, results, put=setattr):
    """Wrap mod's rows to their tiny size (put(mod, name, row)); every
    row's result is appended to results, in call order."""
    for name, size in ROWS.items():
        def row(*a, _real=getattr(mod, name), _size=size, **kw):
            if kw.get("pipeline", 1) > 1:
                kw["pipeline"] = 2
            if a[:1] == ("rtty",):
                a = ("300",) + a[1:]
            results.append(_real(*a, **{**kw, **_size}))
            return results[-1]
        put(mod, name, row)
'''

CHILD = ROWS + '''
import json, sys
import torch
sys.modules["jax"] = None
import minimodem_tpu_torch.bench as b
torch.set_num_threads(1)
results = []
tiny(b, results)
rc = b.main(["1.0", "1", "--device", "cpu"])
# the two scripts' import graphs: the curve's work and its ranks' modules,
# and the soak's main up to its backend (none here: exit 2)
import importlib
import minimodem_tpu_torch.parallel.launch, minimodem_tpu_torch.parallel.service
from minimodem_tpu_torch.scripts import live_soak, sp_scaling_curve
assert len(sp_scaling_curve.make_work(1.0, 1)[1]) == 1
for name in ("alsa", "pulse", "sndio"):
    lib = importlib.import_module("minimodem_tpu_torch.sigio." + name)
    lib._lib, lib._tried = None, True
assert live_soak.main(["--torch-device", "cpu"]) == 2
bad = [m for m, v in sys.modules.items() if v is not None and
       (m == "minimodem_tpu" or m.startswith(("minimodem_tpu.", "jax")))]
assert not bad, bad
with open(sys.argv[1], "w") as f:
    json.dump(results, f)
sys.exit(rc)
'''


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(mp):
    """The root bench.py's main at 1 s x 1 stream -> (rc, stdout)."""
    mp.setattr(sys, "argv", ["bench.py", "1.0", "1"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _root_bench().main()
    return rc, out.getvalue()


def _port_main():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["1.0", "1", "--device", "cpu"])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners once at the tiny size: the port's in a child with jax
    blocked, the root bench.py here meanwhile.  -> {"jax" | "port": (rc,
    stdout, row results in call order)}."""
    path = str(tmp_path_factory.mktemp("runner") / "rows.json")
    child = subprocess.Popen([sys.executable, "-E", "-c", CHILD, path],
                             cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
    try:
        ns = {}
        exec(ROWS, ns)
        jax_rows = []
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        with pytest.MonkeyPatch.context() as mp:
            ns["tiny"](jax_bench, jax_rows, mp.setattr)
            rc, out = _jax_main(mp)
        torch.set_num_threads(n)
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode in (0, 1) and os.path.exists(path), \
        stderr.decode()
    with open(path) as f:
        port_rows = json.load(f)
    return {"jax": (rc, out, jax_rows),
            "port": (child.returncode, stdout.decode(), port_rows)}


def _smoke():
    """chip_smoke.py as a module (it imports nothing of the port or jax
    at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("side", ["jax", "port"])
def test_runner_prints_the_key_tree_last(runs, side):
    """The last stdout line is the JSON object, with the key tree (and
    the JSON types) chip_smoke.py's phase 22 holds the card's run to;
    every row decoded exact, so decode_exact is true and the exit code
    0.  The port's child imported no jax and nothing of minimodem_tpu."""
    rc, out, rows = runs[side]
    lines = out.strip().splitlines()
    line = json.loads(lines[-1])
    smoke = _smoke()
    assert smoke.key_tree(line) == smoke.RUNNER_KEYS
    assert rc == 0 and line["decode_exact"] is True
    assert len(rows) == 10 and all(r["decode_exact"] for r in rows)
    assert line["fleet_devices"] == (8 if side == "jax" else 1)
    if side == "port":
        # the card line, the versions and one wall line a row come first
        assert lines[0] == "accelerator\t: none"
        assert lines[1].startswith(f"torch {torch.__version__} cuda ")
        assert len(lines) == 2 + len(rows) + 1
        assert all(s.startswith("row ") and "decode exact True" in s
                   for s in lines[2:-1])


def test_runner_rows_have_the_jax_rows_keys(runs):
    """Row for row, in the runners' order, the same keys."""
    jax_rows, port_rows = runs["jax"][2], runs["port"][2]
    assert [r.keys() for r in port_rows] == [r.keys() for r in jax_rows]


@pytest.mark.parametrize("forced", range(10))
def test_runner_exit_code_follows_decode_exact(runs, forced, monkeypatch):
    """Both runners replay their recorded rows with row `forced` set to
    decode_exact False: each prints decode_exact false and exits 1."""
    def replay(mod, rows):
        it = iter([dict(r, decode_exact=(i != forced))
                   for i, r in enumerate(rows)])
        for name in ("batched_loopback_throughput", "loopback_throughput",
                     "fleet_loopback_throughput", "fleet_ingest_throughput",
                     "decode_throughput", "mode_loopback_throughput",
                     "callerid_throughput"):
            monkeypatch.setattr(mod, name, lambda *a, **kw: next(it))

    replay(jax_bench, runs["jax"][2])
    jrc, jout = _jax_main(monkeypatch)
    replay(bench, runs["port"][2])
    prc, pout = _port_main()
    assert jrc == prc == 1
    for out in (jout, pout):
        assert json.loads(out.strip().splitlines()[-1])["decode_exact"] is False


@pytest.mark.parametrize("module,argv,flag", [
    ("bench", [], "--device"),
    ("scripts.sp_scaling_curve", [], "--device"),
    ("scripts.live_soak", ["--selfcheck"], "--torch-device")])
def test_entry_points_without_a_card_exit_1(module, argv, flag):
    """The runner, the curve and the soak default to the card: without
    one each exits 1 with one E: line naming its CPU flag, and prints
    nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    mod = importlib.import_module(f"minimodem_tpu_torch.{module}")
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    assert rc == 1 and out.getvalue() == ""
    msg = err.getvalue()
    assert msg.startswith("E: ") and msg.count("\n") == 1
    assert f"{flag} cpu" in msg


# ---- the sp scaling curve ----

def test_sp_curve_on_gloo_ranks():
    """sp = 1 and 2 as worlds of 1 and 2 gloo ranks on the CPU: the JAX
    script's row keys (scripts/sp_scaling_curve.py) plus backend and
    cards, each row decode-exact, and the final {"curve",
    "audio_seconds"} line."""
    from minimodem_tpu_torch.scripts import sp_scaling_curve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sp_scaling_curve.main(["1.0", "1", "--sp", "1,2",
                                    "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
    keys = {"sp", "batch", "wall_ms", "rtf", "decode_exact"}
    assert [set(r) for r in lines[:2]] == [keys | {"backend", "cards"}] * 2
    final = lines[2]
    assert set(final) == {"curve", "audio_seconds"}
    assert [r["sp"] for r in final["curve"]] == [1, 2]
    for r in final["curve"]:
        assert set(r) == keys | {"speedup_vs_sp1", "backend", "cards"}
        assert r["decode_exact"] is True and r["batch"] == 1
        assert (r["backend"], r["cards"]) == ("gloo", 0)
    assert final["audio_seconds"] > 1.0


# ---- the live soak ----

def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_live_soak", os.path.join(ROOT, "scripts", "live_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _soak(mod, argv, mp):
    """A soak script's main -> (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if mod == "jax":
            mp.setattr(sys, "argv", ["live_soak.py", *argv])
            rc = _jax_soak().main()
        else:
            from minimodem_tpu_torch.scripts import live_soak

            rc = live_soak.main([*argv, "--torch-device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


def _set_lib(mp, lib):
    for pkg in ("minimodem_tpu", "minimodem_tpu_torch"):
        for name in ("alsa", "pulse", "sndio"):
            mod = importlib.import_module(f"{pkg}.sigio.{name}")
            mp.setattr(mod, "_lib", lib if name == "alsa" else None)
            mp.setattr(mod, "_tried", True)


def test_live_soak_selfcheck_matches_jax(monkeypatch):
    """--selfcheck: modulate, then demodulate on the torch device (K1
    and K2 on a card): PASS, exit 0, the JAX script's line."""
    got = _soak("port", ["--selfcheck"], monkeypatch)
    assert got[0] == 0 and got[1].startswith("selfcheck: PASS")
    assert got == _soak("jax", ["--selfcheck"], monkeypatch)


def test_live_soak_without_a_backend_exits_2(monkeypatch):
    _set_lib(monkeypatch, None)
    got = _soak("port", [], monkeypatch)
    assert got == _soak("jax", [], monkeypatch)
    assert got[0] == 2 and got[1] == ""
    assert got[2].startswith("E: no system audio client library found")


def test_live_soak_through_a_stand_in_libasound(monkeypatch):
    """The live loop: a stand-in libasound whose capture holds the burst
    the soak transmits (as a loopback cable would deliver it), decoded
    live by DeviceStreamReceiver: PASS, exit 0, the carrier found and
    the burst written to the playback device."""
    from minimodem_tpu_torch.models.modem import FskModem
    from minimodem_tpu_torch.scripts.live_soak import build_payload

    burst = FskModem("300", device="cpu").modulate(build_payload(1.0, "300"))
    quiet = np.zeros(12000, np.float32)
    fake = FakeAsound(capture=np.concatenate([quiet, burst, quiet]))
    _set_lib(monkeypatch, fake)
    rc, out, err = _soak("port", ["--seconds", "1", "--timeout", "20"],
                         monkeypatch)
    assert rc == 0, err
    assert err.startswith("### CARRIER 300 @ 1250.0 Hz ###\n")
    lines = out.splitlines()
    assert lines[0] == "backend: alsa  mode: 300  rate: 48000  payload: 31 bytes"
    assert lines[-1].startswith("PASS: payload decoded byte-exact")
    assert np.array_equal(np.concatenate(fake.written), burst)
    assert fake.drained
