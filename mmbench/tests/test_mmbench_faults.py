"""The check sees a broken timed path: each cell's run, at a tiny size on
the CPU (the harness's look for a card skipped), with a fault planted
underneath the driver, comes out not correct; a sound run comes out
correct; and the control (the reference in TF32 put in the program's
place) comes out not correct at the test's size.

Faults a decode cell can have: an answer altered where it is produced,
and half of the batch left out (the rest of the answers copied into its
place); the fleet also the exchange between cards left out (rank 0 keeps
only its own block of the gathered results).  No cell trains: no step
that returns its state unchanged.  The fleet runs as four CPU processes
on gloo; its faults are planted in rank 0, this process."""

import numpy as np
import pytest

from _cells import tiny_cell
from mmbench import control, harness

CELLS = ["bell202.loopback8", "uic_train.batch16", "bell202.file",
         "bell202.fleet4"]
FAULTS = [(c, f) for c in CELLS for f in ("altered", "half")] + [
    ("bell202.fleet4", "exchange")]


def _run(name):
    res, lines = harness.run_cell(tiny_cell(name), 2**32 + 77, 3.0, False,
                                  "cpu")
    return res


def _alter(ev):
    """An answer altered: the last event's first payload word, and a
    decoded byte where there are bytes."""
    ev = [np.array(a, copy=True) for a in ev]
    ev[1][-1, 0] += 1
    if len(ev) > 2 and len(ev[2]):
        ev[2][0] ^= 1
    return tuple(ev)


def _plant(monkeypatch, name, fault):
    from minimodem_tpu_torch.ops import device_rx
    from minimodem_tpu_torch.parallel import service
    from minimodem_tpu_torch.rx import engine

    if name in ("bell202.loopback8", "uic_train.loopback16"):
        lb = device_rx.DeviceLoopback
        disp, coll = lb.dispatch_events_batch, lb.collect_events_batch
        if fault == "altered":
            monkeypatch.setattr(lb, "collect_events_batch", lambda self, h: [
                _alter(e) for e in coll(self, h)])
        else:
            def half_dispatch(self, scheds, *a):
                h = disp(self, scheds[:(len(scheds) + 1) // 2], *a)
                h.n = len(scheds)
                return h

            def half_collect(self, h):
                res = coll(self, h)
                return (res * 2)[:h.n]
            monkeypatch.setattr(lb, "dispatch_events_batch", half_dispatch)
            monkeypatch.setattr(lb, "collect_events_batch", half_collect)
    elif name in ("uic_train.batch16", "bell202.fleet4"):
        svc = (device_rx.DeviceReceiver if name == "uic_train.batch16"
               else service.ShardedReceiver)
        run = svc.run_events_batch
        if fault == "exchange":
            gather = service._gather_streams

            def own_block(events, mesh):
                return gather(events, mesh)[:len(events)] * 4
            monkeypatch.setattr(service, "_gather_streams", own_block)
        elif fault == "altered":
            def altered(self, *a, **k):
                ev, rest = run(self, *a, **k)
                return [_alter(e) for e in ev], rest
            monkeypatch.setattr(svc, "run_events_batch", altered)
        else:
            def half(self, *a, **k):
                ev, rest = run(self, *a, **k)
                return (ev[:(len(ev) + 1) // 2] * 2)[:len(ev)], rest
            monkeypatch.setattr(svc, "run_events_batch", half)
    else:
        recv = engine.Receiver
        if fault == "altered":
            prun = device_rx.PipelinedReceiver.run

            def altered(self, *a, **k):
                for seg in prun(self, *a, **k):
                    yield _alter(seg)
            monkeypatch.setattr(device_rx.PipelinedReceiver, "run", altered)
        else:
            dev = recv._run_device
            monkeypatch.setattr(recv, "_run_device", lambda self, s, *a, **k:
                                dev(self, s[:len(s) // 2], *a, **k))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "check"}
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_caught(monkeypatch, name, fault):
    _plant(monkeypatch, name, fault)
    res = _run(name)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    checks = control.control(tiny_cell(name), 2**31 + 3, "cpu")
    assert any(c["value"] > c["limit"] for c in checks), checks
