"""The port's span recorder (minimodem_tpu_torch/utils/trace.py) and its
spans in the two timed paths, on the CPU (the kernels' plain versions).

Outside torch.profiler a span is one check and records nothing; under it
spans nest (the enclosing span is the parent in the profiler's tree, and
the spans of one call or batch are the tree under its top span), carry
their counts, set or added from inside, stop at the log's bound, and sit
in the profiler's Chrome trace as "mm." annotations at the log's times
and walls.  MegaReceiver.run_events_batch gives rx.wire (the wire's bytes
and chunks through the device's shared stager, and its fresh host bytes
only where a chunk of that stager is first allocated), rx.upload (the
totals and carry), rx.enqueue and rx.collect a call, with the card's
counts on the CPU; DeviceLoopback gives lb.pack and the lb.dispatch
and lb.collect trees a batch; the results are the same with the profiler
on and off; and the CLI's --Xprofile trace holds the receiver's spans.
"""

import json
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minimodem_tpu_torch import cli as torch_cli
from minimodem_tpu_torch.codecs import get_codec
from minimodem_tpu_torch.models.modem import FskModem
from minimodem_tpu_torch.ops import device_rx
from minimodem_tpu_torch.ops.tx_device import tx_bit_schedule
from minimodem_tpu_torch.utils import trace

from .helpers import _redirect

RX = ("rx.wire", "rx.upload", "rx.enqueue", "rx.collect")


@pytest.fixture(autouse=True)
def empty_log():
    """Each test starts and ends with an empty log, on one torch thread
    (several pytest workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _events(ev) -> list:
    """Per-stream results as comparable bytes."""
    return [[np.asarray(a).tobytes() for a in s] for s in ev]


# --------------------------------------------------------------------------
# the recorder


def test_off_is_one_check_and_no_record(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler")

    checks = []

    def enabled():
        checks.append(1)
        return torch.autograd._profiler_enabled()

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_enabled", enabled)
    assert not torch.autograd._profiler_enabled()
    with trace.span("a") as s:
        s.count(bytes=3)
        with trace.span("b") as t:
            t.count(n=1)
            trace.add(alloc_bytes=4)
    assert len(checks) == 3                    # one a span, one an add
    assert s is t is trace.span("c")           # one shared no-op object
    assert trace.records() == [] and trace.dropped() == 0


def test_spans_nest_with_parent_req_and_counts():
    """The parent of a span is the span around it, in the log's times and
    in the profiler's tree; a request's spans are the tree under its top
    span; counts are set by count() or added by add() to the innermost
    open span."""
    trace.add(alloc_bytes=99)                  # no profiler: nothing
    with _profiler() as prof:
        trace.add(alloc_bytes=99)              # no open span: nothing
        with trace.span("outer") as o:
            o.count(bytes=10)
            with trace.span("inner") as i:
                i.count(bytes=2)
                trace.add(alloc_bytes=4)
                with trace.span("leaf"):
                    trace.add(alloc_bytes=1)
                trace.add(alloc_bytes=3)
            with trace.span("second"):
                pass
        with trace.span("top"):
            pass
    recs = trace.records()
    assert [r.name for r in recs] == ["outer", "inner", "leaf", "second",
                                      "top"]
    assert recs[0].counts == {"bytes": 10}
    assert recs[1].counts == {"alloc_bytes": 7, "bytes": 2}
    assert recs[2].counts == {"alloc_bytes": 1}
    assert recs[3].counts == {} == recs[4].counts
    for r in recs:
        assert r.start <= r.end
    assert recs[0].start <= recs[1].start <= recs[2].start
    assert recs[2].end <= recs[1].end <= recs[3].start <= recs[0].end
    assert recs[0].end <= recs[4].start
    parent = {e.name[3:]: e.cpu_parent and e.cpu_parent.name
              for e in prof.events() if e.name.startswith("mm.")}
    assert parent == {"outer": None, "inner": "mm.outer", "leaf": "mm.inner",
                      "second": "mm.outer", "top": None}


def test_log_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 2)
    with _profiler():
        for name in "abcd":
            with trace.span(name):
                with trace.span(name + "1") as c:
                    c.count(k=1)
    assert [r.name for r in trace.records()] == ["a", "a1"]
    assert trace.dropped() == 6
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_chrome_trace_annotations_at_the_logs_times(tmp_path):
    """Each span is an "mm." annotation in the exported trace, with the
    log's wall, and as far from the first span as the log has it (times
    on the two clocks agree to 50 us in the median; one span may be off
    by a scheduler quantum, as other processes share the cores)."""
    with _profiler() as prof:
        for k in range(6):
            with trace.span("work") as s:
                s.count(k=k)
                time.sleep(0.002)
            with trace.span("tail"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X"
                     and e.get("name", "").startswith("mm.")),
                    key=lambda e: e["ts"])
    recs = trace.records()
    assert [e["name"] for e in events] == ["mm." + r.name for r in recs]
    assert [r.counts for r in recs if r.name == "work"] == \
        [{"k": k} for k in range(6)]
    t0, s0 = events[0]["ts"], recs[0].start
    at = [abs((e["ts"] - t0) - (r.start - s0) * 1e-3)
          for e, r in zip(events, recs)]
    wall = [abs(e["dur"] - (r.end - r.start) * 1e-3)
            for e, r in zip(events, recs)]
    for diffs in (at, wall):
        assert statistics.median(diffs) < 50.0
        assert max(diffs) < 20_000.0


# --------------------------------------------------------------------------
# the two timed paths


@pytest.fixture(scope="module")
def bell():
    m = FskModem("1200", device="cpu")
    pcm = [(np.clip(m.modulate(t), -1, 1) * 32767).astype(np.int16)
           for t in (b"span the wire\n", b"and the upload, then collect\n")]
    n = max(len(p) for p in pcm)
    wav = np.zeros((2, n), np.int16)
    for i, p in enumerate(pcm):
        wav[i, :len(p)] = p
    enc = get_codec(m.preset.encoder)
    scheds = [tx_bit_schedule(b"loop %d\n" % i, m.cfg, enc) for i in range(3)]
    return m.cfg, wav, [len(p) for p in pcm], scheds


def test_receiver_call_gives_its_four_spans(bell):
    cfg, wav, totals, _ = bell
    rx = device_rx.DeviceReceiver(cfg, device="cpu")
    plain, carry = rx.run_events_batch(wav, totals, 1.5, 2.3)
    assert trace.records() == []
    with _profiler():
        got, carry_on = rx.run_events_batch(wav, totals, 1.5, 2.3)
    assert _events(got) == _events(plain)
    assert all(np.array_equal(carry[k], carry_on[k]) for k in carry)
    assert b"span the wire" in bytes(got[0][2])
    recs = trace.records()
    assert [r.name for r in recs] == list(RX)
    assert all(a.end <= b.start for a, b in zip(recs, recs[1:]))
    key = device_rx.device_rx_key(cfg)
    row = device_rx._round_up_pow2(max(totals) + cfg.nsamples_overscan + 1) \
        + device_rx.geo_from_key(key).halo
    wire = 2 * row * 2                             # two int16 rows
    # the untraced call above allocated the stager's chunks
    chunks = -(-wire // device_rx.STAGE_CHUNK_BYTES)
    assert recs[0].counts == {"bytes": wire, "chunks": chunks}
    assert recs[1].counts == {"bytes": 2 * 4 + 2 * 8 * 4 + 2 * 4 * 4}
    # a second call: four spans of its own, after the first call's
    with _profiler():
        rx.run_events_batch(wav, totals, 1.5, 2.3)
    recs = trace.records()
    assert [r.name for r in recs] == list(RX) * 2
    assert recs[3].end <= recs[4].start


def test_loopback_batch_gives_its_span_trees(bell):
    cfg, _, _, scheds = bell
    lb = device_rx.DeviceLoopback(cfg, device="cpu")
    plain = lb.run_events_batch(scheds)
    assert trace.records() == []
    with _profiler():
        h = lb.dispatch_events_batch(scheds)
        h2 = lb.dispatch_events_batch(scheds[:2])
        lb.prefetch_events_batch(h)
        got = lb.collect_events_batch(h)
        got2 = lb.collect_events_batch(h2)
    assert _events(got) == _events(plain)
    assert _events(got2) == _events(plain[:2])
    assert bytes(got[1][2]) == b"loop 1\n"
    recs = trace.records()
    names = [r.name for r in recs]
    assert names == ["lb.pack", "lb.dispatch", "lb.upload", "lb.enqueue"] * 2 \
        + ["lb.prefetch", "lb.collect", "lb.wait", "lb.unpack"] \
        + ["lb.collect", "lb.prefetch", "lb.wait", "lb.unpack"]
    assert all(r.start <= r.end for r in recs)
    # each index's parent (None: a top span), by the log's times
    parent = []
    for i, r in enumerate(recs):
        around = [j for j, q in enumerate(recs[:i])
                  if q.start <= r.start and r.end <= q.end]
        parent.append(around[-1] if around else None)
    assert parent == [None, None, 1, 1, None, None, 5, 5,
                      None, None, 9, 9, None, 12, 12, 12]


def test_xprofile_trace_holds_the_receivers_spans(tmp_path):
    wav = str(tmp_path / "one.wav")
    with _redirect(b"one segment\n"):
        assert torch_cli.main(["--tx", "--file", wav, "1200"]) == 0
    out_dir = tmp_path / "prof"
    with _redirect(b"") as (out, _):
        assert torch_cli.main(["--rx", "--file", wav, "1200", "--device",
                               "cpu", "--Xprofile", str(out_dir)]) == 0
        assert out.buffer.getvalue() == b"one segment\n"
    events = json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "user_annotation"]
    assert [n for n in names if n.startswith("mm.")] == ["mm." + s
                                                         for s in RX]
