"""``prefill_idle``: the device's idle time under the engine's
``engine.prefill`` ranges, on hand-built slices and on traced tiny runs of
the engine with and without its spans."""

from __future__ import annotations

import contextlib

import pytest

from perfbench.devtrace import TICK, Slice
from perfbench.loadgen import Record
from perfbench.spec import Spec


def reader(name):
    return Spec("mistral7b-chat").reader(name)


def host(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "w4a8_kernel", "ts": ts, "dur": dur, "tid": 7}


def traced(events):
    rec = Record(reqs=[], ticks=[], open=0.0, close=1.0)
    rec.slice = Slice(events)
    return rec


def test_prefill_idle_is_the_idle_time_inside_prefill_ranges():
    """Slice 0-1000 us.  Device busy 100-300 and 250-400 (one busy stretch),
    600-700.  Prefill ranges 50-450 (idle 50-100 and 400-450: 100 us) and
    650-900 (idle 700-900: 200 us); a prefill range of another thread and
    the idle time outside the ranges do not count."""
    events = [host(TICK, 0, 1000), host("engine.admit", 40, 500), host("engine.prefill", 50, 400),
              host("engine.prefill", 650, 250), host("engine.decode", 920, 60),
              host("engine.prefill", 0, 1000, tid=2),
              kernel(100, 200), kernel(250, 150), kernel(600, 100)]
    assert reader("prefill_idle.chat")(traced(events), None) == pytest.approx(30.0)
    assert reader("device_idle.chat")(traced(events), None) == pytest.approx(60.0)


def test_prefill_idle_reads_nothing_without_the_engines_spans():
    assert reader("prefill_idle.chat")(Record(reqs=[], ticks=[], open=0.0, close=1.0), None) is None
    events = [host(TICK, 0, 1000), host("aten::copy_", 50, 400), kernel(100, 200)]
    assert reader("prefill_idle.chat")(traced(events), None) is None
    # spans but no prefill in the slice: no idle time under a prefill
    assert reader("prefill_idle.chat")(traced(events + [host("engine.decode", 500, 100)]), None) == 0.0


@pytest.mark.parametrize("spans", [True, False])
def test_prefill_idle_on_a_traced_tiny_engine(tiny_spec, monkeypatch, spans):
    """Ticks of the load generator under the harness's profiler: on the CPU
    the trace holds no device operation, so every prefill range is idle
    time, a reading above 0 and within ``device_idle``.  An engine that
    marks no spans (the state before them) gives no reading and raises
    nothing."""
    import torch

    from perfbench import harness
    from perfbench.loadgen import Driver, Schedule, clock
    from torch_bnb_fp4_tpu_torch.ops import kernels as K
    from torch_bnb_fp4_tpu_torch.serve import engine

    if not spans:
        monkeypatch.setattr(engine, "span", lambda name: contextlib.nullcontext())
    spec = tiny_spec("tiny-doc")
    p = harness.prepare(spec, 7, torch.device("cpu"))
    sched = Schedule(spec.traffic, 7, spec.geometry.vocab)
    prof = harness.Profiler(K.launch_counts)
    d = Driver(p.engine, spec, sched, 1.0, engine.Request, prof)
    for _ in range(2):
        d.submit(sched.next()[0], clock())
    prof.start()
    for _ in range(4):
        d.tick()
    prof.stop()
    rec = Record(reqs=list(d.reqs.values()), ticks=d.ticks, open=0.0, close=1.0)
    rec.slice = Slice.from_profiler(prof.prof)
    assert any(t.prefill for t in d.ticks)
    got = spec.reader("prefill_idle.longdoc")(rec, spec)
    if spans:
        assert 0.0 < got <= spec.reader("device_idle.longdoc")(rec, spec)
    else:
        assert got is None
