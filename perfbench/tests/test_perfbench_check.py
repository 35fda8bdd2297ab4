"""The check that decides ``correct``, at a size that a CPU test holds:
sound runs pass, the float8 control and the program's own e4m3 KV cache
fail on every seed tried, and so does a run whose timed path is broken
underneath (``perfbench/faults.py``: every token or one slot's tokens
altered where they are produced, a decode step that leaves the cache's
state unchanged, half of the batch left out, a ring's positions one chunk
off).  One chip: no exchange between chips to leave out."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import check, faults, harness

CELLS = ["tiny-chat", "tiny-doc", "tinymoe-chat"]


def run(spec, seed=5, seconds=2.0, trace=False, device="cpu"):
    return harness.run_cell(spec, seed, seconds, trace, torch.device(device), time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(tiny_spec, workload):
    out = run(tiny_spec(workload), seed=2**31 + 7)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert {"setup_s"} < set(out["metrics"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_fails_where_the_program_passes(tiny_spec, workload):
    spec = tiny_spec(workload)
    (name, limit), = spec.params["limits"].items()
    dev = torch.device("cpu")
    for seed in (11, 12, 13):
        p = harness.prepare(spec, seed, dev)
        rec = harness.drive(p, 2.0)
        harness.free(p)
        done = [r for r in rec.due_in_window if r.done is not None]
        reqs = check.sample(done, seed, spec.traffic["check"]["served_tokens"], spec.traffic["check"]["max_rows"])
        gaps, ref = check.program_gaps(spec, seed, reqs, dev)
        control = check.control_gaps(spec, seed, reqs, ref, dev)
        assert check.readings(gaps, reqs)[name] <= limit < check.readings(control, reqs)[name]


def test_the_e4m3_kv_control_fails_where_the_program_passes(tiny_spec):
    """The program's own e4m3 KV cache, the step below the cells' bfloat16
    KV, fails the limit: attention is peaked (``qk_absmax``), so K/V
    rounding shows in the served tokens."""
    spec = tiny_spec("tiny-chat")
    (name, limit), = spec.params["limits"].items()
    dev = torch.device("cpu")
    for seed in (11, 12, 13):
        p = harness.prepare(spec, seed, dev, engine={"kv_dtype": "float8_e4m3fn"})
        rec = harness.drive(p, 2.0)
        harness.free(p)
        assert harness.verify(spec, seed, rec, dev)[name] > limit


FAULT_CASES = [(w, f) for w in CELLS for f in faults.FAULTS if f != "ring_offset"] + [("tiny-doc", "ring_offset")]


@pytest.mark.parametrize(("workload", "fault"), FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(tiny_spec, monkeypatch, workload, fault):
    spec = tiny_spec(workload)
    assert faults.applies(fault, spec)
    faults.FAULTS[fault](monkeypatch, spec)
    out = run(spec)
    assert not out["correct"]
    (name, limit), = spec.params["limits"].items()
    assert out["compared"][name]["value"] > limit


def test_a_ring_offset_needs_rings(tiny_spec):
    assert not faults.applies("ring_offset", tiny_spec("tiny-chat"))
    assert faults.applies("ring_offset", tiny_spec("tiny-doc"))


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_spec):
    """The same path on the card: graphed decode, the profiler slice and the
    kernel readers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run(tiny_spec("tiny-chat"), seconds=3.0, trace=True, device="cuda")
    assert out["correct"], out["compared"]
    assert out["device"]["busy_s"] > 0 and "device_idle.chat" in out["metrics"]
