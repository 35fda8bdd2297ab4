"""The metric readers on synthetic records: tails over all requests due in
the window, open-loop TTFT from the due time, rates over the window only,
and the tick classes of the per-layer readers."""

from __future__ import annotations

import math

import pytest

from perfbench import readers, work
from perfbench.loadgen import Record, Req, Tick
from perfbench.spec import Spec


def req(uid, due, times, done=True, lp=10):
    return Req(uid=uid, prompt=[1] * lp, n_out=len(times), due=due, times=list(times), tokens=[0] * len(times),
               done=(times[-1] if times else due) if done else None)


def record(reqs, ticks=(), open_=10.0, close=20.0):
    return Record(reqs=list(reqs), ticks=list(ticks), open=open_, close=close)


def reader(name):
    return Spec("mistral7b-chat").reader(name)


def test_ttft_counts_from_the_due_time_over_every_request_due_in_the_window():
    # due at 11 but first token at 12.5: 1.5 s, though the request may have been submitted later
    reqs = [req(i, 10.0 + i * 0.5, [10.0 + i * 0.5 + 0.1, 10.0 + i * 0.5 + 0.3]) for i in range(19)]
    reqs[2] = req(2, 11.0, [12.5, 12.7])
    reqs.append(req(99, 9.0, [25.0, 26.0]))  # due before the window: not counted
    v = reader("ttft_p95_ms")(record(reqs), None)
    ttfts = sorted([100.0] * 18 + [1500.0])
    assert v == pytest.approx(ttfts[17] + 0.1 * (ttfts[18] - ttfts[17]))


def test_a_request_that_never_finished_is_late_beyond_any_limit():
    reqs = [req(i, 10.0 + i, [10.0 + i + 0.1, 10.0 + i + 0.2]) for i in range(9)]
    assert reader("ttft_p95_ms")(record(reqs), None) == pytest.approx(100.0)
    reqs.append(req(50, 19.5, [], done=False))
    assert reader("ttft_p95_ms")(record(reqs), None) is None
    assert readers.percentile([1.0, math.inf], 0.5) == math.inf


def test_tpot_spans_first_to_last_token():
    reqs = [req(0, 11.0, [11.2, 11.3, 11.4, 11.5, 11.6]), req(1, 12.0, [12.1, 12.5, 12.9])]
    assert readers.tpot_s(record(reqs)) == pytest.approx([0.1, 0.4])


def test_rates_count_only_the_window():
    reqs = [req(0, 5.0, [9.0, 9.5, 10.5, 19.9, 20.1])]
    rec = record(reqs)
    ticks = [Tick(9.8, 10.2, [(256, [(0, 256)])], 256, 0, 4, []), Tick(10.2, 10.4, [(256, [(256, 200)])], 200, 0, 4, []),
             Tick(19.9, 20.3, [(256, [(0, 256)])], 256, 0, 4, [])]
    assert Spec("mistral7b-longdoc").reader("prompt_tok_s")(record([], ticks), None) == pytest.approx(456 / 10)


def test_tick_classes_and_their_host_times():
    ticks = [Tick(10.0, 10.1, [(64, [(0, 50)])], 50, 8, 4, [(100, 8)]),
             Tick(10.1, 10.5, [], 0, 8, 4, [(100, 8), (30, 8)]),
             Tick(10.5, 10.7, [], 0, 4, 4, [(30, 4)]),
             Tick(19.0, 19.5, [], 0, 8, 4, [(30, 8)], in_slice=True)]
    rec = record([], ticks)
    assert reader("prefill_tick_ms.chat")(rec, None) == pytest.approx(100.0)
    assert reader("decode_step_ms.chat")(rec, None) == pytest.approx(600.0 / 12)


def test_step_mfu_is_the_needed_work_over_the_ticks_host_time():
    spec = Spec("mistral7b-chat")
    g = spec.geometry
    ticks = [Tick(10.0, 10.05, [], 0, 2, 32, [(500, 2), (100, 1)])]
    least = (work.pass_work(g, [(500, 1), (100, 1)], kernel_rows=32, logits_rows=2).least_s()
             + work.pass_work(g, [(501, 1)], kernel_rows=32, logits_rows=1).least_s())
    assert spec.reader("step_mfu.chat")(record([], ticks), spec) == pytest.approx(100 * least / 0.05)
    # one decode step of one row reads the whole model once: 4.19 GB of FP4 linears + the bf16 lm_head
    assert least > 2 * 4.1e9 / work.HBM_BYTES_PER_S


def test_device_idle_reads_the_slice():
    class Slice:
        busy_s, window_s = 0.75, 1.0

    rec = record([])
    assert reader("device_idle.chat")(rec, None) is None
    rec.slice = Slice()
    assert reader("device_idle.chat")(rec, None) == pytest.approx(25.0)


@pytest.mark.parametrize("workload", ["tiny-chat", "tiny-doc"])
def test_ticks_account_for_every_prompt_token(tiny_spec, workload):
    """Whole prompts and 32-row chunks alike: the ticks' prefilled tokens sum
    to the prompts that got their first token, plus part of one still in
    flight; each tick's passes hold the rows the engine ran."""
    import torch

    from perfbench import harness

    spec = tiny_spec(workload)
    p = harness.prepare(spec, 3, torch.device("cpu"))
    rec = harness.drive(p, 1.5)
    started = sum(len(r.prompt) for r in rec.reqs if r.tokens)
    total = sum(t.prefill_tokens for t in rec.ticks)
    longest = max(len(r.prompt) for r in rec.reqs)
    assert started <= total < started + longest
    chunk = spec.traffic["engine"]["prefill_chunk"]
    for t in rec.ticks:
        assert t.prefill_tokens == sum(rows for _, seqs in t.prefill for _, rows in seqs)
        if chunk:
            assert len(t.prefill) <= 1 and all(0 < m <= chunk for m, _ in t.prefill)
