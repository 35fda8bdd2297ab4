"""The engine's tracing: spans on the profiler's clock, each request's wait
from arrival, and the tick's record of its prefill passes.

``Engine.step`` marks its phases with ``utils.profiling.span`` while a
``torch.profiler`` records (``engine.admit`` holding one ``engine.prefill``
per pass, then ``engine.retire``, ``engine.decode``, ``engine.fetch``,
``engine.deliver``) and enters no ``record_function`` otherwise.
``Completion.ttft_s`` and ``queue_s`` count from ``Request.arrival`` (the
submit time when it is None); the HTTP server stamps it on receipt.
``Engine.last_prefill`` rebuilds the load generator's record of each tick's
prefill passes (``perfbench/loadgen.py``), and where that record cannot
follow the engine (prefix-cache suffix chunks) it matches the prompt
arithmetic.  CPU, a one-layer tiny model, one torch thread.
"""

import json
import threading
import time
import types
import urllib.request

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.loadgen import Driver, Req, clock
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, EngineServer, Request
from torch_bnb_fp4_tpu_torch.utils import profiling

CFG = T.ModelConfig.tiny_test(n_layers=1)
PHASES = ("engine.admit", "engine.retire", "engine.decode", "engine.fetch", "engine.deliver")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return T.quantize_params(CFG, T.random_weights(CFG, seed=9), fuse=True, device="cpu")


def _engine(params, chunk=0, **kw):
    return Engine(params, CFG, EngineConfig(max_batch=2, max_len=128, inner_steps=2, prefill_chunk=chunk, **kw))


def _ranges(prof, prefix="engine."):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith(prefix)]


@pytest.mark.parametrize("chunk", [0, 32])
def test_a_step_emits_each_span_nested_as_specified(params, chunk):
    """One traced step that prefills a prompt (its last chunk, when chunked)
    and decodes: the five phases in order, one prefill pass inside the
    admission, and the fetch of the first token inside the prefill."""
    eng = _engine(params, chunk)
    eng.submit(Request(uid=1, prompt=list(range(1, 41)), max_new_tokens=4))
    if chunk:
        eng.step()  # rows [0, 32): no first token yet, so nothing decodes
        assert eng._pf is not None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    got = _ranges(prof)
    top = [r for r in got if r[0] != "engine.prefill"]
    assert [n for n, _, _ in top] == list(PHASES)
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))  # one after another
    (pf,) = [r for r in got if r[0] == "engine.prefill"]
    admit = top[0]
    assert admit[1] <= pf[1] and pf[2] <= admit[2]
    items = [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == "aten::item"]
    assert any(pf[1] <= a and b <= pf[2] for a, b in items)  # the first token's fetch


def test_prefix_suffix_chunks_are_prefill_passes(params):
    """A prefix-cache hit prefills its suffix in 32-row chunks: one
    ``engine.prefill`` each, all inside the admission."""
    eng = _engine(params, prefix_cache=True)
    shared = list(range(1, 71))
    eng.submit(Request(uid=1, prompt=shared + [3], max_new_tokens=8))
    eng.step()
    eng.submit(Request(uid=2, prompt=shared + list(range(80, 120)), max_new_tokens=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    assert eng.stats()["prefix_hits"] == 1
    got = _ranges(prof)
    admit = [r for r in got if r[0] == "engine.admit"][0]
    passes = [r for r in got if r[0] == "engine.prefill"]
    assert len(passes) == len(eng.last_prefill) == 2  # rows [64, 96) and [96, 128)
    assert all(admit[1] <= s and e <= admit[2] for _, s, e in passes)


def test_spans_enter_no_record_function_with_the_profiler_off(params, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    for chunk in (0, 32):
        eng = _engine(params, chunk, prefix_cache=True)
        out = eng.run([Request(uid=u, prompt=list(range(1, 1 + 20 * u)), max_new_tokens=3) for u in (1, 2, 3)])
        assert len(out) == 3
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):  # the same helper, with a profiler recording
        with profiling.span("engine.x"):
            pass
    assert entered == ["engine.x"]


def test_queue_wait_and_ttft_count_from_arrival(params):
    """One slot: the second request waits in the queue until the first has
    retired.  ``arrival`` moves every time of a request back; None counts
    from ``submit()``."""
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=64, inner_steps=2))
    t0 = time.perf_counter()
    eng.submit(Request(uid=1, prompt=[1, 2, 3], max_new_tokens=4))
    eng.submit(Request(uid=2, prompt=[4, 5], max_new_tokens=4, arrival=t0 - 0.25))
    while eng.pending or any(r is not None for r in eng.slot_req):
        eng.step()
    wall = time.perf_counter() - t0
    a, b = sorted(eng.completions, key=lambda c: c.uid)
    assert 0.0 <= a.queue_s <= a.ttft_s <= a.total_s <= wall
    # b waited out a's whole service (a retires at the tick after its last token)
    assert b.queue_s >= a.total_s + 0.25 - 1e-3
    assert b.queue_s <= b.ttft_s <= b.total_s <= wall + 0.25
    assert eng.stats()["mean_ttft_s"] == pytest.approx((a.ttft_s + b.ttft_s) / 2)


@pytest.mark.parametrize("chunk", [0, 32])
def test_an_aborted_request_keeps_its_queue_wait(params, chunk):
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=128, inner_steps=2, prefill_chunk=chunk))
    now = time.perf_counter()
    eng.submit(Request(uid=1, prompt=list(range(1, 41)), max_new_tokens=4, arrival=now - 0.1))
    eng.submit(Request(uid=2, prompt=[4, 5], max_new_tokens=4, arrival=now - 0.3))
    eng.step()  # uid 1 admitted (mid-prefill when chunked); uid 2 queued
    assert eng.abort(2) and eng.abort(1)
    first, queued = {c.uid: c for c in eng.completions}[1], {c.uid: c for c in eng.completions}[2]
    assert queued.finish_reason == "abort" and queued.queue_s == pytest.approx(queued.total_s) and queued.total_s >= 0.3
    assert 0.1 <= first.queue_s < first.total_s  # its wait ended at admission


def _load_generator(eng, ecfg):
    spec = types.SimpleNamespace(traffic={"engine": {"max_len": ecfg.max_len, "prefill_chunk": ecfg.prefill_chunk,
                                                     "max_batch": ecfg.max_batch}})
    return Driver(eng, spec, None, 0.0, Request)


def _passes(eng):
    return [(rows, [(cached, real)]) for _, rows, cached, real in eng.last_prefill]


MIXES = {
    "whole": (dict(), [(1, 40, 3), (2, 5, 6), (3, 70, 2), (4, 33, 4), (5, 1, 3)]),
    "chunked": (dict(prefill_chunk=32), [(1, 40, 3), (2, 5, 6), (3, 100, 2), (4, 64, 4), (5, 1, 3)]),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_last_prefill_rebuilds_the_load_generators_ticks(params, mix):
    kw, lens = MIXES[mix]
    ecfg = EngineConfig(max_batch=2, max_len=128, inner_steps=2, **kw)
    eng = Engine(params, CFG, ecfg)
    d = _load_generator(eng, ecfg)
    for uid, lp, n in lens:
        d.submit(Req(uid=uid, prompt=[(uid * 7 + j) % CFG.vocab_size for j in range(lp)], n_out=n), clock())
    while d.inflight:
        d.tick()
        t = d.ticks[-1]
        assert sorted(t.prefill) == sorted(_passes(eng))
        assert t.prefill_tokens == sum(real for *_, real in eng.last_prefill)
    assert sum(t.prefill_tokens for t in d.ticks) == sum(lp for _, lp, _ in lens)


@pytest.mark.parametrize("chunk", [0, 32])
def test_last_prefill_follows_prefix_cache_hits(params, chunk):
    """A hit prefills only the suffix past the reused rows, in steps of the
    chunk (32 rows without chunking): the passes are the prompt's arithmetic,
    and over the run the passes' prompt tokens are the prompts less the
    reused rows."""
    ecfg = EngineConfig(max_batch=2, max_len=128, inner_steps=2, prefill_chunk=chunk, prefix_cache=True)
    eng = Engine(params, CFG, ecfg)
    shared = [(5 * j + 1) % CFG.vocab_size for j in range(70)]
    prompts = {1: shared + [3], 2: shared + list(range(80, 120)), 3: shared[:40] + [9, 9]}
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=20))
    seen = []
    for _ in range(3):  # uid 1 is in flight (chunked: its 3 chunks); then uid 2 forks it
        eng.step()
        seen += eng.last_prefill
    eng.submit(Request(uid=2, prompt=prompts[2], max_new_tokens=2))
    eng.submit(Request(uid=3, prompt=prompts[3], max_new_tokens=2))
    while eng.pending or eng._pf is not None or any(r is not None for r in eng.slot_req):
        eng.step()
        seen += eng.last_prefill
    st = eng.stats()
    assert st["prefix_hits"] >= 1
    assert sum(real for *_, real in seen) == sum(len(p) for p in prompts.values()) - st["prefix_tokens_reused"]
    grain = chunk or 32
    reuse = len(shared) // grain * grain  # 64: the donor holds the shared rows
    lp = len(prompts[2])
    lp_pad = (lp + 31) // 32 * 32
    want = [(2, min(lo + grain, lp_pad) - lo, lo, min(lp, lo + grain) - lo) for lo in range(reuse, lp, grain)]
    assert [p for p in seen if p[0] == 2] == want


def test_the_server_stamps_arrival_on_receipt(params):
    """A request that arrives while a tick runs reaches ``Engine.submit``
    only after that tick; its TTFT exceeds the one counted from
    ``submit()`` by that wait."""
    eng = Engine(params, CFG, EngineConfig(max_batch=2, max_len=64, inner_steps=2))
    in_tick, submitted, firsts = threading.Event(), {}, {}
    step, submit = eng.step, eng.submit

    def slow_step():
        if not in_tick.is_set():
            in_tick.set()
            time.sleep(0.4)
        return step()

    def timed_submit(req):
        submitted[req.uid] = time.perf_counter()
        submit(req)

    eng.step, eng.submit = slow_step, timed_submit
    srv = EngineServer(eng, port=0)
    on_token = eng.on_token

    def timed_on_token(uid, tok):
        firsts.setdefault(uid, time.perf_counter())
        on_token(uid, tok)

    eng.on_token = timed_on_token
    srv.start()
    try:
        def post(body):
            req = urllib.request.Request(f"http://{srv.host}:{srv.port}/v1/completions",
                                         data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        first = threading.Thread(target=post, args=({"prompt": [1, 2, 3], "max_tokens": 3},))
        first.start()
        assert in_tick.wait(timeout=30)
        got = post({"prompt": [4, 5, 6], "max_tokens": 3})
        first.join(timeout=60)
        assert not first.is_alive()
    finally:
        srv.stop()
    uid = got["uid"]
    from_submit = firsts[uid] - submitted[uid]
    assert got["ttft_s"] - from_submit >= 0.2  # most of the 0.4 s tick it arrived during
