"""The port's greedy continuous-batching engine (CPU, plain kernel versions).

Oracle, as in tests/test_serve.py: each request's engine output equals a
standalone greedy ``generate`` of the same prompt on the same params, with
more requests than slots (slot recycling) and mixed prompt lengths in flight
together.  One request is also held against the JAX package's ``generate``
on the same weights, carried across with convert/from_numpy.py.  Chunked
prefill interleaves with decoding and matches ``generate``; the ring engine
matches the full-cache engine (as tests/test_sliding.py:193-209).  ``submit``
rejects the sampling parameters a greedy engine cannot honour, and adapters,
with the JAX engine's exception type, and ``abort`` cancels a request
queued, between prefill chunks or decoding (as tests/test_serve.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

from test_torch_transformer import flatten_jax_params

CFG = T.ModelConfig.tiny_test(n_layers=1)


@pytest.fixture(scope="module")
def params():
    return T.quantize_params(CFG, T.random_weights(CFG, seed=9), fuse=True, device="cpu")


def _oracle(params, prompt, n):
    return T.generate(params, CFG, torch.tensor([prompt], dtype=torch.int32), max_new_tokens=n)[0].tolist()


def test_continuous_batching_slot_recycling(params):
    """4 requests through 2 slots, different lengths, all match generate."""
    eng = Engine(params, CFG, EngineConfig(max_batch=2, max_len=64))
    reqs = [
        Request(uid=1, prompt=[1, 2, 3], max_new_tokens=5),
        Request(uid=2, prompt=[4, 5], max_new_tokens=8),
        Request(uid=3, prompt=list(range(10, 50)), max_new_tokens=3),
        Request(uid=4, prompt=[1], max_new_tokens=4),
    ]
    res = eng.run(reqs)
    assert set(res) == {1, 2, 3, 4}
    for r in reqs:
        assert res[r.uid].tokens == _oracle(params, r.prompt, r.max_new_tokens), r.uid
        assert res[r.uid].finish_reason == "length"
    st = eng.stats()
    assert st["completions"] == 4 and st["tokens_out"] >= sum(r.max_new_tokens - 1 for r in reqs)
    assert st["active_slots"] == 0 and st["pending"] == 0 and st["mean_ttft_s"] > 0


def test_single_request_matches_jax_generate():
    jcfg = JT.ModelConfig.tiny_test(n_layers=1)
    jp = JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=9), fuse=True)
    arrays, meta = flatten_jax_params(jp)
    tp = params_from_numpy(arrays, meta, CFG, device="cpu")
    prompt = [7, 8, 9, 10, 11]
    want = np.asarray(JT.generate(jp, jcfg, jnp.asarray([prompt], jnp.int32), max_new_tokens=6))[0].tolist()
    res = Engine(tp, CFG, EngineConfig(max_batch=2, max_len=32, inner_steps=4)).run(
        [Request(uid=1, prompt=prompt, max_new_tokens=6)])
    assert res[1].tokens == want


def test_eos_and_stop_ids(params):
    probe = _oracle(params, [2, 3], 6)
    eng = Engine(params, CFG, EngineConfig(max_batch=2, max_len=32))
    res = eng.run([Request(uid=7, prompt=[2, 3], max_new_tokens=6, eos_id=probe[1]),
                   Request(uid=8, prompt=[2, 3], max_new_tokens=6, stop_ids=[9999, probe[2]])])
    assert res[7].finish_reason == "eos" and res[7].tokens == probe[: probe.index(probe[1]) + 1]
    assert res[8].finish_reason == "stop" and res[8].tokens == probe[: probe.index(probe[2]) + 1]


def test_capacity_limits_generation(params):
    """A prompt near max_len stops at the cache capacity with reason length."""
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=16))
    res = eng.run([Request(uid=1, prompt=list(range(1, 13)), max_new_tokens=50)])
    assert len(res[1].tokens) == 16 - 12 and res[1].finish_reason == "length"
    assert res[1].tokens == _oracle(params, list(range(1, 13)), 4)


def test_submit_validation(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=8))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=[]))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=2, prompt=list(range(8))))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=3, prompt=[1], temperature=0.5))


@pytest.fixture(scope="module")
def jax_engine():
    from torch_bnb_fp4_tpu.serve import Engine as JEngine, EngineConfig as JEngineConfig

    jcfg = JT.ModelConfig.tiny_test(n_layers=1)
    jp = JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=9), fuse=True)
    return JEngine(jp, jcfg, JEngineConfig(max_batch=1, max_len=8))


BAD_SAMPLING = [dict(temperature="hot"), dict(temperature=True), dict(temperature=-1.0),
                dict(temperature=float("nan")), dict(temperature=float("inf")), dict(temperature=0.5),
                dict(top_p=0.0), dict(top_p=1.5), dict(top_p=0.9), dict(top_p="x"), dict(top_p=False),
                dict(adapter="a")]


@pytest.mark.parametrize("bad", BAD_SAMPLING, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_submit_rejects_bad_sampling_as_jax_does(params, jax_engine, bad):
    """A greedy engine rejects per-request sampling and adapters it cannot
    honour with the JAX engine's exception type (ValueError): the HTTP
    server turns that into a 400 and keeps serving the other requests."""
    from torch_bnb_fp4_tpu.serve import Request as JRequest

    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=8))
    with pytest.raises(Exception) as want:
        jax_engine.submit(JRequest(uid=1, prompt=[1], **bad))
    with pytest.raises(Exception) as got:
        eng.submit(Request(uid=1, prompt=[1], **bad))
    assert got.type is want.type is ValueError
    assert not eng.pending


@pytest.mark.parametrize("ok", [dict(temperature=0), dict(temperature=0.0, top_p=1), dict(top_p=1.0)])
def test_submit_accepts_greedy_sampling_values(params, jax_engine, ok):
    from torch_bnb_fp4_tpu.serve import Request as JRequest

    jax_engine.submit(JRequest(uid=1, prompt=[1], **ok))
    jax_engine.pending.clear()
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=8))
    eng.submit(Request(uid=1, prompt=[1], **ok))
    assert len(eng.pending) == 1


def test_chunked_prefill_matches_generate_and_interleaves(params):
    """prefill_chunk=32: a 3-chunk prompt goes in one chunk per tick while an
    already-decoding request gains a token on every one of those ticks, and
    both completions equal generate (tests/test_serve.py:491-513)."""
    eng = Engine(params, CFG, EngineConfig(max_batch=2, max_len=128, inner_steps=1, prefill_chunk=32))
    eng.submit(Request(uid=1, prompt=[5, 6, 7], max_new_tokens=12))
    for _ in range(3):
        eng.step()
    n_before = len(eng.slot_tokens[0])
    long_prompt = list(range(1, 90))  # 89 tokens -> bucket 96 -> 3 chunks
    eng.submit(Request(uid=2, prompt=long_prompt, max_new_tokens=4))
    ticks = 0
    while eng._pf is not None or eng.pending:
        eng.step()
        ticks += 1
        assert len(eng.slot_tokens[0]) > n_before
        n_before = len(eng.slot_tokens[0])
        assert ticks < 20
    assert ticks == 3
    res = eng.run([])
    assert res[1].tokens == _oracle(params, [5, 6, 7], 12)
    assert res[2].tokens == _oracle(params, long_prompt, 4)


CFG_E = T.ModelConfig.tiny_test(sliding_window=32, n_layers=1)
ECFG_E = dict(max_batch=2, max_len=96, inner_steps=2, prefill_chunk=32)


def test_engine_ring_matches_full():
    params = T.quantize_params(CFG_E, T.random_weights(CFG_E, seed=11), fuse=True, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG_E.vocab_size, n).tolist() for n in (40, 61)]

    def serve(sliding_kv):
        eng = Engine(params, CFG_E, EngineConfig(sliding_kv=sliding_kv, **ECFG_E))
        assert [a.shape[1] for a in eng.cache.k] == ([64] if sliding_kv else [96])  # (ceil(32/32)+1)*32
        out = eng.run([Request(uid=i, prompt=p, max_new_tokens=20) for i, p in enumerate(prompts)])
        return [out[i].tokens for i in range(len(prompts))], eng.stats()["kv_cache_bytes"]

    (ring, ring_bytes), (full, full_bytes) = serve(True), serve(False)
    assert ring == full and ring_bytes * 3 == full_bytes * 2


def test_rings_need_chunked_prefill():
    """Whole-prompt writes are not ring-aligned: without prefill_chunk the
    engine keeps full caches whatever sliding_kv says."""
    params = T.quantize_params(CFG_E, T.random_weights(CFG_E, seed=11), fuse=True, device="cpu")
    assert Engine(params, CFG_E, EngineConfig(**dict(ECFG_E, prefill_chunk=0))).cache.min_rows == 96
    assert Engine(params, CFG_E, EngineConfig(**ECFG_E)).cache.min_rows == 64
    assert Engine(params, CFG, EngineConfig(**ECFG_E)).cache.min_rows == 96  # no sliding window


@pytest.mark.parametrize("chunk", [16, 33, 100, -32])
def test_prefill_chunk_must_be_a_multiple_of_32(chunk):
    with pytest.raises(ValueError, match="multiple of 32"):
        EngineConfig(prefill_chunk=chunk)


def test_abort(params):
    """tests/test_serve.py::test_abort: abort() cancels queued and decoding
    requests; unaffected requests stay equal to generate; unknown uids
    return False."""
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=32))
    eng.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=6))
    eng.submit(Request(uid=2, prompt=[3, 4], max_new_tokens=6))
    assert eng.abort(2)  # still queued -> empty completion
    eng.step()  # admits uid 1
    assert eng.abort(1)  # decoding -> keeps its tokens so far
    assert not eng.abort(99)
    eng.submit(Request(uid=3, prompt=[5, 6], max_new_tokens=4))
    while len(eng.completions) < 3:
        eng.step()
    res = {c.uid: c for c in eng.completions}
    assert res[2].finish_reason == "abort" and res[2].tokens == []
    assert res[1].finish_reason == "abort" and len(res[1].tokens) >= 1
    assert res[3].tokens == _oracle(params, [5, 6], 4) and res[3].logprobs is None
    assert eng.stats()["completions"] == 3 and eng.slot_req == [None]


def test_abort_mid_chunked_prefill(params):
    """A request aborted between two prefill chunks completes empty; its slot
    was never bound, and the next request is served as generate serves it."""
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=128, prefill_chunk=32))
    eng.submit(Request(uid=1, prompt=list(range(1, 90)), max_new_tokens=4))
    eng.step()  # first of three chunks
    assert eng._pf is not None and eng._pf["req"].uid == 1
    assert eng.abort(1) and eng._pf is None and eng.slot_req == [None]
    assert not eng.abort(1)
    res = eng.run([Request(uid=2, prompt=[7, 8, 9], max_new_tokens=5)])
    assert res[1].finish_reason == "abort" and res[1].tokens == [] and res[1].prompt_len == 89
    assert res[2].tokens == _oracle(params, [7, 8, 9], 5)


def test_submit_rejects_out_of_vocab_tokens(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=8))
    for bad in ([CFG.vocab_size], [-1]):
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(Request(uid=1, prompt=bad))
    assert not eng.pending
