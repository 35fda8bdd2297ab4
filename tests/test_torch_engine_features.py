"""The port's engine features (CPU): warmup, the static-buffer decode, batch
buckets, the admission budget, logprobs, the fp8 KV cache.

``warmup()`` runs every serving program first, and serving then adds none
(``traces`` flat; tests/test_serve.py:378-393, 469-490, 516-527).  The decode
function over the engine's static buffers, run eagerly, equals a plain loop
of ``T.forward`` and argmax on a copy of the same cache.  Batch buckets and
compaction, and the admission budget, keep every completion equal to
``generate`` (tests/test_serve.py:394-447).  Logprobs with chunked prefill
equal the JAX engine's.  The fp8 KV cache: the write cast against JAX's
``astype`` over all 65536 bf16 patterns (the same byte for |x| <= 464,
+-448 above, where JAX writes NaN: ROADMAP R6); the fp8 engine against the
JAX fp8 engine; K7's plain version with e4m3 K/V against the JAX kernel in
interpret mode; other dtype mixes refused.

Tolerances: greedy tokens identical; logprobs 1e-4 (f32 log_softmax of
logits that agree to the matmul tolerances); K7 as tests/test_torch_attention.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu.ops.attention import flash_attention as jax_flash
from torch_bnb_fp4_tpu.serve import Engine as JEngine, EngineConfig as JConfig, Request as JRequest
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import attention as A
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

from test_torch_attention import _case, _close_to_jax
from test_torch_transformer import flatten_jax_params

CFG = T.ModelConfig.tiny_test(n_layers=1)


@pytest.fixture(scope="module")
def params():
    return T.quantize_params(CFG, T.random_weights(CFG, seed=9), fuse=True, device="cpu")


@pytest.fixture(scope="module")
def both():
    """(JAX params, port params) of the same tiny model (unfused)."""
    jcfg = JT.ModelConfig.tiny_test(n_layers=1)
    jp = JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=9))
    return jp, params_from_numpy(*flatten_jax_params(jp), CFG, device="cpu")


def _oracle(params, prompt, n):
    return T.generate(params, CFG, torch.tensor([prompt], dtype=torch.int32), max_new_tokens=n)[0].tolist()


WARM_CASES = {
    "plain": (dict(max_batch=2, max_len=64, inner_steps=4), 40,
              [([5, 6, 7], 6), (list(range(1, 35)), 5)]),
    "batch buckets": (dict(max_batch=4, max_len=64, inner_steps=2, batch_buckets=True), 8,
                      [([u, u + 1], 3 * u) for u in (1, 2, 3, 4)]),
    "chunked": (dict(max_batch=2, max_len=96, inner_steps=2, prefill_chunk=32), 96,
                [(list(range(1, 70)), 5), ([3, 4], 5)]),
    "spec + logprobs": (dict(max_batch=2, max_len=48, inner_steps=4, spec_tokens=3, spec_ngram=2, logprobs=True), 8,
                        [([1, 2, 3], 8), ([4, 5, 6, 7], 6)]),
    "prefix": (dict(max_batch=2, max_len=64, inner_steps=2, prefix_cache=True), 40,
               [([7, 3, 9, 1] * 9 + [11], 5), ([7, 3, 9, 1] * 9 + [22, 23], 5)]),
}


@pytest.mark.parametrize("name", list(WARM_CASES))
def test_warmup_leaves_traces_flat(params, name):
    """After warmup() no served request runs a program for the first time;
    completions stay equal to generate."""
    kw, max_prompt, reqs = WARM_CASES[name]
    eng = Engine(params, CFG, EngineConfig(**kw))
    warm = eng.warmup(max_prompt_len=max_prompt)
    assert warm["decode"] >= 2 and warm["prefill"] >= 1
    if kw.get("prefix_cache"):
        assert warm["fork"] >= 1
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)])
    assert eng.traces == warm, (warm, eng.traces)
    for i, (p, n) in enumerate(reqs):
        assert res[i].tokens == _oracle(params, p, n), i


def test_warmup_rejects_mid_serving(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=2, max_len=32))
    eng.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=4))
    eng.step()
    with pytest.raises(RuntimeError):
        eng.warmup(max_prompt_len=8)


def test_static_decode_function_equals_plain_loop(params):
    """The decode program (reads the static tokens, mask and cache; writes
    tokens and lengths in place), run eagerly, against T.forward + argmax on a
    copy of the cache with idle slots at length 0."""
    eng = Engine(params, CFG, EngineConfig(max_batch=3, max_len=32, inner_steps=4, logprobs=True))
    for slot, prompt in ((0, [5, 6, 7]), (2, [9, 8, 7, 6, 5])):
        lp_pad = eng._bucket(len(prompt))
        toks = torch.zeros((1, lp_pad), dtype=torch.int32)
        toks[0, : len(prompt)] = torch.tensor(prompt)
        first, _ = eng._prefill_fn(toks, slot, len(prompt), torch.zeros(1), torch.ones(1))
        eng._tok[slot] = first
    eng._active.copy_(torch.tensor([True, False, True]))
    ref = T.KVCache(k=[a.clone() for a in eng.cache.k], v=[a.clone() for a in eng.cache.v],
                    length=torch.where(eng._active, eng.cache.length, 0))
    tok, want, want_lp = eng._tok.clone(), [], []
    for _ in range(4):
        logits, ref = T.forward(params, CFG, tok[:, None], ref)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        want.append(tok)
        want_lp.append(torch.log_softmax(logits[:, -1].float(), -1).gather(1, tok[:, None].long())[:, 0])
    eng._decode_fn(3, 4)
    assert torch.equal(eng._out_tok[:4], torch.stack(want))
    torch.testing.assert_close(eng._out_lp[:4], torch.stack(want_lp), rtol=0, atol=0)
    assert torch.equal(eng.cache.length, ref.length)
    for a, b in zip(eng.cache.k + eng.cache.v, ref.k + ref.v):
        assert torch.equal(a[[0, 2]], b[[0, 2]])


def test_batch_buckets_single_request_runs_small(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=8, max_len=32, batch_buckets=True))
    res = eng.run([Request(uid=1, prompt=[5, 6, 7], max_new_tokens=6)])
    assert res[1].tokens == _oracle(params, [5, 6, 7], 6) and eng.stats()["decode_batch"] == 1


def test_batch_buckets_compaction_shrinks(params):
    """Four slots; when the three low slots retire, the high one moves down
    (one KV row copy per layer) and decodes at batch 1, still exact."""
    eng = Engine(params, CFG, EngineConfig(max_batch=4, max_len=64, inner_steps=1, batch_buckets=True))
    short = [Request(uid=u, prompt=[u, u + 1], max_new_tokens=2) for u in (1, 2, 3)]
    long = Request(uid=9, prompt=[7, 8, 9], max_new_tokens=12)
    for r in short + [long]:
        eng.submit(r)
    seen = set()
    while eng.pending or any(r is not None for r in eng.slot_req):
        eng.step()
        seen.add(eng.stats()["decode_batch"])
    assert 4 in seen and 1 in seen, seen
    res = {c.uid: c for c in eng.completions}
    for r in short + [long]:
        assert res[r.uid].tokens == _oracle(params, r.prompt, r.max_new_tokens), r.uid


def test_admit_budget_bounds_per_tick_prefills(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=4, max_len=32, admit_budget=1, inner_steps=1))
    reqs = [Request(uid=u, prompt=[u, u + 1], max_new_tokens=6) for u in (1, 2, 3)]
    for r in reqs:
        eng.submit(r)
    assert eng.step() == 1 and eng.step() == 2
    res = eng.run([])
    for r in reqs:
        assert res[r.uid].tokens == _oracle(params, r.prompt, r.max_new_tokens), r.uid


def test_logprobs_with_chunked_prefill_match_jax(both):
    """Chunked prefill (the first token's logprob from the last chunk) and
    decode logprobs: tokens equal the JAX engine's; each logprob equals
    log_softmax of the port's own eager forward at that token (1e-4: the
    engine's chunked prefill sums in other orders), and the JAX engine's
    within twice the model tolerance on logits (tests/test_torch_transformer.py:
    |dlogit| <= 2e-2 * max|logit|; a log_softmax moves by at most twice the
    largest logit change)."""
    jp, tp = both
    kw = dict(max_batch=2, max_len=96, inner_steps=1, prefill_chunk=32, logprobs=True)
    reqs = [dict(uid=1, prompt=list(range(1, 70)), max_new_tokens=6), dict(uid=2, prompt=[5, 6], max_new_tokens=8)]
    jres = JEngine(jp, JT.ModelConfig.tiny_test(n_layers=1), JConfig(**kw)).run([JRequest(**r) for r in reqs])
    res = Engine(tp, CFG, EngineConfig(**kw)).run([Request(**r) for r in reqs])
    for r in reqs:
        got, want = res[r["uid"]], jres[r["uid"]]
        assert got.tokens == want.tokens and len(got.logprobs) == len(got.tokens) and max(got.logprobs) <= 0
        cache = T.KVCache.zeros(CFG, 1, len(r["prompt"]) + len(got.tokens), device="cpu")
        toks, own, top = torch.tensor([r["prompt"]], dtype=torch.int32), [], 0.0
        for t in got.tokens:
            lg, cache = T.forward(tp, CFG, toks, cache, last_only=True)
            own.append(torch.log_softmax(lg[0, -1], -1)[t].item())
            top = max(top, lg.abs().max().item())
            toks = torch.tensor([[t]], dtype=torch.int32)
        np.testing.assert_allclose(got.logprobs, own, atol=1e-4)
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=2 * 2e-2 * top)


def test_kv_cast_matches_jax_astype():
    """Every bf16 bit pattern: the same e4m3 byte as JAX's astype for |x| <=
    464, +-448 above (JAX: NaN), NaN for NaN."""
    bits = np.arange(65536, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = T.kv_cast(x, torch.float8_e4m3fn)
    want = np.asarray(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(jnp.float8_e4m3fn)).view(np.uint8)
    xf = x.float().numpy()
    small = np.abs(xf) <= 464
    np.testing.assert_array_equal(got.view(torch.uint8).numpy()[small], want[small])
    big = np.abs(xf) > 464
    assert big.sum() > 30000
    np.testing.assert_array_equal(got.float().numpy()[big], np.sign(xf[big]) * 448)
    assert np.isnan(got.float().numpy()[np.isnan(xf)]).all()
    assert T.kv_cast(x, torch.bfloat16) is x


@pytest.mark.parametrize("extra,prompt", [({}, [1, 2, 3, 1, 2]), (dict(prefill_chunk=32), list(range(1, 40)))],
                         ids=["whole", "chunked"])
def test_fp8_engine_matches_jax_fp8_engine(both, extra, prompt):
    """kv_dtype float8_e4m3fn: the cache (and every small prefill cache)
    stores one byte per element, and the greedy tokens equal the JAX fp8
    engine's, with whole-prompt and chunked prefill."""
    jp, tp = both
    kw = dict(max_batch=2, max_len=96, inner_steps=1, kv_dtype="float8_e4m3fn", **extra)
    req = dict(uid=1, prompt=prompt, max_new_tokens=9)
    jeng = JEngine(jp, JT.ModelConfig.tiny_test(n_layers=1), JConfig(**kw))
    want = jeng.run([JRequest(**req)])[1].tokens
    eng = Engine(tp, CFG, EngineConfig(**kw))
    assert eng.run([Request(**req)])[1].tokens == want
    assert all(a.dtype == torch.float8_e4m3fn for a in eng.cache.k + eng.cache.v)
    assert eng.stats()["kv_cache_bytes"] == jeng.stats()["kv_cache_bytes"]


@pytest.mark.parametrize("name", ["causal", "long_cache", "window_softcap", "ring", "unaligned"])
def test_flash_plain_fp8_kv_matches_jax_kernel(name):
    """K7's plain version with a bf16 q over e4m3 K/V (the bytes kv_cast and
    JAX's astype agree on) against the JAX kernel in interpret mode, whose
    p.astype(v.dtype) rounds p to e4m3 too."""
    a, o = _case(name)
    q = torch.from_numpy(a["q"]).to(torch.bfloat16)
    k, v = (T.kv_cast(torch.from_numpy(a[n]).to(torch.bfloat16), torch.float8_e4m3fn) for n in ("k", "v"))
    pos = (torch.from_numpy(a["qpos"]), torch.from_numpy(a["valid"]), torch.from_numpy(a["kpos"]))
    got = A.flash_attention(q, k, v, *pos, o["window"], o["scale"], o["softcap"], block_q=o["block_q"],
                            block_k=o["block_k"]).float().numpy()
    jq = jnp.asarray(a["q"], jnp.bfloat16)
    jk, jv = (jnp.asarray(a[n], jnp.bfloat16).astype(jnp.float8_e4m3fn) for n in ("k", "v"))
    np.testing.assert_array_equal(np.asarray(jk).view(np.uint8), k.view(torch.uint8).numpy())
    want = np.asarray(jax_flash(jq, jk, jv, jnp.asarray(a["qpos"]), jnp.asarray(a["valid"]), jnp.asarray(a["kpos"]),
                                o["window"], o["scale"], o["softcap"], block_q=o["block_q"], block_k=o["block_k"],
                                interpret=True), np.float32)
    _close_to_jax(got, want)


def test_flash_refuses_other_dtype_mixes():
    a, _ = _case("causal")
    q = torch.from_numpy(a["q"]).to(torch.bfloat16)
    k = torch.from_numpy(a["k"]).to(torch.bfloat16)
    pos = (torch.from_numpy(a["qpos"]), torch.from_numpy(a["valid"]), torch.from_numpy(a["kpos"]))
    k8 = T.kv_cast(k, torch.float8_e4m3fn)
    for qq, kk, vv in ((q, k, k8), (q, k8, k), (q.float(), k8, k8), (q.half(), k8, k8),
                       (q, k.to(torch.float8_e5m2), k.to(torch.float8_e5m2))):
        with pytest.raises(ValueError, match="share one float dtype"):
            A.flash_attention(qq, kk, vv, *pos)

