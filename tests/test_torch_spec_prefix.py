"""The port's speculative decoding and prefix cache against the JAX engine's (CPU).

Drafts: ``prompt_lookup_draft`` (batched over rows) equals JAX's on the five
cases of tests/test_spec.py:50-77 and on seeded random histories, exactly.
Verification: the rejection sampler emits each token with the filtered
distribution's probability (tests/test_spec.py:169-201).  Engines, on the
same weights (carried across with convert/from_numpy.py): the greedy
speculative engine gives the JAX speculative engine's tokens and the port's
plain engine's, its logprobs equal plain decode's and JAX's; donor search
(tests/test_prefix.py:41-56); prefix-cache and retired-prefix-store engines
give generate's tokens and, with chunked prefill, the JAX engine's; and the
store's LRU order
moves a covered prefix to the MRU end (ROADMAP R4: not the reference's
order).

Greedy tokens must be identical; logprobs of two port engines within 1e-4
(their verify rows go through the same plain matmuls in another batch
shape), of the port and JAX within twice the model tolerance on logits;
distributions as in tests/test_spec.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu.serve import Engine as JEngine, EngineConfig as JConfig, Request as JRequest
from torch_bnb_fp4_tpu.serve import prompt_lookup_draft as jax_draft
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request, prompt_lookup_draft
from torch_bnb_fp4_tpu_torch.serve.engine import filtered_logits, spec_verify

from test_torch_transformer import flatten_jax_params

CFG = T.ModelConfig.tiny_test(n_layers=1)
SYS = [7, 3, 9, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3,
       8, 4, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 0, 2]  # tests/test_prefix.py's 36-token "system prompt"


@pytest.fixture(scope="module")
def both():
    """(JAX params, port params) of the same tiny model."""
    jcfg = JT.ModelConfig.tiny_test(n_layers=1)
    jp = JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=9))
    return jp, params_from_numpy(*flatten_jax_params(jp), CFG, device="cpu")


def _oracle(params, prompt, n):
    return T.generate(params, CFG, torch.tensor([prompt], dtype=torch.int32), max_new_tokens=n)[0].tolist()


def _port_draft(seqs, k, n, width=32):
    hist = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        hist[i, : len(s)] = s
    hlen = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    return prompt_lookup_draft(torch.from_numpy(hist), hlen, k=k, n=n).tolist()


def _jax_draft(seq, k, n, width=32):
    hist = np.zeros(width, np.int32)
    hist[: len(seq)] = seq
    return np.asarray(jax_draft(jnp.asarray(hist), jnp.int32(len(seq)), k=k, n=n)).tolist()


@pytest.mark.parametrize("seq,k,n,want", [
    ([7, 8, 9, 1, 2, 5, 7, 8], 3, 2, [9, 1, 2]),  # continuation of the earlier gram
    ([3, 4, 5, 0, 3, 4, 6, 2, 3, 4], 1, 2, [5]),  # the earliest occurrence wins
    ([1, 2, 1, 2], 4, 2, [1, 2, 1, 2]),  # read cyclically with the occurrences' period
    ([1, 2, 3, 4, 5], 3, 2, None),  # no match: arbitrary ids from the row
    ([5], 2, 3, None),  # shorter than the gram
], ids=["continuation", "earliest", "cycle", "no_match", "short"])
def test_draft_cases_match_jax(seq, k, n, want):
    got = _port_draft([seq], k, n)[0]
    assert got == _jax_draft(seq, k, n)
    if want is not None:
        assert got == want
    assert len(got) == k and all(0 <= t < 32 for t in got)


def test_draft_batched_random_histories_match_jax():
    """Rows of one batch (different lengths, small alphabets so grams repeat)
    each equal JAX's single-row draft."""
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 4, rng.integers(1, 48)).tolist() for _ in range(64)]
    for k, n in ((4, 3), (3, 2), (1, 1)):
        got = _port_draft(seqs, k, n, width=48)
        assert got == [_jax_draft(s, k, n, width=48) for s in seqs]


def test_rejection_sampling_distribution():
    """tests/test_spec.py::test_rejection_sampling_distribution: with a
    deterministic proposal, the token emitted at each position follows the
    filtered distribution p, and the draft is accepted with probability p(d);
    greedy rows reduce to exact matching."""
    ecfg = EngineConfig(temperature=0.8, top_p=0.95, spec_tokens=2)
    v, b = 8, 4000
    row = torch.from_numpy(np.random.default_rng(0).standard_normal(v).astype(np.float32))
    logits = row.expand(b, 3, v)
    draft = torch.full((b, 2), 3, dtype=torch.int32)
    temp, tp = torch.full((b,), 0.8), torch.full((b,), 0.95)
    emitted, emit = spec_verify(ecfg, logits, draft, torch.Generator().manual_seed(1), temp, tp)
    f = filtered_logits(ecfg, row[None, :], temp[:1], tp[:1])[0].numpy()
    p = np.exp(f - f.max())
    p /= p.sum()
    first = emitted[:, 0].numpy()
    emp = np.bincount(first, minlength=v) / b
    assert np.abs(emp - p).sum() < 0.06, (emp, p)
    assert abs((first == 3).mean() - p[3]) < 0.03
    assert ((emit >= 1) & (emit <= 3)).all()
    emitted0, _ = spec_verify(ecfg, logits, draft, torch.Generator().manual_seed(2), torch.zeros(b), tp)
    am = int(torch.argmax(row))
    assert (emitted0[:, 0] == (3 if am == 3 else am)).all()


# prompts whose greedy decodes the two packages' models give alike: a near-tie between their logits (e.g.
# [4, 5] at its 6th token, top-2 margin 0.0026 of max|logit| 2.23) would be a model difference, not one of the
# engines compared here
SPEC_REQS = [([1, 2, 3, 1, 2], 9), ([5, 6], 12), ([6, 7, 8, 9], 5), ([2, 2, 2, 2, 2], 7), ([9, 1, 9, 1], 12),
             ([12, 13, 14], 14)]


SPEC_KW = dict(max_batch=2, max_len=48, inner_steps=1, spec_tokens=3, spec_ngram=2, logprobs=True)


@pytest.fixture(scope="module")
def jax_spec(both):
    """The JAX speculative engine's completions of SPEC_REQS (with logprobs;
    one verify forward per tick keeps its compiled programs few)."""
    jp, _ = both
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(SPEC_REQS)]
    return JEngine(jp, JT.ModelConfig.tiny_test(n_layers=1), JConfig(**SPEC_KW)).run(reqs)


def _reqs():
    return [Request(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(SPEC_REQS)]


def test_spec_engine_matches_jax_and_plain(both, jax_spec):
    """Greedy speculation is exact: the port's speculative engine gives the
    JAX speculative engine's tokens and its own plain engine's, through slot
    recycling; drafts get accepted (tokens per forward > 1)."""
    _, tp = both
    eng = Engine(tp, CFG, EngineConfig(**dict(SPEC_KW, inner_steps=4)))
    res = eng.run(_reqs())
    plain = Engine(tp, CFG, EngineConfig(max_batch=2, max_len=48, inner_steps=4)).run(_reqs())
    for i in range(len(SPEC_REQS)):
        assert res[i].tokens == jax_spec[i].tokens == plain[i].tokens, SPEC_REQS[i]
    assert eng.stats()["spec_tokens_per_forward"] > 1.0


def test_spec_logprobs_equal_plain_decode_and_jax(both, jax_spec):
    """The speculative path returns its own logprobs (log_softmax of the
    verify logits at each emitted token): equal to plain decode's (1e-4), and
    to the JAX speculative engine's within twice the model tolerance on
    logits (tests/test_torch_transformer.py: |dlogit| <= 2e-2 * max|logit|)."""
    _, tp = both
    spec = Engine(tp, CFG, EngineConfig(**SPEC_KW)).run(_reqs())
    plain = Engine(tp, CFG, EngineConfig(max_batch=2, max_len=48, logprobs=True)).run(_reqs())
    for i, (prompt, _) in enumerate(SPEC_REQS):
        s, p, j = spec[i], plain[i], jax_spec[i]
        assert s.tokens == p.tokens == j.tokens and len(s.logprobs) == len(s.tokens)
        np.testing.assert_allclose(s.logprobs, p.logprobs, atol=1e-4)
        top = max(lg.abs().max().item() for lg in _forced_logits(tp, prompt, s.tokens))
        np.testing.assert_allclose(s.logprobs, j.logprobs, atol=2 * 2e-2 * top)


def _forced_logits(params, prompt, tokens):
    """Last-position logits of eager batch-1 forwards fed ``tokens``."""
    cache = T.KVCache.zeros(CFG, 1, len(prompt) + len(tokens), device="cpu")
    toks, out = torch.tensor([prompt], dtype=torch.int32), []
    for t in tokens:
        lg, cache = T.forward(params, CFG, toks, cache, last_only=True)
        out.append(lg[0, -1])
        toks = torch.tensor([[t]], dtype=torch.int32)
    return out


def test_spec_near_capacity_falls_back(both):
    """tests/test_spec.py::test_spec_near_capacity_falls_back: a slot that
    cannot afford k+1 rows decodes on the plain path, still exact."""
    _, tp = both
    prompt = [1, 2, 3, 4, 5, 1, 2, 3, 4]
    res = Engine(tp, CFG, EngineConfig(max_batch=1, max_len=16, spec_tokens=6, spec_ngram=2)).run(
        [Request(uid=1, prompt=prompt, max_new_tokens=10)])
    assert res[1].tokens == _oracle(tp, prompt, 10)[: len(res[1].tokens)] and res[1].finish_reason == "length"


def test_donor_search_units(both):
    """tests/test_prefix.py::test_donor_search_units."""
    _, tp = both
    eng = Engine(tp, CFG, EngineConfig(max_batch=4, max_len=64, prefix_cache=True))
    eng.slot_req[1] = Request(uid=1, prompt=SYS + [11, 12])
    eng.slot_req[2] = Request(uid=2, prompt=SYS[:8])
    assert eng._find_prefix_donor(SYS + [13], 32) == (1, 32)
    assert eng._find_prefix_donor((SYS + [11, 12])[:33], 32) == (1, 32)
    assert eng._find_prefix_donor(SYS[:31] + [99], 32) is None
    assert eng._find_prefix_donor([99] * 40, 32) is None
    assert eng._find_prefix_donor(SYS + [13], 64) is None


PREFIX_CASES = {
    "live donors": (dict(max_batch=4, max_len=64, inner_steps=1, prefix_cache=True),
                    [[(SYS + [11, 12], 8), (SYS + [21, 22, 23], 8), (SYS[:34] + [31], 6), ([5, 6, 7], 5)]]),
    "chunked": (dict(max_batch=2, max_len=96, inner_steps=1, prefill_chunk=32, prefix_cache=True),
                [[(SYS + SYS[:8], 6), (SYS + [41, 42], 8)]]),
    "store, chunked": (dict(max_batch=2, max_len=96, inner_steps=1, prefill_chunk=32, prefix_cache=True,
                            prefix_store=2),
                       [[(SYS + [11, 12], 6)], [(SYS + SYS[:8], 6), (SYS + [41, 42], 5)]]),
}


@pytest.mark.parametrize("name", list(PREFIX_CASES))
def test_prefix_engines_match_jax(both, name):
    """Prefix caching forks KV instead of recomputing it: tokens equal the
    port's generate and, with chunked prefill, the JAX engine's (same
    config), whose hit counters the port's agree with; whole-prompt
    admission (suffix chunks of 32) forks live donors as
    tests/test_prefix.py's engine does (>= 2 hits, >= 64 tokens).  "store":
    the second wave's donors are retired requests held in the store rows.
    The prompts are ones whose greedy decodes the two packages' models give
    alike (SPEC_REQS)."""
    jp, tp = both
    kw, waves = PREFIX_CASES[name]
    jeng = JEngine(jp, JT.ModelConfig.tiny_test(n_layers=1), JConfig(**kw)) if kw.get("prefill_chunk") else None
    eng = Engine(tp, CFG, EngineConfig(**kw))
    uid = 0
    for wave in waves:
        reqs = []
        for prompt, n in wave:
            reqs.append(dict(uid=uid, prompt=prompt, max_new_tokens=n))
            uid += 1
        res = eng.run([Request(**r) for r in reqs])
        jres = jeng.run([JRequest(**r) for r in reqs]) if jeng is not None else None
        for r in reqs:
            assert res[r["uid"]].tokens == _oracle(tp, r["prompt"], r["max_new_tokens"]), r
            if jres is not None:
                assert res[r["uid"]].tokens == jres[r["uid"]].tokens, r
    st = eng.stats()
    if jeng is None:
        assert st["prefix_hits"] >= 2 and st["prefix_tokens_reused"] >= 64, st
        return
    jst = jeng.stats()
    assert st["prefix_hits"] == jst["prefix_hits"] >= 1
    assert st["prefix_tokens_reused"] == jst["prefix_tokens_reused"]
    assert st["prefix_store_entries"] == jst["prefix_store_entries"]


def test_store_lru_moves_a_covered_prefix_to_mru(both):
    """A retiring request whose cached tokens an entry already covers touches
    that entry (R4): with entries [A, B] (A least recent), a 32-token request
    inside A (too short to hit the cache: reuse is capped at len - 1) leaves
    [B, A], so the next new entry evicts B.  The reference keeps [A, B]."""
    _, tp = both
    eng = Engine(tp, CFG, EngineConfig(max_batch=1, max_len=96, prefix_cache=True, prefix_store=2))
    a = eng.run([Request(uid=0, prompt=SYS + [1, 2, 3], max_new_tokens=4)])[0]
    seq_a = SYS + [1, 2, 3] + a.tokens[:-1]
    b_prompt = [9, 8, 7] * 12
    b = eng.run([Request(uid=1, prompt=b_prompt, max_new_tokens=4)])[1]
    seq_b = b_prompt + b.tokens[:-1]
    assert [e["tokens"] for e in eng._store] == [seq_a, seq_b]
    hits = eng.stats()["prefix_hits"]
    eng.run([Request(uid=2, prompt=seq_a[:32], max_new_tokens=1)])
    assert eng.stats()["prefix_hits"] == hits  # no hit: the touch comes from the covered retirement
    assert [e["tokens"] for e in eng._store] == [seq_b, seq_a]
    c_prompt = [4, 4, 5] * 12
    eng.run([Request(uid=3, prompt=c_prompt, max_new_tokens=4)])
    assert [e["tokens"][:3] for e in eng._store] == [SYS[:3], c_prompt[:3]]  # B evicted, A kept
