"""The port's sampling and logprobs against the JAX engine's (CPU).

``filtered_logits``, ``select`` and ``logprob_of`` (serve/engine.py) against
JAX's ``Engine._filtered_logits`` and ``Engine._lp_of`` on the same seeded
random logits (made with numpy), for top-k, top-p, min-p, their mixes, and
per-row temperature and top_p; greedy and temperature-0 rows take the argmax;
draws are seeded; and the distribution a draw follows is the filtered one
(the cases of tests/test_serve.py:309-377, plus an empirical check over many
draws).

Tolerances: the kept sets are equal, except in a row where a token's
exclusive cumulative mass lies within 1e-6 of top_p (the two sorts and
cumulative sums round differently there); kept values and logprobs agree
within 1e-5 (both divide in f32; the softmax and log_softmax sums differ in
order).  Distributions: L1 distance to the target under 0.03 with 20000
draws (the expected L1 of an exact sampler is about 0.01 there).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.serve import Engine as JEngine, EngineConfig as JConfig
from torch_bnb_fp4_tpu_torch.serve import EngineConfig
from torch_bnb_fp4_tpu_torch.serve.engine import categorical, filtered_logits, logprob_of, select

FILTERS = {
    "top_k": dict(top_k=20),
    "top_p": dict(top_p=0.9),
    "min_p": dict(min_p=0.05),
    "top_k+top_p": dict(top_k=40, top_p=0.8),
    "top_p+min_p": dict(top_p=0.95, min_p=0.1),
    "all": dict(top_k=50, top_p=0.9, min_p=0.05),
}


def _logits(seed, b=16, v=512, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, v)) * scale).astype(np.float32)


def _jax_filtered(kw, logits, temp=None, top_p=None):
    stub = SimpleNamespace(ecfg=JConfig(temperature=0.7, **kw))
    t = None if temp is None else jnp.asarray(temp)
    p = None if top_p is None else jnp.asarray(top_p)
    return np.asarray(JEngine._filtered_logits(stub, jnp.asarray(logits), t, p))


def _boundary_rows(want, top_p):
    """Rows where some token's exclusive cumulative mass (sorted descending,
    from JAX's filtered logits before top-p) lies within 1e-6 of top_p."""
    out = set()
    for i, row in enumerate(want):
        p = np.exp(row - row.max())
        p = np.sort(p / p.sum())[::-1]
        excl = np.cumsum(p) - p
        if np.any(np.abs(excl - top_p[i]) < 1e-6):
            out.add(i)
    return out


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("per_row", [False, True], ids=["engine", "per_row"])
def test_filtered_logits_match_jax(name, per_row):
    kw = FILTERS[name]
    logits = _logits(list(FILTERS).index(name))
    b = logits.shape[0]
    rng = np.random.default_rng(7)
    temp = rng.uniform(0.3, 1.5, b).astype(np.float32) if per_row else None
    top_p = rng.uniform(0.5, 0.99, b).astype(np.float32) if per_row and "top_p" in kw else None
    want = _jax_filtered(kw, logits, temp, top_p)
    ecfg = EngineConfig(temperature=0.7, **kw)
    got = filtered_logits(ecfg, torch.from_numpy(logits), None if temp is None else torch.from_numpy(temp),
                          None if top_p is None else torch.from_numpy(top_p)).numpy()
    tp = np.full(b, kw.get("top_p", 1.0), np.float32) if top_p is None else top_p
    skip = _boundary_rows(want, tp) if "top_p" in kw else set()
    assert len(skip) <= 1
    for i in range(b):
        if i in skip:
            continue
        kept = np.isfinite(want[i])
        np.testing.assert_array_equal(np.isfinite(got[i]), kept, err_msg=f"row {i}")
        assert 0 < kept.sum() < logits.shape[1] or name == "min_p"
        np.testing.assert_allclose(got[i][kept], want[i][kept], rtol=1e-5, atol=1e-5)


def test_logprobs_match_jax():
    logits = _logits(3, b=8, v=1000)
    tok = np.random.default_rng(4).integers(0, 1000, 8).astype(np.int32)
    want = np.asarray(JEngine._lp_of(None, jnp.asarray(logits), jnp.asarray(tok)))
    got = logprob_of(torch.from_numpy(logits), torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got <= 0).all()


def test_greedy_and_temperature_zero_rows_are_argmax():
    logits = torch.from_numpy(_logits(5))
    argmax = torch.argmax(logits, dim=-1).to(torch.int32)
    # a greedy engine never draws (no generator needed)
    assert torch.equal(select(EngineConfig(), logits, None), argmax)
    ecfg = EngineConfig(temperature=1.0, top_p=0.9)
    temp = torch.tensor([0.0, 1.0] * 8)
    gen = torch.Generator().manual_seed(0)
    got = select(ecfg, logits, gen, temp, torch.full((16,), 0.9))
    assert torch.equal(got[temp == 0], argmax[temp == 0])
    # JAX's greedy rows agree
    stub = SimpleNamespace(ecfg=JConfig(temperature=1.0, top_p=0.9))
    jgot = np.asarray(JEngine._select(stub, jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                                      jnp.asarray(temp.numpy()), jnp.full((16,), 0.9)))
    np.testing.assert_array_equal(jgot[temp.numpy() == 0], argmax.numpy()[temp.numpy() == 0])


def test_draws_are_seeded():
    logits = torch.from_numpy(_logits(6))
    ecfg = EngineConfig(temperature=1.0, top_k=100)

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([select(ecfg, logits, gen) for _ in range(4)])

    assert torch.equal(draws(1), draws(1))
    assert not torch.equal(draws(1), draws(2))


def test_top_p_nucleus_restricts_candidates():
    """tests/test_serve.py::test_top_p_nucleus_restricts_candidates: probs
    (.5, .3, .15, .05) with top_p 0.6 sample only {0, 1}; top_p -> 0 is
    greedy."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    gen = torch.Generator().manual_seed(0)
    seen = {int(select(EngineConfig(temperature=1.0, top_p=0.6), logits, gen)[0]) for _ in range(64)}
    assert seen == {0, 1}
    assert {int(select(EngineConfig(temperature=1.0, top_p=0.01), logits, gen)[0]) for _ in range(8)} == {0}


@pytest.mark.parametrize("kw,want", [(dict(min_p=0.4), {0, 1}), (dict(min_p=0.9), {0}),
                                     (dict(top_p=0.9, min_p=0.35), {0, 1}), (dict(top_p=0.9, min_p=0.1), {0, 1, 2})])
def test_min_p_relative_floor(kw, want):
    """tests/test_serve.py::test_min_p_relative_floor: the floor applies after
    top-p, to the renormalized distribution."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    gen = torch.Generator().manual_seed(1)
    ecfg = EngineConfig(temperature=1.0, **kw)
    assert {int(select(ecfg, logits, gen)[0]) for _ in range(64)} == want


def test_categorical_follows_the_softmax():
    p = np.array([0.4, 0.25, 0.15, 0.1, 0.05, 0.03, 0.015, 0.005])
    logits = torch.log(torch.from_numpy(p).float()).expand(20000, 8)
    got = categorical(logits, torch.Generator().manual_seed(3)).numpy()
    emp = np.bincount(got, minlength=8) / got.size
    assert np.abs(emp - p).sum() < 0.03, emp


def test_select_follows_the_filtered_distribution():
    """Many draws from one row follow softmax of JAX's filtered logits for
    the same row (temperature 0.8, top_k 5, top_p 0.9, min_p 0.02)."""
    row = _logits(8, b=1, v=16, scale=1.5)
    kw = dict(top_k=5, top_p=0.9, min_p=0.02)
    want = _jax_filtered(kw, row, np.asarray([0.8], np.float32))[0]
    p = np.exp(want - want.max())
    p /= p.sum()
    ecfg = EngineConfig(temperature=0.8, **kw)
    got = select(ecfg, torch.from_numpy(row).expand(20000, 16), torch.Generator().manual_seed(4),
                 torch.full((20000,), 0.8), torch.full((20000,), 0.9)).numpy()
    emp = np.bincount(got, minlength=16) / got.size
    assert set(np.nonzero(emp)[0]) <= set(np.nonzero(p)[0])
    assert np.abs(emp - p).sum() < 0.03, (emp, p)


@pytest.mark.parametrize("bad,match", [(dict(top_p=0.0), "top_p"), (dict(top_p=1.5), "top_p"),
                                       (dict(temperature=-1.0), "temperature"), (dict(top_k=-1), "top_k"),
                                       (dict(min_p=1.0), "min_p"), (dict(kv_dtype="int8"), "kv_dtype")])
def test_engine_config_rejects_bad_sampling(bad, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(**bad)
