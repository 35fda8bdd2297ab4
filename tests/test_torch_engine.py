"""The port's greedy continuous-batching engine (CPU, plain kernel versions).

Oracle, as in tests/test_serve.py: each request's engine output equals a
standalone greedy ``generate`` of the same prompt on the same params, with
more requests than slots (slot recycling) and mixed prompt lengths in flight
together.  One request is also held against the JAX package's ``generate``
on the same weights, carried across with convert/from_numpy.py.
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


@pytest.mark.parametrize("field,value", [("temperature", 0.7), ("prefill_chunk", 32), ("spec_tokens", 2),
                                         ("prefix_cache", True), ("kv_dtype", "float8_e4m3fn"),
                                         ("batch_buckets", True), ("logprobs", True)])
def test_unported_engine_features_raise(field, value):
    with pytest.raises(NotImplementedError):
        EngineConfig(**{field: value})


def test_submit_validation(params):
    eng = Engine(params, CFG, EngineConfig(max_batch=1, max_len=8))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=[]))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=2, prompt=list(range(8))))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(uid=3, prompt=[1], temperature=0.5))
