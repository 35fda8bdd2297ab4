"""K10 (decode attention, ``ops/attention.py::decode_attention``) on the CPU:
its plain version against the dense route, slot isolation, the route that
sends a one-row query to it, its operand checks, and the decoder and engine
built on it against the JAX package.

Tolerances:
* plain vs dense, f32 q: |d| <= 1e-5 * max|o|.  Both compute the same f32
  scores and softmax; only the order of the f32 sums (over up to 1100 keys,
  and over the key ranges) and the place of the division differ, each
  worth a few f32 ulps (2^-24 relative) of terms of the size of |v| <= ~5.
* plain vs dense, bf16 q and output: at most one bf16 ulp of the largest
  |o| of the element's (slot, head) row (the same f32 results, rounded to
  bf16, may land on either side of a rounding boundary; an element that is
  small by cancellation carries the f32 noise of its row's terms, so its own
  ulp is no measure).
* rows at or past a slot's live bound never read: poisoning them, or changing
  another slot, leaves an output bit-identical.
* model logits vs the JAX package: |dlogit| <= 2e-2 * max|logit| (the
  tolerance of tests/test_torch_transformer.py, for the same reasons).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import attention as A
from torch_bnb_fp4_tpu_torch.ops import kernels as K
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request

from test_torch_transformer import flatten_jax_params

HK = 2
ROWS = 1100  # > the longest range: every RANGE_ROWS cuts it into 2-5 ranges
RING_ROWS, RING_TOTAL, RING_WINDOW = 1088, 2500, 1000


def _layout(name):
    """(lens, window): the positions each slot's cache has seen.  ``linear``:
    never wrapped, lengths 1 (an idle slot), partial and exactly ``ROWS``;
    ``ring``: every slot wrapped past its rows, under a sliding window."""
    if name == "linear":
        return [1, 700, ROWS], None, ROWS
    return [RING_TOTAL, RING_TOTAL + 37, RING_ROWS + 5], RING_WINDOW, RING_ROWS


def _operands(g, d, kv_dtype, layout, seed=0, q_dtype=torch.float32):
    """q (B, 1, G * HK, D), k, v (B, rows, HK, D) and their DecodeKeys: the
    query at each slot's last position."""
    lens, window, rows = _layout(layout)
    gen = torch.Generator().manual_seed(seed)
    b = len(lens)
    q = torch.randn((b, 1, g * HK, d), generator=gen).to(q_dtype)
    k, v = (T.kv_cast(torch.randn((b, rows, HK, d), generator=gen), kv_dtype) for _ in range(2))
    new_len = torch.tensor(lens, dtype=torch.int32)
    kpos, valid = T.kv_slot_positions(new_len, rows)
    qpos = (new_len - 1)[:, None]
    return q, k, v, (qpos, kpos, valid), window


def _dense(q, k, v, pos, window, scale, cap):
    qpos, kpos, valid = pos
    blocked = ~T.attention_mask(qpos, kpos, valid, window)
    return T._attention_dense(q, k, v, blocked, scale, cap)


def _plain(q, k, v, pos, window, scale, cap, range_rows=None):
    qpos, kpos, valid = pos
    return A.decode_attention_plain(q, k, v, A.decode_keys(qpos, valid, kpos), window, scale, cap,
                                    range_rows=range_rows)


def _row_ulp_bf16(o):
    """One bf16 ulp (2^(e - 7) for |x| in [2^e, 2^(e+1))) of the largest |o|
    of each (slot, head) row of o (B, 1, Hq, D)."""
    return torch.exp2(torch.floor(torch.log2(o.abs().amax(-1, keepdim=True).clamp(min=2.0**-126))) - 7)


OPTIONS = {"plain": (None, None), "softcap_scale": (1.0 / 10.0, 20.0)}


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn], ids=["bf16", "e4m3"])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 4, 7, 8])
def test_plain_matches_dense(g, d, kv_dtype):
    """Every layout, option and range count the wrapper can pick, against
    the dense route (f32 q: the algorithm, at f32 precision)."""
    for layout in ("linear", "ring"):
        q, k, v, pos, window = _operands(g, d, kv_dtype, layout, seed=g * d)
        for scale, cap in OPTIONS.values():
            want = _dense(q, k, v, pos, window, scale, cap)
            lim = 1e-5 * want.abs().max().item()
            for r in (None, *A.RANGE_ROWS):
                got = _plain(q, k, v, pos, window, scale, cap, r)
                assert got.dtype == torch.float32 and torch.isfinite(got).all()
                err = (got - want).abs().max().item()
                assert err <= lim, (layout, scale, cap, r, err, lim)


@pytest.fixture
def one_thread():
    """One CPU thread for a test of equal bits: with more, the BLAS may split
    a reduction over however many threads it finds free, and so sum in
    another order from one call to the next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["linear", "ring"])
def test_plain_in_one_range_is_the_dense_route(one_thread, layout, q_dtype):
    """In one range (the CPU route) the plain version runs the dense route's
    own ops on the rows it reads: the same bits, so a one-row decode and a
    speculative verify of the same tokens still agree."""
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, layout, seed=4, q_dtype=q_dtype)
    for scale, cap in OPTIONS.values():
        assert torch.equal(_plain(q, k, v, pos, window, scale, cap), _dense(q, k, v, pos, window, scale, cap))


@pytest.mark.parametrize("layout", ["linear", "ring"])
def test_plain_bf16_within_one_ulp_of_dense(layout):
    """The port's dtypes (bf16 q and output, bf16 K/V), Mistral's heads."""
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, layout, seed=3, q_dtype=torch.bfloat16)
    want = _dense(q, k, v, pos, window, None, None).float()
    for r in (None, *A.RANGE_ROWS):
        got = _plain(q, k, v, pos, window, None, None, r)
        assert got.dtype == torch.bfloat16
        assert ((got.float() - want).abs() <= _row_ulp_bf16(want)).all(), r


@pytest.mark.parametrize("poison", [float("nan"), 1e30, float("inf")], ids=["nan", "1e30", "inf"])
def test_rows_past_length_are_never_read(one_thread, poison):
    """Every K/V row at or past a slot's length holds ``poison``: the output
    stays finite and bit-identical, in every range split."""
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, "linear", seed=5, q_dtype=torch.bfloat16)
    lens = _layout("linear")[0]
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lens):
        kp[i, n:] = poison
        vp[i, n:] = poison
    for r in (None, *A.RANGE_ROWS):
        clean = _plain(q, k, v, pos, window, None, None, r)
        got = _plain(q, kp, vp, pos, window, None, None, r)
        assert torch.isfinite(got).all() and torch.equal(got, clean), r


@pytest.mark.parametrize("layout", ["linear", "ring"])
def test_other_slots_do_not_move(one_thread, layout):
    """Slot 0's K/V altered inside its live rows: only slot 0's output moves."""
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, layout, seed=6, q_dtype=torch.bfloat16)
    n0 = min(_layout(layout)[0][0], k.shape[1])
    k2, v2 = k.clone(), v.clone()
    k2[0, :n0] = -k2[0, :n0]
    v2[0, :n0] = 2 * v2[0, :n0] + 1
    for r in (None, *A.RANGE_ROWS):
        before = _plain(q, k, v, pos, window, None, None, r)
        after = _plain(q, k2, v2, pos, window, None, None, r)
        assert torch.equal(after[1:], before[1:]) and not torch.equal(after[0], before[0]), r


def test_cpu_call_launches_nothing():
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, "linear", q_dtype=torch.bfloat16)
    qpos, kpos, valid = pos
    before = K.launch_counts()
    got = A.decode_attention(q, k, v, A.decode_keys(qpos, valid, kpos), window)
    assert K.launch_counts() == before
    torch.testing.assert_close(got, _plain(q, k, v, pos, window, None, None), rtol=0, atol=0)


def test_decode_keys():
    """Key positions padded to the kernel's tile with KEY_NONE where a row
    holds nothing; live = 1 + the last valid row, at least 1."""
    new_len = torch.tensor([1, 70, 200, 0], dtype=torch.int32)
    kpos, valid = T.kv_slot_positions(new_len, 130)
    keys = A.decode_keys((new_len - 1)[:, None], valid, kpos)
    assert keys.key_positions.shape == (4, 192) and keys.live.tolist() == [1, 70, 130, 1]
    assert keys.q_positions.tolist() == [0, 69, 199, -1]
    assert (keys.key_positions[:, 130:] == A.KEY_NONE).all()
    assert torch.equal(keys.key_positions[:, :130], torch.where(valid, kpos, A.KEY_NONE))


@pytest.mark.parametrize("b,rows,hk,want", [(32, 3072, 8, 512), (4, 4352, 8, 256), (1, 8192, 8, 256),
                                             (64, 3072, 8, 1024), (1, 64, 8, 256)])
def test_range_rows_follow_the_shape(b, rows, hk, want):
    """From (B, rows, Hk, SMs) alone, on a 132-SM card: the chat cell's 32 x
    3072 rows, longdoc's 4 x 4352-row rings, a batch-1 8192-row cache, 64
    slots, a cache shorter than one range."""
    assert A.decode_range_rows(b, rows, hk, 132) == want
    assert b * hk * -(-rows // want) >= A.DECODE_BLOCKS_PER_SM * 132 or want == min(A.RANGE_ROWS)


# -- the route --------------------------------------------------------------------------------------


def _count_routes(monkeypatch, cfg, prompt_len=5, steps=2, kv_dtype=torch.bfloat16):
    """(decode_attention calls, dense calls) of a prefill and ``steps`` decode
    steps over a ``kv_dtype`` cache."""
    calls = {"decode": 0, "dense": 0}
    dec, dense = T.decode_attention, T._attention_dense

    def counted_dec(*a, **kw):
        calls["decode"] += 1
        return dec(*a, **kw)

    def counted_dense(*a, **kw):
        calls["dense"] += 1
        return dense(*a, **kw)

    monkeypatch.setattr(T, "decode_attention", counted_dec)
    monkeypatch.setattr(T, "_attention_dense", counted_dense)
    params = T.quantize_params(cfg, T.random_weights(cfg, seed=1), fuse=True, device="cpu")
    cache = T.KVCache.zeros(cfg, 2, 16, dtype=kv_dtype, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, prompt_len), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    logits, cache = T.prefill(params, cfg, tokens, cache)
    prefill_calls = dict(calls)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(steps):
        tok, cache = T.decode_step(params, cfg, tok, cache)
    return prefill_calls, {k: calls[k] - prefill_calls[k] for k in calls}


@pytest.mark.parametrize("name,kw,to_k10", [
    ("mistral_like_d128", dict(sliding_window=8), True),
    ("tinyllama_like_d64_g8", dict(n_heads=16, n_kv_heads=2), True),
    ("gemma2_like_d256", dict(dim=512, n_heads=2, n_kv_heads=1, attn_logit_softcap=50.0,
                              query_pre_attn_scalar=256.0, alt_sliding=True, sliding_window=4), True),
    ("phi3_like_d96", dict(dim=768, n_heads=8, n_kv_heads=8), False),
    ("group_16", dict(dim=2048, n_heads=16, n_kv_heads=1), False),
])
def test_route_by_shape(monkeypatch, name, kw, to_k10):
    """Lq == 1 goes to decode_attention (one call per layer) when the head
    dim is one of HEAD_DIMS and at most 8 query heads share a kv head;
    otherwise, and for every Lq > 1 (prefill), the dense route."""
    cfg = T.ModelConfig.tiny_test(n_layers=2, **kw)
    prefill_calls, step_calls = _count_routes(monkeypatch, cfg)
    assert prefill_calls == {"decode": 0, "dense": 2}
    assert step_calls == ({"decode": 4, "dense": 0} if to_k10 else {"decode": 0, "dense": 4})


@pytest.mark.parametrize("kv_dtype,to_k10", [(torch.bfloat16, True), (torch.float8_e4m3fn, True),
                                             (torch.float16, False), (torch.float32, False)],
                         ids=["bf16", "e4m3", "f16", "f32"])
def test_route_by_kv_dtype(monkeypatch, kv_dtype, to_k10):
    """K10 reads K/V as stored in bf16 or e4m3 only: a cache in another
    float dtype decodes through the dense route, on either device alike."""
    cfg = T.ModelConfig.tiny_test(n_layers=2, sliding_window=8)
    assert A.decode_fits(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, kv_dtype) == to_k10
    prefill_calls, step_calls = _count_routes(monkeypatch, cfg, kv_dtype=kv_dtype)
    assert prefill_calls == {"decode": 0, "dense": 2}
    assert step_calls == ({"decode": 4, "dense": 0} if to_k10 else {"decode": 0, "dense": 4})


@pytest.mark.parametrize("kv_dtype", ["float16", "float32"])
def test_engine_on_another_kv_dtype_decodes_densely(monkeypatch, kv_dtype):
    """An engine may store its cache in any float dtype; one that K10 does
    not read decodes through the dense route and serves every request."""
    calls = {"decode": 0}
    dec = T.decode_attention

    def counted_dec(*a, **kw):
        calls["decode"] += 1
        return dec(*a, **kw)

    monkeypatch.setattr(T, "decode_attention", counted_dec)
    cfg = T.ModelConfig.tiny_test(n_layers=2)
    params = T.quantize_params(cfg, T.random_weights(cfg, seed=1), fuse=True, device="cpu")
    eng = Engine(params, cfg, EngineConfig(max_batch=2, max_len=48, inner_steps=4, kv_dtype=kv_dtype))
    res = eng.run([Request(uid=i, prompt=list(range(1, 2 + 3 * i)), max_new_tokens=5) for i in range(3)])
    assert all(a.dtype == getattr(torch, kv_dtype) for a in eng.cache.k + eng.cache.v)
    assert calls["decode"] == 0 and eng.stats()["decode_steps"] > 0
    assert sorted(res) == [0, 1, 2] and all(len(c.tokens) == 5 for c in res.values())


# -- operand checks ------------------------------------------------------------------------------------


def _good():
    q, k, v, pos, window = _operands(4, 128, torch.bfloat16, "linear", q_dtype=torch.bfloat16)
    qpos, kpos, valid = pos
    return q, k, v, A.decode_keys(qpos, valid, kpos)


BAD = {
    "two_query_rows": lambda q, k, v, ks: (torch.cat([q, q], 1), k, v, ks),
    "k_v_shapes_differ": lambda q, k, v, ks: (q, k, v[:, :-1], ks),
    "head_dim_differs": lambda q, k, v, ks: (q[..., :64], k, v, ks),
    "batch_differs": lambda q, k, v, ks: (q[:2], k, v, ks),
    "hq_not_multiple_of_hk": lambda q, k, v, ks: (q[:, :, :3], k, v, ks),
    "int_kv": lambda q, k, v, ks: (q, k.to(torch.int16), v.to(torch.int16), ks),
    "k_v_dtypes_differ": lambda q, k, v, ks: (q, k, v.float(), ks),
    "int_q": lambda q, k, v, ks: (q.to(torch.int32), k, v, ks),
    "keys_of_another_cache": lambda q, k, v, ks: (q, k, v, ks._replace(key_positions=ks.key_positions[:, :64])),
    "keys_int64": lambda q, k, v, ks: (q, k, v, ks._replace(live=ks.live.long())),
    "keys_of_another_batch": lambda q, k, v, ks: (q, k, v, ks._replace(q_positions=ks.q_positions[:2])),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_refuses_bad_operands(bad):
    with pytest.raises(ValueError):
        A.decode_attention(*BAD[bad](*_good()))


CUDA_BAD = {
    "f32_q": lambda q, k, v, ks: (q.float(), k, v, ks),
    "f16_kv": lambda q, k, v, ks: (q, k.half(), v.half(), ks),
    "head_dim_96": lambda q, k, v, ks: (q[..., :96], k[..., :96], v[..., :96], ks),
    "group_16": lambda q, k, v, ks: (q.repeat(1, 1, 4, 1), k, v, ks),
    "strided_head_dim": lambda q, k, v, ks: (q.repeat_interleave(2, dim=-1)[..., ::2], k, v, ks),
    "misaligned_rows": lambda q, k, v, ks: (q, torch.nn.functional.pad(k, (0, 4))[..., :128],
                                            torch.nn.functional.pad(v, (0, 4))[..., :128], ks),
    "keys_not_contiguous": lambda q, k, v, ks: (q, k, v, ks._replace(
        live=torch.stack([ks.live, ks.live], 1)[:, 0])),
}


@pytest.mark.parametrize("bad", list(CUDA_BAD))
def test_kernel_operand_checks(bad):
    """What only the CUDA kernel refuses, checked before any launch (the
    checks run on CPU tensors here)."""
    ops = CUDA_BAD[bad](*_good())
    A._check_decode_operands(*ops)
    with pytest.raises(ValueError):
        A._check_cuda_decode_operands(*ops)


def test_decode_keys_refuse_bad_shapes():
    new_len = torch.tensor([3, 5], dtype=torch.int32)
    kpos, valid = T.kv_slot_positions(new_len, 8)
    with pytest.raises(ValueError):
        A.decode_keys(new_len[:, None].repeat(1, 2), valid, kpos)
    with pytest.raises(ValueError):
        A.decode_keys(new_len[:, None], valid.int(), kpos)
    with pytest.raises(ValueError):
        A.decode_keys(new_len[:, None].long(), valid, kpos)


# -- end to end against the JAX package ------------------------------------------------------------------


def _check_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2e-2 * np.abs(want).max())


KNOBS = dict(qk_norm=True, post_norms=True, hidden_act="gelu_tanh", norm_offset=True, embed_scale=True,
             attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=6, alt_sliding=True,
             query_pre_attn_scalar=100.0)


def _twins(kw, seed):
    jcfg = JT.ModelConfig.tiny_test(n_layers=2, **kw)
    jp = JT.quantize_params(jcfg, JT.random_weights(jcfg, seed=seed), fuse=True)
    arrays, meta = flatten_jax_params(jp)
    cfg = T.ModelConfig(**jcfg.__dict__)
    return jcfg, jp, cfg, params_from_numpy(arrays, meta, cfg, device="cpu")


@pytest.mark.parametrize("name,kw", [("mistral_like", dict(sliding_window=8)), ("gemma2_knobs", KNOBS)])
def test_decode_steps_match_jax(name, kw):
    """A prefill, then 6 decode steps through K10's plain version, each
    step's logits against the JAX package's on the same tokens (the
    windows of 8 and 6 mask the oldest keys by the last steps)."""
    jcfg, jp, cfg, tp = _twins(kw, seed=12)
    toks = np.random.default_rng(13).integers(1, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jl, jc = JT.forward(jp, jcfg, jnp.asarray(toks), JT.KVCache.zeros(jcfg, 2, 16))
    tl, tc = T.forward(tp, cfg, torch.from_numpy(toks), T.KVCache.zeros(cfg, 2, 16, device="cpu"))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    for _ in range(6):
        jl, jc = JT.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = T.forward(tp, cfg, torch.from_numpy(nxt[:, None]), tc)
        _check_logits(tl.numpy(), jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)


def test_engine_decode_logits_match_jax():
    """Three requests of different lengths through two slots of the port's
    engine (an idle slot and a recycled one among its decode steps): every
    recorded decode step's logits against the JAX package's forward over the
    request's prompt and tokens."""
    jcfg, jp, cfg, tp = _twins(dict(sliding_window=8), seed=14)
    eng = Engine(tp, cfg, EngineConfig(max_batch=2, max_len=48, inner_steps=4))
    eng.step_logits = torch.zeros((4, 2, cfg.vocab_size), dtype=torch.float32)
    rng = np.random.default_rng(15)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 9), (13, 4), (2, 7)))]
    seen, step = {}, eng.step

    def recorded_step():
        n = step()
        for i, r in enumerate(eng.slot_req):
            if r is not None:
                seen.setdefault(r.uid, []).extend(eng.step_logits[j, i].clone()
                                                  for j in range(eng.last_decode_steps))
        return n

    eng.step = recorded_step
    out = eng.run(reqs)
    assert sum(len(v) for v in seen.values()) >= 8
    for r in reqs:
        lg = seen.get(r.uid, [])
        seq = np.asarray([r.prompt + out[r.uid].tokens[:-1]], np.int32)
        want = np.asarray(JT.forward(jp, jcfg, jnp.asarray(seq), JT.KVCache.zeros(jcfg, 1, 48))[0])[0]
        for j, got in enumerate(lg[: len(out[r.uid].tokens) - 1]):  # rows past its last token are a tick's rest
            _check_logits(got.numpy(), want[len(r.prompt) + j])
