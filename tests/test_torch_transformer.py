"""The port's decoder vs the JAX package's, on weights carried across.

The JAX ``ModelParams`` is flattened here (the flattening of JAX pytrees lives
in the tests, never in the port) into the flat numpy layout that
``torch_bnb_fp4_tpu_torch.convert.from_numpy`` documents, rebuilt as the
port's params on the CPU, and both models run the same tokens.

Tolerance on logits: |dlogit| <= 2e-2 * max|logit_ref|.  Both sides round
hidden states to bf16 after every linear and norm; f32 summation order and
the f32 transcendental functions differ, which can flip a bf16 rounding and
carry ~2^-8 relative noise through a layer.  Greedy tokens must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T

LIN_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gateup")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def flatten_jax_params(params):
    """JAX ModelParams -> (arrays, meta) in the port's documented layout."""
    arrays, linears = {}, {}

    def put(prefix, lin):
        if lin is None:
            return
        if isinstance(lin, JL.QuantLinear):
            arrays[prefix + ".packed"] = np.asarray(lin.packed)
            arrays[prefix + ".scale"] = _f32(lin.absmax_hi)
            if lin.absmax_lo is not None:  # split-K: the lo half's absmax
                arrays[prefix + ".absmax_lo"] = _f32(lin.absmax_lo)
            if lin.bias is not None:
                arrays[prefix + ".bias"] = _f32(lin.bias)
            if lin.codebook is not None:  # lut, or split-K NF4
                arrays[prefix + ".codebook"] = _f32(lin.codebook)
            linears[prefix] = dict(kind="quant", n_out=lin.n_out, k_in=lin.k_in, blocksize=lin.blocksize,
                                   variant=lin.variant, layout=lin.layout, k_shards=lin.k_shards,
                                   scale_dtype="bfloat16" if lin.absmax_hi.dtype == jnp.bfloat16 else "float32")
            if lin.w8 is not None:  # int8 prefill shadow
                arrays[prefix + ".w8"] = np.asarray(lin.w8)
                arrays[prefix + ".w8_scale"] = np.asarray(lin.w8_scale)
                linears[prefix]["w8_block_k"] = lin.w8_block_k
        else:
            arrays[prefix + ".w"] = _f32(lin.w)
            if lin.bias is not None:
                arrays[prefix + ".bias"] = _f32(lin.bias)
            linears[prefix] = dict(kind="dense", n_out=lin.n_out, k_in=lin.k_in)

    meta = {"linears": linears}
    if isinstance(params.embed, JT.QuantEmbedding):  # a quantized table: its bytes and static fields
        e = params.embed
        arrays.update({"embed.packed": np.asarray(e.packed), "embed.scale": np.asarray(e.scale),
                       "embed.code": np.asarray(e.code)})
        meta["embed"] = dict(kind="quant_embed", vocab_size=e.vocab_size, dim=e.dim, blocksize=e.blocksize)
    else:
        arrays["embed"] = _f32(params.embed)
    arrays["final_norm"] = _f32(params.final_norm)
    put("lm_head", params.lm_head)
    for i, lp in enumerate(params.layers):
        p = f"layers.{i}."
        for n in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm"):
            if getattr(lp, n) is not None:
                arrays[p + n] = _f32(getattr(lp, n))
        for n in LIN_NAMES:
            put(p + n, getattr(lp, n))
        if lp.moe is not None:  # stacked experts: every array keeps its leading expert axis
            for n in ("router", "gate", "up", "down", "gateup"):
                put(p + "moe." + n, getattr(lp.moe, n))
    return arrays, meta


def _models(cfg, seed, fuse=True):
    w = JT.random_weights(cfg, seed=seed)
    jp = JT.quantize_params(cfg, w, fuse=fuse)
    arrays, meta = flatten_jax_params(jp)
    tp = params_from_numpy(arrays, meta, T.ModelConfig(**cfg.__dict__), device="cpu")
    return jp, tp, w


def _check_logits(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2e-2 * np.abs(want).max())


KNOBS = dict(qk_norm=True, post_norms=True, hidden_act="gelu_tanh", norm_offset=True, embed_scale=True,
             attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=6, alt_sliding=True,
             query_pre_attn_scalar=100.0, rope_scaling=(8.0, 1.0, 4.0, 64.0), attn_bias=True)


@pytest.mark.parametrize("name,kw,fuse", [("mistral_like", dict(sliding_window=8), True),
                                          ("knobs_unfused", KNOBS, False)])
def test_forward_logits_match(name, kw, fuse):
    cfg = JT.ModelConfig.tiny_test(n_layers=2, **kw)
    jp, tp, _ = _models(cfg, seed=4, fuse=fuse)
    tcfg = T.ModelConfig(**cfg.__dict__)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, jc = JT.forward(jp, cfg, jnp.asarray(toks), JT.KVCache.zeros(cfg, 2, 16))
    tl, tc = T.forward(tp, tcfg, torch.from_numpy(toks), T.KVCache.zeros(tcfg, 2, 16, device="cpu"))
    _check_logits(tl, jl)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k[1].float().numpy(), _f32(jc.k[1]), atol=2e-2 * np.abs(_f32(jc.k[1])).max())
    # one decode step on top of the filled cache
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    jl2, _ = JT.forward(jp, cfg, jnp.asarray(nxt[:, None]), jc)
    tl2, _ = T.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
    _check_logits(tl2, jl2)


def test_converted_params_equal_port_quantization():
    """Carrying the JAX params across and quantizing in the port from the same
    fp weights give the same bytes, scales and bf16 leaves."""
    cfg = JT.ModelConfig.tiny_test(n_layers=1)
    jp, tp, w = _models(cfg, seed=6)
    qp = T.quantize_params(T.ModelConfig(**cfg.__dict__), w, fuse=True, device="cpu")
    for a, b in ((tp.layers[0].wqkv, qp.layers[0].wqkv), (tp.layers[0].w_down, qp.layers[0].w_down)):
        assert torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale)
    assert torch.equal(tp.embed, qp.embed) and torch.equal(tp.lm_head.w, qp.lm_head.w)
    assert tp.embed.dtype == torch.bfloat16 and tp.layers[0].wqkv.packed.dtype == torch.uint8


@pytest.mark.parametrize("plen", [5, 140])
def test_generate_tokens_identical(plen):
    """140-token prompt: the prefill takes the m-inner kernel (K3) on both
    sides; 5 tokens: K2 throughout."""
    cfg = JT.ModelConfig.tiny_test(n_layers=2)
    jp, tp, _ = _models(cfg, seed=7)
    prompt = np.random.default_rng(plen).integers(1, cfg.vocab_size, size=(1, plen)).astype(np.int32)
    want = np.asarray(JT.generate(jp, cfg, jnp.asarray(prompt), max_new_tokens=6))
    got = T.generate(tp, T.ModelConfig(**cfg.__dict__), torch.from_numpy(prompt), max_new_tokens=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192.0)])
def test_rope_matches_jax(scaling):
    """f32 half-split RoPE, with and without the Llama-3.1 frequency remap."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 9000, size=(2, 5)).astype(np.int32)
    want = np.asarray(JT.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling))
    got = T.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0, scaling).numpy()
    # angles up to ~9000 rad: one f32 ulp of the angle is ~1e-3 rad
    np.testing.assert_allclose(got, want, atol=5e-3 * np.abs(x).max())


def test_prefill_and_decode_step_api():
    cfg = T.ModelConfig.tiny_test(n_layers=1)
    p = T.quantize_params(cfg, T.random_weights(cfg, seed=1), fuse=True, device="cpu")
    cache = T.KVCache.zeros(cfg, 2, 8, device="cpu")
    logits, cache = T.prefill(p, cfg, torch.tensor([[1, 2, 3], [4, 5, 6]]), cache)
    assert tuple(logits.shape) == (2, cfg.vocab_size) and logits.dtype == torch.float32
    tok, cache = T.decode_step(p, cfg, torch.argmax(logits, -1).to(torch.int32), cache)
    assert tuple(tok.shape) == (2,) and cache.length.tolist() == [4, 4]


def test_not_yet_ported_features_raise():
    """Features once refused here are built: the quantized embedding table
    (tests/test_torch_embed.py holds it) and shadows for a model-axis width
    of 2, whose tile depth divides each shard's K (tests/test_torch_parallel.py
    holds them against JAX's)."""
    cfg = T.ModelConfig.tiny_test(n_layers=1, quantize_embed=True)
    p = T.quantize_params(cfg, T.random_weights(cfg), device="cpu")
    assert isinstance(p.embed, T.QuantEmbedding)
    s = L.attach_prefill_shadow(p, tp=2)
    assert (s.layers[0].wq.w8_block_k, s.layers[0].w_down.w8_block_k) == (512, 1024)
