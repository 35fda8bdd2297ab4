"""The quantized embedding table (QuantEmbedding), the bf16 twin
(dense_params) and the cache-free oracle (reference_forward) of the port,
against the JAX package's.

* ``quantize_embedding``: the same bytes as JAX's for FP4 and NF4; the same
  ValueErrors.  ``lookup`` bit-equal to JAX's over every code; the dense
  ``embed_lookup`` unchanged.
* ``quantize_params`` with ``quantize_embed``: the same table; a tiny model
  with a quantized table gives JAX's greedy tokens (weights carried across
  by ``params_from_numpy``), and the engine gives them too.
* Checkpoints holding a quantized table, written by either package and read
  by the other, byte for byte.
* ``synth_params`` with ``quantize_embed`` / ``quantize_lm_head``.
* ``dense_params`` byte-equal to JAX's; its logits JAX's within 2e-2 of
  max|logit|.
  ``reference_forward`` within 2e-2 of max|logit| of JAX's (both round every
  product to bf16; summation order differs), for a dense, a Mixtral and a
  Gemma-2 config.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.convert import checkpoint as JC
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import format as fmt
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

from test_torch_transformer import flatten_jax_params

QCFG = JT.ModelConfig.tiny_test(n_layers=1, quantize_embed=True)


def _same_table(te: T.QuantEmbedding, je: JT.QuantEmbedding):
    assert (te.vocab_size, te.dim, te.blocksize) == (je.vocab_size, je.dim, je.blocksize)
    for name, dtype in (("packed", torch.uint8), ("scale", torch.float32), ("code", torch.float32)):
        got = getattr(te, name)
        assert got.dtype == dtype and got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(je, name)), err_msg=name)


@pytest.mark.parametrize("code_name", ["fp4", "nf4"])
def test_lookup_matches_jax(code_name):
    code = fmt.NF4_CODE if code_name == "nf4" else fmt.FP4_CODE
    rng = np.random.default_rng(1)
    w = rng.normal(size=(256, 128)).astype(np.float32) * 0.05
    te = T.quantize_embedding(w, blocksize=64, code=code, device="cpu")
    je = JT.quantize_embedding(w, blocksize=64, code=jfmt.NF4_CODE if code_name == "nf4" else jfmt.FP4_CODE)
    _same_table(te, je)
    tokens = np.arange(256, dtype=np.int32).reshape(4, 64)  # every row: every code in use
    got = T.embed_lookup(te, torch.from_numpy(tokens))
    want = np.asarray(JT.embed_lookup(je, jnp.asarray(tokens)).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 64, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and against the numpy golden, rounded once to bf16
    golden = fmt.dequantize_codes(fmt.unpack_flat(te.packed.numpy()), te.scale.numpy().reshape(-1), 64, code)
    np.testing.assert_array_equal(got.float().numpy().reshape(-1), fmt.bf16_round(golden))
    assert te.device.type == "cpu" and te.to("cpu").packed.data_ptr() == te.packed.data_ptr()


def test_quantize_embedding_validates_as_jax():
    for bad in (np.zeros((4, 100), np.float32), np.zeros((4, 8, 8), np.float32)):
        with pytest.raises(ValueError) as je:
            JT.quantize_embedding(bad, blocksize=64)
        with pytest.raises(ValueError) as te:
            T.quantize_embedding(bad, blocksize=64, device="cpu")
        assert str(te.value) == str(je.value)


def test_dense_embed_lookup_unchanged():
    w = torch.randn((16, 64)).to(torch.bfloat16)
    tokens = torch.tensor([[1, 3], [0, 15]], dtype=torch.int32)
    assert torch.equal(T.embed_lookup(w, tokens), w[tokens.long()])


def _jax_and_port(cfg, seed, fuse=False):
    jp = JT.quantize_params(cfg, JT.random_weights(cfg, seed=seed), fuse=fuse)
    return jp, params_from_numpy(*flatten_jax_params(jp), T.ModelConfig(**cfg.__dict__), device="cpu")


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_quantize_params_table_matches_jax(quant_type):
    cfg = dataclasses.replace(QCFG, quant_type=quant_type)
    tcfg = T.ModelConfig(**cfg.__dict__)
    weights = JT.random_weights(cfg, seed=4)
    jp = JT.quantize_params(cfg, weights)
    tp = T.quantize_params(tcfg, weights, device="cpu")
    _same_table(tp.embed, jp.embed)
    carried = params_from_numpy(*flatten_jax_params(jp), tcfg, device="cpu")
    assert torch.equal(carried.embed.packed, tp.embed.packed) and carried.embed.blocksize == 64


def test_quant_embed_model_greedy_tokens_match_jax():
    """FP4 table, fused model: generate gives JAX's tokens, and the engine
    (continuous batching, static token buffers) gives generate's."""
    jp, tp = _jax_and_port(QCFG, seed=4, fuse=True)
    tcfg = T.ModelConfig(**QCFG.__dict__)
    assert isinstance(tp.embed, T.QuantEmbedding)
    prompt = np.random.default_rng(2).integers(0, QCFG.vocab_size, (1, 7)).astype(np.int32)
    want = np.asarray(JT.generate(jp, QCFG, jnp.asarray(prompt), max_new_tokens=4))
    got = T.generate(tp, tcfg, torch.from_numpy(prompt), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)
    res = Engine(tp, tcfg, EngineConfig(max_batch=2, max_len=32, inner_steps=2)).run(
        [Request(uid=1, prompt=prompt[0].tolist(), max_new_tokens=4),
         Request(uid=2, prompt=[3, 1, 4], max_new_tokens=3)])
    assert res[1].tokens == want[0].tolist()
    assert res[2].tokens == T.generate(tp, tcfg, torch.tensor([[3, 1, 4]], dtype=torch.int32), 3)[0].tolist()


def test_quant_embed_checkpoints_both_ways(tmp_path):
    jp, tp = _jax_and_port(dataclasses.replace(QCFG, quant_type="nf4"), seed=8)
    cfg = dataclasses.replace(QCFG, quant_type="nf4")
    JC.save_checkpoint(str(tmp_path / "jax"), cfg, jp)
    tcfg, loaded = load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert tcfg.quantize_embed and isinstance(loaded.embed, T.QuantEmbedding)
    _same_table(loaded.embed, jp.embed)
    save_checkpoint(str(tmp_path / "port"), tcfg, tp)
    jcfg, back = JC.load_checkpoint(str(tmp_path / "port"))
    assert jcfg == cfg and isinstance(back.embed, JT.QuantEmbedding)
    _same_table(tp.embed, back.embed)
    from test_torch_convert import assert_same_checkpoint

    assert_same_checkpoint(tmp_path / "jax", tmp_path / "port")
    moved = T.params_to(loaded, "cpu")
    assert isinstance(moved.embed, T.QuantEmbedding) and moved.embed.device.type == "cpu"


def test_synth_params_quantize_embed_and_lm_head():
    cfg = T.ModelConfig.tiny_test(n_layers=1, quantize_embed=True, quantize_lm_head=True)
    p = synth_params(cfg, seed=1, fuse=True, device="cpu")
    assert isinstance(p.embed, T.QuantEmbedding) and tuple(p.embed.packed.shape) == (cfg.vocab_size, cfg.dim // 2)
    assert torch.equal(p.embed.code, torch.from_numpy(fmt.FP4_CODE))
    assert 0.005 <= p.embed.scale.min().item() and p.embed.scale.max().item() < 0.015
    assert isinstance(p.lm_head, L.QuantLinear) and p.lm_head.variant == cfg.variant
    e = T.embed_lookup(p.embed, torch.tensor([[1, 2, 3]], dtype=torch.int32))
    assert e.shape == (1, 3, cfg.dim) and torch.isfinite(e.float()).all()
    toks = T.generate(p, cfg, torch.tensor([[1, 2, 3]], dtype=torch.int32), max_new_tokens=2)
    assert tuple(toks.shape) == (1, 2)
    plain = T.ModelConfig.tiny_test(n_layers=1)
    assert isinstance(synth_params(plain, device="cpu").embed, torch.Tensor)
    assert isinstance(synth_params(cfg, quantized=False, device="cpu").embed, torch.Tensor)
    assert isinstance(synth_params(cfg, layout="splitk", device="cpu").lm_head, L.DenseLinear)


def _dense_same(tlin, jlin):
    assert (tlin.n_out, tlin.k_in) == (jlin.n_out, jlin.k_in) and tlin.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(tlin.w.float().numpy(), np.asarray(jlin.w.astype(jnp.float32)))


def test_dense_params_match_jax():
    cfg = JT.ModelConfig.tiny_test(n_layers=1, attn_bias=True)
    tcfg = T.ModelConfig(**cfg.__dict__)
    weights = JT.random_weights(cfg, seed=12)
    jp, tp = JT.dense_params(cfg, weights), T.dense_params(tcfg, weights, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        _dense_same(getattr(tp.layers[0], name), getattr(jp.layers[0], name))
    np.testing.assert_array_equal(tp.layers[0].wq.bias.float().numpy(), np.asarray(jp.layers[0].wq.bias, np.float32))
    _dense_same(tp.lm_head, jp.lm_head)
    np.testing.assert_array_equal(tp.embed.float().numpy(), np.asarray(jp.embed.astype(jnp.float32)))
    # the twin runs through the same forward: logits within the port's model tolerance
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    want, _ = JT.forward(jp, cfg, jnp.asarray(prompt), JT.KVCache.zeros(cfg, 1, 6))
    got, _ = T.forward(tp, tcfg, torch.from_numpy(prompt), T.KVCache.zeros(tcfg, 1, 6, device="cpu"))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


REF_CONFIGS = {
    "llama": dict(),
    "mixtral": dict(n_experts=4, experts_per_tok=2, dim=512, ffn_dim=512, n_heads=4, n_kv_heads=2),
    "gemma2": dict(post_norms=True, hidden_act="gelu_tanh", norm_offset=True, embed_scale=True, sliding_window=4,
                   alt_sliding=True, attn_logit_softcap=50.0, final_logit_softcap=30.0, query_pre_attn_scalar=64.0,
                   dim=512, ffn_dim=512, n_heads=4, n_kv_heads=2),
}


@pytest.mark.parametrize("name", list(REF_CONFIGS))
def test_reference_forward_matches_jax(name):
    cfg = JT.ModelConfig.tiny_test(n_layers=2, **REF_CONFIGS[name])
    weights = JT.random_weights(cfg, seed=21)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(JT.reference_forward(cfg, weights, tokens), np.float32)
    got = T.reference_forward(T.ModelConfig(**cfg.__dict__), weights, tokens, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), np.abs(got - want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
