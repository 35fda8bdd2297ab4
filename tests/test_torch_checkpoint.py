"""Packed checkpoints: the port's reader and writer against the JAX package's
(convert/checkpoint.py), in both directions, on the same files.

* JAX save -> port load: every tensor byte-identical to the JAX params
  (ramp with f32 and bf16 scales, NF4, exact, dense and quantized lm_head,
  Gemma-2 post-norms, Qwen3 q/k norms, attention biases).
* Port save -> JAX load: the same bytes come back.
* A checkpoint loaded by both packages gives the same greedy tokens.
* A quantized embedding table loads (tests/test_torch_embed.py holds its
  bytes both ways); tp = 2 loads fused per shard with JAX's bytes; an
  unknown format version raises ValueError in both packages.  Split-K checkpoints are
  tests/test_torch_splitk.py's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.convert import checkpoint as JC
from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T

from test_torch_transformer import flatten_jax_params

CONFIGS = {
    "ramp_f32": dict(),
    "ramp_bf16_scales": dict(),
    "nf4_quant_lm_head": dict(quant_type="nf4", quantize_lm_head=True),
    "exact_quant_lm_head": dict(variant="exact", quantize_lm_head=True),
    "gemma2_post_norms": dict(post_norms=True, hidden_act="gelu_tanh", norm_offset=True, embed_scale=True),
    "qwen3_qk_norms_bias": dict(qk_norm=True, attn_bias=True),
}


def _jax_params(name, n_layers=1):
    cfg = JT.ModelConfig.tiny_test(n_layers=n_layers, **CONFIGS[name])
    params = JT.quantize_params(cfg, JT.random_weights(cfg, seed=len(name)))
    if name == "ramp_bf16_scales":  # compact checkpoints keep bf16 scales
        params = jax.tree.map(lambda q: dataclasses.replace(q, absmax_hi=q.absmax_hi.astype(jnp.bfloat16))
                              if isinstance(q, JL.QuantLinear) else q, params,
                              is_leaf=lambda q: isinstance(q, JL.QuantLinear))
    return cfg, params


def _port_arrays(p: T.ModelParams) -> dict:
    """The port's params in the flat layout of ``flatten_jax_params`` (bf16
    leaves widened to f32, which holds them exactly)."""
    out = {"embed": p.embed, "final_norm": p.final_norm}

    def put(prefix, lin):
        if isinstance(lin, L.QuantLinear):
            out.update({prefix + ".packed": lin.packed, prefix + ".scale": lin.scale})
            if lin.scale_lo is not None:
                out[prefix + ".absmax_lo"] = lin.scale_lo
            if lin.codebook is not None:
                out[prefix + ".codebook"] = lin.codebook
        elif lin is not None:
            out[prefix + ".w"] = lin.w
        if lin is not None and lin.bias is not None:
            out[prefix + ".bias"] = lin.bias

    put("lm_head", p.lm_head)
    for i, lp in enumerate(p.layers):
        for f in dataclasses.fields(lp):
            v = getattr(lp, f.name)
            if isinstance(v, torch.Tensor):
                out[f"layers.{i}.{f.name}"] = v
            elif isinstance(v, T.MoEParams):
                for g in dataclasses.fields(v):
                    put(f"layers.{i}.moe.{g.name}", getattr(v, g.name))
            else:
                put(f"layers.{i}.{f.name}", v)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in out.items()}


def _assert_same(arrays, port_params):
    got = _port_arrays(port_params)
    assert sorted(got) == sorted(arrays)
    for k, want in arrays.items():
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_checkpoint_loads_byte_identical(tmp_path, name):
    cfg, jp = _jax_params(name)
    JC.save_checkpoint(str(tmp_path), cfg, jp)
    tcfg, tp = load_checkpoint(str(tmp_path), device="cpu")
    assert tcfg == T.ModelConfig(**cfg.__dict__)
    arrays, meta = flatten_jax_params(jp)
    _assert_same(arrays, tp)
    for prefix, m in meta["linears"].items():  # dtypes and static fields
        lin = tp.lm_head if prefix == "lm_head" else getattr(tp.layers[0], prefix.split(".")[-1])
        assert (lin.n_out, lin.k_in) == (m["n_out"], m["k_in"])
        if m["kind"] == "quant":
            assert lin.variant == m["variant"] and str(lin.scale.dtype) == f"torch.{m['scale_dtype']}"
        else:
            assert lin.w.dtype == torch.bfloat16
    assert tp.embed.dtype == tp.final_norm.dtype == tp.layers[0].attn_norm.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["ramp_bf16_scales", "nf4_quant_lm_head", "qwen3_qk_norms_bias"])
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    cfg, jp = _jax_params(name)
    arrays, meta = flatten_jax_params(jp)
    tp = params_from_numpy(arrays, meta, T.ModelConfig(**cfg.__dict__), device="cpu")
    save_checkpoint(str(tmp_path), T.ModelConfig(**cfg.__dict__), tp)
    jcfg, back = JC.load_checkpoint(str(tmp_path))
    assert jcfg == cfg
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype, (pa, a.dtype, b.dtype)
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a),
                                      np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b))
    with open(tmp_path / "manifest.json") as f:
        man = json.load(f)
    bf16_keys = man["tensors"]["layers.0"]["bf16_keys"]
    assert man["format_version"] == 3 and "layers.0.attn_norm" in bf16_keys
    assert any(k.endswith(".absmax_hi") for k in bf16_keys) == (name == "ramp_bf16_scales")


def test_checkpoint_roundtrip_through_port_keeps_shadows_out(tmp_path):
    """Shadows are rebuilt at load time, never stored; a port save of a port
    load is the same checkpoint."""
    cfg, jp = _jax_params("exact_quant_lm_head")
    JC.save_checkpoint(str(tmp_path / "a"), cfg, jp)
    tcfg, tp = load_checkpoint(str(tmp_path / "a"), device="cpu")
    save_checkpoint(str(tmp_path / "b"), tcfg, L.attach_prefill_shadow(tp))
    for name in sorted(os.listdir(tmp_path / "a")):
        if name.endswith(".npz"):
            with np.load(tmp_path / "a" / name) as za, np.load(tmp_path / "b" / name) as zb:
                assert za.files == zb.files, name
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    with open(tmp_path / "a" / "manifest.json") as fa, open(tmp_path / "b" / "manifest.json") as fb:
        assert json.load(fa) == json.load(fb)
    _, fused = load_checkpoint(str(tmp_path / "b"), fuse=True, device="cpu")
    assert fused.layers[0].wqkv is not None and fused.layers[0].wq is None


def test_same_checkpoint_same_greedy_tokens(tmp_path):
    cfg, jp = _jax_params("ramp_f32")
    JC.save_checkpoint(str(tmp_path), cfg, jp)
    jcfg, jparams = JC.load_checkpoint(str(tmp_path))
    tcfg, tparams = load_checkpoint(str(tmp_path), device="cpu")
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 9)).astype(np.int32)
    want = np.asarray(JT.generate(jparams, jcfg, jnp.asarray(prompt), max_new_tokens=5))
    got = T.generate(tparams, tcfg, torch.from_numpy(prompt), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)


def _save_variant(path, what):
    if what == "quant_embed":
        cfg = JT.ModelConfig.tiny_test(n_layers=1, quantize_embed=True)
    else:
        cfg = JT.ModelConfig.tiny_test(n_layers=1)
    w = JT.random_weights(cfg, seed=1)
    JC.save_checkpoint(path, cfg, JT.quantize_params(cfg, w))


@pytest.mark.parametrize("what,match", [("quant_embed", "QuantEmbedding")])
def test_unported_checkpoint_contents_raise(tmp_path, monkeypatch, what, match):
    """A quantized embedding table, once refused here, now loads (as a
    ``match``); like every load it goes to the card by default and raises on
    a host without one."""
    _save_variant(str(tmp_path), what)
    _, p = load_checkpoint(str(tmp_path), device="cpu")
    assert type(p.embed).__name__ == match
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint(str(tmp_path))


def test_unknown_version_and_tp_raise(tmp_path):
    """tp = 2 loads (fused per shard: JAX's bytes; tests/test_torch_parallel.py
    covers split-K repacking); an unknown format version raises in both
    packages."""
    _save_variant(str(tmp_path), "plain")
    _, jp = JC.load_checkpoint(str(tmp_path), tp=2, fuse=True)
    _, tp = load_checkpoint(str(tmp_path), tp=2, fuse=True, device="cpu")
    np.testing.assert_array_equal(tp.layers[0].wqkv.packed.numpy(), np.asarray(jp.layers[0].wqkv.packed))
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    man["format_version"] = 99
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="format_version 99"):
        JC.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="format_version 99"):
        load_checkpoint(str(tmp_path), device="cpu")
