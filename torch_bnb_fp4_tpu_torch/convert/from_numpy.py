"""Carry a model's weights across from the JAX package: a flat dict of numpy
arrays plus static metadata -> the port's ``ModelParams`` on a device.

Keys of ``arrays`` (layer ``i``, linear name ``L`` one of wq wk wv wo w_gate
w_up w_down wqkv w_gateup; absent linears are simply missing):

  embed                      (vocab, dim)        bf16 leaf
  final_norm                 (dim,)              bf16 leaf
  layers.i.attn_norm         (dim,)              bf16 leaf
  layers.i.mlp_norm          (dim,)              bf16 leaf
  layers.i.{post_attn_norm, post_mlp_norm, q_norm, k_norm}   optional bf16 leaves
  layers.i.L.packed          (k_pad/2, n_pad)    uint8      quantized linear
  layers.i.L.scale           (k_pad/bs, n_pad)   f32 (or bf16 leaf, see below); split-K: absmax_hi,
                                                 (k_pad/(2*bs), n_pad)
  layers.i.L.absmax_lo       (k_pad/(2*bs), n_pad)  f32   split-K only: the lo half's absmax
  layers.i.L.bias            (n_out,)            f32, optional
  layers.i.L.codebook        (16,)               f32, lut variant and split-K NF4 only
  layers.i.L.w8              (k_pad, n_pad)      int8       int8 prefill shadow, optional
  layers.i.L.w8_scale        (k_pad/w8_block_k, n_pad)  f32  its per-K-tile column scales
  layers.i.L.w               (k_in, n_out)       bf16 leaf  dense linear
  layers.i.L.bias            (n_out,)            bf16 leaf  dense linear, optional
  lm_head.*                  as a linear (``lm_head.w`` for the dense head)
  layers.i.moe.router.w      (dim, n_experts)    bf16 leaf  the router of a mixture-of-experts layer
  layers.i.moe.router.bias   (n_experts,)        bf16 leaf, optional
  layers.i.moe.E.*           as a quantized (or dense) linear with a leading n_experts axis on
                             every array, E one of gate up down gateup (a stacked linear)

bf16 leaves arrive as float32, which holds every bf16 value exactly, and are
cast back to bf16 here.  ``meta["linears"]`` maps each linear's prefix
(``layers.3.wqkv``, ``layers.3.moe.gateup``, ``layers.3.moe.router``,
``lm_head``) to its static fields:
``{"kind": "quant", "n_out", "k_in", "blocksize", "variant", "scale_dtype":
"float32" | "bfloat16", "w8_block_k", "layout", "k_shards"}`` (``w8_block_k``,
the shadow's K-tile depth, only with ``.w8``; ``layout`` "pairk" when absent,
``k_shards`` 1) or ``{"kind": "dense", "n_out", "k_in"}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.linear import DenseLinear, QuantLinear
from ..models.transformer import LayerParams, ModelConfig, MoEParams, ModelParams
from ..utils.device import resolve_device

LINEAR_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gateup")
MOE_NAMES = ("router", "gate", "up", "down", "gateup")
OPTIONAL_NORMS = ("post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def params_from_numpy(arrays: dict[str, np.ndarray], meta: dict, cfg: ModelConfig, device=None) -> ModelParams:
    """Build ``ModelParams`` on ``device`` from the documented flat layout."""
    device = resolve_device(device)

    def t(key, dtype=None):
        a = torch.from_numpy(np.require(arrays[key], requirements=["C", "W"]))
        return a.to(device=device, dtype=dtype) if dtype is not None else a.to(device)

    def bf16(key):
        a = arrays[key]
        if a.dtype != np.float32:
            raise ValueError(f"{key}: bf16 leaves arrive as float32, got {a.dtype}")
        return t(key, torch.bfloat16)

    def linear(prefix):
        m = meta["linears"].get(prefix)
        if m is None:
            return None
        bias_key = prefix + ".bias"
        if m["kind"] == "dense":
            return DenseLinear(w=bf16(prefix + ".w"), bias=bf16(bias_key) if bias_key in arrays else None,
                               n_out=m["n_out"], k_in=m["k_in"])
        if m["kind"] != "quant":
            raise ValueError(f"{prefix}: unknown linear kind {m['kind']!r}")
        if arrays[prefix + ".packed"].dtype != np.uint8:
            raise ValueError(f"{prefix}.packed must be uint8")
        cb_key = prefix + ".codebook"
        shadow = {}
        if prefix + ".w8" in arrays:
            if arrays[prefix + ".w8"].dtype != np.int8:
                raise ValueError(f"{prefix}.w8 must be int8")
            shadow = dict(w8=t(prefix + ".w8"), w8_scale=t(prefix + ".w8_scale", torch.float32),
                          w8_block_k=m["w8_block_k"])
        lo_key = prefix + ".absmax_lo"
        return QuantLinear(
            packed=t(prefix + ".packed"), scale=t(prefix + ".scale", _DTYPES[m.get("scale_dtype", "float32")]),
            scale_lo=t(lo_key, torch.float32) if lo_key in arrays else None,
            bias=t(bias_key, torch.float32) if bias_key in arrays else None,
            n_out=m["n_out"], k_in=m["k_in"], blocksize=m.get("blocksize", 64), variant=m["variant"],
            layout=m.get("layout", "pairk"), k_shards=m.get("k_shards", 1),
            codebook=t(cb_key, torch.float32) if cb_key in arrays else None, **shadow,
        )

    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        extra = {n: bf16(p + n) for n in OPTIONAL_NORMS if p + n in arrays}
        lins = {n: linear(p + n) for n in LINEAR_NAMES}
        if p + "moe.router" in meta["linears"]:
            lins["moe"] = MoEParams(**{n: linear(p + "moe." + n) for n in MOE_NAMES})
        layers.append(LayerParams(attn_norm=bf16(p + "attn_norm"), mlp_norm=bf16(p + "mlp_norm"), **lins, **extra))
    return ModelParams(embed=bf16("embed"), layers=layers, final_norm=bf16("final_norm"), lm_head=linear("lm_head"))
