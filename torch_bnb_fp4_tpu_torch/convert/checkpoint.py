"""Packed-FP4 checkpoints: the JAX package's on-disk format, read and written
with torch and numpy alone.

Counterpart of ``torch_bnb_fp4_tpu/convert/checkpoint.py``: the same
directory layout, file names, keys and manifest, so a checkpoint converted
once by either package loads in the other.

  manifest.json   {"format_version", "config": ModelConfig fields, "tensors":
                   {group: {"kind", ..., "bf16_keys": [...]}}}
  <group>.npz     one file per weight group: embed, final_norm, layers.N,
                  lm_head

A mixture-of-experts layer keeps its attention linears under the layer's
``linears`` and its MLP under ``moe`` (``router``: the dense router's shape,
stored as ``layers.N.moe.router.w``; ``experts``: gate, up and down, each a
linear whose arrays carry a leading n_experts axis, ``down`` marked
row-parallel), as the JAX package stores it.

A quantized linear stores ``packed``, its scale under ``absmax_hi`` (the
port's field ``scale``), a split-K linear also ``absmax_lo`` (``scale_lo``),
``bias`` when present, and ``layout``, ``k_shards``, ``variant`` and the
codebook in the manifest.  An entry without ``layout`` (formats 1 and 2) is
split-K.  A row-parallel split-K entry (wo, w_down, the experts' down) packed
with ``k_shards`` other than the load's ``tp`` (1) is repacked to one shard
where it was loaded (``convert/quantize.repack_k_shards``, exact).  bf16
arrays are stored as uint16 views and listed in ``bf16_keys`` (npz cannot
hold bf16).  Linears are stored unfused and int8 prefill shadows are never
stored (they are rebuilt at load time by ``attach_prefill_shadow``).  Format
versions 1-3 are read, 3 is written.

Not yet ported (``NotImplementedError``): quantized embedding tables and
``tp > 1``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..models.linear import DenseLinear, QuantLinear
from ..models.transformer import LayerParams, ModelConfig, ModelParams, MoEParams, fuse_params
from ..utils.device import resolve_device
from .quantize import repack_k_shards

FORMAT_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_EXPERTS = ("gate", "up", "down")
_EXTRA_NORMS = ("post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """(array, is_bf16): a bf16 tensor becomes its uint16 bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _to_tensor(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def _linear_to_arrays(prefix: str, q, store: dict) -> dict:
    if isinstance(q, DenseLinear):
        store[f"{prefix}.w"] = q.w
        if q.bias is not None:
            store[f"{prefix}.bias"] = q.bias
        return dict(kind="dense", n_out=q.n_out, k_in=q.k_in)
    if not isinstance(q, QuantLinear):
        raise TypeError(f"{prefix}: cannot store a {type(q).__name__}")
    store[f"{prefix}.packed"] = q.packed
    store[f"{prefix}.absmax_hi"] = q.scale
    if q.scale_lo is not None:
        store[f"{prefix}.absmax_lo"] = q.scale_lo
    if q.bias is not None:
        store[f"{prefix}.bias"] = q.bias
    return dict(kind="quant", n_out=q.n_out, k_in=q.k_in, blocksize=q.blocksize, layout=q.layout,
                k_shards=q.k_shards, variant=q.variant,
                codebook=None if q.codebook is None else q.codebook.float().cpu().tolist())


def save_checkpoint(path: str, cfg: ModelConfig, params: ModelParams) -> None:
    """Write ``params`` (unfused) as a format-3 packed checkpoint."""
    os.makedirs(path, exist_ok=True)
    manifest = {"format_version": FORMAT_VERSION, "config": dataclasses.asdict(cfg), "tensors": {}}

    def put(name: str, tensors: dict, meta: dict) -> None:
        arrays, bf16_keys = {}, []
        for k, t in tensors.items():
            arrays[k], is_bf16 = _to_numpy(t)
            if is_bf16:
                bf16_keys.append(k)
        np.savez(os.path.join(path, name + ".npz"), **arrays)
        manifest["tensors"][name] = dict(meta, bf16_keys=bf16_keys)

    put("embed", {"embed.w": params.embed}, {"kind": "dense_embed"})
    put("final_norm", {"final_norm.w": params.final_norm}, {"kind": "norm"})
    for i, lp in enumerate(params.layers):
        if lp.wqkv is not None or lp.w_gateup is not None or (lp.moe is not None and lp.moe.gateup is not None):
            raise ValueError("checkpoints store unfused linears: save the params before fuse_params")
        p = f"layers.{i}"
        arrays = {f"{p}.attn_norm": lp.attn_norm, f"{p}.mlp_norm": lp.mlp_norm}
        for n in _EXTRA_NORMS:  # Gemma-2 post-norms, Qwen3 per-head q/k norms
            if getattr(lp, n) is not None:
                arrays[f"{p}.{n}"] = getattr(lp, n)
        meta = {"kind": "layer", "linears": {}}
        for f in _ATTN + (() if lp.moe is not None else _MLP):
            m = _linear_to_arrays(f"{p}.{f}", getattr(lp, f), arrays)
            m["row_parallel"] = f in ("wo", "w_down")
            meta["linears"][f] = m
        if lp.moe is not None:
            router = lp.moe.router
            arrays[f"{p}.moe.router.w"] = router.w
            if router.bias is not None:
                arrays[f"{p}.moe.router.bias"] = router.bias
            meta["moe"] = {"kind": "moe", "router": dict(n_out=router.n_out, k_in=router.k_in), "experts": {}}
            for f in _EXPERTS:
                m = _linear_to_arrays(f"{p}.moe.{f}", getattr(lp.moe, f), arrays)
                m["row_parallel"] = f == "down"
                meta["moe"]["experts"][f] = m
        put(p, arrays, meta)
    arrays = {}
    meta = _linear_to_arrays("lm_head", params.lm_head, arrays)
    if meta["kind"] == "quant":
        meta["row_parallel"] = False
    else:
        meta = {"kind": "dense"}
    put("lm_head", arrays, meta)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _linear_from_arrays(prefix: str, meta: dict, arrays: dict, device):
    if meta.get("kind") == "dense":
        bias = arrays.get(f"{prefix}.bias")
        return DenseLinear(w=arrays[f"{prefix}.w"], bias=bias, n_out=meta["n_out"], k_in=meta["k_in"])
    packed, hi, lo = arrays[f"{prefix}.packed"], arrays[f"{prefix}.absmax_hi"], arrays.get(f"{prefix}.absmax_lo")
    layout = meta.get("layout", "splitk")
    k_shards = meta["k_shards"]
    if layout == "splitk" and meta.get("row_parallel") and k_shards != 1:
        # to the load's tp = 1: an exact byte shuffle, run where the tensors were loaded
        packed, hi, lo = repack_k_shards(packed, hi, lo, meta["blocksize"], k_shards, 1)
        k_shards = 1
    cb = meta.get("codebook")
    return QuantLinear(
        packed=packed, scale=hi, scale_lo=lo, bias=arrays.get(f"{prefix}.bias"), n_out=meta["n_out"],
        k_in=meta["k_in"], blocksize=meta["blocksize"], variant=meta.get("variant", "exact"), layout=layout,
        k_shards=k_shards, codebook=None if cb is None else torch.tensor(cb, dtype=torch.float32, device=device),
    )


def load_checkpoint(path: str, tp: int = 1, fuse: bool = False, device=None) -> tuple[ModelConfig, ModelParams]:
    """Load a packed checkpoint onto ``device`` (default CUDA);
    ``fuse=True`` fuses QKV and gate|up (checkpoints always store unfused)."""
    device = resolve_device(device)
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not yet ported (tp must be 1)")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version not in _SUPPORTED_VERSIONS:
        raise ValueError(f"checkpoint at {path!r} has format_version {version!r}; this reader supports "
                         f"{_SUPPORTED_VERSIONS}. Re-convert the model or upgrade torch_bnb_fp4_tpu_torch.")
    cfg = ModelConfig(**manifest["config"])
    tensors = manifest["tensors"]

    def arrs(name: str) -> dict:
        bf16 = set(tensors[name].get("bf16_keys", []))
        with np.load(os.path.join(path, name + ".npz")) as z:
            return {k: _to_tensor(z[k], k in bf16, device) for k in z.files}

    if tensors["embed"]["kind"] == "quant_embed":
        raise NotImplementedError("quantized embedding tables (QuantEmbedding) are not yet ported")
    embed = arrs("embed")["embed.w"]
    final_norm = arrs("final_norm")["final_norm.w"]
    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}"
        a = arrs(p)
        kw = {f: _linear_from_arrays(f"{p}.{f}", m, a, device) for f, m in tensors[p]["linears"].items()}
        moe = tensors[p].get("moe")
        if moe is not None:
            kw["moe"] = MoEParams(
                router=DenseLinear(w=a[f"{p}.moe.router.w"], bias=a.get(f"{p}.moe.router.bias"),
                                   n_out=moe["router"]["n_out"], k_in=moe["router"]["k_in"]),
                **{f: _linear_from_arrays(f"{p}.moe.{f}", moe["experts"][f], a, device) for f in _EXPERTS})
        kw.update({n: a[f"{p}.{n}"] for n in _EXTRA_NORMS if f"{p}.{n}" in a})
        layers.append(LayerParams(attn_norm=a[f"{p}.attn_norm"], mlp_norm=a[f"{p}.mlp_norm"], **kw))
    lm_meta = tensors["lm_head"]
    a = arrs("lm_head")
    if lm_meta["kind"] == "quant":
        lm_head = _linear_from_arrays("lm_head", lm_meta, a, device)
    else:
        w = a["lm_head.w"]
        lm_head = DenseLinear(w=w, bias=a.get("lm_head.bias"), n_out=w.shape[1], k_in=w.shape[0])
    params = ModelParams(embed=embed, layers=layers, final_norm=final_norm, lm_head=lm_head)
    return cfg, (fuse_params(params) if fuse else params)
