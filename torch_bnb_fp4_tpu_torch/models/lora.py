"""LoRA adapters on packed-FP4 bases (QLoRA-style serving).

Counterpart of ``torch_bnb_fp4_tpu/models/lora.py``.  A PEFT-trained adapter
serves two ways:

* :func:`attach_lora` wraps each target linear in a
  :class:`~.linear.LoRALinear`: the base bytes stay as they are and the
  delta is exact (two skinny products beside the base's kernel);
  :func:`attach_multi_lora` stacks several adapters on one base for
  per-request serving (:class:`~.linear.MultiLoRALinear`, picked per row by
  ``forward(adapter_idx=...)``);
* :func:`merge_lora` folds ``scale * B @ A`` into the base weight and
  requantizes it: no cost per token, one more FP4 rounding of the merged
  weight.

:func:`load_peft_adapter` reads a HF PEFT adapter directory
(``adapter_config.json`` + ``adapter_model.safetensors``, torch (out, in)
orientation, keys ``base_model.model.<module>.lora_A/B[.default].weight``)
with the port's own safetensors reader.  Params must be unfused
(``load_checkpoint`` loads them so; ``synth_params(fuse=False)``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..convert.safetensors_io import iter_tensors
from .linear import (DenseLinear, LoRALinear, MultiLoRALinear, QuantLinear, dense_linear, dequantize_weight,
                     lora_linear, multi_lora_linear, quantize_linear)
from .transformer import LayerParams, ModelConfig, ModelParams

# HF module suffix -> LayerParams field (the converter's map)
_FIELD_OF = {
    "self_attn.q_proj": "wq", "self_attn.k_proj": "wk", "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo", "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}


@dataclasses.dataclass(frozen=True)
class PEFTAdapter:
    """One loaded adapter: rank, alpha, and per-module (lora_A, lora_B) as f32
    numpy arrays, lora_A (r, k_in) and lora_B (n_out, r)."""

    r: int
    alpha: float
    weights: dict  # module stem (e.g. "model.layers.0.self_attn.q_proj") -> (A, B)


def load_peft_adapter(path: str) -> PEFTAdapter:
    """Load a HF PEFT LoRA directory (adapter_config.json +
    adapter_model.safetensors), with the JAX package's refusals: another
    peft_type, rank/alpha patterns, an incomplete A/B pair, an unknown key."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"unsupported peft_type {cfg.get('peft_type')!r} (LoRA only)")
    if cfg.get("rank_pattern") or cfg.get("alpha_pattern"):
        raise ValueError("per-module rank/alpha patterns are not supported")
    pairs: dict[str, dict[str, np.ndarray]] = {}
    for key, t in iter_tensors(os.path.join(path, "adapter_model.safetensors")):
        stem, kind = _parse_adapter_key(key)
        pairs.setdefault(stem, {})[kind] = t.float().numpy()
    weights = {}
    for stem, ab in pairs.items():
        if set(ab) != {"A", "B"}:
            raise ValueError(f"incomplete adapter pair for {stem}: has {sorted(ab)}")
        weights[stem] = (np.asarray(ab["A"], np.float32), np.asarray(ab["B"], np.float32))
    return PEFTAdapter(r=int(cfg["r"]), alpha=float(cfg["lora_alpha"]), weights=weights)


def _parse_adapter_key(key: str) -> tuple[str, str]:
    for marker, kind in ((".lora_A.weight", "A"), (".lora_B.weight", "B"),
                         (".lora_A.default.weight", "A"), (".lora_B.default.weight", "B")):
        if key.endswith(marker):
            stem = key[: -len(marker)]
            for prefix in ("base_model.model.", "base_model."):
                if stem.startswith(prefix):
                    stem = stem[len(prefix):]
                    break
            return stem, kind
    raise ValueError(f"unrecognized adapter tensor name {key!r}")


def _targets(cfg: ModelConfig, adapter: PEFTAdapter):
    """Yield (layer_idx, field, A, B) for every adapter module; a loud error
    for anything this runtime cannot serve."""
    for stem, (a, b) in sorted(adapter.weights.items()):
        if not stem.startswith("model.layers."):
            raise ValueError(f"adapter target {stem!r} is outside the decoder "
                             "(embeddings/lm_head adapters are not supported)")
        rest = stem.split(".", 3)
        i, suffix = int(rest[2]), rest[3]
        if "block_sparse_moe" in suffix:
            raise ValueError(f"adapter target {stem!r}: expert adapters are not "
                             "supported (attach to attention projections)")
        field = _FIELD_OF.get(suffix)
        if field is None:
            raise ValueError(f"adapter target {stem!r} is not a known linear")
        if i >= cfg.n_layers:
            raise ValueError(f"adapter target {stem!r}: the model has {cfg.n_layers} layers")
        yield i, field, a, b


def _check_unfused(lp: LayerParams, what: str) -> None:
    if lp.wqkv is not None or lp.w_gateup is not None:
        raise ValueError(f"{what} requires unfused params (load_checkpoint(..., fuse=False))")


def attach_lora(params: ModelParams, cfg: ModelConfig, adapter: PEFTAdapter) -> ModelParams:
    """Wrap every adapter-targeted linear in a LoRALinear (exact, base bytes
    untouched; the factors go to the base's device).  Params must be unfused:
    a fused QKV stack has no per-projection seam to attach to."""
    new_layers = list(params.layers)
    for i, field, a, b in _targets(cfg, adapter):
        lp = new_layers[i]
        _check_unfused(lp, "attach_lora")
        base = getattr(lp, field)
        if base is None:
            raise ValueError(f"layer {i} has no {field} (MoE layer?)")
        if isinstance(base, (LoRALinear, MultiLoRALinear)):
            raise ValueError(f"layer {i}.{field} already has an adapter attached")
        new_layers[i] = dataclasses.replace(lp, **{field: lora_linear(base, a, b, alpha=adapter.alpha)})
    return dataclasses.replace(params, layers=new_layers)


def attach_multi_lora(params: ModelParams, cfg: ModelConfig,
                      adapters: dict[str, PEFTAdapter]) -> tuple[ModelParams, dict[str, int]]:
    """Stack several adapters on one shared base for per-request serving:
    every module targeted by ANY adapter becomes a MultiLoRALinear holding
    all adapters' factors (zeros for adapters that skip it).  Returns
    ``(params, ids)``, ``ids[name]`` the adapter's index from 1 (0 is the
    reserved "no adapter" slot): pass both to ``Engine(..., adapter_ids=ids)``
    and name an adapter per ``Request``.  Params must be unfused and carry no
    single-adapter LoRALinear (it would apply its one adapter to every row)."""
    names = list(adapters)
    ids = {name: i + 1 for i, name in enumerate(names)}
    stacks: dict[tuple[int, str], list] = {}  # (layer, field) -> per-adapter (A, B, alpha) in id order
    for name in names:
        for i, field, a, b in _targets(cfg, adapters[name]):
            lp = params.layers[i]
            _check_unfused(lp, "attach_multi_lora")
            base = getattr(lp, field)
            if base is None:
                raise ValueError(f"layer {i} has no {field} (MoE layer?)")
            if isinstance(base, (LoRALinear, MultiLoRALinear)):
                raise ValueError(f"layer {i}.{field} already has an adapter attached; detach_lora first")
            stacks.setdefault((i, field), [None] * len(names))[ids[name] - 1] = (a, b, adapters[name].alpha)
    new_layers = list(params.layers)
    for (i, field), entries in stacks.items():
        base = getattr(new_layers[i], field)
        new_layers[i] = dataclasses.replace(new_layers[i], **{field: multi_lora_linear(base, entries)})
    return dataclasses.replace(params, layers=new_layers), ids


def detach_lora(params: ModelParams) -> ModelParams:
    """Strip every LoRALinear, and every MultiLoRALinear (which the JAX
    package's ``detach_lora`` leaves in place), back to its base: the exact
    inverse of either attach."""

    def strip(lp: LayerParams) -> LayerParams:
        rep = {f: getattr(lp, f).base for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
               if isinstance(getattr(lp, f), (LoRALinear, MultiLoRALinear))}
        return dataclasses.replace(lp, **rep) if rep else lp

    return dataclasses.replace(params, layers=[strip(lp) for lp in params.layers])


def merge_lora(params: ModelParams, cfg: ModelConfig, adapter: PEFTAdapter) -> ModelParams:
    """Fold each adapter into its base weight (W + (alpha/r) * B @ A) and
    requantize quantized bases, as the JAX package does: the weight is
    dequantized in f32 (K6 on the card, K9a for split-K), the numpy f32 delta
    added on the host, and ``quantize_linear`` packs the sum onto the base's
    device (an NF4 ``lut`` base becomes NF4 ``ramp``; any other base FP4 with
    its variant).  No cost per token; the merged weight carries the FP4
    rounding on the delta too (the attached form keeps it exact)."""
    scale = adapter.alpha / adapter.r
    new_layers = list(params.layers)
    for i, field, a, b in _targets(cfg, adapter):
        lp = new_layers[i]
        base = getattr(lp, field)
        if isinstance(base, LoRALinear):
            base = base.base
        delta = scale * (b @ a)  # (n_out, k_in)
        bias = None if base.bias is None else base.bias.float().cpu().numpy()
        if isinstance(base, QuantLinear):
            w = dequantize_weight(base, out_dtype=torch.float32).cpu().numpy() + delta
            lut = base.variant == "lut"
            merged = quantize_linear(w, bias, blocksize=base.blocksize, quant_type="nf4" if lut else "fp4",
                                     variant="ramp" if lut else base.variant, device=base.packed.device)
        elif isinstance(base, DenseLinear):
            w = base.w.float().cpu().numpy().T + delta
            merged = dense_linear(w, bias, device=base.w.device)
        else:
            raise ValueError(f"cannot merge into {type(base).__name__}")
        new_layers[i] = dataclasses.replace(lp, **{field: merged})
    return dataclasses.replace(params, layers=new_layers)
