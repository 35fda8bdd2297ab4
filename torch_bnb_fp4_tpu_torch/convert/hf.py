"""HF checkpoint -> packed FP4 checkpoint (offline, streaming, on the host).

Counterpart of ``torch_bnb_fp4_tpu/convert/hf.py``: from the same HF
directory the streaming converter writes the same manifest and the same npz
arrays as the JAX package's, so the checkpoint loads in either package.
Tensors stream from the safetensors shards through the port's own reader
(``convert/safetensors_io.py``: the card's machine has no ``safetensors``
package); each weight group (a decoder layer, a Mixtral expert, the
embedding, the lm_head) is quantized, written and freed once its tensors have
all arrived.  Norms stay bf16, the embedding too unless ``quantize_embed``,
and the lm_head is a dense bf16 linear unless ``quantize_lm_head``.

HF-serialized bitsandbytes 4-bit layers (what ``transformers`` writes for a
``load_in_4bit`` model) import exactly, double-quantized absmax decoded, or
are dequantized and quantized fresh with ``requantize``.

:func:`quantize_hf_weights` builds ``ModelParams`` in memory from the same
HF-named tensors with the same rules (the path of
``compat.recursively_replace_with_fp4_linear``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from collections.abc import Iterator

import numpy as np
import torch

from ..models.linear import DenseLinear, QuantLinear, dense_linear
from ..models.transformer import (LayerParams, ModelConfig, ModelParams, MoEParams, norm_names, quantize_embedding,
                                  stack_linears)
from ..ops import format as fmt
from ..utils.device import resolve_device
from . import safetensors_io as st
from .bnb import dequantize_nested_absmax, from_bnb_state
from .checkpoint import CheckpointWriter, _embed_to_arrays, _linear_to_arrays, _moe_to_arrays
from .quantize import quantize_pack_pairk, quantize_pack_pairk_lut

_LINEAR_FIELDS = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
_ROW_PARALLEL = ("wo", "w_down")


def config_from_hf(model_dir: str, **overrides) -> ModelConfig:
    """ModelConfig from an HF llama/mistral-family ``config.json``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return config_from_hf_dict(hf, **overrides)


def config_from_hf_dict(hf: dict, **overrides) -> ModelConfig:
    """ModelConfig from an HF config dict (``config.json`` or
    ``model.config.to_dict()``): Llama/Mistral, Qwen2 (q/k/v bias), Qwen3
    (per-head q/k norms), Gemma (GeGLU, (1 + w) norms, sqrt(dim) embedding
    scale), Gemma-2 (post-norms, logit softcaps, alternating sliding
    windows), Phi-3, Mixtral (sparse MoE) and Llama-3.1's ``rope_scaling``;
    another rope_scaling type raises ValueError."""
    kw = dict(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        ffn_dim=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=hf.get("sliding_window"),
        # informational: biases come from the checkpoint's .bias tensors
        attn_bias=bool(hf.get("attention_bias", hf.get("model_type") == "qwen2")),
    )
    act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
    if act in ("gelu", "gelu_pytorch_tanh", "gelu_new"):
        kw["hidden_act"] = "gelu_tanh"
    if hf.get("head_dim") is not None:
        kw["head_dim"] = hf["head_dim"]
    if hf.get("model_type", "").startswith("gemma"):
        kw["norm_offset"] = True
        kw["embed_scale"] = True
    if hf.get("model_type", "").startswith("qwen3"):
        kw["qk_norm"] = True
    if hf.get("model_type") == "gemma2":
        kw["post_norms"] = True
        kw["alt_sliding"] = hf.get("sliding_window") is not None
        if hf.get("attn_logit_softcapping") is not None:
            kw["attn_logit_softcap"] = float(hf["attn_logit_softcapping"])
        if hf.get("final_logit_softcapping") is not None:
            kw["final_logit_softcap"] = float(hf["final_logit_softcapping"])
        if hf.get("query_pre_attn_scalar") is not None:
            kw["query_pre_attn_scalar"] = float(hf["query_pre_attn_scalar"])
    if hf.get("num_local_experts"):
        kw["n_experts"] = int(hf["num_local_experts"])
        kw["experts_per_tok"] = int(hf.get("num_experts_per_tok", 2))
    rs = hf.get("rope_scaling")
    if rs:
        rt = rs.get("rope_type", rs.get("type"))
        if rt == "llama3":  # Llama-3.1+ long-context remap
            kw["rope_scaling"] = (float(rs["factor"]), float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                                  float(rs["original_max_position_embeddings"]))
        elif rt not in (None, "default"):
            # serving with silently wrong positions is worse than failing
            raise ValueError(f"unsupported rope_scaling type {rt!r} (supported: llama3)")
    kw.update(overrides)
    return ModelConfig(**kw)


def iter_hf_tensors(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) streamed from every safetensors shard: shards sorted
    by name, each shard's tensors sorted by name."""
    for path in st.shard_files(model_dir):
        yield from st.iter_tensors(path)


def _np(a) -> np.ndarray:
    """A tensor or array as numpy (bf16 widened to f32, which holds it exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _to_f32(a) -> np.ndarray:
    return np.asarray(_np(a), np.float32)


def _bf16(a) -> torch.Tensor:
    """A CPU bf16 tensor (round to nearest even) of f32 values."""
    return torch.from_numpy(np.ascontiguousarray(_to_f32(a))).to(torch.bfloat16)


def _split_fused_layer(cfg: ModelConfig, t: dict, p: str) -> None:
    """Split Phi-3's fused projections into the per-tensor names, in place:
    ``self_attn.qkv_proj`` rows are [q | k | v], ``mlp.gate_up_proj`` rows
    [gate | up].  Checkpoints store projections unfused; the load re-fuses."""
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for stem, cuts in (
        (p + "self_attn.qkv_proj",
         (("self_attn.q_proj", 0, cfg.q_dim),
          ("self_attn.k_proj", cfg.q_dim, cfg.q_dim + kv_dim),
          ("self_attn.v_proj", cfg.q_dim + kv_dim, cfg.q_dim + 2 * kv_dim))),
        (p + "mlp.gate_up_proj",
         (("mlp.gate_proj", 0, cfg.ffn_dim),
          ("mlp.up_proj", cfg.ffn_dim, 2 * cfg.ffn_dim))),
    ):
        for kind in (".weight", ".bias"):
            fused = t.pop(stem + kind, None)
            if fused is None:
                continue
            if fused.shape[0] != cuts[-1][2]:
                raise ValueError(f"{stem}{kind} rows {fused.shape[0]} != expected {cuts[-1][2]}")
            for name, lo, hi in cuts:
                t[p + name + kind] = fused[lo:hi]


def _embed_ignored(ignore) -> bool:
    """True when the embedding table is ignore-listed (one substring rule
    against the HF module name, shared by every path)."""
    return any(s in "model.embed_tokens" for s in ignore)


def _embed_code(cfg: ModelConfig) -> np.ndarray:
    return fmt.NF4_CODE if cfg.quant_type == "nf4" else fmt.FP4_CODE


def _np_quant_linear(cfg: ModelConfig, w, bias) -> QuantLinear:
    """One linear quantized into a pair-K QuantLinear on the CPU (FP4 with
    ``cfg.variant``, NF4 as the lut variant), K padded to 8 * blocksize and N
    to 128 with zeros."""
    code = fmt.FP4_CODE if cfg.quant_type == "fp4" else fmt.NF4_CODE
    w = _to_f32(w)
    n_out, k_in = w.shape
    kq = 8 * cfg.blocksize
    k_pad = (k_in + kq - 1) // kq * kq
    n_pad = (n_out + 127) // 128 * 128
    if (k_pad, n_pad) != (k_in, n_out):
        wp = np.zeros((n_pad, k_pad), np.float32)
        wp[:n_out, :k_in] = w
        w = wp
    if cfg.quant_type == "nf4":
        packed, scale = quantize_pack_pairk_lut(w, code, blocksize=cfg.blocksize)
        variant = "lut"
    else:
        packed, scale = quantize_pack_pairk(w, blocksize=cfg.blocksize, variant=cfg.variant)
        variant = cfg.variant
    return QuantLinear(packed=packed, scale=scale, bias=None if bias is None else torch.from_numpy(_to_f32(bias)),
                       n_out=n_out, k_in=k_in, blocksize=cfg.blocksize, variant=variant, layout="pairk", k_shards=1,
                       codebook=None if cfg.quant_type == "fp4" else torch.from_numpy(code.copy()))


def _np_dense_linear(w, bias) -> DenseLinear:
    """An ignore-listed linear as a bf16 DenseLinear on the CPU."""
    w = _to_f32(w)
    n_out, k_in = w.shape
    return DenseLinear(w=_bf16(w.T), bias=None if bias is None else _bf16(bias), n_out=n_out, k_in=k_in)


# HF-serialized bitsandbytes 4-bit state (bnb QuantState.as_dict(packed=True)):
#   <stem>.weight                         uint8 (numel/2, 1) packed codes
#   <stem>.weight.absmax                  f32 (nblocks,)  [u8 when nested]
#   <stem>.weight.quant_map               f32 (16,)
#   <stem>.weight.quant_state.bitsandbytes__{fp4,nf4}
#                                         uint8 JSON blob: blocksize/shape/
#                                         dtype (+ nested_offset/_blocksize)
#   <stem>.weight.nested_absmax/.nested_quant_map   (double-quant only)
_BNB_META = ".weight.quant_state.bitsandbytes__"


def _bnb_state(t: dict, stem: str):
    """A layer's serialized bnb state as (packed_flat u8, absmax f32, shape,
    blocksize, quant_type, bias f32 or None), or None when ``stem`` is not
    bnb-quantized.  A double-quantized absmax is decoded here."""
    for qt in ("fp4", "nf4"):
        mk = f"{stem}{_BNB_META}{qt}"
        if mk in t:
            break
    else:
        return None
    qs = json.loads(bytes(np.asarray(_np(t[mk]), np.uint8).reshape(-1)).decode())
    shape = tuple(int(v) for v in qs["shape"])
    absmax = _np(t[f"{stem}.weight.absmax"])
    if f"{stem}.weight.nested_absmax" in t:
        absmax = dequantize_nested_absmax(absmax, _np(t[f"{stem}.weight.nested_absmax"]),
                                          _np(t[f"{stem}.weight.nested_quant_map"]), float(qs["nested_offset"]),
                                          int(qs.get("nested_blocksize", 256)))
    bias = t.get(f"{stem}.bias")
    return (_np(t[f"{stem}.weight"]).reshape(-1), absmax.astype(np.float32), shape, int(qs["blocksize"]), qt,
            None if bias is None else _to_f32(bias))


def _bnb_stored_linear(t: dict, stem: str, device="cpu"):
    """The EXACT QuantLinear of a serialized bnb layer (codes and absmax grid
    kept), or None when ``stem`` is not bnb-quantized."""
    s = _bnb_state(t, stem)
    if s is None:
        return None
    packed, absmax, shape, bs, qt, bias = s
    return from_bnb_state(packed, absmax, shape, blocksize=bs, quant_type=qt, bias=bias, device=device)


def _bnb_dense_weight(t: dict, stem: str):
    """A serialized bnb layer dequantized exactly to its (n_out, k_in) f32
    weight, and its bias (``ignore`` on a stored-quantized layer, or
    ``requantize``)."""
    packed, absmax, shape, bs, qt, bias = _bnb_state(t, stem)
    code = fmt.FP4_CODE if qt == "fp4" else fmt.NF4_CODE
    return fmt.dequantize_fp4(packed, absmax, shape, blocksize=bs, code=code), bias


def quantize_hf_weights(cfg: ModelConfig, tensors: dict, *, quantize_lm_head: bool = False, quant_type: str = "fp4",
                        ignore: tuple[str, ...] = (), requantize: bool = False, device=None) -> ModelParams:
    """Packed ModelParams on ``device`` (default CUDA) from HF-named tensors
    in memory (torch tensors or numpy arrays), with the streaming
    converter's rules: every linear quantized (pair-K), bnb-stored layers
    imported exactly (or quantized fresh with ``requantize``), layers whose
    name contains an ``ignore`` substring kept as bf16 DenseLinears, norms
    bf16, the embedding a QuantEmbedding when ``cfg.quantize_embed`` (and not
    ignore-listed), the lm_head dense unless ``quantize_lm_head``.  Phi-3's
    fused projections are split in ``tensors``, in place."""
    device = resolve_device(device)
    if quant_type != cfg.quant_type:
        cfg = dataclasses.replace(cfg, quant_type=quant_type)

    def ql(name: str):
        if any(s in name for s in ignore):
            if any(f"{name}{_BNB_META}{qt}" in tensors for qt in ("fp4", "nf4")):
                w, bias = _bnb_dense_weight(tensors, name)  # no fp weights stored
            else:
                w, bias = tensors[name + ".weight"], tensors.get(name + ".bias")
            return dense_linear(_to_f32(w), None if bias is None else _to_f32(bias), device=device)
        if _bnb_state(tensors, name) is not None:
            if requantize:
                return _np_quant_linear(cfg, *_bnb_dense_weight(tensors, name)).to(device)
            return _bnb_stored_linear(tensors, name, device=device)
        return _np_quant_linear(cfg, tensors[name + ".weight"], tensors.get(name + ".bias")).to(device)

    def norm(name: str):
        return _bf16(tensors[name]).to(device)

    an, mn, pan, pmn = norm_names(cfg)
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        _split_fused_layer(cfg, tensors, p)
        if cfg.n_experts:
            ep = p + "block_sparse_moe.experts."
            mlp = dict(moe=MoEParams(
                router=dense_linear(_to_f32(tensors[p + "block_sparse_moe.gate.weight"]), device=device),
                gate=stack_linears([ql(f"{ep}{m}.w1") for m in range(cfg.n_experts)]),
                up=stack_linears([ql(f"{ep}{m}.w3") for m in range(cfg.n_experts)]),
                down=stack_linears([ql(f"{ep}{m}.w2") for m in range(cfg.n_experts)]),
            ))
        else:
            mlp = dict(w_gate=ql(p + "mlp.gate_proj"), w_up=ql(p + "mlp.up_proj"), w_down=ql(p + "mlp.down_proj"))
        if pan is not None:
            mlp.update(post_attn_norm=norm(p + pan + ".weight"), post_mlp_norm=norm(p + pmn + ".weight"))
        if cfg.qk_norm:
            mlp.update(q_norm=norm(p + "self_attn.q_norm.weight"), k_norm=norm(p + "self_attn.k_norm.weight"))
        layers.append(LayerParams(
            attn_norm=norm(p + an + ".weight"), wq=ql(p + "self_attn.q_proj"), wk=ql(p + "self_attn.k_proj"),
            wv=ql(p + "self_attn.v_proj"), wo=ql(p + "self_attn.o_proj"), mlp_norm=norm(p + mn + ".weight"), **mlp,
        ))
    lm_name = "lm_head.weight" if "lm_head.weight" in tensors else "model.embed_tokens.weight"
    if quantize_lm_head:
        lm_head = ql(lm_name[: -len(".weight")])
    else:
        lm_head = dense_linear(_to_f32(tensors[lm_name]), device=device)
    if cfg.quantize_embed and not _embed_ignored(ignore):
        embed = quantize_embedding(_to_f32(tensors["model.embed_tokens.weight"]), cfg.blocksize, code=_embed_code(cfg),
                                   device=device)
    else:
        embed = norm("model.embed_tokens.weight")
    return ModelParams(embed=embed, layers=layers, final_norm=norm("model.norm.weight"), lm_head=lm_head)


def convert_hf_model(model_dir: str, out_dir: str, *, quant_type: str = "fp4", quantize_lm_head: bool = False,
                     quantize_embed: bool = False, ignore: tuple[str, ...] = (), variant: str = "ramp",
                     requantize: bool = False, verbose: bool = True, stats_out: dict | None = None) -> ModelConfig:
    """Stream-convert an HF llama/mistral-family checkpoint directory into a
    packed FP4 checkpoint in ``out_dir``; returns its ModelConfig.

    A host tool that reads and writes files, as the JAX package's is: it
    takes no device and never touches a card (the packing runs on the CPU,
    through the native C packer when a compiler is present), and the
    checkpoint is then loaded with ``load_checkpoint`` onto the card.

    Memory-bounded: tensors stream from the shards and each weight GROUP (a
    decoder layer, a Mixtral expert, the embedding, the lm_head) is
    quantized, written and freed as soon as its tensors have all arrived.
    Group membership comes from the shard headers, read first, so optional
    biases are known before streaming starts.  ``stats_out`` receives
    ``peak_pending_bytes`` (the most tensor bytes held at once),
    ``total_bytes`` and ``groups``.

    ``quant_type`` "fp4" (pair-K ``variant``: ramp, zramp or exact) or
    "nf4" (the lut variant).  ``ignore``: substrings of layer names kept as
    bf16 DenseLinears.  A tied checkpoint (no ``lm_head.weight``) gets its
    lm_head from the embedding.  A bitsandbytes-serialized source imports
    its stored codes exactly (its quant type, FP4 as the exact variant);
    with ``requantize`` the codes are dequantized exactly and quantized
    fresh to ``quant_type`` / ``variant``.
    """
    from .native import available as native_available

    cfg = config_from_hf(model_dir, quant_type=quant_type, variant=variant,
                         quantize_embed=quantize_embed and not _embed_ignored(ignore))

    # --- plan groups from the shard headers (no tensor data read) ---
    all_keys: set[str] = set()
    for path in st.shard_files(model_dir):
        all_keys.update(st.shard_keys(path))

    bnb_qt = next((qt for qt in ("fp4", "nf4") if any(k.endswith(_BNB_META + qt) for k in all_keys)), None)
    if bnb_qt is not None:
        if requantize:
            if verbose:
                print(f"bitsandbytes {bnb_qt} checkpoint detected: REQUANTIZING to {cfg.quant_type}/{cfg.variant} "
                      "(exact dequantize -> fresh pack; serving-speed tradeoff, see convert --help)")
        else:
            cfg = dataclasses.replace(cfg, quant_type=bnb_qt, variant="exact" if bnb_qt == "fp4" else cfg.variant)
            if verbose:
                print(f"bitsandbytes {bnb_qt} checkpoint detected: importing stored codes exactly (no requantization)")

    def group_of(key: str) -> str:
        if ".block_sparse_moe.experts." in key:
            # each Mixtral expert is its own group: its floats are quantized
            # and freed on arrival; only packed bytes wait for the layer
            parts = key.split(".")
            return f"layers.{parts[2]}.experts.{parts[5]}"
        if key.startswith("model.layers."):
            return "layers." + key.split(".")[2]
        if key == "model.embed_tokens.weight":
            return "embed"
        if key == "model.norm.weight":
            return "final_norm"
        if key.startswith("lm_head."):
            return "lm_head"
        return "_ignored"  # e.g. rotary inv_freq buffers of old checkpoints

    need: dict[str, set[str]] = defaultdict(set)
    for key in all_keys:
        need[group_of(key)].add(key)
    tied_lm = "lm_head.weight" not in all_keys

    def is_ignored(hf_name: str) -> bool:
        return any(s in hf_name for s in ignore)

    writer = CheckpointWriter(out_dir, cfg)

    def quant_or_dense(t: dict, stem: str):
        """One linear: a stored bnb layer imported exactly, or quantized
        fresh, or kept dense (ignore-listed)."""
        q = None
        if not is_ignored(stem) and not requantize:
            q = _bnb_stored_linear(t, stem)
        if q is None:
            w, bias = t.get(stem + ".weight"), t.get(stem + ".bias")
            if any(f"{stem}{_BNB_META}{qt}" in t for qt in ("fp4", "nf4")):
                # ignore-listed or requantized bnb layer: no fp weights are stored
                w, bias = _bnb_dense_weight(t, stem)
            if w is None:
                raise ValueError(f"checkpoint is missing tensor {stem + '.weight'!r} (incomplete safetensors shards?)")
            q = _np_dense_linear(w, bias) if is_ignored(stem) else _np_quant_linear(cfg, w, bias)
        return q

    expert_parts: dict[int, dict[int, dict]] = defaultdict(dict)
    layer_hold: dict[int, tuple] = {}

    def flush_expert(i: int, m: int, t: dict) -> None:
        ep = f"model.layers.{i}.block_sparse_moe.experts.{m}."
        # HF Mixtral expert naming: w1 = gate, w3 = up, w2 = down
        expert_parts[i][m] = {field: quant_or_dense(t, ep + wname)
                              for field, wname in (("gate", "w1"), ("up", "w3"), ("down", "w2"))}
        maybe_write_moe_layer(i)

    def maybe_write_moe_layer(i: int) -> None:
        if i not in layer_hold or len(expert_parts[i]) != cfg.n_experts:
            return
        arrays, meta, router = layer_hold.pop(i)
        parts = expert_parts.pop(i)
        moe = MoEParams(router=router, **{f: stack_linears([parts[m][f] for m in range(cfg.n_experts)])
                                          for f in ("gate", "up", "down")})
        meta["moe"] = _moe_to_arrays(f"layers.{i}.moe", moe, arrays)
        writer.put(f"layers.{i}", arrays, meta)
        if verbose:
            print(f"  assembled layers.{i} ({cfg.n_experts} experts)", flush=True)

    def flush_layer(i: int, t: dict) -> None:
        an, mn, pan, pmn = norm_names(cfg)
        p = f"model.layers.{i}."
        _split_fused_layer(cfg, t, p)
        arrays = {f"layers.{i}.attn_norm": _bf16(t[p + an + ".weight"]),
                  f"layers.{i}.mlp_norm": _bf16(t[p + mn + ".weight"])}
        if pan is not None:
            arrays[f"layers.{i}.post_attn_norm"] = _bf16(t[p + pan + ".weight"])
            arrays[f"layers.{i}.post_mlp_norm"] = _bf16(t[p + pmn + ".weight"])
        if cfg.qk_norm:
            arrays[f"layers.{i}.q_norm"] = _bf16(t[p + "self_attn.q_norm.weight"])
            arrays[f"layers.{i}.k_norm"] = _bf16(t[p + "self_attn.k_norm.weight"])
        meta: dict = {"kind": "layer", "linears": {}}
        fields = {f: s for f, s in _LINEAR_FIELDS.items() if not (cfg.n_experts and f in ("w_gate", "w_up", "w_down"))}
        for f, suffix in fields.items():
            m = _linear_to_arrays(f"layers.{i}.{f}", quant_or_dense(t, p + suffix), arrays)
            m["row_parallel"] = f in _ROW_PARALLEL
            meta["linears"][f] = m
        if cfg.n_experts:
            layer_hold[i] = (arrays, meta, _np_dense_linear(t[p + "block_sparse_moe.gate.weight"], None))
            maybe_write_moe_layer(i)
        else:
            writer.put(f"layers.{i}", arrays, meta)

    def flush_lm_head(w, bias, src_name: str = "lm_head") -> None:
        # the ignore list matches the SOURCE tensor name (a tied lm_head is "model.embed_tokens")
        if quantize_lm_head and not is_ignored(src_name):
            arrays: dict = {}
            meta = _linear_to_arrays("lm_head", _np_quant_linear(cfg, w, bias), arrays)
            meta["row_parallel"] = False
            writer.put("lm_head", arrays, meta)
        else:
            arrays = {"lm_head.w": _bf16(_to_f32(w).T)}
            if bias is not None:
                arrays["lm_head.bias"] = _bf16(bias)
            writer.put("lm_head", arrays, {"kind": "dense"})

    # --- stream ---
    pending: dict[str, dict] = defaultdict(dict)
    pending_bytes = peak_pending = total_bytes = 0
    done: set[str] = set()

    def flush(group: str) -> None:
        nonlocal pending_bytes
        t = pending.pop(group)
        if group == "embed":
            w = t["model.embed_tokens.weight"]
            if cfg.quantize_embed and not is_ignored("model.embed_tokens"):
                writer.put("embed", *_embed_to_arrays(
                    quantize_embedding(_to_f32(w), cfg.blocksize, code=_embed_code(cfg), device="cpu")))
            else:
                writer.put("embed", {"embed.w": _bf16(w)}, {"kind": "dense_embed"})
            if tied_lm:
                flush_lm_head(w, None, src_name="model.embed_tokens")
        elif group == "final_norm":
            writer.put("final_norm", {"final_norm.w": _bf16(t["model.norm.weight"])}, {"kind": "norm"})
        elif group == "lm_head":
            flush_lm_head(t["lm_head.weight"], t.get("lm_head.bias"), src_name="lm_head")
        elif ".experts." in group:
            _, i, _, m = group.split(".")
            flush_expert(int(i), int(m), t)
        elif group.startswith("layers."):
            flush_layer(int(group.split(".")[1]), t)
        pending_bytes -= sum(a.nbytes for a in t.values())
        done.add(group)
        if verbose:
            print(f"  wrote {group}", flush=True)

    for name, arr in iter_hf_tensors(model_dir):
        g = group_of(name)
        if g == "_ignored":
            continue
        pending[g][name] = arr
        pending_bytes += arr.nbytes
        total_bytes += arr.nbytes
        peak_pending = max(peak_pending, pending_bytes)
        if set(pending[g]) == need[g]:
            flush(g)

    missing = {g: sorted(need[g] - set(pending.get(g, {}))) for g in need if g not in done and g != "_ignored"}
    if any(missing.values()):
        raise ValueError(f"checkpoint incomplete; missing tensors: {missing}")
    writer.finish()
    if stats_out is not None:
        stats_out.update(peak_pending_bytes=peak_pending, total_bytes=total_bytes, groups=len(done))
    if verbose:
        packer = "native C" if native_available() else "torch"
        print(f"wrote packed checkpoint to {out_dir} (peak pending {peak_pending/2**20:.1f} MiB of "
              f"{total_bytes/2**20:.1f} MiB total; packer {packer})", flush=True)
    return cfg
