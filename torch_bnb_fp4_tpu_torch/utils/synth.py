"""Synthetic model builders for benchmarks and chip_smoke.py.

Kernel and decode speed do not depend on the weight values, so a model is
built from random packed bytes made directly on the device from a seeded
``torch.Generator``: a 7B model materializes in seconds with no host copy.
"""

from __future__ import annotations

import torch

from ..models.linear import DenseLinear, QuantLinear
from ..models.transformer import LayerParams, ModelConfig, ModelParams, MoEParams, fuse_layer, kv_slot_positions
from ..utils.device import resolve_device


def synth_quant_linear(gen: torch.Generator, n_out: int, k_in: int, *, blocksize: int = 64,
                       layout: str = "pairk", k_shards: int = 1, absmax_scale: float = 0.01, variant: str = "ramp",
                       experts: int = 0, device=None) -> QuantLinear:
    """Random QuantLinear with uniform bytes.  Pair-K: f32 scales in
    [0.5, 1.5) * absmax_scale / 192.  Split-K: FP4 absmax hi and lo halves
    each in [0.5, 1.5) * absmax_scale, ``k_shards`` self-contained K slices
    (the JAX package's ``synth_quant_linear``).  ``experts > 0`` makes a
    stack of that many (a leading expert axis on every tensor)."""
    device = resolve_device(device)
    if k_in % (2 * blocksize) or n_out % 128:
        raise ValueError(f"synthetic layers need K % {2 * blocksize} == 0 and N % 128 == 0, got {n_out}x{k_in}")
    if layout not in ("pairk", "splitk"):
        raise ValueError(f"layout must be 'pairk' or 'splitk', got {layout!r}")
    lead = (experts,) if experts else ()
    packed = torch.randint(0, 256, (*lead, k_in // 2, n_out), generator=gen, dtype=torch.uint8, device=device)
    if layout == "pairk":
        u = torch.rand((*lead, k_in // blocksize, n_out), generator=gen, dtype=torch.float32, device=device)
        return QuantLinear(packed=packed, scale=(u + 0.5) * (absmax_scale / 192.0), bias=None, n_out=n_out,
                           k_in=k_in, blocksize=blocksize, variant=variant)
    if k_in % (k_shards * 2 * blocksize):
        raise ValueError(f"K={k_in} does not cut into {k_shards} split-K shards of blocksize {blocksize}")
    hi, lo = (torch.rand((*lead, k_in // (2 * blocksize), n_out), generator=gen, dtype=torch.float32,
                         device=device) for _ in range(2))
    return QuantLinear(packed=packed, scale=(hi + 0.5) * absmax_scale, scale_lo=(lo + 0.5) * absmax_scale,
                       bias=None, n_out=n_out, k_in=k_in, blocksize=blocksize, variant="exact", layout="splitk",
                       k_shards=k_shards)


def synth_dense_linear(gen: torch.Generator, n_out: int, k_in: int, *, scale: float = 0.01,
                       dtype=torch.bfloat16, experts: int = 0, device=None) -> DenseLinear:
    device = resolve_device(device)
    lead = (experts,) if experts else ()
    w = torch.randn((*lead, k_in, n_out), generator=gen, dtype=torch.float32, device=device) * scale
    return DenseLinear(w=w.to(dtype), bias=None, n_out=n_out, k_in=k_in)


def synth_params(cfg: ModelConfig, *, quantized: bool = True, seed: int = 0, tp: int = 1, layout: str = "pairk",
                 fuse: bool = False, device=None) -> ModelParams:
    """Random ModelParams, quantized FP4 or dense bf16, built on ``device``
    from ``seed``.  ``layout`` "pairk" (f32 scales) or "splitk" (FP4 codes,
    true absmax; wo, w_down and the experts' down packed with ``k_shards =
    tp``, the row-parallel layout; ``tp`` sets nothing else, the port has no
    tensor parallelism).  A mixture-of-experts config gets stacked experts
    and a dense router of scale 1 (as the JAX package's ``synth_params``);
    the lm_head is dense.  ``fuse`` fuses each pair-K layer as it is built,
    so the unfused and fused copies of only one layer coexist; split-K
    layers are never fused."""
    device = resolve_device(device)
    if quantized and (cfg.quantize_embed or cfg.quantize_lm_head):
        raise NotImplementedError("quantized embedding / lm_head synthesis is not yet ported")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    def lin(n_out, k_in, experts=0, k_shards=1):
        if quantized:
            return synth_quant_linear(gen, n_out, k_in, blocksize=cfg.blocksize, layout=layout,
                                      k_shards=k_shards if layout == "splitk" else 1, variant=cfg.variant,
                                      experts=experts, device=device)
        return synth_dense_linear(gen, n_out, k_in, experts=experts, device=device)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        extra = {}
        if cfg.qk_norm:
            extra.update(q_norm=ones(cfg.head_dim), k_norm=ones(cfg.head_dim))
        if cfg.post_norms:
            extra.update(post_attn_norm=ones(cfg.dim), post_mlp_norm=ones(cfg.dim))
        lp = LayerParams(attn_norm=ones(cfg.dim), wq=lin(cfg.q_dim, cfg.dim), wk=lin(kv_dim, cfg.dim),
                         wv=lin(kv_dim, cfg.dim), wo=lin(cfg.dim, cfg.q_dim, k_shards=tp), mlp_norm=ones(cfg.dim),
                         **extra)
        e = cfg.n_experts
        if e:
            lp.moe = MoEParams(router=synth_dense_linear(gen, e, cfg.dim, scale=1.0, device=device),
                               gate=lin(cfg.ffn_dim, cfg.dim, e), up=lin(cfg.ffn_dim, cfg.dim, e),
                               down=lin(cfg.dim, cfg.ffn_dim, e, k_shards=tp))
        else:
            lp.w_gate, lp.w_up = lin(cfg.ffn_dim, cfg.dim), lin(cfg.ffn_dim, cfg.dim)
            lp.w_down = lin(cfg.dim, cfg.ffn_dim, k_shards=tp)
        layers.append(fuse_layer(lp) if fuse and quantized else lp)
    embed = (torch.randn((cfg.vocab_size, cfg.dim), generator=gen, dtype=torch.float32, device=device)
             * 0.01).to(torch.bfloat16)
    return ModelParams(embed=embed, layers=layers, final_norm=ones(cfg.dim),
                       lm_head=synth_dense_linear(gen, cfg.vocab_size, cfg.dim, device=device))


def synth_attention(b: int, lq: int, lk: int, hq: int, hk: int, d: int, *, lens, q_offset=None, seed: int = 0,
                    device=None) -> tuple[torch.Tensor, ...]:
    """Operands of one attention call over an Lk-row KV cache: (q, k, v,
    q_positions, kv_valid, kv_positions).  q (B, Lq, Hq, D) and k, v (B, Lk,
    Hk, D) are bf16 standard normals from ``seed``; row i of the cache has
    seen ``lens[i]`` positions (in ring order once lens[i] > Lk, as
    :func:`kv_slot_positions` recovers them); the queries sit at ``q_offset``
    + arange(Lq), by default the last Lq positions of each row."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    q, k, v = randn(b, lq, hq, d), randn(b, lk, hk, d), randn(b, lk, hk, d)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=device).expand(b).contiguous()
    start = lens - lq if q_offset is None else torch.as_tensor(q_offset, dtype=torch.int32, device=device).expand(b)
    q_positions = start[:, None] + torch.arange(lq, dtype=torch.int32, device=device)[None, :]
    kv_positions, kv_valid = kv_slot_positions(lens, lk)
    return q, k, v, q_positions.contiguous(), kv_valid, kv_positions
