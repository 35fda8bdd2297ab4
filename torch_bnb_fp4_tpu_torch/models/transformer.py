"""Llama/Mistral-family decoder with FP4 linears (pair-K or split-K), in PyTorch.

Counterpart of ``torch_bnb_fp4_tpu/models/transformer.py`` for the dense
families.  Parameters are plain dataclasses of tensors; ``forward`` runs
eagerly and writes the KV cache IN PLACE (the JAX version is functional and
returns a fresh cache; here the returned ``KVCache`` shares the per-layer
tensors with the one passed in and only ``length`` is new).

Sliding-window layers may keep rolling rings of ``ring_rows`` rows
(``KVCache.zeros(write_chunk > 0)``).  Attention takes the flash route (K7,
``ops/attention.py``) at Lq * Lk >= ``_FLASH_MIN_CELLS`` with Lq >= 128, on
either device: the card runs the CUDA kernel and the CPU its plain version.
Shorter shapes take the dense, query-chunked path.

Mixture-of-experts layers (Mixtral) keep their experts STACKED
(:class:`MoEParams`); :func:`moe_forward` routes on the device and runs each
expert through the K8 forms of K2-K4 (``models.linear.apply_expert_linear``)
or, for a split-K stack, K9b on the expert's :func:`expert_view`, so no
routing decision is read on the host.

The token embedding is a bf16 table or, with ``cfg.quantize_embed``, a
:class:`QuantEmbedding` (FP4/NF4 codes decoded per looked-up row).
:func:`dense_params` builds the bf16 twin of a model from HF-named weights and
:func:`reference_forward` is the cache-free unquantized oracle.

Adapters (``models/lora.py``) wrap unfused linears in ``LoRALinear`` or
``MultiLoRALinear``; the latter needs ``forward(adapter_idx=...)``, a (B,)
int32 device tensor that every layer linear receives.

Tensor parallelism (``parallel/tp.py``): ``forward(group=...)`` runs a rank's
local shard of the params (column-parallel wq/wk/wv/w_gate/w_up, row-parallel
wo/w_down, vocab-sharded lm_head) with the local head counts taken from the
local widths, and sums the two row-parallel outputs of each layer over the
model group (Megatron's pattern: 2 all-reduces per dense layer, 1 for the
weighted expert sum of a MoE layer).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kernels as K
from ..ops.attention import flash_attention
from ..utils.device import resolve_device
from .linear import (DenseLinear, MultiLoRALinear, QuantLinear, apply_expert_linear, dense_linear, fuse_linears,
                     quantize_linear)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static decoder geometry (same fields and presets as the JAX package)."""

    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: int | None = None
    quantize_lm_head: bool = False
    quantize_embed: bool = False
    blocksize: int = 64
    quant_type: str = "fp4"
    attn_bias: bool = False
    variant: str = "ramp"
    head_dim: int | None = None
    hidden_act: str = "silu"
    norm_offset: bool = False
    embed_scale: bool = False
    rope_scaling: tuple[float, float, float, float] | None = None
    n_experts: int = 0
    experts_per_tok: int = 2
    post_norms: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    alt_sliding: bool = False
    qk_norm: bool = False

    def layer_sliding_window(self, i: int) -> int | None:
        if self.alt_sliding and i % 2:
            return None
        return self.sliding_window

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.dim // self.n_heads)
        if self.rope_scaling is not None:
            object.__setattr__(self, "rope_scaling", tuple(self.rope_scaling))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @classmethod
    def mistral_7b(cls) -> "ModelConfig":
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                   ffn_dim=14336, rope_theta=1e6, sliding_window=4096)

    @classmethod
    def tinyllama_1b(cls) -> "ModelConfig":
        return cls(vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
                   ffn_dim=5632, rope_theta=10000.0)

    @classmethod
    def llama2_70b(cls) -> "ModelConfig":
        return cls(vocab_size=32000, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                   ffn_dim=28672, rope_theta=10000.0)

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                   ffn_dim=14336, rope_theta=500000.0)

    @classmethod
    def qwen2_7b(cls) -> "ModelConfig":
        return cls(vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
                   ffn_dim=18944, rope_theta=1e6, rms_eps=1e-6, attn_bias=True)

    @classmethod
    def qwen3_8b(cls) -> "ModelConfig":
        return cls(vocab_size=151936, dim=4096, n_layers=36, n_heads=32, n_kv_heads=8,
                   ffn_dim=12288, rope_theta=1e6, rms_eps=1e-6, head_dim=128, qk_norm=True)

    @classmethod
    def phi3_mini(cls) -> "ModelConfig":
        return cls(vocab_size=32064, dim=3072, n_layers=32, n_heads=32, n_kv_heads=32,
                   ffn_dim=8192, rope_theta=10000.0)

    @classmethod
    def gemma_7b(cls) -> "ModelConfig":
        return cls(vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
                   ffn_dim=24576, rms_eps=1e-6, head_dim=256, hidden_act="gelu_tanh",
                   norm_offset=True, embed_scale=True)

    @classmethod
    def gemma2_9b(cls) -> "ModelConfig":
        return cls(vocab_size=256000, dim=3584, n_layers=42, n_heads=16, n_kv_heads=8,
                   ffn_dim=14336, rms_eps=1e-6, head_dim=256, hidden_act="gelu_tanh",
                   norm_offset=True, embed_scale=True, post_norms=True,
                   sliding_window=4096, alt_sliding=True,
                   attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=256.0)

    @classmethod
    def mixtral_8x7b(cls) -> "ModelConfig":
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                   ffn_dim=14336, rope_theta=1e6, n_experts=8, experts_per_tok=2)

    @classmethod
    def tiny_test(cls, **kw) -> "ModelConfig":
        """Small geometry for CPU tests (K multiples of 1024)."""
        d = dict(vocab_size=256, dim=1024, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=2048)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass
class MoEParams:
    """Mixture-of-experts MLP state (Mixtral family; the JAX package's
    ``MoEParams``).  ``router`` is a dense (dim -> n_experts) linear, never
    quantized.  ``gate``/``up``/``down`` (and the fused ``gateup``) are
    STACKED linears: every tensor carries a leading n_experts axis
    (:func:`stack_linears`), which lets a token's expert be chosen by an index
    in device memory."""

    router: Any  # DenseLinear (dim -> n_experts)
    gate: Any  # stacked QuantLinear/DenseLinear; None when gateup is fused
    up: Any
    down: Any
    gateup: Any = None

    def to(self, device) -> "MoEParams":
        return MoEParams(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


def stack_linears(linears: list) -> Any:
    """Stack same-shape QuantLinears or DenseLinears into one whose tensors
    gain a leading expert axis (their static fields must match)."""
    l0 = linears[0]
    static = [f.name for f in dataclasses.fields(l0) if not isinstance(getattr(l0, f.name), torch.Tensor)
              and getattr(l0, f.name) is not None]
    for l in linears:
        if type(l) is not type(l0) or any(getattr(l, n) != getattr(l0, n) for n in static):
            raise ValueError("stacked linears must share their type and static fields")
        if isinstance(l, QuantLinear) and l.w8 is not None:
            raise ValueError("stacked linears carry no int8 shadow")

    def stack(name):
        ts = [getattr(l, name) for l in linears]
        if all(t is None for t in ts):
            return None
        return torch.stack(ts)

    return dataclasses.replace(l0, **{f.name: stack(f.name) for f in dataclasses.fields(l0)
                                      if f.name not in static})


def expert_view(stacked: Any, e) -> Any:
    """Expert ``e`` of a stacked linear as an ordinary linear: ``e`` a Python
    int, or a one-element index tensor on the device (a gather, clamped into
    range as JAX's ``dynamic_index_in_dim``; never read on the host)."""
    names = [f.name for f in dataclasses.fields(stacked) if isinstance(getattr(stacked, f.name), torch.Tensor)]
    return dataclasses.replace(stacked, **dict(zip(names, K.select_expert(e, *(getattr(stacked, n) for n in names)))))


@dataclasses.dataclass
class QuantEmbedding:
    """Blockwise FP4/NF4 token-embedding table (``cfg.quantize_embed``; the
    JAX package's ``QuantEmbedding``, models/transformer.py:298).  Mistral-7B's
    32000 x 4096 table: 262 MB in bf16, 74 MB packed (65.5 MB of codes and
    8.2 MB of f32 absmax at blocksize 64).

    The layout is made for a row gather, not the matmul pair-K layout: bnb's
    flat row-major codes, two per byte, HIGH nibble first along the feature
    dim, one f32 absmax per ``blocksize`` features, so each token's row stands
    alone.  :meth:`lookup` decodes the looked-up rows with a 16-entry table
    gather in plain torch (as the JAX package does in jnp: a step touches B
    rows, no kernel is warranted), with the EXACT codebook (FP4 or NF4), and
    runs without a host sync, so a decode step that looks tokens up from a
    static buffer stays capturable in a CUDA graph."""

    packed: torch.Tensor  # (vocab, dim // 2) uint8, high nibble first
    scale: torch.Tensor  # (vocab, dim // blocksize) f32 absmax
    code: torch.Tensor  # (16,) f32 codebook values (FP4_CODE or NF4_CODE)
    vocab_size: int
    dim: int
    blocksize: int = 64

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "QuantEmbedding":
        return dataclasses.replace(self, packed=self.packed.to(device), scale=self.scale.to(device),
                                   code=self.code.to(device))

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (...,) int -> embeddings (..., dim) bf16: code[nibble] *
        absmax in f32, rounded once to bf16."""
        t = tokens.long()
        p, s = self.packed[t], self.scale[t]  # (..., dim/2) u8, (..., dim/bs) f32
        idx = torch.stack([p >> 4, p & 0xF], dim=-1).reshape(*p.shape[:-1], self.dim).long()
        vals = self.code[idx].reshape(*s.shape, self.blocksize) * s[..., None]
        return vals.reshape(*p.shape[:-1], self.dim).to(torch.bfloat16)


def quantize_embedding(w: np.ndarray, blocksize: int = 64, code: np.ndarray | None = None,
                       device=None) -> QuantEmbedding:
    """Quantize a (vocab, dim) table into a :class:`QuantEmbedding` on
    ``device`` (default CUDA) with the numpy golden (``ops/format``).  Blocks
    must not straddle rows (each row looked up alone), so ``dim`` must divide
    by ``blocksize``."""
    from ..ops import format as fmt

    device = resolve_device(device)
    code = fmt.FP4_CODE if code is None else np.asarray(code, np.float32)
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError(f"embedding table must be 2-D, got {w.shape}")
    v, d = w.shape
    if d % blocksize:
        raise ValueError(f"dim {d} not divisible by blocksize {blocksize}")
    codes, absmax = fmt.quantize_codes(w, blocksize, code)
    return QuantEmbedding(packed=torch.from_numpy(fmt.pack_flat(codes).reshape(v, d // 2)).to(device),
                          scale=torch.from_numpy(absmax.reshape(v, d // blocksize)).to(device),
                          code=torch.from_numpy(code.copy()).to(device), vocab_size=v, dim=d, blocksize=blocksize)


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token lookup for either embedding representation -> (..., dim) bf16."""
    if isinstance(embed, QuantEmbedding):
        return embed.lookup(tokens)
    return embed[tokens.long()].to(torch.bfloat16)


@dataclasses.dataclass
class LayerParams:
    attn_norm: torch.Tensor  # (dim,) bf16
    wq: Any  # QuantLinear/DenseLinear, or None when wqkv is fused
    wk: Any
    wv: Any
    wo: Any
    mlp_norm: torch.Tensor
    w_gate: Any = None
    w_up: Any = None
    w_down: Any = None
    wqkv: Any = None
    w_gateup: Any = None
    moe: Any = None
    post_attn_norm: Any = None
    post_mlp_norm: Any = None
    q_norm: Any = None
    k_norm: Any = None


@dataclasses.dataclass
class ModelParams:
    embed: Any  # (vocab, dim) bf16, or QuantEmbedding with cfg.quantize_embed
    layers: list[LayerParams]
    final_norm: torch.Tensor  # (dim,) bf16
    lm_head: Any  # DenseLinear (dim -> vocab) or QuantLinear


def params_to(params: ModelParams, device) -> ModelParams:
    """A copy of ``params`` with every tensor on ``device``."""
    def mv(v):
        if v is None:
            return None
        return v.to(device)

    layers = [LayerParams(**{f.name: mv(getattr(lp, f.name)) for f in dataclasses.fields(LayerParams)})
              for lp in params.layers]
    return ModelParams(embed=mv(params.embed), layers=layers, final_norm=mv(params.final_norm),
                       lm_head=mv(params.lm_head))


def ring_rows(cap: int, window: int | None, write_chunk: int) -> int:
    """KV rows of one layer: ``cap`` for global attention, or a rolling ring of
    ``ceil(window / c + 1) * c`` rows (c = ``write_chunk``) for a sliding-window
    layer.  ``R % c == 0`` and ``R >= window + c`` keep every write of up to c
    rows at a multiple of c (chunked prefill), or of one row anywhere
    (decode), inside the ring without wrapping, and keep every key a chunk's
    oldest query may see."""
    if window is None or write_chunk <= 0:
        return cap
    c = write_chunk
    return min(cap, (-(-window // c) + 1) * c)


@dataclasses.dataclass
class KVCache:
    """KV cache, one (B, rows_i, n_kv, head_dim) pair per layer in its storage
    dtype (bf16, or ``float8_e4m3fn``, written through :func:`kv_cast`), with
    a per-sequence ``length`` (B,) int32 (continuous batching needs one write
    offset per slot).

    ``rows_i`` is ``max_len``, or with ``write_chunk > 0`` a rolling ring of
    ``ring_rows`` rows on sliding-window layers (Mistral-7B at max_len 8192 and
    chunk 256: 4352 rows on all 32 layers).  Writes land at ``length % rows``;
    :func:`kv_slot_positions` recovers each slot's position, so ring and
    full-size caches share one code path."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    length: torch.Tensor

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, write_chunk: int = 0,
              device=None) -> "KVCache":
        """``write_chunk > 0``: the caller promises every multi-row write is at
        most ``write_chunk`` rows starting at a multiple of it."""
        device = resolve_device(device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            shape = (batch, ring_rows(max_len, cfg.layer_sliding_window(i), write_chunk), cfg.n_kv_heads,
                     cfg.head_dim)
            ks.append(torch.zeros(shape, dtype=dtype, device=device))
            vs.append(torch.zeros(shape, dtype=dtype, device=device))
        return cls(k=ks, v=vs, length=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return max(a.shape[1] for a in self.k)

    @property
    def min_rows(self) -> int:
        """Smallest per-layer row count: positions older than this many steps
        back may be evicted (ring layers)."""
        return min(a.shape[1] for a in self.k)


def kv_slot_positions(new_len: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, valid), each (B, rows): slot s of an R-row cache holds the
    latest position p < new_len with p = s (mod R); a slot whose residue has
    no such position gets p < 0 (invalid).  For a cache that never wrapped
    this is arange with valid = p < new_len."""
    last = new_len[:, None] - 1
    s = torch.arange(rows, dtype=torch.int32, device=new_len.device)[None, :]
    p = last - torch.remainder(last - s, rows)
    return p, p >= 0


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, offset: bool = False) -> torch.Tensor:
    """Llama order: normalize in f32, downcast, then multiply by the bf16
    weight; Gemma (``offset``) multiplies by (1 + w) in f32 first."""
    xf = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)  # xf * rsqrt(mean(xf^2) + eps)
    if offset:
        return (xf * (1.0 + weight.float())).to(x.dtype)
    return xf.to(x.dtype) * weight


def _act(cfg: ModelConfig, gate: torch.Tensor) -> torch.Tensor:
    g = gate.float()
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(g, approximate="tanh")
    return F.silu(g)


def rope_tables(positions: torch.Tensor, d: int, theta: float,
                scaling: tuple[float, float, float, float] | None = None):
    """(cos, sin), each (B, L, 1, d/2) f32, for ``positions`` (B, L).
    ``scaling`` applies the Llama-3.1 frequency remap."""
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32, device=positions.device) / (d // 2))
    if scaling is not None:
        factor, lo_f, hi_f, orig = scaling
        wavelen = torch.full_like(freqs, 2.0 * math.pi) / freqs
        smooth = (torch.full_like(freqs, orig) / wavelen - lo_f) / (hi_f - lo_f)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        freqs = (1.0 - smooth) * freqs / factor + smooth * freqs
    angles = positions.float()[..., None] * freqs  # (B, L, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, L, H, D) in f32, half-split layout."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: tuple[float, float, float, float] | None = None) -> torch.Tensor:
    """Rotary embedding of x (B, L, H, D) at positions (B, L)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, scaling))


_ATTN_QUERY_CHUNK = 512
# Lq * Lk at which attention takes the flash route (the JAX package's value,
# models/transformer.py:500); the H100's own crossover is measured by
# chip_smoke.py phase 3b and written in PERF.md
_FLASH_MIN_CELLS = 256 * 4096


def _use_flash(lq: int, lk: int) -> bool:
    """By shape alone, on either device (the JAX package also requires a TPU
    backend, so on the CPU it stays dense where the port does not)."""
    return lq * lk >= _FLASH_MIN_CELLS and lq >= 128


def attention_mask(q_positions, kv_positions, kv_valid, sliding_window):
    """(B, 1, 1, Lq, Lk) bool: key visible to the query (causal, written,
    inside the sliding window)."""
    qpos = q_positions[:, None, None, :, None]
    kpos = kv_positions[:, None, None, None, :]
    mask = (kpos <= qpos) & kv_valid[:, None, None, None, :]
    if sliding_window is not None:
        mask = mask & (kpos > qpos - sliding_window)
    return mask


def _attention_route(q_positions, kv_positions, kv_valid, sliding_window):
    """Causal GQA attention over one (cache rows, window), routed once by
    shape: long shapes (:func:`_use_flash`) go to ``flash_attention`` (K7),
    the others to the dense route over the mask built here.  Returns
    ``attend(q, k, v, scale, logit_softcap)``."""
    if _use_flash(q_positions.shape[1], kv_positions.shape[1]):
        return lambda q, k, v, scale, cap: flash_attention(q, k, v, q_positions, kv_valid, kv_positions,
                                                           sliding_window, scale, cap)
    blocked = ~attention_mask(q_positions, kv_positions, kv_valid, sliding_window)
    return lambda q, k, v, scale, cap: _attention_chunked(q, k, v, blocked, scale, cap)


def _attention_chunked(q, k, v, blocked, scale=None, logit_softcap=None):
    """The dense route, chunked over the query axis at 512 rows (exact: each
    query row's softmax is independent), so the f32 logits stay (B, Hk, G,
    512, Lk)."""
    lq = q.shape[1]
    if lq > _ATTN_QUERY_CHUNK:
        c = _ATTN_QUERY_CHUNK
        return torch.cat([_attention_dense(q[:, c0 : c0 + c], k, v, blocked[:, :, :, c0 : c0 + c], scale,
                                           logit_softcap) for c0 in range(0, lq, c)], dim=1)
    return _attention_dense(q, k, v, blocked, scale, logit_softcap)


def _attention_dense(q, k, v, blocked, scale=None, logit_softcap=None):
    b, lq, hq, d = q.shape
    hk = k.shape[2]
    group = hq // hk
    qf = q.reshape(b, lq, hk, group, d).float()
    logits = torch.einsum("blhgd,bshd->bhgls", qf, k.float()) * (1.0 / np.sqrt(d) if scale is None else scale)
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    probs = torch.softmax(logits.masked_fill_(blocked, -1e30), dim=-1)
    out = torch.einsum("bhgls,bshd->blhgd", probs, v.float())
    return out.reshape(b, lq, hq, d).to(q.dtype)


def _attn_scale(cfg: ModelConfig) -> float | None:
    if cfg.query_pre_attn_scalar is not None:
        return 1.0 / np.sqrt(cfg.query_pre_attn_scalar)
    return None


@dataclasses.dataclass
class _StepContext:
    """What every layer of one forward shares: RoPE tables, the KV write
    rows, and the attention of each (cache rows, sliding window)."""

    cos: torch.Tensor
    sin: torch.Tensor
    write_b: torch.Tensor  # (B, L) batch index of each written row
    write_rows: dict  # cache rows -> (B, L) row index (start clamped as JAX's dynamic_update_slice)
    attend: dict  # (cache rows, window) -> attend(q, k, v, scale, logit_softcap), from _attention_route


E4M3_MAX = 448.0


def kv_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a KV cache's storage ``dtype``.  For ``float8_e4m3fn`` the
    rounding is written out, so that the CPU and the card write the same byte
    whatever PyTorch's own cast does on each: round to nearest even, which is
    the byte JAX's ``astype`` writes for |x| <= 464, and saturation to +-448
    above, where JAX writes NaN (ROADMAP R6).  NaN stays NaN.  Other dtypes
    take PyTorch's cast."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.float()
    a = xf.abs().clamp(max=E4M3_MAX)
    e = torch.frexp(a).exponent  # a in [2^(e-1), 2^e)
    # the e4m3 spacing there: 2^(e-4) (3 mantissa bits), 2^-9 below 2^-6 (subnormals); built from its bits
    step = ((e - 4).clamp(min=-9) + 127).to(torch.int32).bitwise_left_shift(23).view(torch.float32)
    return torch.copysign(torch.round(a / step) * step, xf).to(dtype)


def _write_kv(cache: torch.Tensor, new: torch.Tensor, ctx: _StepContext) -> None:
    """Write ``new`` (B, L, Hk, D) at each sequence's offset, IN PLACE."""
    cache[ctx.write_b, ctx.write_rows[cache.shape[1]]] = kv_cast(new, cache.dtype)


def _apply_expert(stacked, e, x, **kw):
    """Expert ``e`` of a stacked linear applied to ``x``: a pair-K stack
    through K8 (``apply_expert_linear``, no copy of the expert), a split-K
    or dense stack through its :func:`expert_view` (the JAX package's
    ``_apply_expert``; the index stays on the device)."""
    if isinstance(stacked, QuantLinear) and stacked.layout == "pairk":
        return apply_expert_linear(stacked, e, x, **kw)
    return expert_view(stacked, e)(x, **kw)


def _expert_ffn(moe: MoEParams, cfg: ModelConfig, e, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU of expert ``e`` on rows x (T, dim) -> f32 (T, dim), in the op
    order of the dense MLP branch of :func:`_layer_forward`."""
    if moe.gateup is not None:
        gate, up = torch.chunk(_apply_expert(moe.gateup, e, x), 2, dim=-1)
    else:
        gate, up = _apply_expert(moe.gate, e, x), _apply_expert(moe.up, e, x)
    return _apply_expert(moe.down, e, _act(cfg, gate).to(up.dtype) * up, out_dtype=torch.float32)


def moe_forward(moe: MoEParams, cfg: ModelConfig, x: torch.Tensor, force_dense: bool | None = None,
                group=None) -> torch.Tensor:
    """Sparse-MoE MLP (the JAX package's ``moe_forward``, HF
    MixtralSparseMoeBlock semantics): router softmax in f32, top
    ``experts_per_tok`` (sorted), renormalized over the selected k, weighted
    sum of the expert outputs.  x (..., dim) -> f32 (..., dim).

    Two exact strategies, chosen by shape alone (``force_dense`` overrides):
    per-token when T * k <= n_experts (decode: each token runs its k experts,
    whose indices stay on the device as elements of the int32 ``top_i``), else
    all-experts (prefill: every expert runs all T rows, weighted by each
    token's routing mass, zero where it was not chosen).  Neither reads a
    routing decision on the host, so a decode step needs no host sync and
    replays as a CUDA graph.

    With a tensor-parallel ``group`` the experts are local shards and the
    result is this rank's partial of the weighted sum, which the caller sums
    over the group; an expert down bias is refused there (it would be added
    once per rank)."""
    if group is not None and getattr(moe.down, "bias", None) is not None:
        raise ValueError("expert down-projection bias is unsupported under TP")
    *lead, d = x.shape
    t = math.prod(lead)
    xt = x.reshape(t, d)
    probs = torch.softmax(moe.router(xt, out_dtype=torch.float32), dim=-1)  # (T, E)
    top_w, top_i = torch.topk(probs, cfg.experts_per_tok, dim=-1, sorted=True)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    top_i = top_i.to(torch.int32).contiguous()  # K8 reads its expert as an int32 in device memory
    per_token = t * cfg.experts_per_tok <= cfg.n_experts if force_dense is None else not force_dense
    if per_token:
        rows = []
        for ti in range(t):
            acc = None  # acc = 0 + w_0 y_0 + w_1 y_1 + ..., in j order
            for j in range(cfg.experts_per_tok):
                wy = top_w[ti, j] * _expert_ffn(moe, cfg, top_i[ti, j], xt[ti : ti + 1])[0]
                acc = wy if acc is None else acc + wy
            rows.append(acc)
        out = torch.stack(rows)
    else:
        out = None
        for e in range(cfg.n_experts):
            w_e = (top_w * (top_i == e)).sum(dim=-1)  # (T,) routing mass of expert e
            wy = w_e[:, None] * _expert_ffn(moe, cfg, e, xt)
            out = wy if out is None else out + wy
    return out.reshape(*lead, d)


def _split_bias(q, group):
    """Under TP a row-parallel layer's bias is added once, after the sum over
    the group (the JAX package's ``_split_bias``): (the layer without its
    bias, the bias), the bias of a LoRA wrapper's base included."""
    if group is None or q.bias is None:
        return q, None
    from .linear import LoRALinear

    if isinstance(q, (LoRALinear, MultiLoRALinear)):  # the bias lives on the base
        return dataclasses.replace(q, base=dataclasses.replace(q.base, bias=None)), q.bias
    return dataclasses.replace(q, bias=None), q.bias


def _layer_forward(lp: LayerParams, cfg: ModelConfig, x, k_cache, v_cache, ctx: _StepContext, layer_idx: int = 0,
                   adapter_idx: torch.Tensor | None = None, group=None):
    """One decoder block.  Writes this step's K/V into the layer's cache
    tensors in place; returns the new hidden state.  ``adapter_idx`` goes to
    every linear; only ``MultiLoRALinear`` targets read it.

    ``group`` (tensor parallelism, ``parallel/tp.py``): ``lp`` holds this
    rank's local shards, so the head counts come from the local widths; the
    row-parallel wo and w_down (or the MoE block) return f32 partials that
    are summed over the group, then get their bias, then are cast: exactly 2
    all-reduces per dense layer (the JAX package's psum pattern)."""
    b, l, _ = x.shape
    hd = cfg.head_dim
    if lp.wqkv is not None:  # local head counts from the fused width (exact: the width scales 1/tp)
        full = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        n_heads, n_kv = cfg.n_heads * lp.wqkv.n_out // full, cfg.n_kv_heads * lp.wqkv.n_out // full
    else:
        n_heads, n_kv = lp.wq.n_out // hd, lp.wk.n_out // hd
    akw = {} if adapter_idx is None else dict(adapter_idx=adapter_idx)
    row_kw = dict(akw) if group is None else dict(akw, out_dtype=torch.float32)

    def reduce(y, bias):
        # partials stay f32 until after the sum (per-rank bf16 rounding would add O(tp) ulps per layer)
        if group is not None:
            from ..parallel.tp import all_reduce_

            y = all_reduce_(y, group)
        if bias is not None:
            y = y + bias
        return y.to(x.dtype)

    h = rms_norm(x, lp.attn_norm, cfg.rms_eps, cfg.norm_offset)
    if lp.wqkv is not None:
        qkv = lp.wqkv(h, **akw)
        qc, kc = n_heads * hd, n_kv * hd
        q, k, v = qkv[..., :qc], qkv[..., qc : qc + kc], qkv[..., qc + kc :]
    else:
        q, k, v = lp.wq(h, **akw), lp.wk(h, **akw), lp.wv(h, **akw)
    q = q.reshape(b, l, n_heads, hd)
    k = k.reshape(b, l, n_kv, hd)
    v = v.reshape(b, l, n_kv, hd)
    if lp.q_norm is not None:
        q = rms_norm(q, lp.q_norm, cfg.rms_eps, cfg.norm_offset)
        k = rms_norm(k, lp.k_norm, cfg.rms_eps, cfg.norm_offset)
    # one rotation over the q and k heads together (elementwise: same values)
    q, k = torch.split(apply_rope(torch.cat([q, k], dim=2), ctx.cos, ctx.sin), [n_heads, n_kv], dim=2)
    _write_kv(k_cache, k, ctx)
    _write_kv(v_cache, v, ctx)
    rows, window = k_cache.shape[1], cfg.layer_sliding_window(layer_idx)
    attn = ctx.attend[(rows, window)](q, k_cache, v_cache, _attn_scale(cfg), cfg.attn_logit_softcap)
    wo, wo_bias = _split_bias(lp.wo, group)
    y = reduce(wo(attn.reshape(b, l, n_heads * hd), **row_kw), wo_bias)
    if lp.post_attn_norm is not None:
        y = rms_norm(y, lp.post_attn_norm, cfg.rms_eps, cfg.norm_offset)
    x = x + y
    h = rms_norm(x, lp.mlp_norm, cfg.rms_eps, cfg.norm_offset)
    if lp.moe is not None:
        y = reduce(moe_forward(lp.moe, cfg, h, group=group), None)
    else:
        if lp.w_gateup is not None:
            gate, up = torch.chunk(lp.w_gateup(h, **akw), 2, dim=-1)
        else:
            gate, up = lp.w_gate(h, **akw), lp.w_up(h, **akw)
        wd, wd_bias = _split_bias(lp.w_down, group)
        y = reduce(wd(_act(cfg, gate).to(up.dtype) * up, **row_kw), wd_bias)
    if lp.post_mlp_norm is not None:
        y = rms_norm(y, lp.post_mlp_norm, cfg.rms_eps, cfg.norm_offset)
    return x + y


def has_multi_lora(params: ModelParams) -> bool:
    """True when any layer linear is a ``MultiLoRALinear`` (per-row adapter
    stacks): such params need ``adapter_idx`` at every forward."""
    return any(isinstance(getattr(lp, f), MultiLoRALinear) for lp in params.layers
               for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))


def forward(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, cache: KVCache,
            positions: torch.Tensor | None = None, last_only: bool = False,
            last_index: int | None = None, adapter_idx: torch.Tensor | None = None,
            group=None) -> tuple[torch.Tensor, KVCache]:
    """Run L tokens (B, L) through the model, appending to the cache.

    Returns (logits (B, L', vocab) f32, cache with the new lengths); L' is 1
    with ``last_only`` or ``last_index`` (the lm_head runs on that position
    only).  The cache tensors are updated in place.

    ``adapter_idx``: (B,) int32 per-row adapter index (0 = no adapter) on
    the tokens' device, for ``MultiLoRALinear`` params
    (``models.lora.attach_multi_lora``); required exactly when the params
    carry adapter stacks, as in the JAX package.

    ``group``: the model group of a tensor-parallel mesh when ``params`` and
    ``cache`` are this rank's local shards (``parallel.tp_forward_fn``): the
    logits are then this rank's vocabulary shard (B, L', vocab / tp).
    """
    multi = has_multi_lora(params)
    if adapter_idx is None and multi:
        raise ValueError("params carry MultiLoRALinear adapters: forward() needs adapter_idx ((B,) i32; 0 = no "
                         "adapter)")
    if adapter_idx is not None and not multi:
        raise ValueError("adapter_idx given but params have no MultiLoRALinear")
    b, l = tokens.shape
    if positions is None:
        positions = cache.length[:, None] + torch.arange(l, dtype=torch.int32, device=tokens.device)[None, :]
    x = embed_lookup(params.embed, tokens)
    if cfg.embed_scale:
        # made on the device (no host copy, so a decode step can be captured in a CUDA graph)
        x = x * torch.full((), cfg.dim**0.5, dtype=torch.bfloat16, device=x.device)
    new_len = cache.length + l
    dev = tokens.device
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    ctx = _StepContext(cos=cos, sin=sin, write_b=torch.arange(b, device=dev)[:, None].expand(b, l),
                       write_rows={}, attend={})
    kv_pos = {}  # cache rows -> (kv_positions, kv_valid), each (B, rows)
    for i in range(cfg.n_layers):
        rows, window = cache.k[i].shape[1], cfg.layer_sliding_window(i)
        if rows not in ctx.write_rows:
            # a ring write never straddles the wrap (ring_rows), so the clamp
            # only matters where JAX's dynamic_update_slice clamps too
            start = torch.clamp(torch.remainder(cache.length, rows), max=rows - l).to(torch.int64)
            ctx.write_rows[rows] = start[:, None] + torch.arange(l, device=dev)[None, :]
            kv_pos[rows] = kv_slot_positions(new_len, rows)
        if (rows, window) not in ctx.attend:
            ctx.attend[(rows, window)] = _attention_route(positions, *kv_pos[rows], window)

    for i, lp in enumerate(params.layers):
        x = _layer_forward(lp, cfg, x, cache.k[i], cache.v[i], ctx, layer_idx=i, adapter_idx=adapter_idx,
                           group=group)
    x = rms_norm(x, params.final_norm, cfg.rms_eps, cfg.norm_offset)
    if last_index is not None:
        x = x[:, last_index : last_index + 1]
    elif last_only:
        x = x[:, -1:]
    logits = params.lm_head(x, out_dtype=torch.float32)
    if cfg.final_logit_softcap is not None:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits, KVCache(k=cache.k, v=cache.v, length=new_len)


@torch.no_grad()
def prefill(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, cache: KVCache):
    """Run the prompt; returns (last-position logits (B, vocab), cache)."""
    logits, cache = forward(params, cfg, tokens, cache, last_only=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params: ModelParams, cfg: ModelConfig, token: torch.Tensor, cache: KVCache):
    """One greedy decode step: token (B,) -> (next_token (B,) int32, cache)."""
    logits, cache = forward(params, cfg, token[:, None], cache)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache


@torch.no_grad()
def generate(params: ModelParams, cfg: ModelConfig, prompt: torch.Tensor, max_new_tokens: int,
             max_len: int | None = None) -> torch.Tensor:
    """Greedy generation: prompt (B, Lp) -> (B, max_new_tokens) int32.  The
    JAX package's decode ``lax.scan`` is a Python loop here; the last step,
    whose output the scan drops, is not run."""
    b, lp = prompt.shape
    if max_len is None:
        max_len = lp + max_new_tokens
    cache = KVCache.zeros(cfg, b, max_len, device=prompt.device)
    first, cache = prefill(params, cfg, prompt, cache)
    tok = torch.argmax(first, dim=-1).to(torch.int32)
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        tok, cache = decode_step(params, cfg, tok, cache)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def norm_names(cfg: ModelConfig) -> tuple[str, str, str | None, str | None]:
    """HF names of (attn_norm, mlp_norm, post_attn_norm, post_mlp_norm)."""
    if cfg.post_norms:
        return ("input_layernorm", "pre_feedforward_layernorm",
                "post_attention_layernorm", "post_feedforward_layernorm")
    return ("input_layernorm", "post_attention_layernorm", None, None)


def fuse_layer(lp: LayerParams, tp: int = 1) -> LayerParams:
    """Fuse QKV and gate|up (the expert stacks' too) in one layer: one kernel
    launch each.  Only pair-K linears fuse; split-K ones stay as they are.
    ``tp`` interleaves the fused columns per shard (``fuse_linears``), so a
    contiguous column split stays exact."""
    def fusable(*ls):
        return all(isinstance(l, QuantLinear) and l.layout == "pairk" for l in ls)

    rep = {}
    if fusable(lp.wq, lp.wk, lp.wv):
        rep.update(wqkv=fuse_linears([lp.wq, lp.wk, lp.wv], tp=tp), wq=None, wk=None, wv=None)
    if fusable(lp.w_gate, lp.w_up):
        rep.update(w_gateup=fuse_linears([lp.w_gate, lp.w_up], tp=tp), w_gate=None, w_up=None)
    if lp.moe is not None and fusable(lp.moe.gate, lp.moe.up):
        # fuse_linears concatenates on the last axis, so stacked experts fuse in one call
        rep.update(moe=dataclasses.replace(lp.moe, gateup=fuse_linears([lp.moe.gate, lp.moe.up], tp=tp), gate=None,
                                           up=None))
    return dataclasses.replace(lp, **rep)


def fuse_params(params: ModelParams, tp: int = 1) -> ModelParams:
    """Fuse QKV and gate|up in every layer (:func:`fuse_layer`), the
    columns interleaved per shard for a model-axis width of ``tp``."""
    return dataclasses.replace(params, layers=[fuse_layer(lp, tp=tp) for lp in params.layers])


def quantize_params(cfg: ModelConfig, weights: dict[str, np.ndarray], fuse: bool = False,
                    device=None) -> ModelParams:
    """ModelParams on ``device`` from fp weights in HF llama naming (Mixtral's
    for ``cfg.n_experts``: ``block_sparse_moe.gate`` is the dense router,
    ``experts.{m}.w1/w3/w2`` are gate/up/down): every linear quantized,
    norms and router bf16, the embedding bf16 unless ``cfg.quantize_embed``
    (a :class:`QuantEmbedding` with the quant type's exact codebook), a dense
    bf16 lm_head unless ``cfg.quantize_lm_head``."""
    device = resolve_device(device)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)

    def ql(w, bias=None):
        return quantize_linear(w, bias, blocksize=cfg.blocksize, quant_type=cfg.quant_type, variant=cfg.variant,
                               device=device)

    layers = []
    an, mn, pan, pmn = norm_names(cfg)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."

        def q(name):
            return ql(weights[p + name + ".weight"], weights.get(p + name + ".bias"))

        extra = {}
        if pan is not None:
            extra.update(post_attn_norm=bf16(weights[p + pan + ".weight"]),
                         post_mlp_norm=bf16(weights[p + pmn + ".weight"]))
        if cfg.qk_norm:
            extra.update(q_norm=bf16(weights[p + "self_attn.q_norm.weight"]),
                         k_norm=bf16(weights[p + "self_attn.k_norm.weight"]))
        if cfg.n_experts:
            ep = p + "block_sparse_moe.experts."

            def experts(w):
                return stack_linears([ql(weights[f"{ep}{m}.{w}.weight"]) for m in range(cfg.n_experts)])

            extra.update(moe=MoEParams(router=dense_linear(weights[p + "block_sparse_moe.gate.weight"], device=device),
                                       gate=experts("w1"), up=experts("w3"), down=experts("w2")))
        else:
            extra.update(w_gate=q("mlp.gate_proj"), w_up=q("mlp.up_proj"), w_down=q("mlp.down_proj"))
        layers.append(LayerParams(
            attn_norm=bf16(weights[p + an + ".weight"]),
            wq=q("self_attn.q_proj"), wk=q("self_attn.k_proj"), wv=q("self_attn.v_proj"),
            wo=q("self_attn.o_proj"), mlp_norm=bf16(weights[p + mn + ".weight"]), **extra,
        ))
    lm_w = weights.get("lm_head.weight")
    if lm_w is None:  # tied embeddings
        lm_w = weights["model.embed_tokens.weight"]
    lm_head = ql(np.asarray(lm_w)) if cfg.quantize_lm_head else dense_linear(lm_w, device=device)
    if cfg.quantize_embed:
        from ..ops import format as fmt

        embed = quantize_embedding(weights["model.embed_tokens.weight"], cfg.blocksize,
                                   code=fmt.NF4_CODE if cfg.quant_type == "nf4" else fmt.FP4_CODE, device=device)
    else:
        embed = bf16(weights["model.embed_tokens.weight"])
    params = ModelParams(embed=embed, layers=layers, final_norm=bf16(weights["model.norm.weight"]), lm_head=lm_head)
    return fuse_params(params) if fuse else params


def dense_params(cfg: ModelConfig, weights: dict[str, np.ndarray], dtype=torch.bfloat16, device=None) -> ModelParams:
    """Unquantized ModelParams on ``device`` (default CUDA), DenseLinear
    everywhere (the JAX package's ``dense_params``): the bf16 twin that runs
    through the same forward and decode code as the quantized model, the
    speed baseline and correctness oracle."""
    device = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.asarray(weights[name], np.float32)).to(device=device, dtype=dtype)

    def dl(name):
        return dense_linear(weights[name + ".weight"], weights.get(name + ".bias"), dtype=dtype, device=device)

    layers = []
    an, mn, pan, pmn = norm_names(cfg)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        extra = {}
        if cfg.n_experts:
            ep = p + "block_sparse_moe.experts."
            extra.update(moe=MoEParams(router=dl(p + "block_sparse_moe.gate"),
                                       gate=stack_linears([dl(f"{ep}{m}.w1") for m in range(cfg.n_experts)]),
                                       up=stack_linears([dl(f"{ep}{m}.w3") for m in range(cfg.n_experts)]),
                                       down=stack_linears([dl(f"{ep}{m}.w2") for m in range(cfg.n_experts)])))
        else:
            extra.update(w_gate=dl(p + "mlp.gate_proj"), w_up=dl(p + "mlp.up_proj"), w_down=dl(p + "mlp.down_proj"))
        if pan is not None:
            extra.update(post_attn_norm=t(p + pan + ".weight"), post_mlp_norm=t(p + pmn + ".weight"))
        if cfg.qk_norm:
            extra.update(q_norm=t(p + "self_attn.q_norm.weight"), k_norm=t(p + "self_attn.k_norm.weight"))
        layers.append(LayerParams(
            attn_norm=t(p + an + ".weight"), wq=dl(p + "self_attn.q_proj"), wk=dl(p + "self_attn.k_proj"),
            wv=dl(p + "self_attn.v_proj"), wo=dl(p + "self_attn.o_proj"), mlp_norm=t(p + mn + ".weight"), **extra,
        ))
    lm_w = weights.get("lm_head.weight")
    if lm_w is None:  # tied embeddings
        lm_w = weights["model.embed_tokens.weight"]
    return ModelParams(embed=t("model.embed_tokens.weight"), layers=layers, final_norm=t("model.norm.weight"),
                       lm_head=dense_linear(lm_w, dtype=dtype, device=device))


@torch.no_grad()
def reference_forward(cfg: ModelConfig, weights: dict[str, np.ndarray], tokens, device=None) -> torch.Tensor:
    """Unquantized bf16 forward of HF-named fp ``weights`` with no cache, on
    ``device`` (default CUDA): the twin-model correctness oracle (the JAX
    package's ``reference_forward``).  Each product is f32-accumulated and
    rounded to bf16, as a bf16 matmul.  tokens (B, L) -> logits (B, L,
    vocab) f32."""
    device = resolve_device(device)
    tokens = torch.as_tensor(tokens).to(device)
    b, l = tokens.shape

    def f32(name):
        return torch.from_numpy(np.asarray(weights[name], np.float32)).to(device)

    def bf16(name):
        return f32(name).to(torch.bfloat16)

    def lin(name, x):
        y = (x.float() @ bf16(name).T.float()).to(torch.bfloat16)
        bias = weights.get(name.replace(".weight", ".bias"))
        return y if bias is None else y + bf16(name.replace(".weight", ".bias"))

    x = bf16("model.embed_tokens.weight")[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.full((), cfg.dim**0.5, dtype=torch.bfloat16, device=device)
    positions = torch.arange(l, dtype=torch.int32, device=device)[None, :].expand(b, l)
    kv_valid = torch.ones((b, l), dtype=torch.bool, device=device)
    an, mn, pan, pmn = norm_names(cfg)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."

        def nrm(y, name):
            return rms_norm(y, bf16(p + name + ".weight"), cfg.rms_eps, cfg.norm_offset)

        h = nrm(x, an)
        q = lin(p + "self_attn.q_proj.weight", h).reshape(b, l, cfg.n_heads, cfg.head_dim)
        k = lin(p + "self_attn.k_proj.weight", h).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        v = lin(p + "self_attn.v_proj.weight", h).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:  # Qwen3 per-head q/k norms, before RoPE
            q = rms_norm(q, bf16(p + "self_attn.q_norm.weight"), cfg.rms_eps, cfg.norm_offset)
            k = rms_norm(k, bf16(p + "self_attn.k_norm.weight"), cfg.rms_eps, cfg.norm_offset)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        attend = _attention_route(positions, positions, kv_valid, cfg.layer_sliding_window(i))
        attn = attend(q, k, v, _attn_scale(cfg), cfg.attn_logit_softcap)
        y = lin(p + "self_attn.o_proj.weight", attn.reshape(b, l, cfg.q_dim))
        if pan is not None:
            y = nrm(y, pan)
        x = x + y
        h = nrm(x, mn)
        if cfg.n_experts:
            hf = h.reshape(b * l, cfg.dim)
            probs = torch.softmax(hf.float() @ f32(p + "block_sparse_moe.gate.weight").T, dim=-1)
            top_w, top_i = torch.topk(probs, cfg.experts_per_tok, dim=-1)
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
            acc = torch.zeros((b * l, cfg.dim), dtype=torch.float32, device=device)
            for m in range(cfg.n_experts):
                ep = p + f"block_sparse_moe.experts.{m}."
                g, u = lin(ep + "w1.weight", hf), lin(ep + "w3.weight", hf)
                y = lin(ep + "w2.weight", _act(cfg, g).to(u.dtype) * u)
                acc = acc + (top_w * (top_i == m)).sum(dim=-1)[:, None] * y.float()
            x = x + acc.reshape(b, l, cfg.dim).to(x.dtype)
        else:
            gate, up = lin(p + "mlp.gate_proj.weight", h), lin(p + "mlp.up_proj.weight", h)
            y = lin(p + "mlp.down_proj.weight", _act(cfg, gate).to(up.dtype) * up)
            if pmn is not None:
                y = nrm(y, pmn)
            x = x + y
    x = rms_norm(x, bf16("model.norm.weight"), cfg.rms_eps, cfg.norm_offset)
    logits = x.float() @ f32("lm_head.weight").T
    if cfg.final_logit_softcap is not None:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def random_weights(cfg: ModelConfig, seed: int = 0, scale: float = 0.02) -> dict[str, np.ndarray]:
    """Random fp32 weights in HF llama naming (Mixtral's for experts; numpy,
    seeded) — the same arrays as the JAX package's ``random_weights`` for the
    same seed."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = {
        "model.embed_tokens.weight": w(cfg.vocab_size, cfg.dim),
        "model.norm.weight": np.ones(cfg.dim, np.float32),
        "lm_head.weight": w(cfg.vocab_size, cfg.dim),
    }
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for nname in norm_names(cfg):
            if nname is not None:
                out[p + nname + ".weight"] = np.ones(cfg.dim, np.float32)
        out[p + "self_attn.q_proj.weight"] = w(cfg.q_dim, cfg.dim)
        out[p + "self_attn.k_proj.weight"] = w(kv_dim, cfg.dim)
        out[p + "self_attn.v_proj.weight"] = w(kv_dim, cfg.dim)
        out[p + "self_attn.o_proj.weight"] = w(cfg.dim, cfg.q_dim)
        if cfg.attn_bias:
            out[p + "self_attn.q_proj.bias"] = w(cfg.q_dim)
            out[p + "self_attn.k_proj.bias"] = w(kv_dim)
            out[p + "self_attn.v_proj.bias"] = w(kv_dim)
        if cfg.qk_norm:
            out[p + "self_attn.q_norm.weight"] = np.ones(cfg.head_dim, np.float32)
            out[p + "self_attn.k_norm.weight"] = np.ones(cfg.head_dim, np.float32)
        if cfg.n_experts:
            out[p + "block_sparse_moe.gate.weight"] = w(cfg.n_experts, cfg.dim)
            for m in range(cfg.n_experts):
                ep = p + f"block_sparse_moe.experts.{m}."
                out[ep + "w1.weight"] = w(cfg.ffn_dim, cfg.dim)
                out[ep + "w2.weight"] = w(cfg.dim, cfg.ffn_dim)
                out[ep + "w3.weight"] = w(cfg.ffn_dim, cfg.dim)
        else:
            out[p + "mlp.gate_proj.weight"] = w(cfg.ffn_dim, cfg.dim)
            out[p + "mlp.up_proj.weight"] = w(cfg.ffn_dim, cfg.dim)
            out[p + "mlp.down_proj.weight"] = w(cfg.dim, cfg.ffn_dim)
    return out
