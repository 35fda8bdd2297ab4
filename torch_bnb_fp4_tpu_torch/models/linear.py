"""QuantLinear / DenseLinear: the linear layers of the port.

Counterpart of ``torch_bnb_fp4_tpu/models/linear.py``.  A layer is a plain
dataclass of tensors applied by :func:`apply_linear`, which pads K and N to
the kernels' quanta and picks a kernel by layout and row count M.  Padding:
the pack step zero-pads N to 128 and K (code 0 decodes to 0); apply pads x
with zeros and slices the result.

Two layouts, as in the JAX package:
  * pair-K (the FP4 serving path): ``ops.kernels.matmul_fp4_pk`` (K2/K3/K4),
    K padded to 512.
  * split-K (bnb-exact FP4/NF4: the codes and absmax grid of a bitsandbytes
    state kept as they are): ``ops.kernels.matmul_fp4`` / ``gemv_fp4`` (K9b)
    and ``dequantize_tpu`` (K9a), K padded to 1024 (or to k_shards*128 for a
    K-sharded packing).  ``k_shards`` > 1 stores K as that many
    self-contained packings (the row-parallel layout of wo and w_down); one
    kernel call covers them all, reading x in place.
    Split-K is never fused and never gets an int8 shadow.

The int8 prefill shadow (:func:`attach_int8_shadow`) decodes and requantizes
a pair-K layer's weights once (K6) into ``w8`` / ``w8_scale``; prefill GEMMs
of 256 rows or more then run as a pure int8 GEMM (K5).  A STACKED pair-K
QuantLinear (every tensor with a leading expert axis,
``models.transformer.stack_linears``) is applied one expert at a time by
:func:`apply_expert_linear` (K8); it gets no shadow.  A stacked split-K
linear is applied through ``models.transformer.expert_view``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import format as fmt
from ..ops import kernels as K
from ..utils.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class QuantLinear:
    """Blockwise-FP4 linear layer state.

    ``packed`` uint8 (k_pad/2, n_pad).  ``layout="pairk"``: ``scale``
    (k_pad/blocksize, n_pad) f32|bf16 = absmax/192 (the JAX package's
    ``absmax_hi``; ``scale_lo`` is None), ``variant`` names the stored
    codebook and ``codebook`` (16,) f32 is set for ``variant="lut"`` only.
    ``layout="splitk"``: ``scale`` and ``scale_lo`` (k_pad/(2*blocksize),
    n_pad) f32 hold the TRUE absmax (not /192) of the hi and lo nibble halves
    (the JAX package's ``absmax_hi`` / ``absmax_lo``, the checkpoint keys),
    ``variant`` is "exact", ``codebook`` None for FP4 or the (16,) table
    (NF4), and ``k_shards`` the number of self-contained K slices.  A stacked
    layer (mixture of experts) has a leading expert axis on every tensor.
    Optional int8 prefill shadow (pair-K only): ``w8`` (k_pad, n_pad) int8
    and ``w8_scale`` (k_pad / w8_block_k, n_pad) f32 per-K-tile column scales
    (:func:`attach_int8_shadow`).
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor | None  # (n_out,) f32 or None; (E, n_out) stacked
    n_out: int
    k_in: int
    blocksize: int = 64
    variant: str = "exact"
    codebook: torch.Tensor | None = None
    w8: torch.Tensor | None = None
    w8_scale: torch.Tensor | None = None
    w8_block_k: int = 1024
    layout: str = "pairk"
    k_shards: int = 1
    scale_lo: torch.Tensor | None = None

    @property
    def n_pad(self) -> int:
        return self.packed.shape[-1]

    @property
    def k_pad(self) -> int:
        return 2 * self.packed.shape[-2]

    def to(self, device) -> "QuantLinear":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(self, packed=mv(self.packed), scale=mv(self.scale), bias=mv(self.bias),
                                   codebook=mv(self.codebook), w8=mv(self.w8), w8_scale=mv(self.w8_scale),
                                   scale_lo=mv(self.scale_lo))

    def __call__(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return apply_linear(self, x, **kw)


@dataclasses.dataclass
class DenseLinear:
    """Unquantized linear with the same calling convention as QuantLinear
    (the bf16 twin's layers and the dense lm_head).  ``w`` is (k_in, n_out)."""

    w: torch.Tensor
    bias: torch.Tensor | None
    n_out: int
    k_in: int

    def to(self, device) -> "DenseLinear":
        return dataclasses.replace(self, w=self.w.to(device), bias=None if self.bias is None else self.bias.to(device))

    def __call__(self, x: torch.Tensor, out_dtype=None, **_kw) -> torch.Tensor:
        # f32-accumulated product returned in f32, like the JAX dot with
        # preferred_element_type=f32.  On the card cuBLAS writes f32 straight
        # from bf16 operands (mm with out_dtype); the CPU has no such op and
        # multiplies the exact f32 widenings.
        x2 = x.reshape(-1, self.k_in)
        if x.is_cuda and x.dtype == self.w.dtype and x.dtype != torch.float32:
            y = torch.mm(x2, self.w, out_dtype=torch.float32)
        else:
            y = x2.float() @ self.w.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(out_dtype if out_dtype is not None else x.dtype).reshape(*x.shape[:-1], self.n_out)


def dense_linear(w: np.ndarray, bias: np.ndarray | None = None, dtype=torch.bfloat16, device=None) -> DenseLinear:
    """DenseLinear from a torch-convention (n_out, k_in) weight."""
    device = resolve_device(device)
    w = np.asarray(w, np.float32)
    n_out, k_in = w.shape
    return DenseLinear(
        w=torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device, dtype=dtype),
        bias=None if bias is None else torch.from_numpy(np.asarray(bias, np.float32)).to(device=device, dtype=dtype),
        n_out=n_out, k_in=k_in,
    )


def quantize_linear(w: np.ndarray, bias: np.ndarray | None = None, *, blocksize: int = 64, quant_type: str = "fp4",
                    layout: str | None = None, k_shards: int = 1, variant: str = "ramp", scale_dtype=None,
                    device=None) -> QuantLinear:
    """Quantize a weight (n_out, k_in) into a QuantLinear on ``device``.

    ``quant_type`` "fp4" or "nf4".  ``layout`` None picks "pairk" when
    ``k_shards`` is 1, else "splitk" (the JAX package's default).  Pair-K:
    nf4 forces ``variant="lut"``; ``variant`` exact | zramp | ramp;
    ``scale_dtype`` None = float32.  Split-K: bnb's codes and true absmax
    (variant "exact", ``codebook`` set for nf4), K cut into ``k_shards``
    self-contained packings; ``variant`` and ``scale_dtype`` are not used.
    """
    device = resolve_device(device)
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"quantize_linear expects a 2-D (n_out, k_in) weight, got shape {w.shape}")
    n_out, k_in = w.shape
    if quant_type not in ("fp4", "nf4"):
        raise ValueError(f"quant_type must be 'fp4' or 'nf4', got {quant_type!r}")
    if layout is None:
        layout = "pairk" if k_shards == 1 else "splitk"
    if layout not in ("pairk", "splitk"):
        raise ValueError(f"layout must be 'pairk' or 'splitk', got {layout!r}")
    if layout == "pairk":
        if k_shards != 1:
            raise ValueError("pairk shards contiguously in both dims; k_shards applies to splitk only")
        if quant_type == "nf4":
            variant = "lut"
        elif variant not in fmt.PAIRK_VARIANTS:
            raise ValueError(f"variant must be one of {fmt.PAIRK_VARIANTS}, got {variant!r}")
        k_pad = _round_up(k_in, 8 * blocksize)
    elif k_shards == 1:
        k_pad = _round_up(k_in, max(K.K_QUANTUM, 2 * blocksize))
    else:
        k_pad = _round_up(k_in, k_shards * 2 * blocksize)
    n_pad = _round_up(n_out, 128)
    if (k_pad, n_pad) != (k_in, n_out):
        wp = np.zeros((n_pad, k_pad), dtype=np.float32)
        wp[:n_out, :k_in] = w
    else:
        wp = w
    if layout == "splitk":
        code = fmt.FP4_CODE if quant_type == "fp4" else fmt.NF4_CODE
        packed, hi, lo = fmt.pack_tpu_sharded(wp, blocksize=blocksize, code=code, k_shards=k_shards)
        return QuantLinear(
            packed=torch.from_numpy(packed).to(device), scale=torch.from_numpy(hi).to(device),
            scale_lo=torch.from_numpy(lo).to(device),
            bias=None if bias is None else torch.from_numpy(np.asarray(bias, np.float32)).to(device),
            n_out=n_out, k_in=k_in, blocksize=blocksize, variant="exact", layout="splitk", k_shards=k_shards,
            codebook=None if quant_type == "fp4" else torch.from_numpy(code.copy()).to(device),
        )
    codebook = None
    if variant == "lut":
        packed, scale = fmt.pack_tpu_pairk_lut(wp, fmt.NF4_CODE, blocksize=blocksize)
        codebook = torch.from_numpy(fmt.NF4_CODE.copy()).to(device)
    else:
        packed, scale = fmt.pack_tpu_pairk(wp, blocksize=blocksize, variant=variant,
                                           scale_dtype=torch.float32 if scale_dtype is None else scale_dtype)
    return QuantLinear(
        packed=packed.to(device), scale=scale.to(device),
        bias=None if bias is None else torch.from_numpy(np.asarray(bias, np.float32)).to(device),
        n_out=n_out, k_in=k_in, blocksize=blocksize, variant=variant, codebook=codebook,
    )


def _shard_reorder_x(x2: torch.Tensor, k_shards: int) -> torch.Tensor:
    """x columns reordered so that a K-sharded split-K packing runs as ONE
    unsharded call: shard d's packed rows meet x columns [d*K/D, d*K/D +
    K/2D) (hi) and the next K/2D (lo), while an unsharded call splits x at
    K/2.  One (M, D, 2, K/2D) -> (M, 2, D, K/2D) permute (the JAX package's
    ``_shard_reorder_x``), kept as the reference the tests hold
    ``ops.kernels.splitk_x_columns`` against: the port's K9b and its plain
    version take the shard count and read x in place instead."""
    m, k = x2.shape
    return x2.reshape(m, k_shards, 2, k // (2 * k_shards)).transpose(1, 2).reshape(m, k)


def apply_linear(q: QuantLinear, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Forward pass, x (..., k_in) -> (..., n_out).  Pair-K: one row goes
    through the batch-1 route; with a shadow attached, M >= ``A8_MIN_M`` rows
    of non-f32 x through K5 (any variant, lut included); other rows through
    ``matmul_fp4_pk``'s M-based choice (the JAX package's
    models/linear.py:475-498).  Split-K: ``gemv_fp4`` (one row) or
    ``matmul_fp4`` (K9b), which reads a K-sharded packing's x in place; no
    shadow."""
    *lead, k = x.shape
    if k != q.k_in:
        raise ValueError(f"input feature dim {k} does not match layer k_in={q.k_in} "
                         f"(x.shape={tuple(x.shape)}, layer {q.n_out}x{q.k_in})")
    m = math.prod(lead)
    if m == 0:
        return torch.zeros((*lead, q.n_out), dtype=x.dtype, device=x.device)
    x2 = x.reshape(m, k)
    if k != q.k_pad:
        x2 = torch.nn.functional.pad(x2, (0, q.k_pad - k))
    bias = q.bias
    if bias is not None and q.n_pad != q.n_out:
        bias = torch.nn.functional.pad(bias, (0, q.n_pad - q.n_out))
    cb = q.codebook if q.variant == "lut" else None
    kw = dict(blocksize=q.blocksize, out_dtype=out_dtype, variant=q.variant)
    if q.layout == "splitk":
        out = (K.gemv_fp4 if m == 1 else K.matmul_fp4)(x2, q.packed, (q.scale, q.scale_lo), bias, q.codebook,
                                                        blocksize=q.blocksize, out_dtype=out_dtype,
                                                        k_shards=q.k_shards)
    elif m == 1:
        out = K.gemv_fp4_pk(x2, q.packed, q.scale, bias, cb, **kw)
    elif q.w8 is not None and m >= K.A8_MIN_M and x2.dtype != torch.float32:
        # f16 x is quantized from its own values (matmul_fp4_pk would round it to bf16 first)
        out = K.matmul_w8(x2, q.w8, q.w8_scale, bias, block_k=q.w8_block_k, out_dtype=out_dtype)
    else:
        out = K.matmul_fp4_pk(x2, q.packed, q.scale, bias, cb, **kw)
    if q.n_pad != q.n_out:
        out = out[:, : q.n_out]
    return out.reshape(*lead, q.n_out)


def apply_expert_linear(sq: QuantLinear, e, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Forward through expert ``e`` of a STACKED pair-K QuantLinear without
    copying that expert (the JAX package's ``apply_expert_linear``,
    models/linear.py:524-575): the K8 forms of K2/K3/K4 read ``e`` from device
    memory and offset into the stack themselves.  ``e`` is a Python int (the
    all-experts loop) or a one-element int32 tensor on x's device (a token's
    routed expert, never read on the host).  One row takes the m-outer path
    (K2), other row counts ``select_path``'s choice."""
    if sq.layout != "pairk":
        raise ValueError("apply_expert_linear requires the pairk layout")
    if sq.packed.ndim != 3:
        raise ValueError(f"apply_expert_linear needs a stacked (E, K/2, N) packing, got {tuple(sq.packed.shape)}")
    *lead, k = x.shape
    if k != sq.k_in:
        raise ValueError(f"input feature dim {k} does not match layer k_in={sq.k_in} "
                         f"(x.shape={tuple(x.shape)}, layer {sq.n_out}x{sq.k_in})")
    m = math.prod(lead)
    if m == 0:
        return torch.zeros((*lead, sq.n_out), dtype=x.dtype, device=x.device)
    x2 = x.reshape(m, k)
    if k != sq.k_pad:
        x2 = torch.nn.functional.pad(x2, (0, sq.k_pad - k))
    bias = sq.bias  # (E, n_out): the kernel offsets into it
    if bias is not None and sq.n_pad != sq.n_out:
        bias = torch.nn.functional.pad(bias, (0, sq.n_pad - sq.n_out))
    cb = None
    if sq.variant == "lut":
        cb = sq.codebook[0] if sq.codebook.ndim == 2 else sq.codebook
    kw = dict(blocksize=sq.blocksize, out_dtype=out_dtype, variant=sq.variant, expert=e)
    if m == 1:
        out = K.gemv_fp4_pk(x2, sq.packed, sq.scale, bias, cb, **kw)
    else:
        out = K.matmul_fp4_pk(x2, sq.packed, sq.scale, bias, cb, **kw)
    if sq.n_pad != sq.n_out:
        out = out[:, : sq.n_out]
    return out.reshape(*lead, sq.n_out)


def fuse_linears(linears: list[QuantLinear]) -> QuantLinear:
    """Fuse same-input pair-K linears into one (column concat): one kernel
    call for QKV and one for gate|up.  Stacked (expert) linears fuse the same
    way: every concat is on the last axis.  Tensor parallelism (tp > 1) is
    not yet ported.  Split-K layers are never fused (as in the JAX
    package)."""
    q0 = linears[0]
    if any(l.layout != "pairk" for l in linears):
        raise ValueError("fusion is pairk-only")
    if any(l.variant != q0.variant for l in linears):
        raise ValueError("fused linears must share a codebook variant")
    if q0.variant == "lut" and any(not torch.equal(l.codebook, q0.codebook) for l in linears):
        raise ValueError("fused lut linears must share one codebook")
    if any(l.k_in != q0.k_in or l.k_pad != q0.k_pad or l.blocksize != q0.blocksize for l in linears):
        raise ValueError("fused linears must share k_in, k_pad and blocksize")
    if any(l.n_out != l.n_pad for l in linears):
        raise ValueError("fused linears must be 128-aligned")
    if any(l.bias is not None for l in linears):
        bias = torch.cat([l.bias if l.bias is not None else torch.zeros((*l.packed.shape[:-2], l.n_out),
                                                                         dtype=torch.float32, device=l.packed.device)
                          for l in linears], dim=-1)
    else:
        bias = None
    return QuantLinear(
        packed=torch.cat([l.packed for l in linears], dim=-1).contiguous(),
        scale=torch.cat([l.scale for l in linears], dim=-1).contiguous(),
        bias=bias, n_out=sum(l.n_out for l in linears), k_in=q0.k_in, blocksize=q0.blocksize,
        variant=q0.variant, codebook=q0.codebook,
    )


def dequantize_weight(q: QuantLinear, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize W (n_out, k_in) (the JAX package's ``dequantize_weight``):
    K6 for pair-K, K9a for split-K, whose output of a K-sharded packing
    ([hi panels of every shard; lo panels of every shard]) is put back in
    Wt row order."""
    if q.layout == "pairk":
        wt = K.dequantize_tpu_pk(q.packed, q.scale, q.codebook if q.variant == "lut" else None,
                                 blocksize=q.blocksize, out_dtype=out_dtype, variant=q.variant)
        return wt[: q.k_in, : q.n_out].T
    wt = K.dequantize_tpu(q.packed, (q.scale, q.scale_lo), q.codebook, blocksize=q.blocksize, out_dtype=out_dtype)
    if q.k_shards > 1:
        kp, n = q.packed.shape
        wt = wt.reshape(2, q.k_shards, kp // q.k_shards, n).transpose(0, 1).reshape(2 * kp, n)
    return wt[: q.k_in, : q.n_out].T


def attach_int8_shadow(q: QuantLinear, tp: int = 1) -> QuantLinear:
    """Attach the int8 prefill shadow to a pair-K QuantLinear: K6 and the
    requantization run once (``ops.kernels.make_int8_shadow``) so that
    prefill GEMMs of M >= 256 rows run as pure int8 GEMMs (K5).  Costs one
    byte per weight on the device (twice the packed FP4); the FP4 bytes stay
    the decode path.  The tile depth ``w8_block_k`` is 1024 where it divides
    k_pad, else 512 (the pair-K layout pads K to a multiple of 512)."""
    if q.layout != "pairk":
        raise ValueError("int8 shadow requires the pairk layout")
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not yet ported (tp must be 1)")
    if q.packed.ndim != 2:
        raise ValueError("stacked (expert) linears are not supported yet")
    bk = 1024 if q.k_pad % 1024 == 0 else 512
    w8, g = K.make_int8_shadow(q.packed, q.scale, q.codebook if q.variant == "lut" else None,
                               blocksize=q.blocksize, variant=q.variant, block_k=bk)
    return dataclasses.replace(q, w8=w8, w8_scale=g, w8_block_k=bk)


def attach_prefill_shadow(params, tp: int = 1):
    """A copy of ``params`` (a ``ModelParams``, or any dataclass or list
    holding linears) in which every 2-D pair-K QuantLinear, a quantized
    lm_head included, carries an int8 prefill shadow.  Dense layers, split-K
    layers and stacked (expert) packings are left as they are."""
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not yet ported (tp must be 1)")

    def walk(v):
        if isinstance(v, QuantLinear):
            return attach_int8_shadow(v) if v.packed.ndim == 2 and v.layout == "pairk" else v
        if isinstance(v, list):
            return [walk(x) for x in v]
        if dataclasses.is_dataclass(v) and not isinstance(v, (type, DenseLinear)):
            return dataclasses.replace(v, **{f.name: walk(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v

    return walk(params)
