"""bitsandbytes interop: exact conversion of bnb-quantized state.

Counterpart of ``torch_bnb_fp4_tpu/convert/bnb.py``.  A bnb ``QuantState``
(packed uint8 codes two per byte, HIGH nibble first, over the row-major flat
weight; one absmax per ``blocksize`` flat elements; optionally a
double-quantized absmax) becomes a QuantLinear with the same codes and the
same absmax grid: no requantization.  The split-K layout keeps bnb's
arithmetic (code * absmax in f32) bit for bit; the pair-K layout folds
absmax/192 into its scale for FP4 (one f32 rounding).  Blocks must not
straddle rows (K % blocksize == 0, true for every transformer geometry).

Nothing here imports bitsandbytes: :func:`from_bnb_torch_layer` reads
``weight``, ``weight.quant_state`` and ``bias`` off any object that has them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.linear import QuantLinear
from ..ops import format as fmt
from ..utils.device import resolve_device


def dequantize_nested_absmax(absmax_u8: np.ndarray, absmax2: np.ndarray, code2: np.ndarray, offset: float,
                             nested_blocksize: int = 256) -> np.ndarray:
    """Decode bnb's DOUBLE-QUANTIZED absmax to f32: absmax = code2[u8] *
    absmax2[block] + offset, one ``absmax2`` per ``nested_blocksize`` codes
    (``bnb_4bit_use_double_quant=True``, the HF default)."""
    u8 = np.asarray(absmax_u8, np.uint8).reshape(-1)
    code2 = np.asarray(code2, np.float32)
    absmax2 = np.asarray(absmax2, np.float32).reshape(-1)
    blk = np.arange(u8.size) // nested_blocksize
    return (code2[u8] * absmax2[blk] + np.float32(offset)).astype(np.float32)


def from_bnb_state(packed_flat: np.ndarray, absmax_flat: np.ndarray, shape: tuple[int, int], *, blocksize: int = 64,
                   quant_type: str = "fp4", bias: np.ndarray | None = None, layout: str | None = None,
                   device=None) -> QuantLinear:
    """A QuantLinear on ``device`` (default CUDA) from bnb flat state of a
    (n_out, k_in) weight.  ``layout`` None or "pairk" (NF4 rides the lut
    decode) or "splitk" (bnb-exact FP4/NF4 through K9a/K9b).  K and N are
    padded to the layout's quanta with zero codes; the padded absmax is 1
    (as bnb pads; a zero code decodes to 0 whatever it multiplies), so the
    bytes equal the JAX package's."""
    device = resolve_device(device)
    n_out, k_in = shape
    if k_in % blocksize != 0:
        raise ValueError(f"K={k_in} not a multiple of blocksize={blocksize}: bnb's flat blocks straddle rows; "
                         "requantize from full precision instead")
    if quant_type not in ("fp4", "nf4"):
        raise ValueError(f"quant_type must be 'fp4' or 'nf4', got {quant_type!r}")
    if layout is None:
        layout = "pairk"
    if layout not in ("pairk", "splitk"):
        raise ValueError(f"layout must be 'pairk' or 'splitk', got {layout!r}")
    codes = fmt.unpack_flat(np.asarray(packed_flat)).reshape(n_out, k_in)
    absmax = np.asarray(absmax_flat, np.float32).reshape(n_out, k_in // blocksize)
    kq = 8 * blocksize if layout == "pairk" else max(1024, 2 * blocksize)
    k_pad = (k_in + kq - 1) // kq * kq
    n_pad = (n_out + 127) // 128 * 128
    if (k_pad, n_pad) != (k_in, n_out):
        cp = np.zeros((n_pad, k_pad), np.uint8)
        cp[:n_out, :k_in] = codes
        ap = np.ones((n_pad, k_pad // blocksize), np.float32)
        ap[:n_out, : k_in // blocksize] = absmax
        codes, absmax = cp, ap
    ct = codes.T  # (K, N)
    lo = None
    if layout == "pairk":
        if quant_type == "fp4":
            ct = fmt.RANK_REMAP[ct]
            hi = (absmax.T / fmt.PAIRK_VALUE_SCALE).astype(np.float32)
        else:  # NF4's table ascends, so its stored codes are ranks already; scale = absmax
            hi = absmax.T.astype(np.float32)
        packed = ((ct[1::2].astype(np.uint8) << 4) | ct[0::2]).astype(np.uint8)
    else:
        half = ct.shape[0] // 2
        packed = ((ct[:half].astype(np.uint8) << 4) | (ct[half:] & 0xF)).astype(np.uint8)
        at = absmax.T  # (K/bs, N)
        hi, lo = at[: at.shape[0] // 2], at[at.shape[0] // 2 :]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return QuantLinear(
        packed=put(packed), scale=put(hi), scale_lo=None if lo is None else put(lo),
        bias=None if bias is None else put(np.asarray(bias, np.float32)),
        n_out=n_out, k_in=k_in, blocksize=blocksize, layout=layout, k_shards=1,
        variant="lut" if layout == "pairk" and quant_type == "nf4" else "exact",
        codebook=None if quant_type == "fp4" else put(fmt.NF4_CODE),
    )


def _np(t) -> np.ndarray:
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def from_bnb_torch_layer(linear, layout: str | None = None, device=None) -> QuantLinear:
    """Convert a bnb ``Linear4bit`` / ``LinearFP4`` (read by duck typing:
    ``weight`` with a ``quant_state`` holding absmax, shape, blocksize,
    quant_type and, double-quantized, ``state2`` and ``offset``; ``bias``).
    Double-quantized states are decoded with :func:`dequantize_nested_absmax`."""
    w = linear.weight
    qs = getattr(w, "quant_state", None)
    if qs is None:
        raise ValueError("layer is not bnb-quantized (no quant_state)")
    packed = _np(getattr(w, "data", w)).reshape(-1)
    state2 = getattr(qs, "state2", None)
    if state2 is not None:
        absmax = dequantize_nested_absmax(_np(qs.absmax), _np(state2.absmax), _np(state2.code), float(qs.offset),
                                          nested_blocksize=state2.blocksize)
    else:
        absmax = np.asarray(_np(qs.absmax), np.float32)
    bias = None if getattr(linear, "bias", None) is None else np.asarray(_np(linear.bias), np.float32)
    return from_bnb_state(packed, absmax, tuple(qs.shape), blocksize=qs.blocksize,
                          quant_type=getattr(qs, "quant_type", "fp4"), bias=bias, layout=layout, device=device)
