"""FP4 blockwise format: the port's copy of the numpy golden.

Counterpart of ``torch_bnb_fp4_tpu/ops/format.py``.  Quantization runs in
numpy on the host (it is a load-time step).  The JAX package rounds to bf16
with ``ml_dtypes``; this copy rounds with torch, which gives the same
round-to-nearest-even result.

Pair-K layout (``pack_tpu_pairk``, returns CPU torch tensors): the weight W
(N_out, K_in) is stored transposed, Wt (K, N).  ``packed`` uint8 (K/2, N):
byte (i, n) holds the RANK-CODED code of Wt[2i, n] in the LOW nibble and of
Wt[2i+1, n] in the HIGH nibble.  ``scale`` (K/blocksize, N) = absmax/192, so
kernels contract x with the integer code values 192*code.

bnb flat layout (``pack_flat``, ``quantize_flat`` alias ``quantize_fp4``,
``dequantize_fp4``, ``tpu_layout_from_bnb``): 4-bit codes two per byte, HIGH
nibble first, over the row-major flat weight; one absmax per ``blocksize``
flat elements.

Split-K layout (``pack_tpu``, ``pack_tpu_sharded``, numpy arrays as in the
JAX package): ``packed`` uint8 (K/2, N), byte (i, n) = code(Wt[i, n]) << 4 |
code(Wt[i + K/2, n]); ``absmax`` (K/blocksize, N) holds the TRUE absmax (not
/192), split into a hi half (rows of Wt [0, K/2)) and a lo half.  Decode is
``codebook[nibble] * absmax`` in f32, which is bnb's arithmetic bit for bit.
``k_shards`` > 1 packs K as that many self-contained slices.
"""

from __future__ import annotations

import numpy as np
import torch

# The 16-entry FP4 codebook (index bit 3 = sign, bits 0-2 = magnitude).
FP4_CODE = np.array(
    [
        0.0, 0.005208333333333333, 0.6666666666666666, 1.0,
        0.3333333333333333, 0.5, 0.16666666666666666, 0.25,
        -0.0, -0.005208333333333333, -0.6666666666666666, -1.0,
        -0.3333333333333333, -0.5, -0.16666666666666666, -0.25,
    ],
    dtype=np.float32,
)

# bitsandbytes NF4 codebook (normal-float 4-bit).
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

DEFAULT_BLOCKSIZE = 64

# Rank remap: flip bit 2 of the magnitude iff bit 1 is set, so the bf16 bit
# pattern of 192*|code| is the linear ramp 0x4180 + rank*0x40 (ops/kernels K1).
_R = np.arange(16)
RANK_REMAP = ((_R & 8) | ((_R & 7) ^ ((_R & 2) << 1))).astype(np.uint8)
del _R

# 192 * FP4_CODE is {0, +-1, +-32, +-48, +-64, +-96, +-128, +-192}: integers
# exact in bf16, so kernels contract x with the integer values and apply
# absmax/192 per quant block afterwards.
PAIRK_VALUE_SCALE = 192.0

# Pair-K codebook variants (magnitudes * 192, ascending rank order):
#   exact  bit-exact bnb FP4 (16-op decode)
#   zramp  drops the 1/192 level for 24/192 (11-op decode)
#   ramp   pure affine-in-bits codebook (6-op decode)
PAIRK_MAGS192 = {
    "exact": np.array([0, 1, 32, 48, 64, 96, 128, 192], np.float32),
    "zramp": np.array([0, 24, 32, 48, 64, 96, 128, 192], np.float32),
    "ramp": np.array([16, 24, 32, 48, 64, 96, 128, 192], np.float32),
}
PAIRK_VARIANTS = tuple(PAIRK_MAGS192)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> nearest bfloat16 (ties to even), returned as float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def quantize_codes(w: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE, code: np.ndarray = FP4_CODE,
                   absmax: np.ndarray | None = None):
    """Quantize a float array to 4-bit codebook indices + per-block absmax.

    Blocks run over the flat row-major order of ``w``.  ``absmax`` overrides
    the per-block scale (re-quantization against a rounded stored scale).
    Nearest entry by 15 midpoint comparisons; a tie at an exact midpoint
    picks the smaller value.  Returns (codes uint8 flat, absmax f32 (nblocks,)).
    """
    flat = np.asarray(w, dtype=np.float32).reshape(-1)
    if flat.size % blocksize != 0:
        raise ValueError(f"numel {flat.size} not divisible by blocksize {blocksize}")
    blocks = flat.reshape(-1, blocksize)
    if absmax is None:
        absmax = np.abs(blocks).max(axis=1).astype(np.float32)
    safe = np.where(absmax == 0.0, 1.0, absmax)
    normed = (blocks / safe[:, None]).reshape(-1)
    order = np.argsort(code, kind="stable").astype(np.uint8)
    sorted_code = code[order]
    mids = (sorted_code[1:] + sorted_code[:-1]) / 2
    idx = np.zeros(normed.shape, np.uint8)
    for m in mids:
        idx += normed > m
    return order[idx].reshape(-1), absmax


def pack_flat(codes: np.ndarray) -> np.ndarray:
    """Pack 4-bit codes two per byte, high nibble first (bnb layout)."""
    codes = codes.reshape(-1)
    if codes.size % 2 != 0:
        raise ValueError("need an even number of codes to pack")
    hi = codes[0::2].astype(np.uint8)
    lo = codes[1::2].astype(np.uint8)
    return ((hi << 4) | (lo & 0xF)).astype(np.uint8)


def unpack_flat(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_flat`: uint8 bytes -> 4-bit codes, high first."""
    packed = packed.reshape(-1)
    out = np.empty(packed.size * 2, dtype=np.uint8)
    out[0::2] = packed >> 4
    out[1::2] = packed & 0xF
    return out


def quantize_flat(w: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE, code: np.ndarray = FP4_CODE):
    """bnb-style quantize (the JAX package's ``quantize_fp4``): row-major flat
    blocks, packed high nibble first.  Returns (packed uint8 (numel/2,),
    absmax f32 (numel/blocksize,))."""
    codes, absmax = quantize_codes(w, blocksize, code)
    return pack_flat(codes), absmax


# the JAX package's name for the same function
quantize_fp4 = quantize_flat


def dequantize_codes(codes: np.ndarray, absmax: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE,
                     code: np.ndarray = FP4_CODE) -> np.ndarray:
    """Inverse of :func:`quantize_codes`: flat float32 ``code[codes] *
    absmax`` of each block."""
    vals = np.asarray(code, np.float32)[codes.astype(np.int64)].reshape(-1, blocksize)
    return (vals * np.asarray(absmax, np.float32)[:, None]).reshape(-1)


def dequantize_fp4(packed: np.ndarray, absmax: np.ndarray, shape, blocksize: int = DEFAULT_BLOCKSIZE,
                   code: np.ndarray = FP4_CODE) -> np.ndarray:
    """Golden dequantize of the bnb flat layout -> float32 ``shape``."""
    return dequantize_codes(unpack_flat(packed), absmax, blocksize, code).reshape(shape)


def tpu_layout_from_bnb(packed_flat: np.ndarray, absmax_flat: np.ndarray, shape, blocksize: int = DEFAULT_BLOCKSIZE):
    """bnb flat state of a (N_out, K_in) weight -> the split-K layout
    (packed (K/2, N), absmax (K/blocksize, N)), exact: no requantization."""
    n_out, k_in = shape
    codes_t = unpack_flat(packed_flat).reshape(n_out, k_in).T
    absmax_t = np.asarray(absmax_flat).reshape(n_out, k_in // blocksize).T
    half = k_in // 2
    packed = ((codes_t[:half].astype(np.uint8) << 4) | (codes_t[half:] & 0xF)).astype(np.uint8)
    return np.ascontiguousarray(packed), np.ascontiguousarray(absmax_t.astype(np.float32))


def pack_tpu(w: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE, code: np.ndarray = FP4_CODE):
    """Quantize + pack W (N_out, K_in) into the split-K layout.  The absmax
    grid is bnb's (blocks along K within each row).  Returns (packed uint8
    (K/2, N), absmax f32 (K/blocksize, N))."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError("pack_tpu expects a 2-D weight (N_out, K_in)")
    n_out, k_in = w.shape
    if k_in % (2 * blocksize) != 0 and k_in % blocksize != 0:
        raise ValueError(f"K={k_in} must be divisible by blocksize {blocksize}")
    if k_in % 2 != 0:
        raise ValueError("K must be even to pack two codes per byte")
    codes, absmax = quantize_codes(w, blocksize, code)
    codes_t = codes.reshape(n_out, k_in).T  # (K, N)
    absmax_t = absmax.reshape(n_out, k_in // blocksize).T  # (K/bs, N)
    half = k_in // 2
    packed = ((codes_t[:half].astype(np.uint8) << 4) | (codes_t[half:].astype(np.uint8) & 0xF)).astype(np.uint8)
    return np.ascontiguousarray(packed), np.ascontiguousarray(absmax_t.astype(np.float32))


def unpack_tpu(packed: np.ndarray, absmax: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE,
               code: np.ndarray = FP4_CODE) -> np.ndarray:
    """Golden dequantize of the split-K layout -> Wt float32 (K, N)."""
    half, n = packed.shape
    codes_t = np.empty((2 * half, n), dtype=np.uint8)
    codes_t[:half] = packed >> 4
    codes_t[half:] = packed & 0xF
    vals = np.asarray(code, np.float32)[codes_t.astype(np.int64)]
    return vals * np.repeat(absmax.astype(np.float32), blocksize, axis=0)


def pack_tpu_sharded(w: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE, code: np.ndarray = FP4_CODE,
                     k_shards: int = 1):
    """Quantize + pack with K cut into ``k_shards`` contiguous slices, each
    packed on its own in the split-K layout (the row-parallel layout: shard d
    holds a self-contained packing of Wt rows [d*K/D, (d+1)*K/D)).  The absmax
    grid equals the unsharded one.  Returns (packed (K/2, N) uint8, absmax_hi
    (K/(2*bs), N) f32, absmax_lo (same)), the shards stacked along K."""
    w = np.asarray(w, dtype=np.float32)
    n_out, k_in = w.shape
    if k_in % (k_shards * 2 * blocksize) != 0:
        raise ValueError(f"K={k_in} must be divisible by k_shards*2*blocksize={k_shards * 2 * blocksize}")
    k_loc = k_in // k_shards
    ps, his, los = [], [], []
    for d in range(k_shards):
        p, a = pack_tpu(w[:, d * k_loc : (d + 1) * k_loc], blocksize, code)
        half = a.shape[0] // 2
        ps.append(p)
        his.append(a[:half])
        los.append(a[half:])
    return (np.ascontiguousarray(np.concatenate(ps, axis=0)), np.ascontiguousarray(np.concatenate(his, axis=0)),
            np.ascontiguousarray(np.concatenate(los, axis=0)))


def unpack_tpu_sharded(packed: np.ndarray, absmax_hi: np.ndarray, absmax_lo: np.ndarray,
                       blocksize: int = DEFAULT_BLOCKSIZE, code: np.ndarray = FP4_CODE, k_shards: int = 1) -> np.ndarray:
    """Golden inverse of :func:`pack_tpu_sharded` -> Wt float32 (K, N)."""
    kp = packed.shape[0]
    kp_loc = kp // k_shards
    s_loc = absmax_hi.shape[0] // k_shards
    parts = []
    for d in range(k_shards):
        a = np.concatenate([absmax_hi[d * s_loc : (d + 1) * s_loc], absmax_lo[d * s_loc : (d + 1) * s_loc]], axis=0)
        parts.append(unpack_tpu(packed[d * kp_loc : (d + 1) * kp_loc], a, blocksize, code))
    return np.concatenate(parts, axis=0)


def pairk_code(variant: str = "exact") -> np.ndarray:
    """(16,) f32 rank-coded codebook of a pair-K variant (bit 3 = sign)."""
    m = PAIRK_MAGS192[variant] / PAIRK_VALUE_SCALE
    return np.concatenate([m, -m]).astype(np.float32)


def _pair_bytes(codes: np.ndarray, n_out: int, k_in: int) -> np.ndarray:
    ct = codes.reshape(n_out, k_in).T  # (K, N)
    return np.ascontiguousarray(((ct[1::2].astype(np.uint8) << 4) | ct[0::2]).astype(np.uint8))


def pack_tpu_pairk(w: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE, variant: str = "exact",
                   scale_dtype: torch.dtype = torch.float32):
    """Quantize + pack W (N_out, K_in) into the pair-K layout.

    Returns (packed uint8 (K/2, N), scale (K/blocksize, N) in ``scale_dtype``),
    both CPU tensors.  With bf16 scales the stored scale is rounded FIRST and
    codes are quantized against the rounded value, as decode multiplies by it.
    """
    w = np.asarray(w, dtype=np.float32)
    n_out, k_in = w.shape
    if k_in % (2 * blocksize) != 0:
        raise ValueError(f"K={k_in} must be divisible by 2*blocksize={2 * blocksize}")
    if scale_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scale_dtype must be torch.float32 or torch.bfloat16, got {scale_dtype}")
    absmax = None
    if scale_dtype == torch.bfloat16:
        flat = np.abs(w.reshape(-1, blocksize)).max(axis=1).astype(np.float32)
        absmax = bf16_round(flat / PAIRK_VALUE_SCALE) * PAIRK_VALUE_SCALE
    if variant == "exact":
        codes, absmax = quantize_codes(w, blocksize, FP4_CODE, absmax=absmax)
        codes = RANK_REMAP[codes]
    elif variant in PAIRK_VARIANTS:
        codes, absmax = quantize_codes(w, blocksize, pairk_code(variant), absmax=absmax)
    else:
        raise ValueError(f"unknown pairk variant {variant!r}; expected one of {PAIRK_VARIANTS}")
    scale = np.ascontiguousarray(absmax.reshape(n_out, k_in // blocksize).T / PAIRK_VALUE_SCALE)
    return (torch.from_numpy(_pair_bytes(codes, n_out, k_in)),
            torch.from_numpy(scale.astype(np.float32)).to(scale_dtype))


def _unpair(packed: torch.Tensor) -> np.ndarray:
    p = np.asarray(packed.cpu().numpy(), np.uint8)
    kp, n = p.shape
    ct = np.empty((2 * kp, n), dtype=np.uint8)
    ct[0::2] = p & 0xF
    ct[1::2] = p >> 4
    return ct


def unpack_tpu_pairk(packed: torch.Tensor, scale: torch.Tensor, blocksize: int = DEFAULT_BLOCKSIZE,
                     variant: str = "exact") -> np.ndarray:
    """Golden dequantize of the pair-K layout -> Wt float32 (K, N)."""
    ivals = (PAIRK_VALUE_SCALE * pairk_code(variant))[_unpair(packed)]
    scales = np.repeat(scale.float().cpu().numpy(), blocksize, axis=0)
    return (ivals * scales).astype(np.float32)


def pack_tpu_pairk_lut(w: np.ndarray, codebook: np.ndarray, blocksize: int = DEFAULT_BLOCKSIZE):
    """Quantize + pack against an arbitrary strictly increasing 16-entry
    codebook (NF4 or any bnb table) into the pair-K byte layout.  The nibble
    is the code index; ``scale`` f32 (K/bs, N) = absmax; value =
    bf16(code[nibble]) * scale.  Returns CPU tensors (packed, scale)."""
    w = np.asarray(w, dtype=np.float32)
    code = np.asarray(codebook, np.float32)
    if code.shape != (16,):
        raise ValueError(f"codebook must have 16 entries, got {code.shape}")
    if not np.all(np.diff(code) > 0):
        raise ValueError("codebook must be strictly increasing (bnb tables are)")
    n_out, k_in = w.shape
    if k_in % (2 * blocksize) != 0:
        raise ValueError(f"K={k_in} must be divisible by 2*blocksize={2 * blocksize}")
    # nearest neighbour w.r.t. the bf16-rounded table the kernels decode to
    codes, absmax = quantize_codes(w, blocksize, bf16_round(code))
    scale = np.ascontiguousarray(absmax.reshape(n_out, k_in // blocksize).T)
    return torch.from_numpy(_pair_bytes(codes, n_out, k_in)), torch.from_numpy(scale)


def unpack_tpu_pairk_lut(packed: torch.Tensor, scale: torch.Tensor, codebook: np.ndarray,
                         blocksize: int = DEFAULT_BLOCKSIZE) -> np.ndarray:
    """Golden dequantize of the pair-K LUT layout -> Wt float32 (K, N)."""
    vals = bf16_round(np.asarray(codebook, np.float32))[_unpair(packed)]
    scales = np.repeat(scale.float().cpu().numpy(), blocksize, axis=0)
    return (vals * scales).astype(np.float32)
