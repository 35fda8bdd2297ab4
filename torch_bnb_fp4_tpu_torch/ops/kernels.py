"""FP4 kernels K1-K6, K8 and K9a/K9b: CUDA wrappers, plain PyTorch versions,
launch counts, the M-based path choice of ``matmul_fp4_pk`` and the int8
prefill shadow.

Counterpart of ``torch_bnb_fp4_tpu/ops/kernels.py``.  Every wrapper takes its
kernel's plain version for a tensor on the CPU and launches the CUDA kernel
(``csrc/``, built by ``_build``) for a CUDA tensor; there is no fallback from
one to the other.  The plain versions repeat the kernels' arithmetic in torch
ops and run on any device, so a test can hold a kernel against its plain
version on the card.

  K1 decode_pairs       csrc/pairk_decode.cuh (device routine) + decode_pairs.cu
  K2 matmul_pk          csrc/matmul_pk.cu          GEMV / small-M (m-outer), bf16 wgmma
  K3 matmul_pk_minner   csrc/matmul_pk_minner.cu   decode-once GEMM (m-inner), bf16 wgmma
  K4 matmul_pk_w4a8     csrc/matmul_pk_w4a8.cu     int8 tensor-core GEMM
  K5 matmul_w8          csrc/matmul_w8.cu          int8 GEMM over a prefill shadow, int8 wgmma (K4's loop)
  K6 dequantize_tpu_pk  csrc/dequant_pk.cu         pair-K dequantize (Wt = w * s)
  K8 expert=...         the K2/K3/K4 sources       expert e of a stacked (E, K/2, N) packing
  K9a dequantize_tpu    csrc/dequant_splitk.cu     split-K dequantize (Wt = code * absmax)
  K9b matmul_fp4        csrc/matmul_splitk.cu      split-K fused dequant-matmul, bf16 wgmma (gemv_fp4: one row)

``dequantize_fp4_flat`` (bnb flat packing -> weight) is plain torch: the JAX
package has no kernel for it either.

K8 is the expert form of K2, K3 and K4 (``expert=`` on their wrappers and on
``matmul_fp4_pk``): the kernel reads the expert index from device memory and
offsets the packed, scale and bias pointers itself, so the MoE dispatch never
reads a routing decision on the host and copies no expert.  Its launches are
counted under ``<wrapper>_expert``.

K9a/K9b serve the split-K layout (``ops/format.pack_tpu``): high nibble = Wt
row i, low nibble = row i + K/2, true absmax in hi/lo halves, a 16-entry f32
codebook (FP4, NF4 or any bnb table) as data.  Their launches are counted
under ``dequant_splitk`` and ``matmul_splitk``.

Block shapes are constants of the kernels; there is no per-chip table.  The
launch plans of K2, K3, K4/K5 and K9b (``k2_plan``, ``k3_plan``,
``w4a8_split``, ``k9b_plan``: tile, K split) are pure Python, so the CPU
tests hold them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from . import format as fmt

VARIANT_CODE = {"exact": 0, "zramp": 1, "ramp": 2, "lut": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# M at which bf16 input with an FP4-family variant takes the w4a8 path (the
# JAX package's a8_min_m, ops/kernels.py:127-139); activation K-tile request
A8_MIN_M = 256
A8_BLOCK_K = 1024
# K2's f32-x kernel (and K9b's f32-x stream) split K until the grid holds about
# this many blocks per SM (swept on an H100: 4 was best at M = 1 and 8 over the
# four Mistral-7B shapes)
K2_BLOCKS_PER_SM = 4
# K2/K3 (bf16 x, warpgroup MMA): the x rows of a K2 block (the n of its wgmma),
# the fewest quant blocks a K split keeps, and the int32 counters of the
# in-kernel split merge (one per output tile)
K2_ROWS = (8, 16, 32, 64, 128)
SPLIT_MIN_BLOCKS = 4
SPLIT_COUNTERS = 8192

# launches per wrapper: each CUDA launch adds one (plain CPU calls do not);
# "flash_attention" is K7's, counted by ops/attention.py
LAUNCHES = {"decode_pairs": 0, "matmul_pk": 0, "matmul_pk_minner": 0, "matmul_pk_w4a8": 0, "flash_attention": 0,
            "flash_attention_fp8": 0, "matmul_w8": 0, "dequant_pk": 0, "matmul_pk_expert": 0, "matmul_pk_minner_expert": 0,
            "matmul_pk_w4a8_expert": 0, "dequant_splitk": 0, "matmul_splitk": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts: a CUDA graph's replays run
    the launches its capture counted (and a capture, which runs nothing,
    takes its own back with ``times=-1``)."""
    for k, n in delta.items():
        LAUNCHES[k] += times * n


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def _choose_block(dim: int, requested: int, quantum: int) -> int:
    """Largest multiple of ``quantum`` that is <= requested and divides dim."""
    assert dim % quantum == 0, (dim, quantum)
    best = quantum
    for s in range(min(requested, dim) // quantum, 0, -1):
        if (dim // quantum) % s == 0:
            best = s * quantum
            break
    return best


def _k_block_pairk(k: int, requested: int, blocksize: int, s_quantum: int = 8) -> int:
    """The JAX path's K block for scale-tiled pair-K kernels: quantum
    s_quantum*blocksize, else one full-K block.  Fixes the w4a8 activation
    K-tile (a8_block_k), which is part of that path's numerics."""
    q = s_quantum * blocksize
    if k % q == 0:
        return _choose_block(k, requested, q)
    if k % (2 * blocksize) or (k // 2) % 32:
        raise ValueError(f"K={k} is not a pair-K shape for blocksize {blocksize}")
    return k


@functools.lru_cache(maxsize=256)
def a8_block_k(k: int, scale_dtype: torch.dtype, blocksize: int = 64) -> int:
    return _k_block_pairk(k, A8_BLOCK_K, blocksize, 16 if scale_dtype == torch.bfloat16 else 8)


# ---------------------------------------------------------------------------
# K8: the expert index
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _expert_table(device: torch.device, n_experts: int) -> torch.Tensor:
    """arange(n_experts) int32 on ``device``, made once: a static (Python
    int) expert is passed to a K8 launch as one of its elements, so the
    all-experts loop copies nothing from the host per call."""
    return torch.arange(n_experts, dtype=torch.int32, device=device)


def expert_index(expert, n_experts: int, device: torch.device) -> torch.Tensor:
    """The expert of a K8 call as a one-element int32 tensor on ``device``:
    a Python int in [0, n_experts) becomes an element of the cached table; a
    tensor (an element of the router's top-k indices) must already be int32,
    one element, on ``device`` (its value is never read on the host; the
    kernel clamps it into [0, n_experts) as ``dynamic_index_in_dim`` does).
    It is exempt from the 16-byte alignment of the other operands."""
    if isinstance(expert, (int, np.integer)) and not isinstance(expert, bool):
        if not 0 <= expert < n_experts:
            raise ValueError(f"expert {expert} is outside the stack of {n_experts}")
        return _expert_table(device, n_experts)[int(expert)]
    if not torch.is_tensor(expert):
        raise TypeError(f"expert must be an int or an int32 tensor, got {type(expert).__name__}")
    if expert.dtype != torch.int32 or expert.numel() != 1 or expert.device != device:
        raise ValueError(f"a tensor expert index must be one int32 element on {device}, got {expert.dtype} "
                         f"{tuple(expert.shape)} on {expert.device}")
    return expert


def select_expert(expert, *stacked):
    """Expert ``expert`` of each stacked operand (None stays None): plain
    indexing for an int, else a gather at the clamped index, so a plain
    version (or ``models.transformer.expert_view``) on the card reads no
    routing decision on the host either."""
    if isinstance(expert, (int, np.integer)):
        return tuple(None if t is None else t[int(expert)] for t in stacked)
    n = next(t for t in stacked if t is not None).shape[0]
    idx = expert.reshape(1).long().clamp(0, n - 1)
    return tuple(None if t is None else t.index_select(0, idx)[0] for t in stacked)


def _check_stack(packed, scale, bias, expert) -> None:
    """Operand ranks of a 2-D call (``expert`` None) or of a K8 call: packed
    (E, K/2, N), scale (E, K/bs, N), bias (E, N) or None."""
    if expert is None:
        if packed.ndim != 2:
            raise ValueError(f"packed must be 2-D (K/2, N) without an expert, got {tuple(packed.shape)}")
        return
    e = packed.shape[0]
    if packed.ndim != 3 or scale.ndim != 3 or scale.shape[0] != e:
        raise ValueError(f"an expert call needs stacked packed (E, K/2, N) and scale (E, K/bs, N), got "
                         f"{tuple(packed.shape)} and {tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (e, packed.shape[2]):
        raise ValueError(f"a stacked bias must be {(e, packed.shape[2])}, got {tuple(bias.shape)}")


# ---------------------------------------------------------------------------
# K1: pair-K byte decode
# ---------------------------------------------------------------------------


def make_pairk_lut(codebook, device=None) -> torch.Tensor:
    """(16,) int16 bf16 BIT PATTERNS of a codebook (the lut decode's table)."""
    cb = torch.as_tensor(np.asarray(codebook, np.float32) if not torch.is_tensor(codebook) else codebook)
    return cb.to(device=device, dtype=torch.float32).to(torch.bfloat16).view(torch.int16).contiguous()


def decode_pairs_plain(x_u8: torch.Tensor, variant: str = "exact", lut: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K1: uint8 bytes -> int32 words holding two bf16 bit patterns of
    192*code (low 16 bits = low nibble).  The integer steps run in int64 and
    are masked to 32 bits, reproducing the kernel's uint32 wraparound."""
    X = x_u8.to(torch.int64)
    if variant == "lut":
        lu = lut.to(torch.int64) & 0xFFFF
        bits = lu[X & 0xF] | (lu[(X >> 4) & 0xF] << 16)
    elif variant in ("ramp", "zramp"):
        t = (X * 0x01001000) & 0xFFFFFFFF
        if variant == "ramp":
            bits = (0x41804180 + ((t >> 6) & 0x01C001C0)) | (t & 0x80008000)
        else:
            q12 = t & 0x70007000
            b0 = 0x41804180 + (q12 >> 6)
            s1 = ((q12 + 0x70007000) >> 15) & 0x00010001
            bits = (b0 & ((s1 * 0xFFFF) & 0xFFFFFFFF)) | (t & 0x80008000)
    elif variant == "exact":
        t = X * 0x1001
        q2 = t & 0x00070007
        bits = 0x41804180 + (q2 << 6)
        s1 = ((q2 + 0x00060006) >> 3) & 0x00010001
        bits = bits & (s1 * 0xFFFF)
        one = q2 & (s1 ^ 0x00010001)
        bits = bits | (one * 0x3F80)
        bits = bits | ((t & 0x00080008) << 12)
    else:
        raise ValueError(f"unknown pairk variant {variant!r}")
    bits = bits & 0xFFFFFFFF
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def decode_pairs(x_u8: torch.Tensor, variant: str = "exact", lut: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on its own (the CUDA test kernel on a CUDA tensor): same result as
    :func:`decode_pairs_plain`."""
    if x_u8.dtype != torch.uint8:
        raise ValueError(f"decode_pairs takes uint8 bytes, got {x_u8.dtype}")
    if variant == "lut" and lut is None:
        raise ValueError("variant='lut' needs the bf16 bit-pattern table")
    if not x_u8.is_cuda:
        return decode_pairs_plain(x_u8, variant, lut)
    x = x_u8.contiguous()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    lut_d = None if variant != "lut" else lut.to(x.device).contiguous()
    fn = _build.kernel("decode_pairs.cu")
    LAUNCHES["decode_pairs"] += 1
    _check_status("decode_pairs", fn(x.data_ptr(), out.data_ptr(), x.numel(), VARIANT_CODE[variant],
                                     _ptr(lut_d), _stream(x)))
    return out


def pairs_weight_tile(packed: torch.Tensor, variant: str = "exact", lut: torch.Tensor | None = None) -> torch.Tensor:
    """Plain decode of a packed (K/2, N) tile -> (K, N) bf16 code values
    (192*code for FP4 variants, bf16(code) for lut), scale NOT applied.  The
    word of a byte depends on the byte alone, so :func:`decode_pairs_plain`
    runs once over all 256 bytes and the tile gathers from that table (the
    same bits as decoding every byte)."""
    table = decode_pairs_plain(torch.arange(256, device=packed.device).to(torch.uint8), variant, lut)
    words = table[packed.to(torch.int64)]  # (K/2, N) int32: low half row 2i, high half row 2i+1
    pair = words.view(torch.int16).reshape(*packed.shape, 2).transpose(-1, -2)  # little-endian halves
    return pair.reshape(-1, packed.shape[1]).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions of K2-K4 (any device)
# ---------------------------------------------------------------------------


def _finish(acc: torch.Tensor, bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(out_dtype)


def matmul_pk_plain(x, packed, scale, bias=None, lut=None, *, blocksize=64, out_dtype=None, variant, expert=None,
                    ksplit=1):
    """Plain K2: per quant block b, part_b = x_b . (192*code)_b in f32, then
    acc = sum_b part_b * scale[b] (the TPU kernel's order, :680-691).  With
    ``expert`` (K8), the operands are stacked and expert e's are used.
    ``ksplit`` > 1 follows the kernel's K split: each of the contiguous
    ranges of quant blocks accumulates acc = acc + part * scale in block order
    from 0, and the ranges' partials are summed in range order."""
    if expert is not None:
        packed, scale, bias = select_expert(expert, packed, scale, bias)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    m, k = x.shape
    n = packed.shape[1]
    nb = k // blocksize
    if nb % ksplit:
        raise ValueError(f"ksplit={ksplit} must divide the {nb} quant blocks")
    w = pairs_weight_tile(packed, variant, lut).float().reshape(nb, blocksize, n)
    xb = x.float().reshape(m, nb, blocksize).transpose(0, 1)  # (nb, m, bs)
    terms = torch.bmm(xb, w) * scale.float()[:, None, :]  # (nb, m, n) f32: part_b * scale[b]
    if ksplit == 1:
        return _finish(terms.sum(0), bias, out_dtype)
    terms = terms.reshape(ksplit, nb // ksplit, m, n)
    ws = terms[:, 0]
    for b in range(1, nb // ksplit):  # every range at once, block by block
        ws = ws + terms[:, b]
    acc = ws[0]
    for r in range(1, ksplit):
        acc = acc + ws[r]
    return _finish(acc, bias, out_dtype)


def matmul_pk_minner_plain(x, packed, scale, bias=None, lut=None, *, blocksize=64, out_dtype=None, variant,
                           expert=None):
    """Plain K3: weight tile = code value * scale, rounded in bf16 for bf16
    input (w * bf16(scale), :726-729) and kept in f32 for f32 input; then an
    f32 matmul.  With ``expert`` (K8), expert e of stacked operands."""
    if expert is not None:
        packed, scale, bias = select_expert(expert, packed, scale, bias)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.dtype == torch.float32:
        wt = pairs_weight_tile(packed, variant, lut).float() * scale.float().repeat_interleave(blocksize, dim=0)
    else:
        wt = minner_weights_plain(packed, scale, lut, blocksize=blocksize, variant=variant).float()
    return _finish(x.float() @ wt, bias, out_dtype)


def minner_weights_plain(packed, scale, lut=None, *, blocksize=64, variant):
    """K3's weight tile the way its producer warpgroup builds it: each packed
    byte decoded (K1) to a word of two bf16 values, the pair multiplied in
    bf16 by the column's bf16(scale) duplicated into both halves (one __hmul2:
    the exact product of two bf16 values rounded once), the two halves landing
    in rows 2i and 2i+1.  (K, N) bf16, equal byte for byte to
    ``pairs_weight_tile(...) * bf16(scale)`` rounded to bf16 (the TPU
    kernel's prescale, :726-729)."""
    kp, n = packed.shape
    table = decode_pairs_plain(torch.arange(256, device=packed.device).to(torch.uint8), variant, lut)
    words = table[packed.to(torch.int64)]  # (K/2, N) int32: K1 of each byte
    pairs = words.view(torch.bfloat16).reshape(kp, n, 2)  # little-endian: [..., 0] is row 2i
    s2 = scale.float().to(torch.bfloat16).repeat_interleave(blocksize // 2, dim=0)  # (K/2, N)
    return (pairs * s2[:, :, None]).transpose(1, 2).reshape(2 * kp, n)


def quantize_activations(x: torch.Tensor, block_k: int):
    """Per (row, K-tile) int8 activations for the w4a8 path (:1143-1147):
    r = max|x| over the tile (0 -> 1), x8 = round_half_even(x * (127 / r)),
    rs = r * (1/127).  The f32 division is written out: ``127.0 / r`` in torch
    multiplies by a reciprocal, which rounds differently."""
    m, k = x.shape
    xr = x.float().reshape(m, k // block_k, block_k)
    r = xr.abs().amax(dim=2)
    r = torch.where(r == 0.0, torch.ones_like(r), r)
    q = torch.full_like(r, 127.0).div(r)
    x8 = torch.round(xr * q[:, :, None]).to(torch.int8).reshape(m, k)
    return x8.contiguous(), (r * (1.0 / 127.0)).contiguous()


def w4a8_weights_plain(packed, scale, *, blocksize=64, variant, a8_block_k):
    """The w4a8 path's requantized weights: (w8 int8 (K, N), g (K/a8_block_k, N)
    f32 = tile column max of the scales (0 -> 1) times 192/127)."""
    k, n = 2 * packed.shape[0], packed.shape[1]
    nk, nsub = k // a8_block_k, a8_block_k // blocksize
    s = scale.float().reshape(nk, nsub, n)
    g = s.amax(dim=1)
    g = torch.where(g == 0.0, torch.ones_like(g), g)
    f = (s / g[:, None, :]) * (127.0 / fmt.PAIRK_VALUE_SCALE)  # (nk, nsub, n)
    wv = pairs_weight_tile(packed, variant).float().reshape(nk, nsub, blocksize, n)
    w8 = torch.round(wv * f[:, :, None, :]).to(torch.int8).reshape(k, n)
    return w8, g * (fmt.PAIRK_VALUE_SCALE / 127.0)


def w4a8_weights_table_plain(packed, scale, *, blocksize=64, variant, a8_block_k):
    """K4's weight decode in torch ops: for each quant block of each column the
    16 int8 values rint(v_j * f) of the nibbles j = 0..15 (v_j = the K1 value
    192*code, f = (scale / g) * 127/192 as in :func:`w4a8_weights_plain`),
    then every nibble looked up in its column's table.  Equals
    ``w4a8_weights_plain(...)[0]`` byte for byte; the CUDA kernel builds the
    same tables and maps nibbles with byte permutes."""
    kp, n = packed.shape
    k = 2 * kp
    nk, nsub = k // a8_block_k, a8_block_k // blocksize
    s = scale.float().reshape(nk, nsub, n)
    g = s.amax(dim=1)
    g = torch.where(g == 0.0, torch.ones_like(g), g)
    f = ((s / g[:, None, :]) * (127.0 / fmt.PAIRK_VALUE_SCALE)).reshape(k // blocksize, 1, n)
    vals = pairs_weight_tile(torch.arange(16, dtype=torch.uint8, device=packed.device)[None, :], variant)[0]
    table = torch.round(vals.float()[None, :, None] * f).to(torch.int8)  # (K/64, 16, N)
    x = packed.to(torch.int64)
    nib = torch.stack([x & 0xF, x >> 4], dim=1).reshape(k, n)  # row 2i low nibble, 2i+1 high
    return torch.gather(table, 1, nib.reshape(k // blocksize, blocksize, n)).reshape(k, n)


def matmul_pk_w4a8_plain(x8, rs, packed, scale, bias=None, *, blocksize=64, out_dtype, variant, a8_block_k,
                         expert=None):
    """Plain K4: exact per-K-tile integer dots (float64 holds them exactly),
    then acc = acc + (d * rs) * g tile by tile in f32.  With ``expert`` (K8),
    expert e of stacked operands."""
    if expert is not None:
        packed, scale, bias = select_expert(expert, packed, scale, bias)
    m, k = x8.shape
    n = packed.shape[1]
    nk = k // a8_block_k
    w8, g = w4a8_weights_plain(packed, scale, blocksize=blocksize, variant=variant, a8_block_k=a8_block_k)
    xt = x8.double().reshape(m, nk, a8_block_k).transpose(0, 1)  # (nk, m, bk)
    d = torch.bmm(xt, w8.double().reshape(nk, a8_block_k, n)).float()  # (nk, m, n) exact
    acc = torch.zeros((m, n), dtype=torch.float32, device=x8.device)
    for t in range(nk):
        acc = acc + (d[t] * rs[:, t : t + 1]) * g[t][None, :]
    return _finish(acc, bias, out_dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers of K2-K4
# ---------------------------------------------------------------------------


def _check_buffers(**tensors) -> None:
    """Every given tensor on the first one's device, contiguous and 16-byte
    aligned (None entries are skipped)."""
    first, dev = next((n, t.device) for n, t in tensors.items() if t is not None)
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {first} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned for the CUDA kernels")


def _check_cuda_operands(x, x_dtypes, packed, scale, bias, blocksize, **extra):
    """What the CUDA kernels assume and do not check themselves: dtypes, one
    device, contiguous 16-byte-aligned buffers, blocksize 64 and N % 128."""
    if x.dtype not in x_dtypes:
        raise ValueError(f"the CUDA kernel takes x in {x_dtypes}, got {x.dtype}")
    _check_buffers(x=x, packed=packed, scale=scale, bias=bias, **extra)
    if packed.dtype != torch.uint8 or scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"packed must be uint8 and scale f32/bf16, got {packed.dtype}, {scale.dtype}")
    if blocksize != 64:
        raise ValueError(f"the CUDA pair-K kernels take blocksize 64, got {blocksize}")
    if packed.shape[-1] % 128:
        raise ValueError(f"the CUDA pair-K kernels need N % 128 == 0, got N={packed.shape[-1]}")
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    if extra.get("lut") is not None and extra["lut"].dtype != torch.int16:
        raise ValueError("lut must hold the int16 bf16 bit patterns of make_pairk_lut")
    if extra.get("rs") is not None and extra["rs"].dtype != torch.float32:
        raise ValueError("rs must be float32")


class TilePlan(NamedTuple):
    """The launch of a K2/K3 warpgroup-MMA kernel: ``rows`` x ``cols`` output
    tile per block (rows: every x row up to the tile), ``ksplit`` contiguous
    ranges of quant blocks and the grid (n_tiles, ksplit, m_tiles)."""

    rows: int
    cols: int
    ksplit: int
    m_tiles: int
    n_tiles: int


def fill_split(tiles: int, nb: int, sms: int, most: int | None = None, per: int = 1) -> int:
    """K splits of a grid of ``tiles`` output tiles over ``nb`` stages of
    ``per`` quant blocks (64 rows of K) each: the most (at most ``most``)
    that divide nb, keep at least SPLIT_MIN_BLOCKS quant blocks per split and
    keep the grid within one wave of ``sms`` blocks (one block per SM); 1
    where the tiles alone fill the wave.  A second, partial wave cost more
    than the deeper split saved in every case swept on the H100
    (``benchmarks_torch/hopper_bench.py``)."""
    least = min(SPLIT_MIN_BLOCKS, nb * per)
    ok = [d for d in range(1, nb + 1) if nb % d == 0 and nb // d * per >= least and tiles * d <= sms
          and (most is None or d <= most)]
    return ok[-1] if ok else 1


@functools.lru_cache(maxsize=1024)
def k2_plan(m: int, k: int, n: int, sms: int) -> TilePlan:
    """K2 with bf16 x (csrc/matmul_pk.cu, Cfg): one block takes every row of x
    (rows = M rounded up to 8, 16, 32, 64 or 128; 128-row M tiles above),
    four consumer warpgroups of 64 columns up to 64 rows, two at 128.  The
    split's f32 partials (written and read back: 8 M N bytes a split) move at
    most the packed weights' K N / 2 bytes: d <= K / (16 M).  Memoized: it
    runs on every decode-step call."""
    rows = next((r for r in K2_ROWS if r >= m), K2_ROWS[-1])
    cols = 256 if rows <= 64 else 128
    n_tiles, m_tiles = -(-n // cols), -(-m // 128)
    split = fill_split(n_tiles * m_tiles, k // 64, sms, max(1, k // (16 * m)))
    return TilePlan(rows, cols, split, m_tiles, n_tiles)


@functools.lru_cache(maxsize=1024)
def k3_plan(m: int, k: int, n: int, sms: int) -> TilePlan:
    """K3 with bf16 x (csrc/matmul_pk_minner.cu): 256 x 128 output tiles (one
    block covers all M <= 256 rows), four consumer warpgroups and a producer
    warpgroup."""
    n_tiles, m_tiles = n // 128, -(-m // 256)
    return TilePlan(256, 128, fill_split(n_tiles * m_tiles, k // 64, sms), m_tiles, n_tiles)


def pk_tile_smem(kname: str, rows: int = 256) -> int:
    """Dynamic shared memory per block of K2's bf16 kernel at ``rows`` x rows
    (``kname`` "K2") or of K3's ("K3"), as the kernel's own layout sets it
    (``Cfg<rows>::SMEM``, ``kSmem``); builds the kernels on first use."""
    if kname == "K2":
        return _build.query("pk_matmul_pk_smem")(rows)
    return _build.query("pk_matmul_pk_minner_smem")()


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _split_counters(device: torch.device) -> torch.Tensor:
    """The int32 tile counters of the K2/K3 split merge on ``device``'s
    current stream, made once per stream, all 0.  Each launch's last block
    per tile sets its counter back to 0, so the launches of one stream, which
    never overlap, share them, and a CUDA graph replays them.  Launches on
    another stream take counters of their own: two splits running at once on
    one set would mix their tickets.  A graph keeps the counters of the
    stream it was captured on (made by the capture if it is that stream's
    first split): replay such graphs one at a time."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    if key not in _counters:
        _counters[key] = torch.zeros(SPLIT_COUNTERS, dtype=torch.int32, device=device)
    return _counters[key]


@functools.lru_cache(maxsize=1024)
def _k2_f32_launch(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(x rows per block, K splits) for K2's f32-x kernel: 1-8 rows and 512
    columns per block, and the fewest K splits that fill about
    K2_BLOCKS_PER_SM blocks on each SM, dividing the K/64 quant blocks, with
    the staged x chunk inside 48 KB of shared memory."""
    rows = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    nb = k // 64
    target = -(-K2_BLOCKS_PER_SM * sms // (-(-n // 512) * -(-m // rows)))
    for d in range(1, nb + 1):
        if nb % d == 0 and d >= target and rows * (k // d) * 4 <= 48 * 1024:
            return rows, d
    return rows, nb


def _split_buffers(plan: TilePlan, m: int, n: int, device):
    """(workspace, counters) of a split launch, (None, None) unsplit."""
    if plan.ksplit == 1:
        return None, None
    if plan.n_tiles * plan.m_tiles > SPLIT_COUNTERS:
        raise ValueError(f"{plan.n_tiles * plan.m_tiles} output tiles exceed the {SPLIT_COUNTERS} split counters")
    return torch.empty((plan.ksplit, m, n), dtype=torch.float32, device=device), _split_counters(device)


def matmul_pk(x, packed, scale, bias=None, lut=None, *, blocksize=64, out_dtype=None, variant, expert=None):
    """K2: y = x . Wt + bias, the GEMV / small-M kernel (bf16 x on the
    warpgroup MMA, f32 x on CUDA cores).  ``expert`` (an int or a one-element
    int32 tensor on x's device): K8, expert e of stacked operands."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_stack(packed, scale, bias, expert)
    e = None if expert is None else expert_index(expert, packed.shape[0], x.device)
    if not x.is_cuda:
        return matmul_pk_plain(x, packed, scale, bias, lut, blocksize=blocksize, out_dtype=out_dtype, variant=variant,
                               expert=e)
    _check_cuda_operands(x, (torch.float32, torch.bfloat16), packed, scale, bias, blocksize, lut=lut)
    return _launch_matmul_pk(x, packed, scale, bias, lut, out_dtype, variant, e)


def _launch_matmul_pk(x, packed, scale, bias, lut, out_dtype, variant, expert=None, ksplit=None):
    """Launch K2 (K8 with an ``expert_index`` tensor) on checked CUDA
    operands, with ``k2_plan``'s K split or (bf16 x; the split sweep of
    ``benchmarks_torch/hopper_bench.py``) a given one."""
    m, k = x.shape
    n = packed.shape[-1]
    if x.dtype == torch.bfloat16:
        plan = k2_plan(m, k, n, _sm_count(x.device))
        if ksplit is not None:
            plan = plan._replace(ksplit=ksplit)
        rows, split = plan.rows, plan.ksplit
        ws, counters = _split_buffers(plan, m, n, x.device)
    else:
        rows, split = _k2_f32_launch(m, k, n, _sm_count(x.device))
        ws, counters = torch.empty((split, m, n), dtype=torch.float32, device=x.device), None
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _build.kernel("matmul_pk.cu")
    LAUNCHES["matmul_pk" if expert is None else "matmul_pk_expert"] += 1
    _check_status("matmul_pk", fn(
        x.data_ptr(), _DTYPE_CODE[x.dtype], packed.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype],
        _ptr(bias), _ptr(lut), _ptr(ws), _ptr(counters), out.data_ptr(), _DTYPE_CODE[out_dtype],
        m, k, n, split, rows, VARIANT_CODE[variant], _ptr(expert), _n_experts(packed, expert), _stream(x)))
    return out


def _n_experts(packed, expert) -> int:
    return 1 if expert is None else packed.shape[0]


def matmul_pk_minner(x, packed, scale, bias=None, lut=None, *, blocksize=64, out_dtype=None, variant, expert=None):
    """K3: decode-once GEMM; bf16 x on the warpgroup MMA (``k3_plan``), f32 x
    on CUDA cores.  ``expert``: K8, expert e of stacked operands (as
    :func:`matmul_pk`)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_stack(packed, scale, bias, expert)
    e = None if expert is None else expert_index(expert, packed.shape[0], x.device)
    if not x.is_cuda:
        return matmul_pk_minner_plain(x, packed, scale, bias, lut, blocksize=blocksize, out_dtype=out_dtype,
                                      variant=variant, expert=e)
    _check_cuda_operands(x, (torch.float32, torch.bfloat16), packed, scale, bias, blocksize, lut=lut)
    m, k = x.shape
    n = packed.shape[-1]
    split, ws, counters = 1, None, None
    if x.dtype == torch.bfloat16:
        plan = k3_plan(m, k, n, _sm_count(x.device))
        split = plan.ksplit
        ws, counters = _split_buffers(plan, m, n, x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _build.kernel("matmul_pk_minner.cu")
    LAUNCHES["matmul_pk_minner" if e is None else "matmul_pk_minner_expert"] += 1
    _check_status("matmul_pk_minner", fn(
        x.data_ptr(), _DTYPE_CODE[x.dtype], packed.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype],
        _ptr(bias), _ptr(lut), _ptr(ws), _ptr(counters), out.data_ptr(), _DTYPE_CODE[out_dtype], m, k, n, split,
        VARIANT_CODE[variant], _ptr(e), _n_experts(packed, e), _stream(x)))
    return out


# K4 and K5 share one int8 warpgroup-MMA main loop (csrc/int8_mainloop.cuh)
K4_TILE = 128  # the loop's output tile (M and N) and K rows per stage
K4_MAX_SPLIT = 4  # K-tile ranges at most
K4_MAX_BLOCK_K = 1 << 17  # 127 * 127 * block_k stays inside the loop's int32 accumulator
K4_THREAD_REGS = 128  # the loop's setmaxnreg split (2 x 128 threads at 176, 2 x 128 at 80) needs this launch count


def _int8_regs(name: str, regs: int) -> int:
    if regs < 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed with cudaError {-regs}")
    return regs


@functools.lru_cache(maxsize=8)
def w4a8_kernel_regs(variant: str) -> int:
    """Registers per thread of K4's kernel for ``variant`` on the current
    card (``cudaFuncGetAttributes``); K4 launches only at ``K4_THREAD_REGS``."""
    return _int8_regs("matmul_pk_w4a8", _build.query("pk_matmul_pk_w4a8_regs")(VARIANT_CODE[variant]))


@functools.lru_cache(maxsize=1)
def w8_kernel_regs() -> int:
    """Registers per thread of K5's kernel; it launches only at ``K4_THREAD_REGS`` too."""
    return _int8_regs("matmul_w8", _build.query("pk_matmul_w8_regs")())


def _check_int8_regs(name: str, regs: int) -> None:
    if regs != K4_THREAD_REGS:
        raise RuntimeError(f"{name}: the kernel was built at {regs} registers per thread; its setmaxnreg split "
                           f"needs exactly {K4_THREAD_REGS}")


@functools.lru_cache(maxsize=1024)
def w4a8_split(m: int, k: int, n: int, a8_block_k: int, sms: int) -> int:
    """K-tile ranges K4 (and K5, with its block_k) takes for this shape on a
    card with ``sms`` SMs: 1 when its 128 x 128 output tiles fill half a wave
    or more; else the split (at most ``K4_MAX_SPLIT`` and the K-tiles) that
    minimizes waves x K-tiles per range, the smaller one on a tie.  The
    ranges' per-K-tile terms are summed in K-tile order by a second pass, so
    every split is bit-equal."""
    tiles = -(-m // K4_TILE) * (n // K4_TILE)
    nk = k // a8_block_k
    if 2 * tiles > sms:
        return 1
    cost = {s: -(-tiles * s // sms) * -(-nk // s) for s in range(1, min(nk, K4_MAX_SPLIT) + 1)}
    return min(cost, key=lambda s: (cost[s], s))


def matmul_pk_w4a8(x8, rs, packed, scale, bias=None, *, blocksize=64, out_dtype, variant, a8_block_k, expert=None):
    """K4: int8 warpgroup-MMA GEMM over pre-quantized activations.  ``expert``:
    K8, expert e of stacked operands (as :func:`matmul_pk`)."""
    _check_stack(packed, scale, bias, expert)
    e = None if expert is None else expert_index(expert, packed.shape[0], x8.device)
    if not x8.is_cuda:
        return matmul_pk_w4a8_plain(x8, rs, packed, scale, bias, blocksize=blocksize, out_dtype=out_dtype,
                                    variant=variant, a8_block_k=a8_block_k, expert=e)
    _check_cuda_operands(x8, (torch.int8,), packed, scale, bias, blocksize, rs=rs)
    m, k = x8.shape
    n = packed.shape[-1]
    if a8_block_k <= 0 or k % a8_block_k or a8_block_k % K4_TILE or a8_block_k > K4_MAX_BLOCK_K:
        raise ValueError(f"a8_block_k={a8_block_k} must divide K={k}, be a multiple of {K4_TILE} and at most "
                         f"{K4_MAX_BLOCK_K} for the CUDA kernel")
    _check_int8_regs(f"matmul_pk_w4a8 ({variant})", w4a8_kernel_regs(variant))
    split = w4a8_split(m, k, n, a8_block_k, _sm_count(x8.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x8.device)
    terms = None if split == 1 else torch.empty((k // a8_block_k, m, n), dtype=torch.float32, device=x8.device)
    fn = _build.kernel("matmul_pk_w4a8.cu")
    LAUNCHES["matmul_pk_w4a8" if e is None else "matmul_pk_w4a8_expert"] += 1
    _check_status("matmul_pk_w4a8", fn(
        x8.data_ptr(), rs.data_ptr(), packed.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype],
        _ptr(bias), out.data_ptr(), _DTYPE_CODE[out_dtype], _ptr(terms), m, k, n, a8_block_k, split,
        VARIANT_CODE[variant], _ptr(e), _n_experts(packed, e), _stream(x8)))
    return out


# ---------------------------------------------------------------------------
# Entry points with the JAX package's path choice
# ---------------------------------------------------------------------------


def select_path(m: int, compute_dtype: torch.dtype, variant: str, a8: bool | None) -> str:
    """Which kernel ``matmul_fp4_pk`` runs (ops/kernels.py:1062-1114 and
    :1233-1238 of the JAX package): "w4a8" (K4), "minner" (K3) or "mouter"
    (K2).  The TPU's 48 MB VMEM gate on the m-inner path (:1114) is dropped:
    the CUDA kernels keep no full-M accumulator, so no M is too large."""
    if a8 is None:
        a8 = m >= A8_MIN_M and compute_dtype == torch.bfloat16 and variant != "lut"
    elif a8:
        if compute_dtype != torch.bfloat16:
            raise ValueError("a8=True requires bf16 compute (f32 keeps full-precision dots)")
        if variant == "lut":
            raise ValueError("a8 requires an FP4-family variant (lut codebook range is data)")
    if a8:
        return "w4a8"
    if compute_dtype == torch.bfloat16:
        return "minner" if m > 128 else "mouter"
    return "minner" if m > 256 else "mouter"


def matmul_fp4_pk(x, packed, scale, bias=None, codebook=None, *, blocksize=64, out_dtype=None, variant,
                  a8=None, expert=None):
    """Fused pair-K dequant-matmul: y[M, N] = x[M, K] @ Wt[K, N] (+ bias).

    ``packed`` uint8 (K/2, N); ``scale`` f32|bf16 (K/blocksize, N) =
    absmax/192 (lut: absmax); ``variant`` is required.  x may be f32, bf16 or
    f16; f16 computes in bf16, f32 in f32.  ``a8``: None = auto (bf16, M >=
    256, FP4-family variant), True forces the int8 path, False forbids it.

    ``expert`` (K8): run against expert e of STACKED operands, packed (E,
    K/2, N), scale (E, K/blocksize, N) and bias (E, N); e is a Python int or a
    one-element int32 tensor on x's device (see :func:`expert_index`).  The
    path is chosen from the per-expert (M, K, N) exactly as for a 2-D call.
    """
    if variant == "lut":
        if codebook is None:
            raise ValueError("variant='lut' requires a 16-entry codebook array")
    elif variant not in fmt.PAIRK_VARIANTS:
        raise ValueError(f"unknown pairk variant {variant!r}; expected one of {fmt.PAIRK_VARIANTS} or 'lut'")
    elif codebook is not None:
        raise ValueError("codebook is only used with variant='lut'")
    if expert is None:
        if packed.ndim != 2 or packed.dtype != torch.uint8:
            raise ValueError(f"packed must be 2-D uint8 (K/2, N), got {tuple(packed.shape)} {packed.dtype}")
    elif packed.ndim != 3 or packed.dtype != torch.uint8:
        raise ValueError(f"expert selection needs STACKED 3-D uint8 packed (E, K/2, N), got {tuple(packed.shape)} "
                         f"{packed.dtype}")
    kp, n = packed.shape[-2:]
    k = 2 * kp
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, K={k}) for packed (K/2={kp}, N={n}), got {tuple(x.shape)}")
    want_scale = (k // blocksize, n) if expert is None else (packed.shape[0], k // blocksize, n)
    if tuple(scale.shape) != want_scale:
        raise ValueError(f"scale must be {want_scale} for blocksize={blocksize}, got {tuple(scale.shape)}")
    if scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scale must be float32 or bfloat16, got {scale.dtype}")
    m = x.shape[0]
    out_dtype = x.dtype if out_dtype is None else out_dtype
    compute_dtype = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    x = x.to(compute_dtype).contiguous()
    lut = make_pairk_lut(codebook, x.device) if variant == "lut" else None
    path = select_path(m, compute_dtype, variant, a8)
    kw = dict(blocksize=blocksize, out_dtype=out_dtype, variant=variant, expert=expert)
    if path == "mouter":
        return matmul_pk(x, packed, scale, bias, lut, **kw)
    if path == "minner":
        return matmul_pk_minner(x, packed, scale, bias, lut, **kw)
    bk = a8_block_k(k, scale.dtype, blocksize)
    x8, rs = quantize_activations(x, bk)
    return matmul_pk_w4a8(x8, rs, packed, scale, bias, a8_block_k=bk, **kw)


def gemv_fp4_pk(x, packed, scale, bias=None, codebook=None, *, blocksize=64, out_dtype=None, variant, expert=None):
    """Batch-1 route: a single row through K2 (K8's with ``expert``)."""
    if x.shape[0] != 1:
        raise ValueError(f"gemv_fp4_pk is the batch-1 fast path; got x.shape={tuple(x.shape)} (use matmul_fp4_pk)")
    return matmul_fp4_pk(x, packed, scale, bias, codebook, blocksize=blocksize, out_dtype=out_dtype,
                         variant=variant, expert=expert)


# ---------------------------------------------------------------------------
# K6: pair-K dequantize, and the int8 prefill shadow built from it
# ---------------------------------------------------------------------------


def dequantize_pk_plain(packed, scale, lut=None, *, blocksize=64, out_dtype=torch.bfloat16, variant):
    """Plain K6: Wt (K, N) = w * s in f32, cast once to ``out_dtype``; w is
    192*code (bf16(code) for lut), s the scale row of the weight's block."""
    w = pairs_weight_tile(packed, variant, lut).float()
    return (w * scale.float().repeat_interleave(blocksize, dim=0)).to(out_dtype)


def dequantize_tpu_pk(packed, scale, codebook=None, *, blocksize=64, out_dtype=torch.bfloat16, variant):
    """K6: materialize Wt (K, N) from a pair-K packing (the JAX package's
    ``dequantize_tpu_pk``, ops/kernels.py:1339); bit-exact with
    :func:`dequantize_pk_plain`."""
    if variant == "lut":
        if codebook is None:
            raise ValueError("variant='lut' requires a 16-entry codebook array")
    elif variant not in fmt.PAIRK_VARIANTS:
        raise ValueError(f"unknown pairk variant {variant!r}; expected one of {fmt.PAIRK_VARIANTS} or 'lut'")
    kp, n = packed.shape
    if scale.shape != (2 * kp // blocksize, n):
        raise ValueError(f"scale must be {(2 * kp // blocksize, n)} for blocksize={blocksize}, got {tuple(scale.shape)}")
    lut = make_pairk_lut(codebook, packed.device) if variant == "lut" else None
    if not packed.is_cuda:
        return dequantize_pk_plain(packed, scale, lut, blocksize=blocksize, out_dtype=out_dtype, variant=variant)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel writes f32, bf16 or f16, got {out_dtype}")
    # packed stands in for x: the checks need a tensor on the operands' device
    _check_cuda_operands(packed, (torch.uint8,), packed, scale, None, blocksize, lut=lut)
    out = torch.empty((2 * kp, n), dtype=out_dtype, device=packed.device)
    fn = _build.kernel("dequant_pk.cu")
    LAUNCHES["dequant_pk"] += 1
    _check_status("dequant_pk", fn(packed.data_ptr(), scale.data_ptr(), _DTYPE_CODE[scale.dtype], _ptr(lut),
                                   out.data_ptr(), _DTYPE_CODE[out_dtype], kp, n, VARIANT_CODE[variant],
                                   _stream(packed)))
    return out


def make_int8_shadow(packed, scale, codebook=None, *, blocksize=64, variant, block_k=1024):
    """(w8 (K, N) int8, g (K/block_k, N) f32): the int8 prefill shadow of a
    pair-K packing (the JAX package's ``make_int8_shadow``, :928): K6 at f32,
    then per (block_k tile, column) g = max|Wt| (0 -> 1), w8 =
    round_half_even(Wt * (127 / g)), and g / 127.  Torch ops on the weights'
    device after K6; the division is written out, as in
    :func:`quantize_activations`, so the bytes equal the JAX package's."""
    wt = dequantize_tpu_pk(packed, scale, codebook, blocksize=blocksize, out_dtype=torch.float32, variant=variant)
    k, n = wt.shape
    if k % block_k:
        raise ValueError(f"K={k} must divide by block_k={block_k}")
    wr = wt.reshape(k // block_k, block_k, n)
    g = wr.abs().amax(dim=1)
    g = torch.where(g == 0.0, torch.ones_like(g), g)
    q = torch.full_like(g, 127.0).div(g)
    w8 = torch.round(wr.mul_(q[:, None, :])).to(torch.int8).reshape(k, n)
    return w8.contiguous(), (g * (1.0 / 127.0)).contiguous()


# ---------------------------------------------------------------------------
# K5: int8 GEMM over a prefill shadow
# ---------------------------------------------------------------------------


def matmul_w8_plain(x8, rs, w8, g, bias=None, *, out_dtype, block_k, split=1):
    """Plain K5: exact per-K-tile integer dots (float64 holds them exactly),
    then acc = acc + (d * rs) * g tile by tile in f32.  ``split`` > 1
    follows the kernel's K split: each of the contiguous K-tile ranges
    writes its tiles' f32 terms (d * rs) * g, which are then added to 0 in
    K-tile order: the same additions as unsplit."""
    m, k = x8.shape
    n = w8.shape[1]
    nk = k // block_k
    xt = x8.double().reshape(m, nk, block_k).transpose(0, 1)  # (nk, m, bk)
    d = torch.bmm(xt, w8.double().reshape(nk, block_k, n)).float()  # (nk, m, n) exact
    acc = torch.zeros((m, n), dtype=torch.float32, device=x8.device)
    if split == 1:
        for t in range(nk):
            acc = acc + (d[t] * rs[:, t : t + 1]) * g[t][None, :]
        return _finish(acc, bias, out_dtype)
    if not 1 <= split <= nk:
        raise ValueError(f"split={split} must be between 1 and the {nk} K-tiles")
    terms = torch.empty((nk, m, n), dtype=torch.float32, device=x8.device)
    for z in range(split):  # range z: K-tiles [z nk / split, (z + 1) nk / split), as the kernel's blockIdx.z
        for t in range(z * nk // split, (z + 1) * nk // split):
            terms[t] = (d[t] * rs[:, t : t + 1]) * g[t][None, :]
    for t in range(nk):
        acc = acc + terms[t]
    return _finish(acc, bias, out_dtype)


def matmul_w8_int8(x8, rs, w8, g, bias=None, *, out_dtype, block_k):
    """K5 on pre-quantized activations: the CUDA kernel on a CUDA tensor (K4's
    int8 warpgroup-MMA loop with ``w4a8_split``'s K split),
    :func:`matmul_w8_plain` on a CPU one."""
    if not x8.is_cuda:
        return matmul_w8_plain(x8, rs, w8, g, bias, out_dtype=out_dtype, block_k=block_k)
    m, k = x8.shape
    n = w8.shape[1]
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 or g.dtype != torch.float32 or rs.dtype != torch.float32:
        raise ValueError(f"K5 takes int8 x8 and w8 and f32 rs and g, got {x8.dtype}, {w8.dtype}, {rs.dtype}, {g.dtype}")
    if k % block_k or block_k % K4_TILE or block_k > K4_MAX_BLOCK_K or n % 128:
        raise ValueError(f"K5 needs block_k | K, block_k % {K4_TILE} == 0, block_k <= {K4_MAX_BLOCK_K} and "
                         f"N % 128 == 0, got K={k} block_k={block_k} N={n}")
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel writes f32, bf16 or f16, got {out_dtype}")
    _check_buffers(x8=x8, rs=rs, w8=w8, g=g, bias=bias)
    _check_int8_regs("matmul_w8", w8_kernel_regs())
    split = w4a8_split(m, k, n, block_k, _sm_count(x8.device))
    out = torch.empty((m, n), dtype=out_dtype, device=x8.device)
    terms = None if split == 1 else torch.empty((k // block_k, m, n), dtype=torch.float32, device=x8.device)
    fn = _build.kernel("matmul_w8.cu")
    LAUNCHES["matmul_w8"] += 1
    _check_status("matmul_w8", fn(x8.data_ptr(), rs.data_ptr(), w8.data_ptr(), g.data_ptr(), _ptr(bias),
                                  out.data_ptr(), _DTYPE_CODE[out_dtype], _ptr(terms), m, k, n, block_k, split,
                                  _stream(x8)))
    return out


def matmul_w8(x, w8, g, bias=None, *, block_k=1024, out_dtype=None):
    """y[M, N] = x[M, K] @ dequant8(w8)[K, N] (+ bias): the int8-shadow GEMM
    (the JAX package's ``matmul_w8``, ops/kernels.py:852).  ``g`` has one row
    per ``block_k`` rows of the shadow.  x (any float dtype) is quantized per
    (row, block_k tile) from its own values widened to f32, so f16 input is
    not rounded to bf16 first; the result has x's dtype unless ``out_dtype``
    says otherwise."""
    k, n = w8.shape
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if k % block_k:
        raise ValueError(f"K={k} must divide by block_k={block_k}")
    if g.shape != (k // block_k, n):
        raise ValueError(f"g must be {(k // block_k, n)} (block_k={block_k}), got {tuple(g.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    x8, rs = quantize_activations(x, block_k)
    return matmul_w8_int8(x8, rs, w8, g, bias, out_dtype=out_dtype, block_k=block_k)


# ---------------------------------------------------------------------------
# K9a/K9b: the split-K layout (bnb-exact FP4 / NF4, K-sharded packings)
# ---------------------------------------------------------------------------

# the K multiple an unsharded split-K layer is padded to (the JAX package's K_QUANTUM)
K_QUANTUM = 1024


def _split_absmax(absmax, kp: int, blocksize: int, n: int):
    """(hi, lo) halves of a split-K absmax, each (kp/blocksize, n): the pair
    as given, or one (K/blocksize, n) array of ``format.pack_tpu`` cut in two
    (the JAX package's ``_split_absmax``, with its messages)."""
    rows = kp // blocksize
    if isinstance(absmax, (tuple, list)):
        shi, slo = absmax
    else:
        if tuple(absmax.shape) != (2 * rows, n):
            raise ValueError(f"absmax must be (K/blocksize, N) = {(2 * rows, n)} for blocksize={blocksize}, "
                             f"got {tuple(absmax.shape)}")
        shi, slo = absmax[:rows], absmax[rows:]
    if tuple(shi.shape) != (rows, n) or tuple(slo.shape) != (rows, n):
        raise ValueError(f"absmax halves must each be {(rows, n)}, got {tuple(shi.shape)} and {tuple(slo.shape)}")
    return shi, slo


@functools.lru_cache(maxsize=64)
def _table_on(device: torch.device, key: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(key, np.float32).copy()).to(device)


def code_table(codebook, device) -> torch.Tensor:
    """The (16,) f32 decode table on ``device``: FP4_CODE for ``codebook``
    None, else the codebook (NF4 or any bnb table).  A numpy table (and the
    FP4 one) is uploaded once per device and cached; an f32 tensor already on
    the device is used as it is, so a decode step copies nothing."""
    device = torch.device(device)
    if codebook is None:
        return _table_on(device, fmt.FP4_CODE.tobytes())
    if torch.is_tensor(codebook):
        if codebook.numel() != 16:
            raise ValueError(f"codebook must have 16 entries, got {tuple(codebook.shape)}")
        return codebook.reshape(16).to(device=device, dtype=torch.float32).contiguous()
    cb = np.asarray(codebook, np.float32)
    if cb.size != 16:
        raise ValueError(f"codebook must have 16 entries, got {cb.shape}")
    return _table_on(device, np.ascontiguousarray(cb.reshape(16)).tobytes())


def _check_decode_impl(decode_impl, codebook) -> None:
    """The JAX package's ``decode_impl`` contract: "gather" or "arith"
    (arith is FP4 only).  Both give the table's bits, so the port decodes
    from the table either way."""
    if decode_impl not in (None, "gather", "arith"):
        raise ValueError(f"decode_impl must be 'gather' or 'arith', got {decode_impl!r}")
    if decode_impl == "arith" and codebook is not None:
        raise ValueError("arith decode is FP4-only")


def _splitk_halves(packed, table, shi, slo, blocksize):
    """Plain decode: (Wt rows [0, K/2), Wt rows [K/2, K)), each (K/2, N) f32
    = table[nibble] * absmax of the row's block, one f32 multiply each."""
    kp, n = packed.shape
    p = packed.to(torch.int32)
    out = []
    for codes, s in ((p >> 4, shi), (p & 0xF, slo)):
        v = table[codes].reshape(kp // blocksize, blocksize, n)
        out.append((v * s.float()[:, None, :]).reshape(kp, n))
    return out


def dequantize_splitk_plain(packed, absmax_hi, absmax_lo, table, *, blocksize=64, out_dtype=torch.bfloat16):
    """Plain K9a: Wt (K, N), hi nibbles in rows [0, K/2) and lo nibbles in
    [K/2, K), each table[nibble] * absmax in f32, cast once to ``out_dtype``."""
    hi, lo = _splitk_halves(packed, table, absmax_hi, absmax_lo, blocksize)
    return torch.cat([hi, lo], dim=0).to(out_dtype)


def splitk_weights_plain(packed, absmax_hi, absmax_lo, table, *, blocksize=64):
    """K9b's bf16 weights the way its kernels decode them: each byte X looked
    up as (table[X >> 4], table[X & 15]) in a 256-entry table (the small
    kernel's per-lane table; the large kernel reads the 16-entry table by
    nibble, the same values), each value times the absmax of its half's
    64-row block in f32 and rounded once to bf16.  (hi, lo): Wt rows [0, K/2)
    and [K/2, K), each (K/2, N) bf16."""
    kp, n = packed.shape
    byte = torch.arange(256, device=packed.device)
    pairs = torch.stack([table[byte >> 4], table[byte & 15]], dim=1)[packed.to(torch.int64)]  # (K/2, N, 2) f32
    return tuple((pairs[..., h].reshape(kp // blocksize, blocksize, n) * s.float()[:, None, :])
                 .reshape(kp, n).to(torch.bfloat16) for h, s in ((0, absmax_hi), (1, absmax_lo)))


def splitk_x_columns(kp: int, k_shards: int = 1, device=None):
    """(hi, lo): the x column each packed row meets with its high and its low
    nibble, each (K/2,) int64.  A packing of ``k_shards`` K shards is that
    many self-contained slices: packed row i of shard d = i // (K/2D) meets x
    column d K/D + i % (K/2D) and the one K/2D further.  The CUDA kernels
    compute the same columns per 64-row block and read x in place; the plain
    version gathers x with them (the JAX package reorders x instead, as
    models/linear.py::_shard_reorder_x does; the tests hold one against the
    other)."""
    kpl = kp // k_shards
    i = torch.arange(kp, device=device)
    hi = (i // kpl) * 2 * kpl + i % kpl
    return hi, hi + kpl


def matmul_splitk_plain(x, packed, absmax_hi, absmax_lo, bias, table, *, blocksize=64, out_dtype, k_shards=1,
                        ksplit=1):
    """Plain K9b: the weights as K9a decodes them in f32, rounded once to
    bf16 for non-f32 ``x`` (:func:`splitk_weights_plain`); an f32 matmul of x
    against them, bias added in f32, one cast to ``out_dtype``.  ``k_shards``
    > 1: x read through :func:`splitk_x_columns`.  ``ksplit`` > 1 follows the
    bf16 kernels' K split: contiguous ranges of 64-row blocks, each range's
    f32 partial, the partials summed in range order."""
    kp = packed.shape[0]
    if x.dtype != torch.float32:
        hi, lo = (w.float() for w in splitk_weights_plain(packed, absmax_hi, absmax_lo, table, blocksize=blocksize))
    else:
        hi, lo = _splitk_halves(packed, table, absmax_hi, absmax_lo, blocksize)
    ch, cl = splitk_x_columns(kp, k_shards, x.device)
    xf = x.float()
    xh, xl = xf[:, ch], xf[:, cl]
    nb = kp // blocksize
    if nb % ksplit:
        raise ValueError(f"ksplit={ksplit} must divide the {nb} absmax blocks")
    acc = None
    for r in range(ksplit):
        rows = slice(r * kp // ksplit, (r + 1) * kp // ksplit)
        part = xh[:, rows] @ hi[rows] + xl[:, rows] @ lo[rows]
        acc = part if acc is None else acc + part
    return _finish(acc, bias, out_dtype)


def _check_splitk_cuda(packed, shi, slo, table, blocksize, **tensors) -> None:
    """What the split-K CUDA kernels assume: blocksize 64, K/2 % 64 == 0,
    N % 128 == 0, f32 absmax and bias, everything on one device, contiguous
    and 16-byte aligned."""
    kp, n = packed.shape
    if blocksize != 64 or kp % 64:
        raise ValueError(f"the CUDA split-K kernels take blocksize 64 and K/2 % 64 == 0, got blocksize {blocksize}, "
                         f"K/2={kp}")
    if n % 128:
        raise ValueError(f"the CUDA split-K kernels need N % 128 == 0, got N={n}")
    if shi.dtype != torch.float32 or slo.dtype != torch.float32:
        raise ValueError(f"split-K absmax must be float32, got {shi.dtype}, {slo.dtype}")
    if tensors.get("bias") is not None and tensors["bias"].dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {tensors['bias'].dtype}")
    _check_buffers(packed=packed, absmax_hi=shi, absmax_lo=slo, table=table, **tensors)


def dequantize_tpu(packed, absmax, codebook=None, *, blocksize=64, out_dtype=torch.bfloat16, decode_impl=None):
    """K9a: materialize Wt (K, N) from a split-K packing (the JAX package's
    ``dequantize_tpu``, ops/kernels.py:255).  ``absmax`` is the (hi, lo) pair
    or one (K/blocksize, N) array; ``codebook`` None (FP4) or a (16,) table.
    Bit-exact with :func:`dequantize_splitk_plain`."""
    _check_decode_impl(decode_impl, codebook)
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be 2-D uint8 (K/2, N), got {tuple(packed.shape)} {packed.dtype}")
    kp, n = packed.shape
    shi, slo = _split_absmax(absmax, kp, blocksize, n)
    table = code_table(codebook, packed.device)
    if not packed.is_cuda:
        return dequantize_splitk_plain(packed, shi, slo, table, blocksize=blocksize, out_dtype=out_dtype)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel writes f32, bf16 or f16, got {out_dtype}")
    shi, slo = shi.contiguous(), slo.contiguous()
    _check_splitk_cuda(packed, shi, slo, table, blocksize)
    out = torch.empty((2 * kp, n), dtype=out_dtype, device=packed.device)
    fn = _build.kernel("dequant_splitk.cu")
    LAUNCHES["dequant_splitk"] += 1
    _check_status("dequant_splitk", fn(packed.data_ptr(), shi.data_ptr(), slo.data_ptr(), table.data_ptr(),
                                       out.data_ptr(), _DTYPE_CODE[out_dtype], kp, n, _stream(packed)))
    return out


K9B_ROWS = (8, 16, 32)  # x rows of K9b's small kernel (the n of its wgmma); 128-row tiles above
K9B_MAX_SPLIT = 4  # K splits of K9b's large kernel at most: the last block of a tile sums them


@functools.lru_cache(maxsize=1024)
def k9b_plan(m: int, k: int, n: int, sms: int) -> TilePlan:
    """K9b with bf16 x (csrc/matmul_splitk.cu).  Up to 32 rows the small
    kernel: one block takes every row of x (rows = M rounded up to 8, 16 or
    32) and 256 columns (128 below N = 4096, so N = 1024 keeps 8 column
    tiles), the weights decoded once into registers; the K split as K2's
    (``fill_split`` over the stages of 64 packed rows, each two 64-row quant
    blocks of either half, d <= K / (16 M): the f32 partials move no more
    bytes than the packed weights).  Above, the large kernel: 128 x 128
    tiles, one decode per M tile, K split at most ``K9B_MAX_SPLIT``.
    Memoized: it runs on every decode-step call."""
    nb = k // 128
    if m <= K9B_ROWS[-1]:
        cols = 256 if n >= 4096 else 128
        n_tiles = -(-n // cols)
        rows = next(r for r in K9B_ROWS if r >= m)
        return TilePlan(rows, cols, fill_split(n_tiles, nb, sms, max(1, k // (16 * m)), per=2), 1, n_tiles)
    n_tiles, m_tiles = n // 128, -(-m // 128)
    return TilePlan(128, 128, fill_split(n_tiles * m_tiles, nb, sms, K9B_MAX_SPLIT, per=2), m_tiles, n_tiles)


def splitk_tile_smem(rows: int, cols: int = 128) -> int:
    """Dynamic shared memory per block of K9b's bf16 kernel at ``rows`` x
    rows and ``cols`` columns (rows 128: the large kernel), as the kernel's
    own layout sets it; builds the kernels on first use."""
    return _build.query("pk_matmul_splitk_smem")(rows, cols)


@functools.lru_cache(maxsize=1024)
def _splitk_f32_launch(m: int, kp: int, n: int, sms: int) -> tuple[int, int]:
    """(K splits, rows) of K9b's f32-x stream: 1, 2, 4 or 8 x rows per block,
    512 columns, and the fewest K splits that fill about
    ``K2_BLOCKS_PER_SM`` blocks on each SM, dividing the K/128 absmax-block
    rows, with the block's x rows (hi and lo halves, f32) inside 48 KB of
    shared memory."""
    rows = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    nb = kp // 64
    blocks = -(-n // 512) * -(-m // rows)
    target = -(-K2_BLOCKS_PER_SM * sms // blocks)
    for d in range(1, nb + 1):
        if nb % d == 0 and d >= target and rows * 2 * (kp // d) * 4 <= 48 * 1024:
            return d, rows
    return nb, rows


def matmul_splitk(x, packed, absmax_hi, absmax_lo, bias, table, *, blocksize=64, out_dtype, k_shards=1):
    """K9b on a compute-dtype ``x`` (f32 or bf16; the CUDA kernel on a CUDA
    tensor, :func:`matmul_splitk_plain` on a CPU one).  ``k_shards``: the
    packing's K shards; the bf16 kernels read x in place
    (:func:`splitk_x_columns`), f32 x is gathered for the CUDA-core stream."""
    kp, n = packed.shape
    if k_shards < 1 or kp % (blocksize * k_shards):
        raise ValueError(f"K/2={kp} must divide into k_shards={k_shards} slices of whole {blocksize}-row blocks")
    if not x.is_cuda:
        return matmul_splitk_plain(x, packed, absmax_hi, absmax_lo, bias, table, blocksize=blocksize,
                                   out_dtype=out_dtype, k_shards=k_shards)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes x in f32 or bf16, got {x.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA kernel writes f32, bf16 or f16, got {out_dtype}")
    _check_splitk_cuda(packed, absmax_hi, absmax_lo, table, blocksize, x=x, bias=bias)
    return _launch_matmul_splitk(x, packed, absmax_hi, absmax_lo, bias, table, out_dtype, k_shards)


def _launch_matmul_splitk(x, packed, absmax_hi, absmax_lo, bias, table, out_dtype, k_shards, ksplit=None):
    """Launch K9b on checked CUDA operands, with ``k9b_plan``'s K split or
    (bf16 x; the split sweep of ``benchmarks_torch/hopper_bench.py``) a
    given one."""
    m, k = x.shape
    kp, n = packed.shape
    if x.dtype == torch.bfloat16:
        plan = k9b_plan(m, k, n, _sm_count(x.device))
        if ksplit is not None:
            plan = plan._replace(ksplit=ksplit)
        ksplit, rows, cols = plan.ksplit, plan.rows, plan.cols
        ws, counters = _split_buffers(plan, m, n, x.device)
    else:  # the CUDA-core stream reads one shard: a sharded x is gathered into the unsharded order
        if k_shards > 1:
            x, k_shards = x[:, torch.cat(splitk_x_columns(kp, k_shards, x.device))].contiguous(), 1
        (ksplit, rows), cols, counters = _splitk_f32_launch(m, kp, n, _sm_count(x.device)), 0, None
        ws = torch.empty((ksplit, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _build.kernel("matmul_splitk.cu")
    LAUNCHES["matmul_splitk"] += 1
    _check_status("matmul_splitk", fn(
        x.data_ptr(), _DTYPE_CODE[x.dtype], packed.data_ptr(), absmax_hi.data_ptr(), absmax_lo.data_ptr(),
        _ptr(bias), table.data_ptr(), _ptr(ws), _ptr(counters), out.data_ptr(), _DTYPE_CODE[out_dtype], m, k, n,
        k_shards, ksplit, rows, cols, _stream(x)))
    return out


def matmul_fp4(x, packed, absmax, bias=None, codebook=None, *, blocksize=64, out_dtype=None, decode_impl=None,
               k_shards=1):
    """Fused split-K dequant-matmul: y[M, N] = x[M, K] @ Wt[K, N] (+ bias)
    (the JAX package's ``matmul_fp4``, ops/kernels.py:378).  ``packed`` uint8
    (K/2, N); ``absmax`` the (hi, lo) pair or one (K/blocksize, N) array of
    TRUE absmax; ``codebook`` None (FP4) or a (16,) table.  x may be f32
    (true f32 dot), bf16, or f16, which computes in bf16 and returns f16 as
    in the JAX package; accumulation is f32.  ``k_shards`` (the port's
    addition): the packing is that many K shards (``format.pack_tpu_sharded``)
    and x keeps its own column order."""
    _check_decode_impl(decode_impl, codebook)
    if packed.ndim != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be 2-D uint8 (K/2, N), got {tuple(packed.shape)} {packed.dtype}")
    kp, n = packed.shape
    k = 2 * kp
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, K={k}) for packed (K/2={kp}, N={n}), got {tuple(x.shape)}")
    shi, slo = _split_absmax(absmax, kp, blocksize, n)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    compute_dtype = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    x = x.to(compute_dtype).contiguous()
    table = code_table(codebook, x.device)
    return matmul_splitk(x, packed, shi.contiguous(), slo.contiguous(), bias, table, blocksize=blocksize,
                         out_dtype=out_dtype, k_shards=k_shards)


def gemv_fp4(x, packed, absmax, bias=None, codebook=None, *, blocksize=64, out_dtype=None, decode_impl=None,
             k_shards=1):
    """Batch-1 route of the split-K layout: one row through K9b (the JAX
    package's ``gemv_fp4``, :485; the same numbers as ``matmul_fp4``)."""
    if x.shape[0] != 1:
        raise ValueError(f"gemv_fp4 is the batch-1 fast path; got x.shape={tuple(x.shape)} (use matmul_fp4)")
    return matmul_fp4(x, packed, absmax, bias, codebook, blocksize=blocksize, out_dtype=out_dtype,
                      decode_impl=decode_impl, k_shards=k_shards)


def dequantize_fp4_flat(packed, absmax, shape, blocksize=64, out_dtype=torch.bfloat16, codebook=None):
    """bnb's flat packing (two codes per byte, HIGH nibble first, one absmax
    per ``blocksize`` flat elements) -> a ``shape`` tensor on packed's device:
    ``code[nibble] * absmax`` in f32, cast to ``out_dtype`` (the JAX package's
    ``dequantize_fp4_flat``, ops/kernels.py:1375).  Plain torch on either
    device: the JAX package computes it with jnp, no Pallas kernel, as a
    tooling path off the serving hot path (which decodes the pair-K and
    split-K layouts in K1-K9), so there is no CUDA kernel to port and no
    launch count.  ``codebook`` None means FP4."""
    code = torch.as_tensor(fmt.FP4_CODE if codebook is None else codebook, dtype=torch.float32,
                           device=packed.device)
    p = packed.reshape(-1).to(torch.int64)
    codes = torch.stack([p >> 4, p & 0xF], dim=1).reshape(-1)
    vals = code[codes].reshape(-1, blocksize) * absmax.reshape(-1, 1).to(device=packed.device, dtype=torch.float32)
    return vals.reshape(shape).to(out_dtype)
