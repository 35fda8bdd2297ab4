"""K7: causal GQA flash attention (online softmax) over per-slot key positions;
K10: decode attention, one query row per slot.

Counterpart of ``torch_bnb_fp4_tpu/ops/attention.py``.  The mask comes from
ARBITRARY per-slot key positions (``kv_positions``), validity (``kv_valid``),
an optional sliding window and an optional Gemma-2 logit softcap, so rolling
ring caches, whose slot order is not position order after a wrap, work as
they are.

``flash_attention`` keeps the JAX signature and the (B, L, H, D) layout.
K and V may come from an fp8 cache (``float8_e4m3fn``) beside a bf16 q, as
in the JAX kernel: the scores are the f32 dot of q with the e4m3 values, and
the probability tile is rounded to e4m3 (``p.astype(v.dtype)``) before the
PV dot.  A CUDA tensor goes to the hand-written kernel (``csrc/flash_attention.cu``,
built by ``_build``) or the call raises; a CPU tensor goes to
:func:`flash_attention_plain`.  There is no fallback from one to the other.

The kernel's tiles are fixed: one CUDA block takes ``block_rows(D)`` (query,
head) rows, i.e. ``block_rows(D) // G`` query positions for all G query heads
of one kv head, and walks the keys ``BLOCK_K`` at a time.  When the grid is
short of one wave of the card's SMs, the wrapper splits the key tiles into
contiguous ranges (:func:`kernel_split`) whose partial results a second
kernel merges in split order.  :func:`flash_attention_plain` takes the
kernel's blocks and, when asked, its split, which fixes where the probability
tile is rounded to bf16; a CPU call runs it unsplit, the JAX recurrence.

``decode_attention`` (K10, ``csrc/decode_attention.cu``) is the dense route
for a one-row query (the JAX package's plain-jnp decode attention), with the
mask built once per forward (:func:`decode_keys`): it reads K and V as
stored, only below each slot's last valid row, and keeps P in f32.  It
replaces no Pallas kernel; the same device rule holds, with
:func:`decode_attention_plain` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .kernels import LAUNCHES, _check_status, _sm_count, _stream

BLOCK_K = 64  # keys per tile of the CUDA kernel
HEAD_DIMS = (64, 128, 256)
MAX_SPLIT = 16  # key ranges at most
MIN_SPLIT_TILES = 4  # key tiles per range at least
_NEG = -1e30
_PLAIN_QUERY_CHUNK = 1024  # the plain version's query rows per pass (bounds its f32 score tile)


def block_rows(d: int) -> int:
    """(query, head) rows per CUDA block: two consumer warpgroups of 64 rows,
    one at D = 256 (its f32 output accumulator fills a warpgroup's registers)."""
    return 64 if d > 128 else 128


def kernel_blocks(hq: int, hk: int, d: int = 128) -> tuple[int, int]:
    """(block_q, block_k) of the CUDA kernel for Hq query heads over Hk kv heads
    at head dim ``d``."""
    return max(1, block_rows(d) // (hq // hk)), BLOCK_K


def kernel_split(b: int, lq: int, lk: int, hq: int, hk: int, sms: int, d: int = 128) -> int:
    """Key ranges the wrapper gives the kernel for this shape on a card with
    ``sms`` SMs (one block per SM): the most that keep the grid (query blocks
    x B * Hk x ranges) inside one wave, at most ``MAX_SPLIT`` and each of at
    least ``MIN_SPLIT_TILES`` key tiles; 1 when the grid fills a wave alone.
    A second, partial wave costs more than it splits off
    (``benchmarks_torch/hopper_bench.py`` times every split of phase 3b's cases)."""
    block_q, block_k = kernel_blocks(hq, hk, d)
    blocks = -(-lq // block_q) * b * hk
    return max(1, min(sms // blocks, -(-lk // block_k) // MIN_SPLIT_TILES, MAX_SPLIT))


def _fp8_kv(q, k, v) -> bool:
    """bf16 q over float8_e4m3fn K/V: the fp8 KV cache's form."""
    return q.dtype == torch.bfloat16 and k.dtype == v.dtype == torch.float8_e4m3fn


def _check_operands(q, k, v, q_positions, kv_valid, kv_positions) -> None:
    """What both routes need: GQA head counts, matching shapes, one float
    dtype (or bf16 q with e4m3 K/V), one device, and a contiguous last (head)
    dimension."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q (B, Lq, Hq, D) and k, v (B, Lk, Hk, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, hq, d = q.shape
    _, lk, hk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if hq % hk:
        raise ValueError(f"Hq={hq} must be a multiple of Hk={hk}")
    if not (_fp8_kv(q, k, v) or (q.dtype == k.dtype == v.dtype and q.dtype.is_floating_point)):
        raise ValueError(f"q, k, v must share one float dtype, or be a bf16 q with float8_e4m3fn k and v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(q_positions.shape) != (b, lq) or q_positions.dtype != torch.int32:
        raise ValueError(f"q_positions must be int32 {(b, lq)}, got {q_positions.dtype} {tuple(q_positions.shape)}")
    if tuple(kv_positions.shape) != (b, lk) or kv_positions.dtype != torch.int32:
        raise ValueError(f"kv_positions must be int32 {(b, lk)}, got {kv_positions.dtype} "
                         f"{tuple(kv_positions.shape)}")
    if tuple(kv_valid.shape) != (b, lk) or kv_valid.dtype != torch.bool:
        raise ValueError(f"kv_valid must be bool {(b, lk)}, got {kv_valid.dtype} {tuple(kv_valid.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_positions", q_positions), ("kv_valid", kv_valid),
                    ("kv_positions", kv_positions)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last (head) dimension")


def _split_ranges(n_tiles: int, split: int) -> list[tuple[int, int]]:
    """The kernel's key-tile ranges: range z is [z * n / S, (z + 1) * n / S)."""
    return [(z * n_tiles // split, (z + 1) * n_tiles // split) for z in range(split)]


def flash_attention_plain(q, k, v, q_positions, kv_valid, kv_positions, sliding_window=None, scale=None,
                          logit_softcap=None, *, block_q, block_k, split=1):
    """The recurrence of the JAX ``_flash_kernel`` in torch ops, one key block
    at a time: s = (q . k) in f32 from the inputs' values, times ``scale``,
    softcapped, masked to -1e30; running max and sum; the probability tile is
    cast to ``v.dtype`` before the PV dot; out = acc / max(l, 1e-30).

    Query rows are independent, so ``block_q`` changes nothing but is checked;
    ``block_k`` is clamped as the JAX wrapper clamps it (``min(block_k,
    max(128, Lk))``) and fixes where p is rounded.  ``split`` follows the
    kernel's partition: the key blocks are cut into ``split`` contiguous
    ranges, each runs the recurrence from m = -1e30, l = 0, acc = 0, and the
    ranges merge in order: M = max m_z, e_z = exp(m_z - M), l = sum l_z e_z,
    acc = sum acc_z e_z (from 0, z = 0 first).  Given the kernel's blocks and
    split, it therefore rounds p where the kernel does; split 1 (the default)
    is the JAX recurrence itself.  With e4m3 K/V (bf16 q) p is rounded to
    e4m3, as JAX's ``p.astype(v.dtype)``."""
    _check_operands(q, k, v, q_positions, kv_valid, kv_positions)
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q and block_k must be positive, got {block_q}, {block_k}")
    b, lq, hq, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = float(d) ** -0.5 if scale is None else scale
    block_k = min(block_k, max(128, lk))
    n_tiles = -(-lk // block_k)
    if not 1 <= split <= n_tiles:
        raise ValueError(f"split must be in [1, {n_tiles}] (the key blocks), got {split}")
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, lq, _PLAIN_QUERY_CHUNK):
        qc = q[:, q0 : q0 + _PLAIN_QUERY_CHUNK]
        lc = qc.shape[1]
        qf = qc.reshape(b, lc, hk, g, d).float()
        qpos = q_positions[:, q0 : q0 + lc][:, None, None, :, None]  # (B, 1, 1, Lc, 1)
        parts = []
        for t0, t1 in _split_ranges(n_tiles, split):
            m = torch.full((b, hk, g, lc, 1), _NEG, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, hk, g, lc, d), dtype=torch.float32, device=q.device)
            for k0 in range(t0 * block_k, min(t1 * block_k, lk), block_k):
                k1 = min(k0 + block_k, lk)  # the JAX wrapper pads with invalid keys: they add 0
                s = torch.einsum("blhgd,bshd->bhgls", qf, kf[:, k0:k1]) * scale
                if logit_softcap is not None:
                    s = logit_softcap * torch.tanh(s / logit_softcap)
                kpos = kv_positions[:, k0:k1][:, None, None, None, :]
                mask = (kpos <= qpos) & kv_valid[:, k0:k1][:, None, None, None, :]
                if sliding_window is not None:
                    mask = mask & (kpos > qpos - sliding_window)
                s = torch.where(mask, s, _NEG)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                # a fully masked row keeps m = -1e30 and exp(0) = 1: p is zeroed explicitly
                p = torch.where(mask, torch.exp(s - m_new), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                pv = torch.einsum("bhgls,bshd->bhgld", p.to(v.dtype).float(), vf[:, k0:k1])
                acc = acc * alpha + pv
                m = m_new
            parts.append((m, l, acc))
        if split == 1:
            _, l, acc = parts[0]
        else:
            mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
            for m_z, l_z, acc_z in parts:
                e = torch.exp(m_z - mx)
                l = l + l_z * e
                acc = acc + acc_z * e
        o = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)  # (B, Hk, G, Lc, D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, lc, hq, d))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _check_cuda_operands(q, k, v) -> None:
    """What the CUDA kernel assumes on top of :func:`_check_operands`: bf16
    q with bf16 or e4m3 K/V, a head dim it is built for, at most
    ``block_rows(D)`` query heads per kv head, and 16-byte aligned rows and
    strides (its TMA boxes and loads move 16 bytes at a time)."""
    d, hq, hk = q.shape[3], q.shape[2], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA flash kernel takes a bf16 q (K/V bf16 or float8_e4m3fn), got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel is built for head dims {HEAD_DIMS}, got {d}")
    if hq // hk > block_rows(d):
        raise ValueError(f"the CUDA flash kernel takes at most {block_rows(d)} query heads per kv head at D={d}, "
                         f"got {hq // hk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 16 bytes")


def flash_attention(q, k, v, q_positions, kv_valid, kv_positions, sliding_window=None, scale=None,
                    logit_softcap=None, *, block_q=None, block_k=None):
    """Causal GQA flash attention, the contract of the dense path: q (B, Lq,
    Hq, D), k/v (B, Lk, Hk, D) read in place through their strides,
    q_positions (B, Lq) int32, kv_valid (B, Lk) bool, kv_positions (B, Lk)
    int32 -> (B, Lq, Hq, D) in q's dtype.  Query head h reads kv head
    h // (Hq / Hk).  ``block_q``/``block_k`` default to the kernel's tiles;
    the kernel takes no others.  On the card the key tiles are split as
    :func:`kernel_split` says for its SM count; on the CPU they are not."""
    return _flash_attention(q, k, v, q_positions, kv_valid, kv_positions, sliding_window, scale, logit_softcap,
                            block_q=block_q, block_k=block_k, split=None)


def _flash_attention(q, k, v, q_positions, kv_valid, kv_positions, sliding_window=None, scale=None,
                     logit_softcap=None, *, block_q=None, block_k=None, split):
    """:func:`flash_attention` with its key split forced (``split`` ranges,
    see :func:`flash_attention_plain`), or chosen as there when None: the
    route the tests and ``benchmarks_torch/hopper_bench.py`` drive."""
    _check_operands(q, k, v, q_positions, kv_valid, kv_positions)
    b, lq, hq, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    kbq, kbk = kernel_blocks(hq, hk, d)
    block_q = kbq if block_q is None else block_q
    block_k = kbk if block_k is None else block_k
    kernel_tiles = (block_q, block_k) == (kbq, kbk)
    if split is None:
        split = kernel_split(b, lq, lk, hq, hk, _sm_count(q.device), d) if q.is_cuda and kernel_tiles else 1
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, q_positions, kv_valid, kv_positions, sliding_window, scale,
                                     logit_softcap, block_q=block_q, block_k=block_k, split=split)
    _check_cuda_operands(q, k, v)
    if not kernel_tiles:
        raise ValueError(f"the CUDA flash kernel's tiles are block_q={kbq}, block_k={kbk}; got {block_q}, {block_k}")
    if not 1 <= split <= -(-lk // kbk):
        raise ValueError(f"split must be in [1, {-(-lk // kbk)}] (the key tiles), got {split}")
    scale = float(d) ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if split > 1:  # the splits' (acc, m, l), merged by the kernel's second pass
        part_acc = torch.empty((split, b, lq, hq, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((split, 2, b, lq, hq), dtype=torch.float32, device=q.device)
    qpos, kpos, kval = q_positions.contiguous(), kv_positions.contiguous(), kv_valid.contiguous()
    fn = _build.kernel("flash_attention.cu")
    fp8 = _fp8_kv(q, k, v)
    LAUNCHES["flash_attention_fp8" if fp8 else "flash_attention"] += 1
    _check_status("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), qpos.data_ptr(), kpos.data_ptr(), kval.data_ptr(),
        b, lq, lk, hq, hk, d, kbq, split, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale,
        0.0 if logit_softcap is None else float(logit_softcap), int(logit_softcap is not None),
        0 if sliding_window is None else int(sliding_window), int(sliding_window is not None), int(fp8), _stream(q)))
    return out


# --- K10: decode attention (Lq = 1) -------------------------------------------------------------

DECODE_TILE = 64  # key rows per stage of the CUDA kernel
RANGE_ROWS = (256, 512, 1024)  # the key-range lengths the wrapper picks among (decode_range_rows)
MAX_GROUP = 8  # query heads per kv head the kernel takes
# blocks per SM the grid should hold: two waves of the three blocks an SM keeps resident at D = 128 (swept on
# an H100 from 1 to 64 slots of 1024-8192 rows, full and with chat-drawn lengths: PERF.md)
DECODE_BLOCKS_PER_SM = 6
DECODE_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)  # the K/V dtypes K10 reads as stored
KEY_NONE = 2**31 - 1  # the key position of a row that holds nothing: no query sees it


class DecodeKeys(NamedTuple):
    """What K10 needs of one cache's key positions, built once per forward
    (:func:`decode_keys`) and shared by every layer over that cache."""

    q_positions: torch.Tensor  # (B,) int32
    key_positions: torch.Tensor  # (B, rows rounded up to DECODE_TILE) int32: KEY_NONE where invalid or padding
    live: torch.Tensor  # (B,) int32 in [1, rows]: 1 + the last valid row; rows at or past it are never read


def decode_keys(q_positions, kv_valid, kv_positions) -> DecodeKeys:
    """:class:`DecodeKeys` of a one-row query at ``q_positions`` (B, 1) over
    a cache whose rows hold ``kv_positions`` where ``kv_valid`` (each (B,
    rows)).  ``live`` is at least 1, so every slot reads its row 0; an idle
    slot of the engine (length 0 -> 1) reads that row alone."""
    if q_positions.ndim != 2 or q_positions.shape[1] != 1 or q_positions.dtype != torch.int32:
        raise ValueError(f"q_positions must be int32 (B, 1), got {q_positions.dtype} {tuple(q_positions.shape)}")
    b, rows = kv_positions.shape
    if tuple(kv_valid.shape) != (b, rows) or kv_valid.dtype != torch.bool or kv_positions.dtype != torch.int32 or \
            q_positions.shape[0] != b:
        raise ValueError(f"kv_valid bool and kv_positions int32 (B, rows) expected beside q_positions (B, 1), got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}, {kv_positions.dtype} {tuple(kv_positions.shape)}")
    pad = -(-rows // DECODE_TILE) * DECODE_TILE - rows
    key = F.pad(torch.where(kv_valid, kv_positions, KEY_NONE), (0, pad), value=KEY_NONE)
    row1 = torch.arange(1, rows + 1, dtype=torch.int32, device=kv_valid.device)
    live = torch.where(kv_valid, row1, 1).amax(dim=1)
    return DecodeKeys(q_positions[:, 0].contiguous(), key, live)


def decode_fits(head_dim: int, group: int, kv_dtype: torch.dtype) -> bool:
    """Whether K10 takes a one-row query at this head dim, group size (query
    heads per kv head) and K/V dtype (bf16 or ``float8_e4m3fn``; the model's
    queries are bf16): the route's choice, by shape and dtype."""
    return head_dim in HEAD_DIMS and 1 <= group <= MAX_GROUP and kv_dtype in DECODE_KV_DTYPES


def decode_range_rows(b: int, rows: int, hk: int, sms: int) -> int:
    """Key rows per range of the kernel's grid for B slots of ``rows`` rows
    over Hk kv heads on a card with ``sms`` SMs: the longest of
    ``RANGE_ROWS`` whose grid (B * Hk * ranges) holds ``DECODE_BLOCKS_PER_SM``
    blocks per SM, else the shortest.  The grid is fixed by the shape, but
    a block past its slot's live rows exits at once, so the grid must hold
    enough blocks for the live ones to spread over the card whatever the
    lengths (``benchmarks_torch/hopper_bench.py`` times every range length)."""
    for r in sorted(RANGE_ROWS, reverse=True):
        if b * hk * -(-rows // r) >= DECODE_BLOCKS_PER_SM * sms:
            return r
    return min(RANGE_ROWS)


def _check_decode_operands(q, k, v, keys: DecodeKeys) -> None:
    """What both routes need: a one-row q (B, 1, Hq, D), k and v (B, rows,
    Hk, D) alike, GQA head counts, a float q and float or e4m3 K/V, keys of
    this batch and cache, one device."""
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q (B, 1, Hq, D) and k, v (B, rows, Hk, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    _, rows, hk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if hq % hk:
        raise ValueError(f"Hq={hq} must be a multiple of Hk={hk}")
    if not q.dtype.is_floating_point or k.dtype != v.dtype or not (k.dtype.is_floating_point or
                                                                   k.dtype == torch.float8_e4m3fn):
        raise ValueError(f"q must be a float and k, v one float or float8_e4m3fn dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    rows_pad = -(-rows // DECODE_TILE) * DECODE_TILE
    for name, t, shape in (("q_positions", keys.q_positions, (b,)), ("key_positions", keys.key_positions,
                                                                     (b, rows_pad)), ("live", keys.live, (b,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"keys.{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v), ("q_positions", keys.q_positions), ("key_positions", keys.key_positions),
                    ("live", keys.live)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def decode_attention_plain(q, k, v, keys: DecodeKeys, sliding_window=None, scale=None, logit_softcap=None, *,
                           range_rows=None):
    """K10's function in torch ops, the dense route's for Lq = 1: s = (q .
    k) in f32 from the inputs' values, times ``scale``, softcapped, -1e30
    where the key is not visible; rows at or past ``keys.live`` are never read
    (zero, and out of every sum).  With ``range_rows`` None this is the dense
    route's own sequence of ops (softmax, then P V in f32).  Else the rows are
    cut into ranges of ``range_rows``, as the kernel cuts them: range z takes
    a softmax of its own (max m_z, sum l_z) and its P V, acc_z; the ranges
    that hold live rows merge in order with weights l_z e^(m_z - M) / sum of
    them (M = max m_z).  Cast to q's dtype."""
    _check_decode_operands(q, k, v, keys)
    b, _, hq, d = q.shape
    rows, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = float(d) ** -0.5 if scale is None else scale
    walked = torch.arange(rows, device=q.device)[None, :] < keys.live[:, None]  # (B, rows)
    kpos, qpos = keys.key_positions[:, :rows], keys.q_positions[:, None]
    seen = walked & (kpos <= qpos)
    if sliding_window is not None:
        seen = seen & (kpos > qpos - sliding_window)
    kf = torch.where(walked[:, :, None, None], k.float(), 0.0)
    vf = torch.where(walked[:, :, None, None], v.float(), 0.0)
    s = torch.einsum("blhgd,bshd->bhgls", q.reshape(b, 1, hk, g, d).float(), kf) * scale  # (B, Hk, G, 1, rows)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(seen[:, None, None, None, :], s, _NEG)
    if range_rows is None:
        out = torch.einsum("bhgls,bshd->blhgd", torch.softmax(s, dim=-1), vf)
        return out.reshape(b, 1, hq, d).to(q.dtype)
    if range_rows < 1:
        raise ValueError(f"range_rows must be positive, got {range_rows}")
    n = -(-rows // range_rows)
    zone = torch.arange(rows, device=q.device)[None, :] // range_rows == torch.arange(n, device=q.device)[:, None]
    sz = torch.where(zone, s, -torch.inf)  # (B, Hk, G, n, rows): range z's rows only
    acc = torch.einsum("bhgls,bshd->blhgd", torch.softmax(sz, dim=-1), vf)  # (B, n, Hk, G, D)
    m = sz.amax(dim=-1, keepdim=True)  # (B, Hk, G, n, 1)
    l = torch.where(zone & walked[:, None, None, None, :], torch.exp(s - m), 0.0).sum(dim=-1)  # 0 past live
    e = torch.exp(m[..., 0] - torch.where(l > 0, m[..., 0], -torch.inf).amax(dim=-1, keepdim=True))
    w = l * e / (l * e).sum(dim=-1, keepdim=True)  # (B, Hk, G, n): range 0 always holds a live row
    out = (acc * w.permute(0, 3, 1, 2)[..., None]).sum(dim=1)  # (B, Hk, G, D)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _check_cuda_decode_operands(q, k, v, keys: DecodeKeys) -> None:
    """What the CUDA kernel assumes on top of :func:`_check_decode_operands`:
    bf16 q with bf16 or e4m3 K/V, a head dim and group size it is built for
    (:func:`decode_fits`), 16-byte aligned rows and strides, contiguous keys."""
    d, hq, hk = q.shape[3], q.shape[2], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype not in DECODE_KV_DTYPES:
        raise ValueError(f"the CUDA decode kernel takes a bf16 q and bf16 or float8_e4m3fn K/V, got {q.dtype}, "
                         f"{k.dtype}")
    if not decode_fits(d, hq // hk, k.dtype):
        raise ValueError(f"the CUDA decode kernel is built for head dims {HEAD_DIMS} and at most {MAX_GROUP} query "
                         f"heads per kv head, got D={d}, {hq // hk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be contiguous in its head dim, 16-byte aligned, with strides that are "
                             f"multiples of 16 bytes")
    for name, t in keys._asdict().items():
        if not t.is_contiguous():
            raise ValueError(f"keys.{name} must be contiguous")


def decode_attention(q, k, v, keys: DecodeKeys, sliding_window=None, scale=None, logit_softcap=None):
    """Attention of one query row per slot, q (B, 1, Hq, D), over its cache k
    and v (B, rows, Hk, D), read in place through their strides, with the
    mask of :func:`decode_keys` -> (B, 1, Hq, D) in q's dtype.  Query head h
    reads kv head h // (Hq / Hk).  On the card: K10, its key ranges as
    :func:`decode_range_rows` says for the card's SM count; on the CPU:
    :func:`decode_attention_plain` in one range."""
    return _decode_attention(q, k, v, keys, sliding_window, scale, logit_softcap, range_rows=None)


def _decode_attention(q, k, v, keys: DecodeKeys, sliding_window=None, scale=None, logit_softcap=None, *,
                      range_rows):
    """:func:`decode_attention` with its range length forced, or chosen as
    there when None: the route the tests and ``benchmarks_torch/hopper_bench.py``
    drive."""
    _check_decode_operands(q, k, v, keys)
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, keys, sliding_window, scale, logit_softcap, range_rows=range_rows)
    _check_cuda_decode_operands(q, k, v, keys)
    b, _, hq, d = q.shape
    rows, hk = k.shape[1], k.shape[2]
    if range_rows is None:
        range_rows = decode_range_rows(b, rows, hk, _sm_count(q.device))
    if range_rows < 1 or range_rows % DECODE_TILE:
        raise ValueError(f"range_rows must be a positive multiple of {DECODE_TILE}, got {range_rows}")
    n = -(-rows // range_rows)
    out = torch.empty((b, 1, hq, d), dtype=torch.bfloat16, device=q.device)
    part_acc = part_ml = None
    if n > 1:  # the ranges' (acc, m, l), merged by the second launch
        part_acc = torch.empty((b, hk, n, hq // hk, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hk, n, hq // hk, 2), dtype=torch.float32, device=q.device)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    fn = _build.kernel("decode_attention.cu")
    LAUNCHES["decode_attention"] += 1
    _check_status("decode_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), keys.q_positions.data_ptr(), keys.key_positions.data_ptr(),
        keys.live.data_ptr(), b, rows, keys.key_positions.shape[1], hq, hk, d, range_rows, n, q.stride(0),
        q.stride(2), *k.stride()[:3], *v.stride()[:3], scale, 0.0 if logit_softcap is None else float(logit_softcap),
        int(logit_softcap is not None), 0 if sliding_window is None else int(sliding_window),
        int(sliding_window is not None), int(k.dtype == torch.float8_e4m3fn), _stream(q)))
    return out
