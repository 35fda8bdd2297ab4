"""K7: causal GQA flash attention (online softmax) over per-slot key positions.

Counterpart of ``torch_bnb_fp4_tpu/ops/attention.py``.  The mask comes from
ARBITRARY per-slot key positions (``kv_positions``), validity (``kv_valid``),
an optional sliding window and an optional Gemma-2 logit softcap, so rolling
ring caches, whose slot order is not position order after a wrap, work as
they are.

``flash_attention`` keeps the JAX signature and the (B, L, H, D) layout.  A
CUDA tensor goes to the hand-written kernel (``csrc/flash_attention.cu``,
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
"""

from __future__ import annotations

import torch

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


def _check_operands(q, k, v, q_positions, kv_valid, kv_positions) -> None:
    """What both routes need: GQA head counts, matching shapes and dtypes, one
    device, and a contiguous last (head) dimension."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q (B, Lq, Hq, D) and k, v (B, Lk, Hk, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, hq, d = q.shape
    _, lk, hk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if hq % hk:
        raise ValueError(f"Hq={hq} must be a multiple of Hk={hk}")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise ValueError(f"q, k, v must share one float dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
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
    is the JAX recurrence itself."""
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
    """What the CUDA kernel assumes on top of :func:`_check_operands`: bf16,
    a head dim it is built for, at most ``block_rows(D)`` query heads per kv
    head, and 16-byte aligned rows (it loads 16 bytes per thread)."""
    d, hq, hk = q.shape[3], q.shape[2], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA flash kernel takes bf16 q/k/v, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel is built for head dims {HEAD_DIMS}, got {d}")
    if hq // hk > block_rows(d):
        raise ValueError(f"the CUDA flash kernel takes at most {block_rows(d)} query heads per kv head at D={d}, "
                         f"got {hq // hk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of 8 elements")


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
    LAUNCHES["flash_attention"] += 1
    _check_status("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), qpos.data_ptr(), kpos.data_ptr(), kval.data_ptr(),
        b, lq, lk, hq, hk, d, kbq, split, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale,
        0.0 if logit_softcap is None else float(logit_softcap), int(logit_softcap is not None),
        0 if sliding_window is None else int(sliding_window), int(sliding_window is not None), _stream(q)))
    return out
