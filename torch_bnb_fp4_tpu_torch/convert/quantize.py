"""Checkpoint-scale split-K quantize + pack and the K-shard repack, in torch.

Counterpart of ``torch_bnb_fp4_tpu/convert/quantize.py`` (split-K part):
``quantize_pack_sharded`` gives the bytes of the numpy golden
``ops/format.pack_tpu_sharded`` bit for bit, with torch CPU ops;
``repack_k_shards`` moves a split-K packing to another number of K shards
exactly (the codes and the absmax grid do not change, only which nibbles
share a byte), so one stored checkpoint serves any row-parallel width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import format as fmt


def _nearest_codes(normed: torch.Tensor, code: np.ndarray) -> torch.Tensor:
    """The golden's 15-midpoint nearest-entry search: ``bucketize`` with
    right=False counts the midpoints strictly below x, the golden's (x > m)
    sum, so a tie picks the smaller value as there."""
    order = np.argsort(code, kind="stable").astype(np.uint8)
    sorted_code = code[order]
    mids = torch.from_numpy((sorted_code[1:] + sorted_code[:-1]) / 2)
    return torch.from_numpy(order)[torch.bucketize(normed, mids, right=False)]


def quantize_pack_sharded(w: np.ndarray, blocksize: int = 64, code: np.ndarray = fmt.FP4_CODE, k_shards: int = 1):
    """Bit-identical, fast equivalent of ``format.pack_tpu_sharded``: ``w``
    (n_out, k_in) float -> (packed uint8 (K/2, N), absmax_hi f32, absmax_lo
    f32) as numpy arrays."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    n_out, k_in = w.shape
    if k_in % (k_shards * 2 * blocksize) != 0:
        raise ValueError(f"K={k_in} not divisible by k_shards*2*blocksize={k_shards * 2 * blocksize}")
    blocks = torch.from_numpy(w).view(n_out, k_in // blocksize, blocksize)
    absmax = blocks.abs().amax(dim=2)  # (N, K/bs)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    codes = _nearest_codes((blocks / safe.unsqueeze(2)).reshape(n_out, k_in), np.asarray(code, np.float32))
    packed, hi, lo = _pair_shards(codes.T.contiguous(), absmax.T.contiguous(), blocksize, k_shards)
    return packed.numpy(), hi.numpy(), lo.numpy()


def _pair_shards(codes_t: torch.Tensor, absmax_t: torch.Tensor, blocksize: int, k_shards: int):
    """Codes (K, N) and absmax (K/bs, N) in Wt row order -> the split-K
    packing of ``k_shards`` slices: shard d pairs its first half of rows (high
    nibble) with its second half (low nibble)."""
    k, n = codes_t.shape
    c = codes_t.reshape(k_shards, 2, k // (2 * k_shards), n)
    packed = ((c[:, 0] << 4) | c[:, 1]).reshape(k // 2, n).to(torch.uint8)
    a = absmax_t.reshape(k_shards, 2, k // (2 * k_shards * blocksize), n)
    rows = k // (2 * blocksize)
    return packed, a[:, 0].reshape(rows, n).contiguous(), a[:, 1].reshape(rows, n).contiguous()


def repack_k_shards(packed, absmax_hi, absmax_lo, blocksize: int, old_shards: int, new_shards: int):
    """Re-pair the nibbles of a split-K packing for another number of K
    shards (the JAX package's ``repack_k_shards``), exactly.  Takes and
    returns torch tensors (on any device) or numpy arrays; a stack of
    experts (a leading axis on all three) is repacked expert by expert."""
    if old_shards == new_shards:
        return packed, absmax_hi, absmax_lo
    if packed.ndim == 3:
        per = [repack_k_shards(*t, blocksize, old_shards, new_shards) for t in zip(packed, absmax_hi, absmax_lo)]
        stack = np.stack if isinstance(packed, np.ndarray) else torch.stack
        return tuple(stack(list(parts)) for parts in zip(*per))
    as_np = isinstance(packed, np.ndarray)
    if as_np:
        packed, absmax_hi, absmax_lo = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                                        (packed, absmax_hi, absmax_lo))
    kp, n = packed.shape
    k = 2 * kp
    if k % (new_shards * 2 * blocksize) or k % (old_shards * 2 * blocksize):
        raise ValueError(f"K={k} not divisible for k_shards={new_shards}")
    # back to Wt row order: shard d holds rows [d*K/D, (d+1)*K/D), hi half first
    p = packed.reshape(old_shards, kp // old_shards, n)
    codes_t = torch.stack([p >> 4, p & 0xF], dim=1).reshape(k, n)
    s = kp // (blocksize * old_shards)
    absmax_t = torch.stack([absmax_hi.reshape(old_shards, s, n), absmax_lo.reshape(old_shards, s, n)],
                           dim=1).reshape(k // blocksize, n)
    out = _pair_shards(codes_t, absmax_t, blocksize, new_shards)
    return tuple(t.numpy() for t in out) if as_np else out
