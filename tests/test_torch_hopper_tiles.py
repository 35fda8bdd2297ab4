"""The partitions of the warpgroup-MMA kernels, held on the CPU.

K7 (csrc/flash_attention.cu) may split the key tiles into contiguous ranges
whose partial (m, l, acc) a second pass merges in range order; its plain
version takes the same split.  Here: the split plain version against the JAX
package's Pallas kernel in interpret mode at the six masking cases of
tests/test_torch_attention.py (small widths; the same tolerance, |d| <=
2^-7 * max|o| + 1e-3: p is rounded to bf16 against each range's own running
max), against the unsplit plain version (2^-7 of each row's max), rows that
see no key (exactly 0 under every split) and the split the wrapper picks.

K4 (csrc/matmul_pk_w4a8.cu) decodes its weights through per-column tables of
the 16 int8 values of each quant block; the table decode in torch ops must
equal the requantized weights of the plain version byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.ops.attention import flash_attention as jax_flash
from torch_bnb_fp4_tpu_torch.ops import attention as A
from torch_bnb_fp4_tpu_torch.ops import kernels as K


def _pos(b, n, start=0):
    return np.broadcast_to(start + np.arange(n, dtype=np.int32), (b, n)).copy()


def _case(name, d=64):
    """(arrays, options) of one masking case of tests/test_torch_attention.py at head dim ``d``."""
    seeds = dict(causal=0, long_cache=1, window_softcap=2, ring=3, unaligned=4, no_visible=5)
    rng = np.random.default_rng(seeds[name])
    opt = dict(window=None, scale=None, softcap=None)
    if name == "causal":
        b, lq, lk, hq, hk = 2, 16, 16, 4, 2
        qpos, kpos, valid = _pos(b, lq), _pos(b, lk), np.ones((b, lk), bool)
    elif name == "long_cache":
        b, lq, lk, hq, hk = 1, 8, 384, 8, 4
        qpos, kpos, valid = _pos(b, lq, 292), _pos(b, lk), (np.arange(lk) < 300)[None, :]
    elif name == "window_softcap":
        b, lq, lk, hq, hk = 1, 24, 128, 2, 2
        qpos, kpos, valid = _pos(b, lq, lk - lq), _pos(b, lk), np.ones((b, lk), bool)
        opt.update(window=40, softcap=30.0, scale=1.0 / 12.0)
    elif name == "ring":
        b, lq, lk, hq, hk = 1, 8, 256, 4, 4
        last, s = 390, np.arange(lk, dtype=np.int32)
        kpos = (last - np.mod(last - s, lk))[None, :].astype(np.int32)
        qpos, valid = _pos(b, lq, 391 - lq), kpos >= 0
        opt.update(window=128)
    elif name == "unaligned":
        b, lq, lk, hq, hk = 1, 13, 200, 2, 1
        qpos, kpos, valid = _pos(b, lq, 167), _pos(b, lk), (np.arange(lk) < 180)[None, :]
    else:  # no_visible: every query sits before every key
        b, lq, lk, hq, hk = 1, 8, 128, 1, 1
        qpos, kpos, valid = np.full((b, lq), -5, np.int32), _pos(b, lk), np.ones((b, lk), bool)
    arr = dict(q=rng.standard_normal((b, lq, hq, d)).astype(np.float32),
               k=rng.standard_normal((b, lk, hk, d)).astype(np.float32),
               v=rng.standard_normal((b, lk, hk, d)).astype(np.float32),
               qpos=qpos.astype(np.int32), valid=np.ascontiguousarray(valid), kpos=kpos.astype(np.int32))
    return arr, opt


def _torch_args(a):
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    return (bf(a["q"]), bf(a["k"]), bf(a["v"]), torch.from_numpy(a["qpos"]), torch.from_numpy(a["valid"]),
            torch.from_numpy(a["kpos"]))


def _plain(a, o, split, block_k=32):
    return A.flash_attention_plain(*_torch_args(a), o["window"], o["scale"], o["softcap"], block_q=8, block_k=block_k,
                                   split=split).float().numpy()


CASES = ["causal", "long_cache", "window_softcap", "ring", "unaligned", "no_visible"]


@pytest.mark.parametrize("name", CASES)
def test_split_plain_matches_jax_kernel(name):
    """Three key ranges (two for the 16-key case) against the unsplit JAX kernel."""
    a, o = _case(name)
    lk = a["k"].shape[1]
    block_k = 8 if lk < 128 else 32
    split = min(3, -(-lk // block_k))
    assert split >= 2
    got = _plain(a, o, split, block_k)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_flash(bf(a["q"]), bf(a["k"]), bf(a["v"]), jnp.asarray(a["qpos"]), jnp.asarray(a["valid"]),
                                jnp.asarray(a["kpos"]), o["window"], o["scale"], o["softcap"], block_q=8,
                                block_k=128, interpret=True), np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want).max() + 1e-3)


@pytest.mark.parametrize("split", [2, 4, 7])
def test_split_plain_matches_unsplit(split):
    """Each (query, head) row within 2^-7 of its own max|o| of the unsplit recurrence."""
    a, o = _case("long_cache")
    got, want = _plain(a, o, split), _plain(a, o, 1)
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2.0**-7 * row).all()


def test_rows_with_no_visible_key_are_zero_under_every_split():
    a, o = _case("ring")
    a["qpos"][:, :3] = -10  # the first three queries sit before every key
    for split in range(1, 9):
        got = _plain(a, o, split)
        assert not got[:, :3].any() and np.abs(got[:, 3:]).max() > 0
    a, o = _case("no_visible")
    for split in (1, 2, 4):
        assert not _plain(a, o, split).any()


def test_split_is_checked():
    a, o = _case("window_softcap")
    with pytest.raises(ValueError, match="split"):
        _plain(a, o, 5)  # 128 keys are 4 blocks of 32


def test_kernel_split_of_the_phase_3b_cases():
    """(a), a 256-query chunk over a 4352-row ring, fills under one wave of 132 SMs
    and is split; (b), a whole 6016-token prompt, fills 11 waves and is not."""
    assert A.kernel_blocks(32, 8, 128) == (32, 64)
    assert A.kernel_split(1, 256, 4352, 32, 8, 132, 128) == 2
    assert A.kernel_split(1, 6016, 6016, 32, 8, 132, 128) == 1
    assert A.kernel_split(1, 256, 4352, 32, 8, 4, 128) == 1  # 64 blocks are more than 4 SMs
    assert A.kernel_split(1, 32, 4352, 32, 8, 132, 128) == A.MAX_SPLIT
    assert A.kernel_split(1, 32, 300, 32, 8, 132, 128) == 1  # 5 key tiles: ranges of 4 at least


def test_cpu_route_takes_the_kernels_split():
    """On the CPU the route runs the plain version with the kernel's blocks,
    unsplit (the JAX recurrence, whatever card would run it); a split forced
    through the private route is the plain version's at that split."""
    a, o = _case("long_cache", d=128)
    args = _torch_args(a)
    args = (args[0].repeat(1, 4, 1, 1), *args[1:3], args[3].repeat(1, 4), *args[4:])  # 32 queries, one block
    b, lq, hq, d = args[0].shape
    hk = args[1].shape[2]
    blocks = dict(block_q=A.kernel_blocks(hq, hk, d)[0], block_k=A.BLOCK_K)
    got = A.flash_attention(*args).float().numpy()
    np.testing.assert_array_equal(got, A.flash_attention_plain(*args, **blocks, split=1).float().numpy())
    forced = A._flash_attention(*args, split=3).float().numpy()
    np.testing.assert_array_equal(forced, A.flash_attention_plain(*args, **blocks, split=3).float().numpy())
    assert np.abs(forced - got).max() > 0  # the split moves where p is rounded


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp"])
def test_w4a8_table_decode_equals_requantized_weights(variant, scale_dtype):
    """K4's per-column 16-entry tables give the plain version's int8 weights,
    byte for byte, with a zero-scale column (g = 0 -> 1, all weights 0)."""
    rng = np.random.default_rng(7)
    k, n = 2048, 256
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    scale = torch.from_numpy(((rng.random((k // 64, n)) + 0.5) * (0.01 / 192)).astype(np.float32)).to(scale_dtype)
    scale[:, 3] = 0
    bk = K.a8_block_k(k, scale_dtype)
    w8, _ = K.w4a8_weights_plain(packed, scale, variant=variant, a8_block_k=bk)
    table = K.w4a8_weights_table_plain(packed, scale, variant=variant, a8_block_k=bk)
    assert table.dtype == torch.int8 and torch.equal(table, w8)
    assert not table[:, 3].any()


def test_w4a8_split_plan():
    """K4 splits its K-tiles only when the 128 x 128 output tiles fill less than
    half of the SMs: wk|wv (N 1024) and wq|wo at 256 rows, never at 6016."""
    assert K.w4a8_split(256, 4096, 1024, 1024, 132) == 4
    assert K.w4a8_split(256, 4096, 4096, 1024, 132) == 2
    assert K.w4a8_split(256, 14336, 4096, 1024, 132) == 2
    assert K.w4a8_split(256, 4096, 6144, 1024, 132) == 1
    assert K.w4a8_split(6016, 4096, 1024, 1024, 132) == 1
