"""The port's flash attention (K7's plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and against the port's dense path.

Inputs are made with numpy from a seed and handed to both packages.  The six
masking cases are those of tests/test_attention.py (causal, long partial
cache, window + softcap + scale, ring layout, unaligned lengths, rows that see
no key), run with the same block_q/block_k on both sides.

Tolerances: vs the JAX kernel |d| <= 2^-7 * max|o| + 1e-3 (the same recurrence
and key partition; the dots' summation order and exp differ, which can flip
the bf16 rounding of p or of the output by one ulp); vs the dense path atol
2e-2, the JAX package's own (the probability tile is rounded to bf16 for the
PV dot, tests/test_attention.py:32-34).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.ops.attention import flash_attention as jax_flash
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import attention as A
from torch_bnb_fp4_tpu_torch.ops import kernels as K
from torch_bnb_fp4_tpu_torch.utils import profiling as P


def _linear_pos(b, n, start=0):
    return np.broadcast_to(start + np.arange(n, dtype=np.int32), (b, n)).copy()


def _ring_pos(total, rows):
    last, s = total - 1, np.arange(rows, dtype=np.int32)
    return (last - np.mod(last - s, rows))[None, :].astype(np.int32)


def _case(name, d=128, hq=None, hk=None):
    """(arrays, options) of one masking case; arrays are numpy."""
    seeds = dict(causal=0, long_cache=1, window_softcap=2, ring=3, unaligned=4, no_visible=5)
    rng = np.random.default_rng(seeds[name])
    opt = dict(window=None, scale=None, softcap=None, block_q=8, block_k=128)
    if name == "causal":
        b, lq, lk, dq, dk = 2, 16, 16, 4, 2
        qpos, kpos, valid = _linear_pos(b, lq), _linear_pos(b, lk), np.ones((b, lk), bool)
    elif name == "long_cache":
        b, lq, lk, dq, dk = 1, 8, 384, 8, 4
        qpos, kpos, valid = _linear_pos(b, lq, 292), _linear_pos(b, lk), (np.arange(lk) < 300)[None, :]
    elif name == "window_softcap":
        b, lq, lk, dq, dk = 1, 24, 128, 2, 2
        qpos, kpos, valid = _linear_pos(b, lq, lk - lq), _linear_pos(b, lk), np.ones((b, lk), bool)
        opt.update(window=40, softcap=30.0, scale=1.0 / 12.0)
    elif name == "ring":
        b, lq, lk, dq, dk = 1, 8, 256, 4, 4
        kpos = _ring_pos(391, lk)
        qpos, valid = _linear_pos(b, lq, 391 - lq), kpos >= 0
        opt.update(window=128)
    elif name == "unaligned":
        b, lq, lk, dq, dk = 1, 13, 200, 2, 1
        qpos, kpos, valid = _linear_pos(b, lq, 167), _linear_pos(b, lk), (np.arange(lk) < 180)[None, :]
    else:  # no_visible: every query sits before every key
        b, lq, lk, dq, dk = 1, 8, 128, 1, 1
        qpos, kpos, valid = np.full((b, lq), -5, np.int32), _linear_pos(b, lk), np.ones((b, lk), bool)
    hq, hk = hq or dq, hk or dk
    arr = dict(q=rng.standard_normal((b, lq, hq, d)).astype(np.float32),
               k=rng.standard_normal((b, lk, hk, d)).astype(np.float32),
               v=rng.standard_normal((b, lk, hk, d)).astype(np.float32),
               qpos=qpos.astype(np.int32), valid=np.ascontiguousarray(valid), kpos=kpos.astype(np.int32))
    return arr, opt


def _torch_args(a):
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    return (bf(a["q"]), bf(a["k"]), bf(a["v"]), torch.from_numpy(a["qpos"]), torch.from_numpy(a["valid"]),
            torch.from_numpy(a["kpos"]))


def _port(a, o):
    return A.flash_attention(*_torch_args(a), o["window"], o["scale"], o["softcap"], block_q=o["block_q"],
                             block_k=o["block_k"]).float().numpy()


def _jax(a, o):
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    got = jax_flash(bf(a["q"]), bf(a["k"]), bf(a["v"]), jnp.asarray(a["qpos"]), jnp.asarray(a["valid"]),
                    jnp.asarray(a["kpos"]), o["window"], o["scale"], o["softcap"], block_q=o["block_q"],
                    block_k=o["block_k"], interpret=True)
    return np.asarray(got, np.float32)


def _dense(a, o):
    q, k, v, qpos, valid, kpos = _torch_args(a)
    blocked = ~T.attention_mask(qpos, kpos, valid, o["window"])
    return T._attention_dense(q, k, v, blocked, o["scale"], o["softcap"]).float().numpy()


def _close_to_jax(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want).max() + 1e-3)


CASES = ["causal", "long_cache", "window_softcap", "ring", "unaligned", "no_visible"]


@pytest.mark.parametrize("name", CASES)
def test_flash_plain_matches_jax_kernel(name):
    a, o = _case(name)
    got = _port(a, o)
    _close_to_jax(got, _jax(a, o))
    if name == "no_visible":  # finite, and zero: l = 0 and acc = 0
        assert not got.any()


@pytest.mark.parametrize("name", CASES)
def test_flash_plain_matches_dense(name):
    a, o = _case(name)
    if name == "no_visible":
        # the dense softmax over an all -1e30 row is uniform, not zero; both are finite
        assert np.isfinite(_dense(a, o)).all() and not _port(a, o).any()
        return
    np.testing.assert_allclose(_port(a, o), _dense(a, o), atol=2e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_head_dims(d):
    a, o = _case("ring", d=d, hq=4, hk=2)
    got = _port(a, o)
    _close_to_jax(got, _jax(a, o))
    np.testing.assert_allclose(got, _dense(a, o), atol=2e-2)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_gqa_groups(group):
    """Query head h reads kv head h // group on every route."""
    a, o = _case("window_softcap", hq=2 * group, hk=2)
    got = _port(a, o)
    _close_to_jax(got, _jax(a, o))
    np.testing.assert_allclose(got, _dense(a, o), atol=2e-2)


def test_flash_kernel_blocks_are_the_default():
    """Without block sizes the CPU route uses the CUDA kernel's tiles, so a
    card-vs-CPU comparison sees one key partition."""
    a, o = _case("long_cache")
    assert A.kernel_blocks(8, 4) == (64, 64) and A.kernel_blocks(32, 8) == (32, 64)
    assert A.kernel_blocks(16, 16) == (128, 64) and A.kernel_blocks(28, 4) == (18, 64)
    assert A.kernel_blocks(16, 8, 256) == (32, 64) and A.kernel_blocks(32, 4, 64) == (16, 64)
    got = A.flash_attention(*_torch_args(a)).float().numpy()
    want = A.flash_attention_plain(*_torch_args(a), block_q=64, block_k=64).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_flash_cpu_route_launches_nothing():
    a, o = _case("causal")
    K.reset_launch_counts()
    _port(a, o)
    assert K.launch_counts()["flash_attention"] == 0


def test_flash_operand_checks():
    q, k, v, qpos, valid, kpos = _torch_args(_case("causal")[0])
    with pytest.raises(ValueError, match="multiple of Hk"):
        A.flash_attention(q[:, :, :3], k, v, qpos, valid, kpos)
    with pytest.raises(ValueError, match="share one float dtype"):
        A.flash_attention(q, k.float(), v, qpos, valid, kpos)
    with pytest.raises(ValueError, match="kv_valid"):
        A.flash_attention(q, k, v, qpos, valid.int(), kpos)
    with pytest.raises(ValueError, match="q_positions"):
        A.flash_attention(q, k, v, qpos.long(), valid, kpos)
    with pytest.raises(ValueError, match="last"):
        A.flash_attention(q.repeat_interleave(2, dim=-1)[..., ::2], k, v, qpos, valid, kpos)
    with pytest.raises(ValueError, match="batch or head dim"):
        A.flash_attention(q[..., :64], k, v, qpos, valid, kpos)


def test_attention_bound_counts_visible_pairs():
    """ops = 4 * D * Hq per visible (query, key) pair, counted from the mask;
    bytes = q, o, k, v once each."""
    a, o = _case("ring")
    q, k, v, qpos, valid, kpos = _torch_args(a)
    mask = T.attention_mask(qpos, kpos, valid, o["window"])
    pairs = P.visible_pairs(qpos, valid, kpos, o["window"])
    assert pairs == int(mask.sum()) and 0 < pairs < qpos.numel() * kpos.shape[1]
    t, by = P.attention_bound_s(q, k, pairs)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    assert by == "bytes" and t == pytest.approx(max(nbytes / P.H100_HBM_BYTES_PER_S,
                                                    4 * 128 * 4 * pairs / P.H100_BF16_FLOPS))
