"""The port's apply_linear vs the JAX package's, on the same weights.

Both sides quantize the same numpy weight (identical bytes, checked), then
run the same inputs.  M covers every route: 1 (batch-1 / K2), 16 (K2), 160
(K3), 256 (K4, the w4a8 path; a8 against a8, ROADMAP fault R3).  K and N are
deliberately unaligned (k_in 1000 -> 1024, n_out 200 -> 256) so the padding
of x, bias and output is exercised.  Tolerances as in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu_torch.models import linear as L


def _w(n, k, seed):
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.02).astype(np.float32)


def _pair(w, bias=None, **kw):
    jq = JL.quantize_linear(w, bias, **kw)
    tq = L.quantize_linear(w, bias, device="cpu", **kw)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scale.float().numpy(), np.asarray(jq.absmax_hi, np.float32))
    return jq, tq


def _ulp_bf16(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _compare(jq, tq, m, k, seed=0, dtype="bfloat16"):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(JL.apply_linear(jq, jnp.asarray(x, jdt), interpret=True), np.float32)
    got = L.apply_linear(tq, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want).max())
    elif m >= 256:  # w4a8 on both sides: exact int dots, one bf16 ulp
        np.testing.assert_array_less(np.abs(got - want), _ulp_bf16(want) * 1.0001 + 1e-30)
    else:
        np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 16, 160, 256])
@pytest.mark.parametrize("variant", ["exact", "ramp"])
def test_apply_linear_padded_with_bias(variant, m):
    w = _w(200, 1000, seed=m)
    bias = np.random.default_rng(99).standard_normal(200).astype(np.float32)
    jq, tq = _pair(w, bias, variant=variant)
    assert (tq.k_pad, tq.n_pad) == (1024, 256)
    _compare(jq, tq, m, 1000, seed=m + 1)


@pytest.mark.parametrize("m", [1, 16])
def test_apply_linear_f32_input(m):
    jq, tq = _pair(_w(256, 1024, seed=5), variant="zramp")
    _compare(jq, tq, m, 1024, seed=7, dtype="float32")


@pytest.mark.parametrize("m", [1, 160])
def test_apply_linear_nf4_lut(m):
    jq, tq = _pair(_w(256, 1024, seed=8), quant_type="nf4")
    assert tq.variant == "lut"
    _compare(jq, tq, m, 1024, seed=9)


def test_apply_linear_bf16_scales():
    w = _w(256, 2048, seed=10)
    jq = JL.quantize_linear(w, variant="ramp", scale_dtype=jnp.bfloat16)
    tq = L.quantize_linear(w, variant="ramp", scale_dtype=torch.bfloat16, device="cpu")
    assert tq.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.scale.float().numpy(), np.asarray(jq.absmax_hi, np.float32))
    _compare(jq, tq, 8, 2048, seed=11)


@pytest.mark.parametrize("m", [1, 16, 160])
def test_fused_linears_match(m):
    ws = [_w(512, 1024, seed=20), _w(128, 1024, seed=21), _w(128, 1024, seed=22)]
    biases = [np.random.default_rng(23).standard_normal(512).astype(np.float32), None, None]
    pairs = [_pair(w, b) for w, b in zip(ws, biases)]
    jf = JL.fuse_linears([p[0] for p in pairs])
    tf = L.fuse_linears([p[1] for p in pairs])
    assert tf.n_out == jf.n_out == 768
    np.testing.assert_array_equal(tf.bias.numpy(), np.asarray(jf.bias))
    _compare(jf, tf, m, 1024, seed=24)


def test_fuse_rejects_mixed_variants():
    a = L.quantize_linear(_w(128, 512, 1), variant="ramp", device="cpu")
    b = L.quantize_linear(_w(128, 512, 2), variant="exact", device="cpu")
    with pytest.raises(ValueError):
        L.fuse_linears([a, b])


def test_zero_rows_and_bad_width():
    tq = L.quantize_linear(_w(128, 512, 3), device="cpu")
    out = L.apply_linear(tq, torch.zeros((0, 4, 512), dtype=torch.bfloat16))
    assert tuple(out.shape) == (0, 4, 128) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        L.apply_linear(tq, torch.zeros((2, 256), dtype=torch.bfloat16))


def test_other_layouts_not_yet_ported():
    """An unknown layout and pair-K with k_shards raise ValueError in both
    packages (split-K itself is tests/test_torch_splitk.py's)."""
    w = _w(128, 512, 4)
    for kw in (dict(layout="rowmajor"), dict(layout="pairk", k_shards=2)):
        with pytest.raises(ValueError):
            JL.quantize_linear(w, **kw)
        with pytest.raises(ValueError):
            L.quantize_linear(w, device="cpu", **kw)


def test_dense_linear_matches_jax():
    w = _w(384, 1024, seed=30)
    x = np.random.default_rng(31).standard_normal((3, 5, 1024)).astype(np.float32)
    jd = JL.dense_linear(w)
    td = L.dense_linear(w, device="cpu")
    want = np.asarray(jd(jnp.asarray(x, jnp.bfloat16), out_dtype=jnp.float32))
    got = td(torch.from_numpy(x).to(torch.bfloat16), out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
