"""The int8 prefill shadow of the port (K6, make_int8_shadow, K5 and the
shadow route of apply_linear) vs the JAX package's, on the same seeded numpy
inputs; the JAX kernels run in interpret mode on the CPU.

Tolerances:
  * K6 and the shadow (w8, g): bit-exact (one f32 multiply and one cast; the
    requantization divides and rounds half to even as JAX does).
  * K5: the int8 activations and the int32 dots are exact on both sides, so
    only the f32 rescale order and the output rounding can differ: f32 out
    within 1e-6 of max|y|, bf16 / f16 out within one ulp of each element.
  * Model logits (shadows on both sides): |dlogit| <= 6e-2 * max|logit| and
    rel L2 <= 3e-2 (ROADMAP P2: a bf16 flip of one activation can move its
    K-tile's int8 scale by one step), greedy tokens equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu.ops import kernels as JK
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import kernels as K

from test_torch_transformer import flatten_jax_params

VARIANTS = ["exact", "zramp", "ramp", "lut"]
SCALE_DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _packing(k, n, variant, scale_dtype, seed=0):
    """(packed, scale) as numpy, the same bytes for both packages."""
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.02).astype(np.float32)
    if variant == "lut":
        packed, scale = jfmt.pack_tpu_pairk_lut(w, jfmt.NF4_CODE)
        scale = np.asarray(jnp.asarray(scale).astype(SCALE_DTYPES[scale_dtype][0]).astype(jnp.float32))
    else:
        packed, scale = jfmt.pack_tpu_pairk(w, variant=variant, scale_dtype=SCALE_DTYPES[scale_dtype][0])
        scale = np.asarray(jnp.asarray(scale).astype(jnp.float32))
    return packed, scale


def _args(packed, scale, variant, scale_dtype):
    jd, td = SCALE_DTYPES[scale_dtype]
    cb = jfmt.NF4_CODE if variant == "lut" else None
    return ((jnp.asarray(packed), jnp.asarray(scale).astype(jd), None if cb is None else jnp.asarray(cb)),
            (torch.from_numpy(packed.copy()), torch.from_numpy(scale.copy()).to(td), cb))


def _ulp(a, dtype):
    """One ulp of each element of ``a`` in bf16 or f16 (subnormals included)."""
    mant, min_exp = {"bfloat16": (7, -126), "float16": (10, -14)}[dtype]
    a = np.abs(np.asarray(a, np.float32))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (np.maximum(e, min_exp) - mant)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_dtype", list(SCALE_DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_k6_plain_bit_exact_vs_jax(variant, scale_dtype, out):
    packed, scale = _packing(1024, 256, variant, scale_dtype, seed=1)
    (jp, js, jcb), (tp, ts, cb) = _args(packed, scale, variant, scale_dtype)
    want = JK.dequantize_tpu_pk(jp, js, jcb, out_dtype=getattr(jnp, out), variant=variant, interpret=True)
    got = K.dequantize_tpu_pk(tp, ts, cb, out_dtype=getattr(torch, out), variant=variant)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (1024, 256)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("scale_dtype", list(SCALE_DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_make_int8_shadow_bit_exact_vs_jax(variant, scale_dtype):
    k, bk = (1536, 512) if variant in ("exact", "lut") else (2048, 1024)
    packed, scale = _packing(k, 384, variant, scale_dtype, seed=2)
    packed[:, :128] = 0  # all-zero columns: g = 0 -> 1
    (jp, js, jcb), (tp, ts, cb) = _args(packed, scale, variant, scale_dtype)
    jw8, jg = JK.make_int8_shadow(jp, js, jcb, variant=variant, block_k=bk, interpret=True)
    w8, g = K.make_int8_shadow(tp, ts, cb, variant=variant, block_k=bk)
    assert w8.dtype == torch.int8 and g.dtype == torch.float32 and tuple(g.shape) == (k // bk, 384)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


# (M, K, block_k, bias, x dtype, out dtype; None = x's)
K5_CASES = [(256, 2048, 1024, False, "bfloat16", None), (300, 1536, 512, True, "bfloat16", "float32"),
            (256, 1536, 512, True, "float16", None), (300, 2048, 1024, False, "float16", "float32"),
            (300, 2048, 1024, True, "bfloat16", "bfloat16"), (256, 1536, 512, False, "bfloat16", "float32")]


@pytest.mark.parametrize("m,k,bk,bias,xdt,odt", K5_CASES)
def test_k5_plain_matches_jax(m, k, bk, bias, xdt, odt):
    n = 256
    packed, scale = _packing(k, n, "ramp", "f32", seed=m + k)
    jw8, jg = JK.make_int8_shadow(jnp.asarray(packed), jnp.asarray(scale), variant="ramp", block_k=bk,
                                  interpret=True)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[3] = 0.0  # an all-zero activation row (r -> 1)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    want = JK.matmul_w8(jnp.asarray(x, getattr(jnp, xdt)), jw8, jg, None if b is None else jnp.asarray(b),
                        out_dtype=None if odt is None else getattr(jnp, odt), block_k=bk, interpret=True)
    got = K.matmul_w8(torch.from_numpy(x).to(getattr(torch, xdt)), torch.from_numpy(np.asarray(jw8)),
                      torch.from_numpy(np.asarray(jg)), None if b is None else torch.from_numpy(b), block_k=bk,
                      out_dtype=None if odt is None else getattr(torch, odt))
    out = odt or xdt
    assert got.dtype == getattr(torch, out)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if out == "float32":
        np.testing.assert_array_less(np.abs(got - want), 1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_less(np.abs(got - want), _ulp(want, out) * 1.0001)


@pytest.fixture(scope="module")
def layer_pair():
    """The JAX test layer of tests/test_w8shadow.py (512 x 2048, ramp, bias),
    shadowed in both packages."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((512, 2048)) / 45).astype(np.float32)
    b = (rng.standard_normal(512) * 0.01).astype(np.float32)
    jq = JL.quantize_linear(w, b, variant="ramp")
    q = L.quantize_linear(w, b, variant="ramp", device="cpu")
    return jq, JL.attach_int8_shadow(jq, interpret=True), q, L.attach_int8_shadow(q)


def test_attached_shadow_equals_jax(layer_pair):
    _, jqs, q, qs = layer_pair
    assert q.w8 is None and qs.w8_block_k == jqs.w8_block_k == 1024
    np.testing.assert_array_equal(qs.w8.numpy(), np.asarray(jqs.w8))
    np.testing.assert_array_equal(qs.w8_scale.numpy(), np.asarray(jqs.w8_scale))
    assert tuple(qs.w8_scale.shape) == (qs.k_pad // qs.w8_block_k, qs.n_pad)


@pytest.mark.parametrize("k_in,block_k", [(1500, 512), (2500, 512), (3000, 1024)])
def test_attached_shadow_block_k_matches_jax(k_in, block_k):
    """The shadow's tile depth follows k_pad as JAX's does: 1024 where it
    divides k_pad, else 512; the shadow bytes stay equal."""
    w = (np.random.default_rng(k_in).standard_normal((128, k_in)) / 45).astype(np.float32)
    jqs = JL.attach_int8_shadow(JL.quantize_linear(w, variant="ramp"), interpret=True)
    qs = L.attach_int8_shadow(L.quantize_linear(w, variant="ramp", device="cpu"))
    assert qs.w8_block_k == jqs.w8_block_k == block_k
    np.testing.assert_array_equal(qs.w8.numpy(), np.asarray(jqs.w8))
    np.testing.assert_array_equal(qs.w8_scale.numpy(), np.asarray(jqs.w8_scale))


@pytest.mark.parametrize("m,dtype,route", [(1, "bfloat16", "fused"), (64, "float32", "fused"),
                                           (32, "bfloat16", "fused"), (255, "bfloat16", "fused"),
                                           (256, "bfloat16", "shadow"), (300, "float16", "shadow")])
def test_shadow_dispatch_rules(layer_pair, monkeypatch, m, dtype, route):
    """JAX test_shadow_dispatch_rules in both packages: one row, f32 x and
    M < 256 take the unshadowed route (identical outputs with and without the
    shadow); M >= 256 of bf16/f16 x takes K5.  Each package's output is held
    against the other's."""
    jq, jqs, q, qs = layer_pair
    x = np.random.default_rng(m).standard_normal((m, 2048)).astype(np.float32)
    calls = []
    real = K.matmul_w8
    monkeypatch.setattr(K, "matmul_w8", lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got, got_plain = qs(xt), q(xt)
    assert calls == ([m] if route == "shadow" else [])
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jqs(jx, interpret=True).astype(jnp.float32))
    if route == "fused":
        assert torch.equal(got, got_plain)
        np.testing.assert_array_equal(want, np.asarray(jq(jx, interpret=True).astype(jnp.float32)))
        tol = (1e-5 if dtype == "float32" else 2.0**-7) * np.abs(want).max()
        np.testing.assert_array_less(np.abs(got.float().numpy() - want), tol)
    else:
        np.testing.assert_array_less(np.abs(got.float().numpy() - want), _ulp(want, dtype) * 1.0001)


def test_attach_int8_shadow_errors(layer_pair):
    _, _, q, _ = layer_pair
    stacked = dataclasses.replace(q, packed=q.packed.expand(2, *q.packed.shape),
                                  scale=q.scale.expand(2, *q.scale.shape))
    with pytest.raises(ValueError, match="stacked"):
        L.attach_int8_shadow(stacked)
    # tensor parallelism: the tile depth divides the per-shard K (JAX's rule); a K that does not shard is refused
    assert L.attach_int8_shadow(q, tp=2).w8_block_k == 1024 and L.attach_prefill_shadow([q], tp=4)[0].w8_block_k == 512
    with pytest.raises(ValueError, match="does not shard into 256-multiples over tp=16"):
        L.attach_int8_shadow(q, tp=16)
    with pytest.raises(ValueError, match="does not shard into 256-multiples over tp=3"):
        L.attach_prefill_shadow([q], tp=3)
    with pytest.raises(ValueError, match="pairk layout"):
        L.attach_int8_shadow(L.quantize_linear(np.zeros((128, 512), np.float32), layout="splitk", device="cpu"))


def test_dequantize_weight_matches_jax():
    """W (n_out, k_in) through K6 with K and N padding sliced off."""
    w = (np.random.default_rng(4).standard_normal((300, 1000)) * 0.02).astype(np.float32)
    for kw in (dict(variant="ramp"), dict(quant_type="nf4")):
        want = JL.dequantize_weight(JL.quantize_linear(w, **kw), interpret=True)
        got = L.dequantize_weight(L.quantize_linear(w, device="cpu", **kw))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (300, 1000)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_model_prefill_with_shadows_matches_jax():
    """tiny_test with a quantized lm_head, shadows attached in both packages
    (same bytes; and carried across by from_numpy): 256-token prefill logits
    and the greedy token agree."""
    cfg = JT.ModelConfig.tiny_test(n_layers=1, quantize_lm_head=True)
    jp = JT.quantize_params(cfg, JT.random_weights(cfg, seed=5))
    arrays, meta = flatten_jax_params(jp)
    tcfg = T.ModelConfig(**cfg.__dict__)
    tp = L.attach_prefill_shadow(params_from_numpy(arrays, meta, tcfg, device="cpu"))
    jps = JL.attach_prefill_shadow(jp, interpret=True)
    assert tp.layers[0].wq.w8 is not None and isinstance(tp.lm_head, L.QuantLinear) and tp.lm_head.w8 is not None
    for name in ("wq", "w_down"):
        np.testing.assert_array_equal(getattr(tp.layers[0], name).w8.numpy(),
                                      np.asarray(getattr(jps.layers[0], name).w8))
    carried = params_from_numpy(*flatten_jax_params(jps), tcfg, device="cpu")
    assert torch.equal(carried.lm_head.w8, tp.lm_head.w8) and carried.lm_head.w8_block_k == 1024
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    want, _ = JT.forward(jps, cfg, jnp.asarray(toks), JT.KVCache.zeros(cfg, 1, 256))
    calls = []
    real = K.matmul_w8
    K.matmul_w8 = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        got, _ = T.forward(tp, tcfg, torch.from_numpy(toks), T.KVCache.zeros(tcfg, 1, 256, device="cpu"))
    finally:
        K.matmul_w8 = real
    assert len(calls) == 8  # the 7 unfused layer linears and the lm_head, each at M = 256
    got, want = got[0].numpy(), np.asarray(want, np.float32)[0]
    assert np.abs(got - want).max() <= 6e-2 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)
    assert int(got[-1].argmax()) == int(want[-1].argmax())
