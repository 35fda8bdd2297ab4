"""The split-K layout (K9a/K9b): the port against the JAX package on the same
numpy inputs.

The JAX side runs its Pallas kernels in interpret mode; the port's wrappers
take their kernels' plain versions on CPU tensors.

Tolerances:
  * format, repack, bnb ingest, checkpoints: byte-identical.
  * K9a (dequantize) and ``dequantize_weight``: bit-exact, f32 and bf16 out
    (one f32 multiply and one cast on both sides).
  * K9b / ``apply_linear``: f32 x |dy| <= 1e-5 * max|y_ref| (f32 summation
    order only: both sides decode the same f32 weights); bf16 and f16 x
    |dy| <= 2^-7 * max|y_ref| (bf16 rounding of the output plus summation
    order, as tests/test_torch_kernels.py).  A K-sharded packing against the
    unsharded one: JAX's own bound (rtol 1e-4, atol 1e-5; the sharded order
    sums K in other blocks).
  * ``moe_forward`` (f32 output): |dy| <= 2^-7 * max|y_ref| (bf16 gate/up
    outputs before the down projection, as tests/test_torch_moe.py).
  * Models: greedy tokens identical.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.convert import bnb as JB
from torch_bnb_fp4_tpu.convert import checkpoint as JC
from torch_bnb_fp4_tpu.convert import quantize as JQ
from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu.ops import kernels as JK
from torch_bnb_fp4_tpu_torch.convert import bnb as B
from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
from torch_bnb_fp4_tpu_torch.convert import quantize as Q
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import format as fmt
from torch_bnb_fp4_tpu_torch.ops import kernels as K
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
from torch_bnb_fp4_tpu_torch.utils import profiling as P
from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

from test_torch_checkpoint import _assert_same
from test_torch_transformer import flatten_jax_params

CODES = {"fp4": jfmt.FP4_CODE, "nf4": jfmt.NF4_CODE}


def _w(n, k, seed, scale=0.02):
    return (np.random.default_rng(seed).standard_normal((n, k)) * scale).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), rel * np.abs(want).max() + 1e-30)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# format golden, torch packer, repack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("k_shards", [1, 2, 4])
def test_pack_tpu_sharded_bytes_equal_jax(qt, k_shards):
    w, code = _w(256, 2048, seed=k_shards), CODES[qt]
    want = jfmt.pack_tpu_sharded(w, code=code, k_shards=k_shards)
    got = fmt.pack_tpu_sharded(w, code=code, k_shards=k_shards)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fmt.unpack_tpu_sharded(*got, code=code, k_shards=k_shards),
                                  jfmt.unpack_tpu_sharded(*want, code=code, k_shards=k_shards))
    if k_shards == 1:
        p, a = fmt.pack_tpu(w, code=code)
        jp, ja = jfmt.pack_tpu(w, code=code)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(fmt.unpack_tpu(p, a, code=code), jfmt.unpack_tpu(jp, ja, code=code))


def test_flat_pack_roundtrip_matches_jax():
    w = _w(64, 192, seed=1)
    p, a = fmt.quantize_flat(w)
    jp, ja = jfmt.quantize_fp4(w)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(a, ja)
    codes = np.random.default_rng(2).integers(0, 16, 500).astype(np.uint8)
    np.testing.assert_array_equal(fmt.pack_flat(codes), jfmt.pack_flat(codes))
    np.testing.assert_array_equal(fmt.unpack_flat(fmt.pack_flat(codes)), codes)
    np.testing.assert_array_equal(fmt.unpack_flat(p), jfmt.unpack_flat(jp))
    with pytest.raises(ValueError, match="even"):
        fmt.pack_flat(codes[:7])


@pytest.mark.parametrize("qt,k_shards", [("fp4", 1), ("fp4", 4), ("nf4", 2)])
def test_quantize_pack_sharded_bit_identical_to_golden(qt, k_shards):
    w = _w(384, 2048, seed=3)
    w[5, :64] = 0.0  # an all-zero block
    want = jfmt.pack_tpu_sharded(w, code=CODES[qt], k_shards=k_shards)
    got = Q.quantize_pack_sharded(w, code=CODES[qt], k_shards=k_shards)
    jgot = JQ.quantize_pack_sharded(w, code=CODES[qt], k_shards=k_shards)
    for a, b, c in zip(got, want, jgot):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("old,new", [(1, 4), (4, 1), (2, 4)])
def test_repack_k_shards_matches_jax(old, new):
    w = _w(256, 2048, seed=old * 10 + new)
    src = jfmt.pack_tpu_sharded(w, k_shards=old)
    want = JQ.repack_k_shards(*src, 64, old, new)
    got = Q.repack_k_shards(*src, 64, old, new)
    got_t = Q.repack_k_shards(*(torch.from_numpy(a) for a in src), 64, old, new)
    for a, at, b, g in zip(got, got_t, want, jfmt.pack_tpu_sharded(w, k_shards=new)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(at.numpy(), b)
        np.testing.assert_array_equal(a, g)  # = packing at the new width directly
    stacked = Q.repack_k_shards(*(np.stack([a, a]) for a in src), 64, old, new)
    for s, a in zip(stacked, got):
        np.testing.assert_array_equal(s[1], a)


# ---------------------------------------------------------------------------
# K9a / K9b plain versions vs the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_k9a_plain_bit_exact_with_jax(out, qt, pair):
    w = _w(256, 2048, seed=7)
    packed, hi, lo = jfmt.pack_tpu_sharded(w, code=CODES[qt])
    cb = None if qt == "fp4" else CODES[qt]
    jabs = (jnp.asarray(hi), jnp.asarray(lo)) if pair else jnp.asarray(np.concatenate([hi, lo]))
    want = _f32(JK.dequantize_tpu(jnp.asarray(packed), jabs, None if cb is None else jnp.asarray(cb),
                                  out_dtype=getattr(jnp, out), interpret=True))
    tabs = (torch.from_numpy(hi), torch.from_numpy(lo)) if pair else torch.from_numpy(np.concatenate([hi, lo]))
    got = K.dequantize_tpu(torch.from_numpy(packed), tabs, cb, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (2048, 256)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if out == "float32":  # = the numpy golden
        np.testing.assert_array_equal(got.numpy(), jfmt.unpack_tpu_sharded(packed, hi, lo, code=CODES[qt]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m", [1, 5, 40, 300])
def test_k9b_plain_matches_jax(m, dtype):
    """FP4 with a bias; NF4 for the 40-row case."""
    k, n = 2048, 384
    qt = "nf4" if m == 40 else "fp4"
    packed, absmax = jfmt.pack_tpu(_w(n, k, seed=m), code=CODES[qt])
    cb = None if qt == "fp4" else CODES[qt]
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(np.float32)
    b = np.random.default_rng(m + 2).standard_normal(n).astype(np.float32)
    jfn = JK.gemv_fp4 if m == 1 else JK.matmul_fp4
    want = _f32(jfn(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(packed), jnp.asarray(absmax), jnp.asarray(b),
                    None if cb is None else jnp.asarray(cb), interpret=True))
    fn = K.gemv_fp4 if m == 1 else K.matmul_fp4
    got = fn(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(packed), torch.from_numpy(absmax),
             torch.from_numpy(b), cb)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    _close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2.0**-7)


def test_k9b_f16_computes_in_bf16():
    """f16 x: the same call as bf16 x with an f16 output (the JAX contract)."""
    packed, absmax = fmt.pack_tpu(_w(256, 1024, seed=9))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((6, 1024)).astype(np.float32))
    args = (torch.from_numpy(packed), torch.from_numpy(absmax))
    got = K.matmul_fp4(x.to(torch.float16), *args)
    assert got.dtype == torch.float16
    assert torch.equal(got, K.matmul_fp4(x.to(torch.float16).to(torch.bfloat16), *args, out_dtype=torch.float16))


def test_k9_shape_and_argument_errors():
    """The JAX package's errors (tests/test_errors.py:61-70) and the port's
    own checks of the batch-1 route and the decode choice."""
    packed, absmax = fmt.pack_tpu(_w(128, 1024, seed=0, scale=0.1))
    p, a = torch.from_numpy(packed), torch.from_numpy(absmax)
    x = torch.zeros((2, 1024))
    with pytest.raises(ValueError, match="absmax must be"):
        K.matmul_fp4(x, p, a[:-1])
    with pytest.raises(ValueError, match="absmax must be"):
        JK.matmul_fp4(jnp.zeros((2, 1024)), jnp.asarray(packed), jnp.asarray(absmax[:-1]), interpret=True)
    with pytest.raises(ValueError, match="absmax halves"):
        K.matmul_fp4(x, p, (a[:8], a[8:15]))
    with pytest.raises(ValueError, match=r"x must be \(M, K=1024\)"):
        K.matmul_fp4(torch.zeros((2, 555)), p, a)
    with pytest.raises(ValueError, match="uint8"):
        K.matmul_fp4(x, p.to(torch.int32), a)
    with pytest.raises(ValueError, match="uint8"):
        K.dequantize_tpu(p[None], a)
    with pytest.raises(ValueError, match="batch-1"):
        K.gemv_fp4(x, p, a)
    with pytest.raises(ValueError, match="FP4-only"):
        K.matmul_fp4(x, p, a, codebook=fmt.NF4_CODE, decode_impl="arith")
    with pytest.raises(ValueError, match="decode_impl"):
        K.dequantize_tpu(p, a, decode_impl="lut")
    with pytest.raises(ValueError, match="16 entries"):
        K.matmul_fp4(x, p, a, codebook=np.zeros(8, np.float32))
    # decode_impl="arith" is FP4 and gives the table's bits
    assert torch.equal(K.dequantize_tpu(p, a, decode_impl="arith"), K.dequantize_tpu(p, a))


def test_code_tables_are_cached_per_device():
    dev = torch.device("cpu")
    assert K.code_table(None, dev) is K.code_table(None, dev)
    np.testing.assert_array_equal(K.code_table(None, dev).numpy(), fmt.FP4_CODE)
    assert K.code_table(fmt.NF4_CODE, dev) is K.code_table(fmt.NF4_CODE.copy(), dev)
    cb = torch.from_numpy(fmt.NF4_CODE.copy())
    assert K.code_table(cb, dev).data_ptr() == cb.data_ptr()  # a device f32 table is used as it is


def test_cpu_calls_never_count_launches():
    K.reset_launch_counts()
    q = L.quantize_linear(_w(128, 1024, 1), layout="splitk", device="cpu")
    L.apply_linear(q, torch.ones((3, 1024), dtype=torch.bfloat16))
    L.dequantize_weight(q)
    assert K.launch_counts()["matmul_splitk"] == K.launch_counts()["dequant_splitk"] == 0


# ---------------------------------------------------------------------------
# the split-K linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,dtype", [(1, "bfloat16"), (7, "float32"), (300, "bfloat16")])
@pytest.mark.parametrize("k_shards", [1, 2, 4])
def test_apply_linear_splitk_matches_jax(k_shards, m, dtype):
    """300 x 1000 weights (K and N padded), with a bias."""
    w = _w(300, 1000, seed=k_shards)
    bias = np.random.default_rng(5).standard_normal(300).astype(np.float32)
    jq = JL.quantize_linear(w, bias, layout="splitk", k_shards=k_shards)
    tq = L.quantize_linear(w, bias, layout="splitk", k_shards=k_shards, device="cpu")
    assert (tq.layout, tq.k_shards, tq.k_pad, tq.n_pad) == ("splitk", k_shards, 1024, 384) == \
           (jq.layout, jq.k_shards, jq.k_pad, jq.n_pad)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.absmax_hi))
    np.testing.assert_array_equal(tq.scale_lo.numpy(), np.asarray(jq.absmax_lo))
    x = np.random.default_rng(m).standard_normal((m, 1000)).astype(np.float32)
    want = _f32(JL.apply_linear(jq, jnp.asarray(x, getattr(jnp, dtype)), interpret=True))
    got = L.apply_linear(tq, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, 300)
    _close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2.0**-7)


@pytest.mark.parametrize("k_shards", [2, 4])
def test_k_sharded_packing_matches_unsharded(k_shards):
    """The JAX package's test_k_sharded_packing_matches_unsharded, in the
    port: same dequantized weights, the same forward up to f32 order."""
    w = _w(128, 2048, seed=11, scale=0.1)
    q1 = L.quantize_linear(w, layout="splitk", device="cpu")
    qd = L.quantize_linear(w, k_shards=k_shards, device="cpu")
    assert qd.k_shards == k_shards and qd.layout == "splitk"
    assert torch.equal(L.dequantize_weight(q1, out_dtype=torch.float32), L.dequantize_weight(qd, out_dtype=torch.float32))
    for m in (1, 5):
        x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 2048)).astype(np.float32))
        np.testing.assert_allclose(L.apply_linear(qd, x).numpy(), L.apply_linear(q1, x).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("qt,k_shards", [("fp4", 1), ("nf4", 4)])
def test_dequantize_weight_bit_exact_with_jax(qt, k_shards):
    w = _w(300, 1000, seed=12)
    jq = JL.quantize_linear(w, quant_type=qt, layout="splitk", k_shards=k_shards)
    tq = L.quantize_linear(w, quant_type=qt, layout="splitk", k_shards=k_shards, device="cpu")
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _f32(JL.dequantize_weight(jq, out_dtype=jdt, interpret=True))
        got = L.dequantize_weight(tq, out_dtype=tdt)
        assert got.dtype == tdt and tuple(got.shape) == (300, 1000)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_splitk_refusals_match_jax():
    """Split-K is never fused, never shadowed and never takes K8, with the
    JAX package's messages (its fusion refusal is an assert; the port raises
    ValueError as for its other fusion refusals)."""
    w = _w(128, 1024, seed=13)
    jq, tq = JL.quantize_linear(w, layout="splitk"), L.quantize_linear(w, layout="splitk", device="cpu")
    jp_, tp_ = JL.quantize_linear(w), L.quantize_linear(w, device="cpu")
    with pytest.raises(AssertionError, match="pairk-only"):
        JL.fuse_linears([jq, jp_])
    with pytest.raises(ValueError, match="pairk-only"):
        L.fuse_linears([tq, tp_])
    with pytest.raises(ValueError, match="int8 shadow requires the pairk layout"):
        JL.attach_int8_shadow(jq, interpret=True)
    with pytest.raises(ValueError, match="int8 shadow requires the pairk layout"):
        L.attach_int8_shadow(tq)
    js, ts = JT.stack_linears([jq, jq]), T.stack_linears([tq, tq])
    x = np.ones((2, 1024), np.float32)
    with pytest.raises(ValueError, match="requires the pairk layout"):
        JL.apply_expert_linear(js, 0, jnp.asarray(x))
    with pytest.raises(ValueError, match="requires the pairk layout"):
        L.apply_expert_linear(ts, 0, torch.from_numpy(x))
    shadowed = L.attach_prefill_shadow([tq, tp_])
    assert shadowed[0].w8 is None and shadowed[1].w8 is not None
    fused = T.fuse_layer(T.LayerParams(attn_norm=None, wq=tq, wk=tq, wv=tq, wo=tq, mlp_norm=None))
    assert fused.wqkv is None and fused.wq is tq


# ---------------------------------------------------------------------------
# bitsandbytes ingest
# ---------------------------------------------------------------------------


def _bnb_state(qt, shape, seed):
    w = _w(*shape, seed=seed)
    packed, absmax = jfmt.quantize_fp4(w, code=CODES[qt])
    return packed, absmax


@pytest.mark.parametrize("layout", ["pairk", "splitk"])
@pytest.mark.parametrize("qt", ["fp4", "nf4"])
def test_from_bnb_state_bytes_equal_jax(qt, layout):
    """Odd N (200 -> 256) and K padding (1088 -> 1536 pair-K, 2048 split-K);
    bnb pads absmax with ones, quantize_linear pads weights with zeros."""
    shape = (200, 1088)
    packed, absmax = _bnb_state(qt, shape, seed=len(qt + layout))
    bias = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    jq = JB.from_bnb_state(packed, absmax, shape, quant_type=qt, bias=bias, layout=layout, device=False)
    tq = B.from_bnb_state(packed, absmax, shape, quant_type=qt, bias=bias, layout=layout, device="cpu")
    assert (tq.layout, tq.variant, tq.k_shards, tq.n_out, tq.k_in) == \
           (jq.layout, jq.variant, jq.k_shards, jq.n_out, jq.k_in)
    for got, want in ((tq.packed, jq.packed), (tq.scale, jq.absmax_hi), (tq.scale_lo, jq.absmax_lo),
                      (tq.bias, jq.bias), (tq.codebook, jq.codebook)):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.numpy().dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout == "splitk":  # bnb-exact: the layer's weights are bnb's dequantize
        ref = jfmt.dequantize_fp4(packed, absmax, shape, code=CODES[qt])
        np.testing.assert_array_equal(L.dequantize_weight(tq, out_dtype=torch.float32).numpy(), ref)
        x = np.random.default_rng(4).standard_normal((3, 1088)).astype(np.float32)
        want = _f32(JL.apply_linear(JB.from_bnb_state(packed, absmax, shape, quant_type=qt, bias=bias, layout=layout),
                                    jnp.asarray(x, jnp.bfloat16), interpret=True))
        _close(L.apply_linear(tq, torch.from_numpy(x).to(torch.bfloat16)).float().numpy(), want, 2.0**-7)


def test_dequantize_nested_absmax_matches_jax():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, 700).astype(np.uint8)
    absmax2 = rng.random(3).astype(np.float32)
    code2 = np.sort(rng.standard_normal(256)).astype(np.float32)
    got = B.dequantize_nested_absmax(u8, absmax2, code2, 0.125)
    want = JB.dequantize_nested_absmax(u8, absmax2, code2, 0.125)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("double_quant", [False, True])
def test_from_bnb_torch_layer_matches_jax(double_quant):
    """A stand-in for a bnb Linear4bit: ``weight`` (uint8 data) with a
    ``quant_state``, and a bias; double quantization keeps absmax as uint8
    codes into ``state2``."""
    shape = (256, 1024)
    packed, absmax = _bnb_state("nf4", shape, seed=6)
    rng = np.random.default_rng(7)
    qs = types.SimpleNamespace(shape=shape, blocksize=64, quant_type="nf4", absmax=torch.from_numpy(absmax))
    if double_quant:
        code2 = np.linspace(-1.0, 1.0, 256).astype(np.float32)
        qs.absmax = torch.from_numpy(rng.integers(0, 256, absmax.size).astype(np.uint8))
        qs.offset = 0.02
        qs.state2 = types.SimpleNamespace(absmax=torch.from_numpy(rng.random(absmax.size // 256 + 1).astype(np.float32)),
                                          code=torch.from_numpy(code2), blocksize=256)
    weight = types.SimpleNamespace(data=torch.from_numpy(packed.reshape(-1, 1)), quant_state=qs)
    layer = types.SimpleNamespace(weight=weight, bias=torch.from_numpy(rng.standard_normal(256).astype(np.float32)))
    jq = JB.from_bnb_torch_layer(layer, layout="splitk")
    tq = B.from_bnb_torch_layer(layer, layout="splitk", device="cpu")
    for got, want in ((tq.packed, jq.packed), (tq.scale, jq.absmax_hi), (tq.scale_lo, jq.absmax_lo),
                      (tq.bias, jq.bias), (tq.codebook, jq.codebook)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="quant_state"):
        B.from_bnb_torch_layer(types.SimpleNamespace(weight=torch.zeros(4), bias=None))


# ---------------------------------------------------------------------------
# models: greedy tokens, the engine, MoE, synth
# ---------------------------------------------------------------------------


def _splitk_jax_params(cfg, qt, seed, k_shards=2):
    """JAX ModelParams with every linear split-K (``quant_type`` ``qt``), wo
    and w_down (and the experts' down) K-sharded into ``k_shards``, a dense
    lm_head."""
    w = JT.random_weights(cfg, seed=seed)
    base = JT.quantize_params(cfg, w)  # norms, embeddings, router and the dense lm_head

    def q(name, shards=1):
        return JL.quantize_linear(w[name], w.get(name.replace(".weight", ".bias")), quant_type=qt, layout="splitk",
                                  k_shards=shards)

    layers = []
    for i, lp in enumerate(base.layers):
        p = f"model.layers.{i}."
        kw = dict(wq=q(p + "self_attn.q_proj.weight"), wk=q(p + "self_attn.k_proj.weight"),
                  wv=q(p + "self_attn.v_proj.weight"), wo=q(p + "self_attn.o_proj.weight", k_shards))
        if cfg.n_experts:
            ep = p + "block_sparse_moe.experts."

            def stack(name, shards=1):
                return JT.stack_linears([q(f"{ep}{m}.{name}.weight", shards) for m in range(cfg.n_experts)])

            kw["moe"] = JT.MoEParams(router=lp.moe.router, gate=stack("w1"), up=stack("w3"),
                                     down=stack("w2", k_shards))
        else:
            kw.update(w_gate=q(p + "mlp.gate_proj.weight"), w_up=q(p + "mlp.up_proj.weight"),
                      w_down=q(p + "mlp.down_proj.weight", k_shards))
        layers.append(JT.LayerParams(attn_norm=lp.attn_norm, mlp_norm=lp.mlp_norm, **kw))
    return JT.ModelParams(embed=base.embed, layers=layers, final_norm=base.final_norm, lm_head=base.lm_head)


def _carry(jp, cfg):
    arrays, meta = flatten_jax_params(jp)
    return params_from_numpy(arrays, meta, T.ModelConfig(**cfg.__dict__), device="cpu")


CFG2 = JT.ModelConfig.tiny_test(n_layers=2)


@pytest.fixture(scope="module")
def splitk_models():
    """{quant_type: (JAX params, the port's params carried across)}."""
    out = {}
    for qt in ("fp4", "nf4"):
        jp = _splitk_jax_params(CFG2, qt, seed=8 + len(qt))
        out[qt] = jp, _carry(jp, CFG2)
    return out


@pytest.mark.parametrize("qt,plen", [("fp4", 5), ("fp4", 140), ("nf4", 140)])
def test_generate_tokens_identical_to_jax(splitk_models, qt, plen):
    """5 tokens: K9b at M = 1 throughout; 140: the prefill at 140 rows."""
    jp, tp = splitk_models[qt]
    lay = tp.layers[0]
    assert lay.wo.k_shards == lay.w_down.k_shards == 2 and lay.wq.layout == "splitk" and lay.wqkv is None
    prompt = np.random.default_rng(plen).integers(1, CFG2.vocab_size, size=(1, plen)).astype(np.int32)
    want = np.asarray(JT.generate(jp, CFG2, jnp.asarray(prompt), max_new_tokens=5))
    got = T.generate(tp, T.ModelConfig(**CFG2.__dict__), torch.from_numpy(prompt), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_equals_generate(splitk_models):
    _, tp = splitk_models["fp4"]
    tcfg = T.ModelConfig(**CFG2.__dict__)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, CFG2.vocab_size, n).tolist() for n in (3, 9)]
    res = Engine(tp, tcfg, EngineConfig(max_batch=2, max_len=32, inner_steps=2)).run(
        [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want = T.generate(tp, tcfg, torch.tensor([p], dtype=torch.int32), max_new_tokens=4)[0].tolist()
        assert res[i].tokens == want


@pytest.mark.parametrize("t", [1, 6])
def test_moe_forward_splitk_stacks_match_jax(t):
    """Split-K expert stacks go through ``expert_view`` + K9b in both
    packages: per-token dispatch at T = 1, all experts at T = 6."""
    cfg = JT.ModelConfig.tiny_test(n_experts=4, experts_per_tok=2, n_layers=1)
    jp = _splitk_jax_params(cfg, "fp4", seed=10)
    tp = _carry(jp, cfg)
    assert tp.layers[0].moe.down.layout == "splitk" and tp.layers[0].moe.down.scale_lo.shape[0] == 4
    x = np.random.default_rng(t).standard_normal((t, cfg.dim)).astype(np.float32)
    want = np.asarray(JT.moe_forward(jp.layers[0].moe, cfg, jnp.asarray(x, jnp.bfloat16)))
    got = T.moe_forward(tp.layers[0].moe, T.ModelConfig(**cfg.__dict__), torch.from_numpy(x).to(torch.bfloat16))
    _close(got.numpy(), want, 2.0**-7)


def test_synth_params_splitk():
    cfg = T.ModelConfig.tiny_test(n_layers=2, n_experts=4)
    p = synth_params(cfg, layout="splitk", tp=2, fuse=True, seed=1, device="cpu")
    lay = p.layers[0]
    assert lay.wqkv is None and lay.wq.layout == "splitk" and lay.wq.k_shards == 1 and lay.wo.k_shards == 2
    assert lay.moe.gateup is None and lay.moe.down.k_shards == 2 and lay.moe.down.packed.ndim == 3
    assert isinstance(p.lm_head, L.DenseLinear)
    for s in (lay.wq.scale, lay.wq.scale_lo):
        assert s.shape == (cfg.dim // 128, cfg.q_dim) and 0.005 <= s.min().item() and s.max().item() < 0.015
    dense = synth_params(T.ModelConfig.tiny_test(n_layers=1), layout="splitk", tp=4, device="cpu")
    x = torch.ones((1, 3, cfg.dim), dtype=torch.bfloat16)
    assert dense.layers[0].w_down.k_shards == 4 and dense.layers[0].wo(x).shape == (1, 3, cfg.dim)


def test_splitk_bounds():
    """Bytes and operations of the bounds, from the shapes."""
    t, by = P.splitk_matmul_bound_s(1, 4096, 14336, x_bytes=2, out_bytes=2)
    assert by == "bytes" and t == pytest.approx((4096 * 14336 * (0.5 + 1 / 16) + 4096 * 2 + 14336 * 2) / 3.35e12)
    t, by = P.splitk_matmul_bound_s(256, 4096, 4096, x_bytes=4, out_bytes=4)
    assert by == "operations" and t == pytest.approx(2 * 256 * 4096 * 4096 / 67e12)
    t, by = P.dequant_splitk_bound_s(4096, 4096, 2)
    assert by == "bytes" and t == pytest.approx(4096 * 4096 * (2.5 + 1 / 16) / 3.35e12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_jax_sharded_checkpoint_loads_repacked(tmp_path, splitk_models):
    """A JAX-written split-K checkpoint with row-parallel k_shards = 2 loads
    at tp = 1 in both packages, repacked to one shard: the same bytes."""
    jp, _ = splitk_models["nf4"]
    JC.save_checkpoint(str(tmp_path), CFG2, jp)
    _, jback = JC.load_checkpoint(str(tmp_path), tp=1)
    tcfg, tp = load_checkpoint(str(tmp_path), device="cpu")
    assert tcfg == T.ModelConfig(**CFG2.__dict__)
    assert tp.layers[1].wo.k_shards == tp.layers[1].w_down.k_shards == jback.layers[1].w_down.k_shards == 1
    _assert_same(flatten_jax_params(jback)[0], tp)


def test_port_checkpoint_loads_in_jax(tmp_path, splitk_models):
    jp, tp = splitk_models["fp4"]
    save_checkpoint(str(tmp_path), T.ModelConfig(**CFG2.__dict__), tp)
    man = json.loads((tmp_path / "manifest.json").read_text())
    m = man["tensors"]["layers.0"]["linears"]["w_down"]
    assert (m["layout"], m["k_shards"], m["row_parallel"]) == ("splitk", 2, True)
    jcfg, back = JC.load_checkpoint(str(tmp_path), tp=2)  # tp = k_shards: no repack
    assert jcfg == CFG2
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype, (pa, a.dtype, b.dtype)
        np.testing.assert_array_equal(_f32(a) if a.dtype == jnp.bfloat16 else np.asarray(a),
                                      _f32(b) if b.dtype == jnp.bfloat16 else np.asarray(b))


def test_format2_manifest_without_layout_reads_as_splitk(tmp_path, splitk_models):
    jp, _ = splitk_models["fp4"]
    JC.save_checkpoint(str(tmp_path), CFG2, jp)
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    man["format_version"] = 2
    for group in man["tensors"].values():
        for m in group.get("linears", {}).values():
            m.pop("layout", None)
    man_path.write_text(json.dumps(man))
    _, jback = JC.load_checkpoint(str(tmp_path))
    _, tp = load_checkpoint(str(tmp_path), device="cpu")
    assert jback.layers[0].wq.layout == tp.layers[0].wq.layout == "splitk"
    assert jback.layers[0].wo.k_shards == tp.layers[0].wo.k_shards == 1
    _assert_same(flatten_jax_params(jback)[0], tp)
