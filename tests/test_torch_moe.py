"""Mixture-of-experts (Mixtral family): the port against the JAX package on
the same numpy inputs, at ``ModelConfig.tiny_test(n_experts=4,
experts_per_tok=2)``.

The expert kernels (K8) are the K2/K3/K4 kernels run against expert e of a
stacked (E, K/2, N) packing; on the CPU their plain versions run, and the
JAX side runs its Pallas kernels in interpret mode.

Tolerances:
  * ``apply_expert_linear``, bf16 output, K2 (M = 1, 24) and K3 (M = 140,
    and the lut codebook at 260): |dy| <= 2^-7 * max|y_ref| (bf16 rounding
    of the output plus f32 summation order, as tests/test_torch_kernels.py).
  * K4 (FP4 at M = 260; both packages take the int8 path from 256 rows):
    at most one bf16 ulp per element (exact int8 dots on both sides).
  * The expert form against the port's own 2-D path on ``packed[e]``, and an
    int index against a tensor index: bit-equal (same arithmetic).
  * ``moe_forward`` (f32 output): |dy| <= 2^-7 * max|y_ref|; the gate/up
    outputs are bf16, so an f32 summation-order difference can flip one of
    their roundings before the down projection.
  * Models: greedy tokens identical; checkpoints byte-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.convert import checkpoint as JC
from torch_bnb_fp4_tpu.models import linear as JL
from torch_bnb_fp4_tpu.models import transformer as JT
from torch_bnb_fp4_tpu_torch.convert import load_checkpoint, save_checkpoint
from torch_bnb_fp4_tpu_torch.convert.from_numpy import params_from_numpy
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.models import transformer as T
from torch_bnb_fp4_tpu_torch.ops import kernels as K
from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

from test_torch_checkpoint import _assert_same
from test_torch_transformer import flatten_jax_params

CFG = JT.ModelConfig.tiny_test(n_experts=4, experts_per_tok=2, n_layers=1)
TCFG = T.ModelConfig(**CFG.__dict__)
E, N, KIN = 4, 256, 1024


def _ulp_bf16(a):
    a = np.abs(np.asarray(a, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny))) - 7)


def _close(got, want, rel=2.0**-7):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), rel * np.abs(want).max() + 1e-30)


@pytest.fixture(scope="module")
def stacks():
    """{quant_type: (JAX stacked linear, port stacked linear)} of E experts
    with a per-expert bias, quantized in each package from the same weights."""
    rng = np.random.default_rng(0)
    out = {}
    for qt in ("fp4", "nf4"):
        ws = [rng.standard_normal((N, KIN)).astype(np.float32) * 0.02 for _ in range(E)]
        bs = [rng.standard_normal(N).astype(np.float32) * 0.01 for _ in range(E)]
        jsq = JT.stack_linears([JL.quantize_linear(w, b, quant_type=qt) for w, b in zip(ws, bs)])
        tsq = T.stack_linears([L.quantize_linear(w, b, quant_type=qt, device="cpu") for w, b in zip(ws, bs)])
        out[qt] = jsq, tsq
    return out


@pytest.fixture(scope="module")
def models():
    """The tiny MoE model's weights, the JAX params (unfused) and the port's
    params carried across from them."""
    w = JT.random_weights(CFG, seed=3)
    jp = JT.quantize_params(CFG, w)
    arrays, meta = flatten_jax_params(jp)
    return w, jp, params_from_numpy(arrays, meta, TCFG, device="cpu")


def test_stack_linears_same_bytes_as_jax(stacks):
    for qt, (jsq, tsq) in stacks.items():
        assert tsq.packed.shape == (E, KIN // 2, N) and tsq.bias.shape == (E, N)
        np.testing.assert_array_equal(tsq.packed.numpy(), np.asarray(jsq.packed))
        np.testing.assert_array_equal(tsq.scale.numpy(), np.asarray(jsq.absmax_hi))
        np.testing.assert_array_equal(tsq.bias.numpy(), np.asarray(jsq.bias))
        if qt == "nf4":
            assert tsq.codebook.shape == (E, 16)
            np.testing.assert_array_equal(tsq.codebook.numpy(), np.asarray(jsq.codebook))


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("m,path", [(1, "mouter"), (24, "mouter"), (140, "minner"), (260, "w4a8")])
def test_apply_expert_linear_matches_jax(stacks, m, path, qt):
    """Experts 0 and E-1, the index as an int and as an int32 tensor."""
    jsq, tsq = stacks[qt]
    if qt == "nf4" and path == "w4a8":
        path = "minner"  # the lut codebook never takes the int8 path
    assert K.select_path(m, torch.bfloat16, tsq.variant, None) == path
    x = np.random.default_rng(m).standard_normal((m, KIN)).astype(np.float32) * 0.5
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for e in (0, E - 1):
        want = np.asarray(JL.apply_expert_linear(jsq, e, jnp.asarray(x, jnp.bfloat16)), np.float32)
        got = L.apply_expert_linear(tsq, e, xt)
        got_t = L.apply_expert_linear(tsq, torch.tensor(e, dtype=torch.int32), xt)
        assert got.dtype == torch.bfloat16 and torch.equal(got, got_t)
        got = got.float().numpy()
        if path == "w4a8":
            np.testing.assert_array_less(np.abs(got - want), _ulp_bf16(want) * 1.0001 + 1e-30)
        else:
            _close(got, want)


@pytest.mark.parametrize("m", [1, 24, 140, 260])
def test_expert_form_bit_equal_to_2d_path(stacks, m):
    """The port's expert form equals its 2-D path on the materialized expert
    (the JAX package's test_expert_kernel_matches_materialized_view)."""
    x = torch.from_numpy(np.random.default_rng(m + 1).standard_normal((m, KIN)).astype(np.float32)).to(torch.bfloat16)
    for qt, (_, tsq) in stacks.items():
        for e in (0, E - 1):
            view = T.expert_view(tsq, e)
            assert view.packed.shape == (KIN // 2, N) and torch.equal(view.packed, tsq.packed[e])
            assert torch.equal(L.apply_expert_linear(tsq, e, x), L.apply_linear(view, x)), (qt, e)
            assert torch.equal(T.expert_view(tsq, torch.tensor(e, dtype=torch.int32)).scale, view.scale)


def test_expert_index_is_checked_and_clamped(stacks):
    """A tensor index must be one int32 element on x's device; an int must
    lie in the stack; a tensor index past the stack is clamped into it, as
    jax.lax.dynamic_index_in_dim clamps (the CUDA kernels clamp alike)."""
    _, tsq = stacks["fp4"]
    x = torch.ones((2, KIN), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        L.apply_expert_linear(tsq, torch.tensor(1), x)  # int64
    with pytest.raises(ValueError, match="int32"):
        L.apply_expert_linear(tsq, torch.tensor([0, 1], dtype=torch.int32), x)
    with pytest.raises(ValueError, match="outside"):
        L.apply_expert_linear(tsq, E, x)
    with pytest.raises(ValueError, match="STACKED"):
        K.matmul_fp4_pk(x, tsq.packed[0], tsq.scale[0], variant="ramp", expert=0)
    top = L.apply_expert_linear(tsq, torch.tensor(E + 3, dtype=torch.int32), x)
    assert torch.equal(top, L.apply_expert_linear(tsq, E - 1, x))


@pytest.mark.parametrize("t,force_dense", [(1, None), (2, None), (6, None), (1, True), (6, False)])
def test_moe_forward_matches_jax(models, t, force_dense):
    """Per-token dispatch (T * k <= E: T = 1, 2), all-experts (T = 6), and
    each forced the other way."""
    _, jp, tp = models
    x = np.random.default_rng(10 + t).standard_normal((t, CFG.dim)).astype(np.float32)
    want = np.asarray(JT.moe_forward(jp.layers[0].moe, CFG, jnp.asarray(x, jnp.bfloat16), force_dense=force_dense))
    got = T.moe_forward(tp.layers[0].moe, TCFG, torch.from_numpy(x).to(torch.bfloat16), force_dense=force_dense)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_dispatch_paths_agree(models):
    """Per-token dispatch equals the all-experts masked pass."""
    moe = models[2].layers[0].moe
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, CFG.dim)).astype(np.float32) * 0.05)
    x = x.to(torch.bfloat16)
    y_tok = T.moe_forward(moe, TCFG, x, force_dense=False)
    y_all = T.moe_forward(moe, TCFG, x, force_dense=True)
    assert (y_tok - y_all).abs().max().item() <= 1e-4


@pytest.mark.parametrize("force_dense", [None, True])
def test_router_semantics_handcrafted(force_dense):
    """Rank-1 dense experts with known outputs and a router whose decisions
    are forced (the JAX package's test of the same name): token 0 routes to
    experts (0, 1), token 1 to (2, 3), each weighted by the top-2 softmax
    renormalized (softmax over all experts, top-k, renormalize)."""
    d, f, e = TCFG.dim, TCFG.ffn_dim, TCFG.n_experts
    consts = [0.5, 1.0, 2.0, 4.0]

    def rank1_expert(c):
        g = np.zeros((f, d), np.float32)
        g[0, :] = 100.0 / d
        u = np.zeros((f, d), np.float32)
        u[0, :] = 1.0
        dn = np.zeros((d, f), np.float32)
        dn[0, 0] = c / d
        return g, u, dn

    gates, ups, downs = zip(*[rank1_expert(c) for c in consts])
    rw = np.zeros((e, d), np.float32)
    rw[0, 0], rw[1, 0] = 3.0, 2.0
    rw[2, 1], rw[3, 1] = 3.0, 2.0

    def stack(ws):
        return T.stack_linears([L.dense_linear(w, device="cpu") for w in ws])

    moe = T.MoEParams(router=L.dense_linear(rw, device="cpu"), gate=stack(gates), up=stack(ups), down=stack(downs))
    x = torch.zeros((2, d), dtype=torch.bfloat16)
    x[0, 0] = 1.0
    x[1, 1] = 1.0
    y = T.moe_forward(moe, TCFG, x, force_dense=force_dense).numpy()
    w_hi = np.e / (np.e + 1)
    gdot = 100.0 / d
    h0 = gdot / (1.0 + np.exp(-gdot))

    def expect(c_hi, c_lo):
        return (w_hi * c_hi + (1 - w_hi) * c_lo) / d * h0

    assert np.allclose(y[0, 0], expect(consts[0], consts[1]), rtol=2e-2)
    assert np.allclose(y[1, 0], expect(consts[2], consts[3]), rtol=2e-2)
    assert np.abs(y[:, 1:]).max() < 1e-6


def test_weights_and_quantization_match_jax(models):
    """random_weights gives the JAX package's arrays (Mixtral naming, same
    RNG order); quantizing them in the port gives the carried JAX params'
    bytes, router and stacked layout included."""
    w, _, tp = models
    tw = T.random_weights(TCFG, seed=3)
    assert sorted(tw) == sorted(w) and all(np.array_equal(tw[k], w[k]) for k in w)
    qp = T.quantize_params(TCFG, tw, device="cpu")
    for f in ("gate", "up", "down"):
        a, b = getattr(tp.layers[0].moe, f), getattr(qp.layers[0].moe, f)
        assert a.packed.shape[0] == E and torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale)
    assert torch.equal(tp.layers[0].moe.router.w, qp.layers[0].moe.router.w)
    assert qp.layers[0].w_gate is None and qp.layers[0].moe.router.w.dtype == torch.bfloat16


def test_fuse_linears_stacked_with_bias_matches_jax():
    """Stacked linears fuse on the last axis; a missing bias becomes zeros of
    the stack's leading shape (E, n) (the JAX package's fuse_linears)."""
    rng = np.random.default_rng(4)
    ws = [[rng.standard_normal((n, KIN)).astype(np.float32) * 0.02 for _ in range(E)] for n in (256, 384)]
    bias = [rng.standard_normal(256).astype(np.float32) for _ in range(E)]
    ja = JT.stack_linears([JL.quantize_linear(w, b) for w, b in zip(ws[0], bias)])
    jb = JT.stack_linears([JL.quantize_linear(w) for w in ws[1]])
    ta = T.stack_linears([L.quantize_linear(w, b, device="cpu") for w, b in zip(ws[0], bias)])
    tb = T.stack_linears([L.quantize_linear(w, device="cpu") for w in ws[1]])
    jf, tf = JL.fuse_linears([ja, jb]), L.fuse_linears([ta, tb])
    assert tf.bias.shape == (E, 640) and tf.packed.shape == (E, KIN // 2, 640) and tf.n_out == 640
    for a, b in ((tf.packed, jf.packed), (tf.scale, jf.absmax_hi), (tf.bias, jf.bias)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = torch.ones((1, KIN), dtype=torch.bfloat16)
    assert torch.equal(L.apply_expert_linear(tf, 2, x)[:, :256], L.apply_expert_linear(ta, 2, x))


@pytest.mark.parametrize("plen", [5, 140])
def test_generate_tokens_identical_to_jax(plen):
    """2 layers, fused gate|up experts.  5 tokens: all-experts prefill
    through K2 (5 * 2 > 4), per-token decode; 140 tokens: the prefill's
    experts through K3."""
    cfg = JT.ModelConfig.tiny_test(n_experts=4, experts_per_tok=2, n_layers=2)
    jp = JT.quantize_params(cfg, JT.random_weights(cfg, seed=7), fuse=True)
    arrays, meta = flatten_jax_params(jp)
    tcfg = T.ModelConfig(**cfg.__dict__)
    tp = params_from_numpy(arrays, meta, tcfg, device="cpu")
    assert tp.layers[1].moe.gateup is not None and tp.layers[1].moe.gate is None
    prompt = np.random.default_rng(plen).integers(1, cfg.vocab_size, size=(1, plen)).astype(np.int32)
    want = np.asarray(JT.generate(jp, cfg, jnp.asarray(prompt), max_new_tokens=4))
    got = T.generate(tp, tcfg, torch.from_numpy(prompt), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_serves_moe(models):
    """The port's engine on the MoE model equals its batch-1 generate (the
    JAX package's test_engine_serves_moe); batch-2 decode is per-token."""
    params = T.fuse_params(models[2])
    eng = Engine(params, TCFG, EngineConfig(max_batch=2, max_len=32, inner_steps=2))
    reqs = [Request(uid=1, prompt=[3, 7, 2], max_new_tokens=6), Request(uid=2, prompt=[9, 11], max_new_tokens=5)]
    res = eng.run(reqs)
    for r in reqs:
        want = T.generate(params, TCFG, torch.tensor([r.prompt], dtype=torch.int32), r.max_new_tokens)
        assert res[r.uid].tokens == want[0].tolist(), r.uid


def test_synth_params_moe_stacks_and_fuses():
    """Stacked random experts; fuse=True fuses each layer's gate|up stack;
    the params move between devices and run."""
    cfg = T.ModelConfig.tiny_test(n_experts=4, experts_per_tok=2, n_layers=2)
    p = synth_params(cfg, seed=1, fuse=True, device="cpu")
    moe = p.layers[0].moe
    assert moe.gate is None and moe.gateup.packed.shape == (4, cfg.dim // 2, 2 * cfg.ffn_dim)
    assert moe.down.scale.shape == (4, cfg.ffn_dim // 64, cfg.dim) and moe.router.w.shape == (cfg.dim, 4)
    p = T.params_to(p, "cpu")
    logits, _ = T.forward(p, cfg, torch.tensor([[1, 2, 3]]), T.KVCache.zeros(cfg, 1, 4, device="cpu"))
    assert torch.isfinite(logits).all()
    dense = synth_params(cfg, quantized=False, seed=1, device="cpu")
    assert dense.layers[0].moe.up.w.shape == (4, cfg.dim, cfg.ffn_dim)


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
def test_jax_moe_checkpoint_loads_byte_identical(tmp_path, qt):
    cfg = JT.ModelConfig.tiny_test(n_experts=4, experts_per_tok=2, n_layers=1, quant_type=qt)
    jp = JT.quantize_params(cfg, JT.random_weights(cfg, seed=5))
    JC.save_checkpoint(str(tmp_path), cfg, jp)
    tcfg, tp = load_checkpoint(str(tmp_path), device="cpu")
    assert tcfg == T.ModelConfig(**cfg.__dict__) and tp.layers[0].w_gate is None
    arrays, _ = flatten_jax_params(jp)
    _assert_same(arrays, tp)
    assert tp.layers[0].moe.router.w.dtype == torch.bfloat16


def test_port_moe_checkpoint_loads_in_jax(tmp_path, models):
    _, jp, tp = models
    save_checkpoint(str(tmp_path), TCFG, tp)
    jcfg, back = JC.load_checkpoint(str(tmp_path))
    assert jcfg == CFG
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype, (pa, a.dtype, b.dtype)
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a),
                                      np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b))
    with pytest.raises(ValueError, match="unfused"):
        save_checkpoint(str(tmp_path / "fused"), TCFG, T.fuse_params(tp))
    _, again = load_checkpoint(str(tmp_path), fuse=True, device="cpu")
    assert again.layers[0].moe.gateup.packed.shape == (E, CFG.dim // 2, 2 * CFG.ffn_dim)


def test_prefill_shadow_skips_expert_stacks(models):
    """attach_prefill_shadow shadows the attention linears only; a stacked
    packing gets none (attach_int8_shadow refuses it), as in the JAX package."""
    shadowed = L.attach_prefill_shadow(models[2])
    lp = shadowed.layers[0]
    assert lp.wq.w8 is not None and lp.moe.gate.w8 is None and lp.moe.down.w8 is None
    with pytest.raises(ValueError, match="stacked"):
        L.attach_int8_shadow(lp.moe.up)
    assert lp.moe.router is models[2].layers[0].moe.router  # the dense router is left as it is
