"""The port's reference-API layer (torch_bnb_fp4_tpu_torch.compat) against
the JAX package's (torch_bnb_fp4_tpu.compat), on the same seeded inputs.

The port takes numpy or torch in and gives torch out (the JAX package gives
JAX arrays for numpy in); every comparison widens both sides to float32.
Tolerances: the flat-layout functions decode the same f32 values, so f32
results are equal up to the matmul's summation order (2e-6 relative); a
bf16 result is within one bf16 ulp of JAX's (2^-7 relative to max|y|); the
quantized layers' forward (pair-K kernels' plain versions against JAX's
interpreted kernels) within 2^-7 of max|y| for bf16 and 1e-5 for f32.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu import compat as J
from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu_torch import compat as C
from torch_bnb_fp4_tpu_torch.models import linear as L
from torch_bnb_fp4_tpu_torch.ops import format as fmt


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _flat_quant(seed, M, N, code=fmt.FP4_CODE):
    w = (np.random.default_rng(seed).standard_normal((M, N)) * 0.1).astype(np.float32)
    packed, absmax = fmt.quantize_fp4(w, code=code)
    return w, packed, absmax


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), np.abs(got - want).max()


class _QuantState:
    """Duck-typed bnb QuantState (absmax, blocksize, code, shape, quant_type)."""

    def __init__(self, absmax, shape, quant_type="fp4", blocksize=64):
        self.absmax, self.shape, self.blocksize, self.quant_type = absmax, shape, blocksize, quant_type
        self.code = fmt.FP4_CODE if quant_type == "fp4" else fmt.NF4_CODE


def test_scalartype_conversions():
    st = C.ScalarType
    assert st.from_torch_dtype(torch.bfloat16) is st.bfloat16 and st.from_torch_dtype(torch.half) is st.float16
    assert st.from_torch_dtype(np.float32) is st.float32 and st.from_torch_dtype("float") is st.float32
    assert st.from_str("bf16") is st.bfloat16 and st.from_str("fp32") is st.float32
    assert st.bfloat16.torch_dtype == torch.bfloat16 and st.float16.torch_dtype == torch.float16
    for name in ("bfloat16", "float16", "float32"):
        assert st(name).value == J.ScalarType(name).value and st(name).torch_dtype == J.ScalarType(name).torch_dtype
    with pytest.raises(ValueError):
        st.from_torch_dtype(torch.int8)
    with pytest.raises(ValueError):
        st.from_str("int8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_fp4_matches_jax(dtype):
    M, N = 64, 128
    _, packed, absmax = _flat_quant(0, M, N)
    want = J.dequantize_fp4(packed, absmax, 64, M, N, dtype=dtype)
    for got in (C.dequantize_fp4(packed, absmax, 64, M, N, dtype=dtype, device="cpu"),
                C.dequantize_fp4_qtype(torch.from_numpy(packed), torch.from_numpy(absmax), 64, M, N,
                                       C.ScalarType(dtype))):
        assert isinstance(got, torch.Tensor) and got.dtype == C.ScalarType(dtype).torch_dtype
        np.testing.assert_array_equal(_f32(got), _f32(want))
    golden = fmt.dequantize_fp4(packed, absmax, (M, N))
    np.testing.assert_array_equal(_f32(C.dequantize_fp4(packed, absmax, 64, M, N, "float32", device="cpu")), golden)


def test_codebook_honoured_as_jax():
    M, N = 32, 128
    w, packed, absmax = _flat_quant(1, M, N, code=fmt.NF4_CODE)
    want = J.dequantize_fp4_codebook_invoke(packed, absmax, jfmt.NF4_CODE, 64, M, N, M * N, "float32")
    got = C.dequantize_fp4_codebook_invoke(packed, absmax, fmt.NF4_CODE, 64, M, N, M * N, "float32", device="cpu")
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(got), fmt.dequantize_fp4(packed, absmax, (M, N), code=fmt.NF4_CODE))
    got_q = C.dequantize_fp4_codebook_invoke_qtype(torch.from_numpy(packed), torch.from_numpy(absmax),
                                                   torch.from_numpy(fmt.NF4_CODE), 64, M, N, M * N,
                                                   C.ScalarType.bfloat16)
    np.testing.assert_array_equal(_f32(got_q), _f32(J.dequantize_fp4_codebook_invoke_qtype(
        packed, absmax, jfmt.NF4_CODE, 64, M, N, M * N, J.ScalarType.bfloat16)))
    with pytest.raises(ValueError, match="numel"):
        C.dequantize_fp4_codebook_invoke(packed, absmax, fmt.NF4_CODE, 64, M, N, M * N + 1, "float32", device="cpu")


@pytest.mark.parametrize("ashape", [(1, 128), (1, 1, 128), (3, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_4bit_inference_matches_jax(ashape, dtype):
    out_f, in_f = 96, 128
    _, packed, absmax = _flat_quant(2, out_f, in_f)
    a = (np.random.default_rng(3).standard_normal(ashape) * 0.5).astype(np.float32)
    want = J.gemm_4bit_inference(a, packed, absmax, jfmt.FP4_CODE, 64, dtype=dtype, Bshape=(out_f, in_f))
    got = C.gemm_4bit_inference(torch.from_numpy(a), packed, absmax, fmt.FP4_CODE, 64, dtype=dtype,
                                Bshape=(out_f, in_f))
    assert tuple(got.shape) == ashape[:-1] + (out_f,) and got.dtype == C.ScalarType(dtype).torch_dtype
    _close(got, want, 2e-6 if dtype == "float32" else 2.0**-7)
    got_q = C.gemm_4bit_inference_qtype(a, packed, absmax, None, 64, C.ScalarType(dtype), Bshape=(out_f, in_f),
                                        device="cpu")
    _close(got_q, want, 2e-6 if dtype == "float32" else 2.0**-7)
    with pytest.raises(ValueError, match="Bshape"):
        C.gemm_4bit_inference(a, packed, absmax, fmt.FP4_CODE, 64, device="cpu")


@pytest.fixture(scope="module")
def qdata():
    out_f, in_f = 96, 128
    _, packed, absmax = _flat_quant(4, out_f, in_f)
    port = C.QuantData(packed, _QuantState(absmax, (out_f, in_f)), (out_f, in_f), device="cpu")
    jax_ = J.QuantData(packed, _QuantState(absmax, (out_f, in_f)), (out_f, in_f))
    return port, jax_


def test_quantdata_gemv_and_gemm_rows_match_jax(qdata):
    port, jax_ = qdata
    assert isinstance(port, torch.nn.Module) and (port.M, port.N, port.numel) == (96, 128, 96 * 128)
    np.testing.assert_array_equal(port.quant_linear.packed.numpy(), np.asarray(jax_.quant_linear.packed))
    rng = np.random.default_rng(5)
    for shape in [(1, 128), (1, 1, 128), (2, 3, 128)]:  # GEMV 2-D / 3-D and GEMM rows
        a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        for dt, jdt, rel in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2.0**-7)):
            got = port(torch.from_numpy(a).to(dt))
            want = jax_.forward(jnp.asarray(a, jdt))
            assert got.dtype == dt and tuple(got.shape) == shape[:-1] + (96,)
            _close(got, want, rel)
        _close(port(a), jax_.forward(jnp.asarray(a)), 1e-5)  # numpy in, torch out


def test_quantdata_zero_size_f16_and_dequantize(qdata):
    port, jax_ = qdata
    out = port(torch.zeros((0, 128)))
    assert tuple(out.shape) == (0, 96)
    a = (np.random.default_rng(6).standard_normal((1, 128)) * 0.5).astype(np.float16)
    got = port(torch.from_numpy(a))
    assert got.dtype == torch.float16  # computed in bf16, cast back at the edge
    np.testing.assert_array_equal(_f32(got), _f32(port(torch.from_numpy(a).to(torch.bfloat16)).to(torch.float16)))
    _close(got, jax_.forward(jnp.asarray(a)), 2.0**-7)
    for dtype in ("float32", "bfloat16"):
        d = port.dequantize(dtype)
        np.testing.assert_array_equal(_f32(d), _f32(jax_.dequantize(dtype)))


def test_quantdata_double_quant_state_matches_jax():
    """A double-quantized absmax (state2/offset) decodes as in the JAX package."""
    out_f, in_f, nb = 64, 128, 64
    _, packed, absmax = _flat_quant(7, out_f, in_f)
    offset = float(absmax.mean())
    sub = np.zeros(-(-absmax.size // nb) * nb, np.float32)
    sub[: absmax.size] = absmax - offset
    sub = sub.reshape(-1, nb)
    a2 = np.abs(sub).max(axis=1)
    a2[a2 == 0] = 1.0
    code2 = np.linspace(-1, 1, 256).astype(np.float32)
    stored = np.abs((sub / a2[:, None])[:, :, None] - code2).argmin(axis=2).astype(np.uint8).reshape(-1)[: absmax.size]

    class _S2:
        absmax, code, blocksize = a2, code2, nb

    states = []
    for _ in range(2):
        s = _QuantState(stored, (out_f, in_f))
        s.state2, s.offset = _S2(), offset
        states.append(s)
    port = C.QuantData(torch.from_numpy(packed), states[0], (out_f, in_f), device="cpu")
    jax_ = J.QuantData(packed, states[1], (out_f, in_f))
    for name in ("packed", "scale"):
        np.testing.assert_array_equal(getattr(port.quant_linear, name).numpy(),
                                      np.asarray(getattr(jax_.quant_linear, "packed" if name == "packed" else
                                                         "absmax_hi")))
    x = np.eye(1, in_f, dtype=np.float32)
    _close(port(x), jax_.forward(jnp.asarray(x)), 1e-5)


def test_torchfp4linear_from_linear_matches_jax():
    """A torch nn.Linear quantized fresh (exact FP4 codes): the same bytes as
    the JAX package's, its output within the reference's error band, and
    the original layer reachable but not a submodule."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(256, 256)
    q = C.TorchFP4Linear.from_linear(lin, device="cpu")
    jq = J.TorchFP4Linear.from_linear(lin)
    assert (q.in_features, q.out_features) == (256, 256) and q.lin[0] is lin and list(q.children()) == []
    for name, jname in (("packed", "packed"), ("scale", "absmax_hi"), ("bias", "bias")):
        np.testing.assert_array_equal(getattr(q.quant_linear, name).numpy(), np.asarray(getattr(jq.quant_linear,
                                                                                                 jname)))
    assert q.quant_linear.variant == jq.quant_linear.variant == "exact"
    x = torch.randn(1, 256)
    with torch.no_grad():
        want = lin(x)
    got = q(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    err = (got - want).abs().mean().item()
    assert 0.001 < err < 0.065, err
    _close(got, jq.forward(x), 1e-5)
    assert torch.equal(q.quant_data.forward(x), got) and q.quant_data.numel == 256 * 256
    assert "TorchFP4Linear" in repr(q)


def test_torchfp4linear_rejects_weightless():
    with pytest.raises(ValueError, match="weight"):
        C.TorchFP4Linear.from_linear(object(), device="cpu")


def test_check_if_name_contained_in_list():
    assert C.check_if_name_contained_in_list("model.lm_head", ["lm_head"])
    assert not C.check_if_name_contained_in_list("model.q_proj", ["lm_head"])


def test_recursive_replace_matches_jax():
    """A tiny transformers Mistral converted by both packages: the same
    config and the same bytes in every tensor; the ignore list and the two
    refusals behave as the JAX package's."""
    transformers = pytest.importorskip("transformers")
    from test_torch_checkpoint import _assert_same
    from test_torch_transformer import flatten_jax_params

    hf_cfg = transformers.MistralConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                        tie_word_embeddings=False)
    torch.manual_seed(7)
    model = transformers.MistralForCausalLM(hf_cfg).eval()
    tcfg, tp = C.recursively_replace_with_fp4_linear(model, device="cpu")
    jcfg, jp = J.recursively_replace_with_fp4_linear(model)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    arrays, _ = flatten_jax_params(jp)
    _assert_same(arrays, tp)
    tcfg3, tp3 = C.convert_torch_model(model, ignore_layer_names=["down_proj"], device="cpu")
    assert isinstance(tp3.layers[0].w_down, L.DenseLinear) and isinstance(tp3.layers[0].w_gate, L.QuantLinear)
    with pytest.raises(ValueError, match="not.*bnb"):
        C.recursively_replace_with_fp4_linear(model, only_replace_bnb_layers=True, device="cpu")
    with pytest.raises(ValueError, match="transformers"):
        C.recursively_replace_with_fp4_linear(torch.nn.Linear(4, 4), device="cpu")
