"""Port format vs the JAX package's numpy golden: identical bytes and scales.

The port (torch_bnb_fp4_tpu_torch/ops/format.py) keeps its own copy of the
pair-K packers and rounds to bf16 with torch; the JAX package's version uses
ml_dtypes.  Both must produce the same bytes, scales and dequantized values.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.ops import format as fmt
from torch_bnb_fp4_tpu_torch.ops import format as pfmt

SHAPES = [(256, 1024), (384, 2048)]  # (N_out, K_in)


def _w(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)


def test_codebooks_and_remap_identical():
    np.testing.assert_array_equal(pfmt.FP4_CODE, fmt.FP4_CODE)
    np.testing.assert_array_equal(pfmt.NF4_CODE, fmt.NF4_CODE)
    np.testing.assert_array_equal(pfmt.RANK_REMAP, fmt.RANK_REMAP)
    assert pfmt.PAIRK_VALUE_SCALE == fmt.PAIRK_VALUE_SCALE
    for v in fmt.PAIRK_VARIANTS:
        np.testing.assert_array_equal(pfmt.pairk_code(v), fmt.pairk_code(v))


@pytest.mark.parametrize("code", ["fp4", "nf4"])
def test_quantize_codes_identical(code):
    cb = fmt.FP4_CODE if code == "fp4" else fmt.NF4_CODE
    w = _w((64, 1024), seed=1)
    w[3, :64] = 0.0  # an all-zero block
    c0, a0 = fmt.quantize_codes(w, 64, cb)
    c1, a1 = pfmt.quantize_codes(w, 64, cb)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(a1, a0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp"])
def test_pack_tpu_pairk_identical(variant, scale_dtype, shape):
    w = _w(shape, seed=2 * fmt.PAIRK_VARIANTS.index(variant) + (scale_dtype == "bfloat16"))
    jdt = np.float32 if scale_dtype == "float32" else ml_dtypes.bfloat16
    tdt = torch.float32 if scale_dtype == "float32" else torch.bfloat16
    p0, s0 = fmt.pack_tpu_pairk(w, variant=variant, scale_dtype=jdt)
    p1, s1 = pfmt.pack_tpu_pairk(w, variant=variant, scale_dtype=tdt)
    assert p1.dtype == torch.uint8 and s1.dtype == tdt
    np.testing.assert_array_equal(p1.numpy(), p0)
    np.testing.assert_array_equal(s1.float().numpy(), s0.astype(np.float32))
    np.testing.assert_array_equal(pfmt.unpack_tpu_pairk(p1, s1, variant=variant),
                                  fmt.unpack_tpu_pairk(p0, s0, variant=variant))


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_tpu_pairk_lut_nf4_identical(shape):
    w = _w(shape, seed=7)
    p0, s0 = fmt.pack_tpu_pairk_lut(w, fmt.NF4_CODE)
    p1, s1 = pfmt.pack_tpu_pairk_lut(w, fmt.NF4_CODE)
    np.testing.assert_array_equal(p1.numpy(), p0)
    np.testing.assert_array_equal(s1.numpy(), s0)
    np.testing.assert_array_equal(pfmt.unpack_tpu_pairk_lut(p1, s1, fmt.NF4_CODE),
                                  fmt.unpack_tpu_pairk_lut(p0, s0, fmt.NF4_CODE))


def test_bf16_round_matches_ml_dtypes():
    a = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 10.0 ** np.arange(-8, 8, 0.00390625)[:4096]
    np.testing.assert_array_equal(pfmt.bf16_round(a), a.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_pack_rejects_bad_input():
    with pytest.raises(ValueError):
        pfmt.pack_tpu_pairk(_w((128, 96)))
    with pytest.raises(ValueError):
        pfmt.pack_tpu_pairk(_w((128, 256)), variant="bogus")
    with pytest.raises(ValueError):
        pfmt.pack_tpu_pairk_lut(_w((128, 256)), fmt.NF4_CODE[::-1])
