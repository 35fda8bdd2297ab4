"""Plain versions of the port's kernels K1-K4 vs the JAX package's Pallas
kernels (interpret mode on the CPU), on the same seeded numpy inputs.

Tolerances:
  * K1 decode: bit-exact.
  * f32 input: |dy| <= 1e-5 * max|y_ref| (f32 summation order only).
  * bf16 output: |dy| <= 2^-7 * max|y_ref| (bf16 rounding of the output plus
    f32 summation order can flip the last bf16 bit of an element).
  * K4 (a8 vs a8): the int8 quantization and the int32 dots are exact, so
    only the f32 rescale order and the bf16 output rounding differ: at most 1
    bf16 ulp of each element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.ops import format as fmt
from torch_bnb_fp4_tpu.ops import kernels as JK
from torch_bnb_fp4_tpu_torch.ops import kernels as K

VARIANTS = ["exact", "zramp", "ramp"]


def _pack(n, k, variant, seed=0, scale_dtype=np.float32):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.02).astype(np.float32)
    return fmt.pack_tpu_pairk(w, variant=variant, scale_dtype=scale_dtype)


def _x(m, k, seed=1):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)


def _to_t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32) if dtype is not None else np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _close_bf16(y, y_ref):
    y, y_ref = np.asarray(y, np.float32), np.asarray(y_ref, np.float32)
    assert y.shape == y_ref.shape
    np.testing.assert_array_less(np.abs(y - y_ref), 2.0**-7 * np.abs(y_ref).max() + 1e-30)


def _close_f32(y, y_ref):
    y, y_ref = np.asarray(y, np.float32), np.asarray(y_ref, np.float32)
    assert y.shape == y_ref.shape
    np.testing.assert_array_less(np.abs(y - y_ref), 1e-5 * np.abs(y_ref).max() + 1e-30)


@pytest.mark.parametrize("variant", VARIANTS)
def test_k1_decode_plain_bit_exact(variant):
    b = np.arange(256, dtype=np.int32).reshape(2, 128)
    want = np.asarray(JK._decode_pairs(jnp.asarray(b), variant))
    got = K.decode_pairs_plain(torch.from_numpy(b.astype(np.uint8)), variant).numpy()
    np.testing.assert_array_equal(got, want)


def test_k1_lut_decode_bit_exact():
    jtab = np.asarray(JK.make_pairk_lut(fmt.NF4_CODE))[0, :16]
    lut = K.make_pairk_lut(fmt.NF4_CODE)
    np.testing.assert_array_equal(lut.numpy().astype(np.int64) & 0xFFFF, jtab)
    b = np.arange(256, dtype=np.int64)
    want = (jtab[b & 0xF] | (jtab[b >> 4] << 16)).astype(np.uint32).view(np.int32)
    got = K.decode_pairs_plain(torch.from_numpy(b.astype(np.uint8)), "lut", lut).numpy()
    np.testing.assert_array_equal(got, want)
    # the CPU tensor path of the wrapper is the plain version
    np.testing.assert_array_equal(K.decode_pairs(torch.from_numpy(b.astype(np.uint8)), "lut", lut).numpy(), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pairs_weight_tile_matches_golden(variant):
    packed, _ = _pack(128, 1024, variant)
    ones = np.full((1024 // 64, 128), 1.0 / 192.0, np.float32)
    tile = K.pairs_weight_tile(torch.from_numpy(packed), variant).float().numpy() / 192.0
    np.testing.assert_array_equal(tile, fmt.unpack_tpu_pairk(packed, ones, variant=variant))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 8])
def test_k2_plain_matches_jax(m, dtype, bias):
    k, n, variant = 2048, 384, "ramp"
    packed, scale = _pack(n, k, variant, seed=m)
    x = _x(m, k)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32) if bias else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = (jnp.asarray(x, jdt), jnp.asarray(packed), jnp.asarray(scale), None if b is None else jnp.asarray(b))
    if m == 1:
        want = JK.gemv_fp4_pk(*jargs, variant=variant, interpret=True)
    else:
        want = JK.matmul_fp4_pk(*jargs, variant=variant, interpret=True)
    tdt = getattr(torch, dtype)
    assert K.select_path(m, tdt, variant, None) == "mouter"
    targs = (_to_t(x, tdt), torch.from_numpy(packed), torch.from_numpy(scale), None if b is None else _to_t(b))
    got = (K.gemv_fp4_pk if m == 1 else K.matmul_fp4_pk)(*targs, variant=variant)
    assert got.dtype == tdt
    (_close_bf16 if dtype == "bfloat16" else _close_f32)(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("variant", ["exact", "ramp"])
def test_k2_bf16_scales_and_f16_input(variant):
    """bf16 scales (compact checkpoints); f16 input computes in bf16 and
    returns f16, as in the JAX package."""
    k, n, m = 1024, 256, 4
    packed, scale = _pack(n, k, variant, seed=11, scale_dtype=jnp.bfloat16)
    x = _x(m, k, seed=12)
    want = JK.matmul_fp4_pk(jnp.asarray(x, jnp.float16), jnp.asarray(packed), jnp.asarray(scale),
                            variant=variant, interpret=True)
    got = K.matmul_fp4_pk(_to_t(x, torch.float16), torch.from_numpy(packed),
                          torch.from_numpy(scale.astype(np.float32)).to(torch.bfloat16), variant=variant)
    assert got.dtype == torch.float16
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("bias", [False, True])
def test_k3_plain_matches_jax(bias):
    k, n, m, variant = 1024, 256, 160, "exact"
    packed, scale = _pack(n, k, variant, seed=3)
    x = _x(m, k, seed=4)
    b = np.random.default_rng(6).standard_normal(n).astype(np.float32) if bias else None
    want = JK.matmul_fp4_pk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(scale),
                            None if b is None else jnp.asarray(b), variant=variant, a8=False, interpret=True)
    assert K.select_path(m, torch.bfloat16, variant, False) == "minner"
    got = K.matmul_fp4_pk(_to_t(x, torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(scale),
                          None if b is None else _to_t(b), variant=variant, a8=False)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))


def test_k3_f32_plain_matches_jax():
    """f32 input above 256 rows takes the m-inner kernel with f32 math."""
    k, n, m, variant = 1024, 256, 264, "zramp"
    packed, scale = _pack(n, k, variant, seed=8)
    x = _x(m, k, seed=9)
    want = JK.matmul_fp4_pk(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), variant=variant,
                            interpret=True)
    assert K.select_path(m, torch.float32, variant, None) == "minner"
    got = K.matmul_fp4_pk(_to_t(x, torch.float32), torch.from_numpy(packed), torch.from_numpy(scale),
                          variant=variant)
    _close_f32(got.numpy(), np.asarray(want, np.float32))


def _ulp_bf16(a):
    a = np.abs(np.asarray(a, np.float32))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("variant", VARIANTS)
def test_k4_plain_matches_jax_a8(variant):
    k, n, m = 2048, 256, 256
    packed, scale = _pack(n, k, variant, seed=21)
    x = _x(m, k, seed=22)
    x[5] = 0.0  # an all-zero activation row (r -> 1)
    b = np.random.default_rng(23).standard_normal(n).astype(np.float32)
    want = np.asarray(JK.matmul_fp4_pk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(scale),
                                       jnp.asarray(b), variant=variant, a8=True, interpret=True), np.float32)
    assert K.select_path(m, torch.bfloat16, variant, None) == "w4a8"
    got = K.matmul_fp4_pk(_to_t(x, torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(scale), _to_t(b),
                          variant=variant).float().numpy()
    np.testing.assert_array_less(np.abs(got - want), _ulp_bf16(want) * 1.0001 + 1e-30)


def test_k4_activation_quantization_matches_jax():
    """x8 / rs of the w4a8 path: same int8 values and f32 scales as the JAX
    package's XLA prologue (:1143-1147)."""
    x = _x(16, 2048, seed=31).astype(np.float32)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    xr = jnp.asarray(xb).reshape(16, 2, 1024)
    r = jnp.max(jnp.abs(xr), axis=2)
    r = jnp.where(r == 0.0, 1.0, r)
    x8_ref = np.asarray(jnp.round(xr * (127.0 / r)[:, :, None]).astype(jnp.int8).reshape(16, 2048))
    x8, rs = K.quantize_activations(torch.from_numpy(xb), 1024)
    np.testing.assert_array_equal(x8.numpy(), x8_ref)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(r * (1.0 / 127.0)))


@pytest.mark.parametrize(
    "m,dtype,variant,a8,path",
    [
        (1, torch.bfloat16, "ramp", None, "mouter"),
        (128, torch.bfloat16, "ramp", None, "mouter"),
        (129, torch.bfloat16, "ramp", None, "minner"),
        (255, torch.bfloat16, "exact", None, "minner"),
        (256, torch.bfloat16, "zramp", None, "w4a8"),
        (6000, torch.bfloat16, "ramp", None, "w4a8"),
        (256, torch.bfloat16, "ramp", False, "minner"),
        (8, torch.bfloat16, "ramp", True, "w4a8"),
        (128, torch.bfloat16, "lut", None, "mouter"),
        (129, torch.bfloat16, "lut", None, "minner"),
        (4096, torch.bfloat16, "lut", None, "minner"),
        (256, torch.float32, "ramp", None, "mouter"),
        (257, torch.float32, "ramp", None, "minner"),
    ],
)
def test_path_choice_table(m, dtype, variant, a8, path):
    assert K.select_path(m, dtype, variant, a8) == path


def test_a8_rejected_for_f32_and_lut():
    with pytest.raises(ValueError):
        K.select_path(300, torch.float32, "ramp", True)
    with pytest.raises(ValueError):
        K.select_path(300, torch.bfloat16, "lut", True)


@pytest.mark.parametrize("k,scale_dtype,want", [(4096, torch.float32, 1024), (14336, torch.float32, 1024),
                                                (14336, torch.bfloat16, 1024), (1536, torch.float32, 512),
                                                (768, torch.float32, 768)])
def test_a8_block_k_matches_jax_resolution(k, scale_dtype, want):
    sq = 16 if scale_dtype == torch.bfloat16 else 8
    assert K.a8_block_k(k, scale_dtype) == JK._k_block_pairk(k, 1024, 64, sq) == want


def test_cpu_tensors_never_count_launches():
    K.reset_launch_counts()
    packed, scale = _pack(128, 1024, "ramp")
    x = torch.from_numpy(_x(2, 1024)).to(torch.bfloat16)
    K.matmul_fp4_pk(x, torch.from_numpy(packed), torch.from_numpy(scale), variant="ramp")
    assert K.launch_counts() == {k: 0 for k in K.LAUNCHES}
