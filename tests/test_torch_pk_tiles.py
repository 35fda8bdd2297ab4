"""The partitions of the warpgroup-MMA K2 and K3, held on the CPU.

K2 (csrc/matmul_pk.cu, bf16 x) and K3 (csrc/matmul_pk_minner.cu) plan their
launches in pure Python (``ops/kernels.py::k2_plan``, ``k3_plan``): here, at
every instance chip_smoke.py's phases 3 and 3d run, the K split divides the
quant blocks, one block covers every row of x, and the grid takes the
deepest split that stays within one wave of 132 SMs and keeps
SPLIT_MIN_BLOCKS quant blocks a split (K2: and whose f32 partials move no
more bytes than the packed weights).  (The block's shared memory is the
kernels' own layout, read from them on the card by tests/test_torch_cuda.py.)

K2 may split K into contiguous ranges whose f32 partials the last block of a
tile sums in range order; its plain version takes the same split.  Here: the
split plain version against the JAX package's Pallas kernel in interpret mode
(``matmul_fp4_pk`` with ``a8=False``, as tests/test_torch_kernels.py runs it;
the same tolerance, |dy| <= 2^-7 * max|y| for bf16 output) and against the
unsplit plain version (f32 output: only the order of f32 sums differs,
|dy| <= 1e-5 * max|y|).

K3's producer warpgroup decodes each packed byte and prescales the pair with
one bf16 multiply by the duplicated bf16 scale; built that way in torch ops,
the tile equals the TPU kernel's prescaled tile byte for byte: the JAX
package's ``_pairs_weight_tile`` of each quant block times its bf16 scale row
in bf16 (``_matmul_pk_minner_kernel``'s prologue), in a Pallas kernel run in
interpret mode.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu.ops import kernels as JK
from torch_bnb_fp4_tpu_torch.ops import format as fmt
from torch_bnb_fp4_tpu_torch.ops import kernels as K

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its instance tables; the module imports only the standard library)

SMS = 132


def _instances():
    """(kernel, M, K, N) of every K2/K3 instance of chip_smoke.py's phases 3 and 3d."""
    out = set()
    for kname, m, run in chip_smoke.PK_INSTANCES:
        shapes = chip_smoke.UNFUSED_SHAPES if run in chip_smoke.UNFUSED_RUNS else chip_smoke.FUSED_SHAPES
        out |= {(kname, m, k, n) for _, k, n, _ in shapes if kname in ("K2", "K3")}
    for kname, m, run in chip_smoke.EXPERT_INSTANCES:
        shapes = chip_smoke.MOE_UNFUSED_SHAPES if run == "moe_served" else chip_smoke.MOE_FUSED_SHAPES
        out |= {(kname, m, k, n) for _, k, n, _ in shapes if kname in ("K2", "K3")}
    return sorted(out)


@pytest.mark.parametrize("kname,m,k,n", _instances())
def test_plan_at_every_phase_3_instance(kname, m, k, n):
    plan = (K.k2_plan if kname == "K2" else K.k3_plan)(m, k, n, SMS)
    nb = k // 64
    assert nb % plan.ksplit == 0 and nb // plan.ksplit >= K.SPLIT_MIN_BLOCKS
    assert plan.m_tiles == 1 and plan.rows >= m  # every weight decoded once per call
    assert plan.n_tiles == -(-n // plan.cols)
    assert plan.n_tiles * plan.ksplit <= SMS or plan.ksplit == 1  # one wave at most
    most = k // (16 * m) if kname == "K2" else nb  # K2: the partials move no more bytes than the weights
    assert plan.ksplit <= max(1, most)
    deeper = [d for d in range(plan.ksplit + 1, nb + 1) if nb % d == 0 and nb // d >= K.SPLIT_MIN_BLOCKS]
    assert all(plan.n_tiles * d > SMS or d > most for d in deeper)  # the deepest split that stays in both
    assert plan.n_tiles * plan.m_tiles <= K.SPLIT_COUNTERS


def test_plans_pinned():
    """The decode step's qkv at M = 1, the 128-row bucket's gate|up, K3 at 224
    rows on o, and a lut bucket of 600 rows (three 256-row M tiles)."""
    assert K.k2_plan(1, 4096, 6144, SMS) == K.TilePlan(8, 256, 4, 1, 24)
    assert K.k2_plan(128, 4096, 28672, SMS) == K.TilePlan(128, 128, 1, 1, 224)
    assert K.k2_plan(17, 14336, 4096, SMS).rows == 32
    assert K.k3_plan(224, 4096, 4096, SMS) == K.TilePlan(256, 128, 4, 1, 32)
    assert K.k3_plan(600, 4096, 4096, SMS).m_tiles == 3
    assert K.fill_split(1, 16, SMS) == 4 and K.fill_split(200, 64, SMS) == 1
    assert K.fill_split(7, 3, SMS) == 1  # 3 quant blocks: never split


def _pack(n, k, variant, seed):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.02).astype(np.float32)
    return jfmt.pack_tpu_pairk(w, variant=variant)


@pytest.mark.parametrize("ksplit", ["plan", 2, 16])
@pytest.mark.parametrize("m", [1, 8, 100])
def test_k2_split_plain_matches_jax(m, ksplit):
    k, n, variant = 1024, 256, "ramp"
    packed, scale = _pack(n, k, variant, seed=m)
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(np.float32)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    split = K.k2_plan(m, k, n, SMS).ksplit if ksplit == "plan" else ksplit
    want = np.asarray(JK.matmul_fp4_pk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(scale),
                                       jnp.asarray(b), variant=variant, a8=False, interpret=True), np.float32)
    got = K.matmul_pk_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(scale),
                            torch.from_numpy(b), variant=variant, ksplit=split).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("variant", ["exact", "lut"])
def test_k2_split_plain_matches_unsplit(variant):
    rng = np.random.default_rng(3)
    k, n, m = 2048, 384, 5
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    scale = torch.from_numpy(((rng.random((k // 64, n)) + 0.5) * (0.01 / 192)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    lut = K.make_pairk_lut(fmt.NF4_CODE) if variant == "lut" else None
    kw = dict(variant=variant, out_dtype=torch.float32)
    want = K.matmul_pk_plain(x, packed, scale, None, lut, **kw)
    for split in (2, 4, 8, 32):
        got = K.matmul_pk_plain(x, packed, scale, None, lut, ksplit=split, **kw)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(ValueError, match="ksplit"):
        K.matmul_pk_plain(x, packed, scale, None, lut, ksplit=3, **kw)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp", "lut"])
def test_k3_producer_tile_equals_prescaled_tile(variant, scale_dtype):
    rng = np.random.default_rng(11)
    k, n = 512, 256
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    scale = torch.from_numpy(((rng.random((k // 64, n)) + 0.5) * (0.01 / 192)).astype(np.float32)).to(scale_dtype)
    lut = K.make_pairk_lut(fmt.NF4_CODE) if variant == "lut" else None
    got = K.minner_weights_plain(packed, scale, lut, variant=variant)

    def prescale(tab_ref, p_ref, s_ref, w_ref):  # as _matmul_pk_minner_kernel fills its weight tile
        for b in range(k // 64):
            w = JK._pairs_weight_tile(p_ref.at[pl.ds(b * 32, 32), :], jnp.bfloat16, variant, tab_ref)
            w_ref[pl.ds(b * 64, 64), :] = w * s_ref[b][None, :].astype(jnp.bfloat16)

    jscale = jnp.asarray(scale.float().numpy(), jnp.bfloat16 if scale_dtype == torch.bfloat16 else jnp.float32)
    want = pl.pallas_call(prescale, out_shape=jax.ShapeDtypeStruct((k, n), jnp.bfloat16), interpret=True)(
        JK.make_pairk_lut(fmt.NF4_CODE), jnp.asarray(packed.numpy()), jscale)
    assert got.dtype == torch.bfloat16 and got.shape == (k, n)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
