"""The warpgroup-MMA K5 and K9b, held on the CPU.

K5 (csrc/matmul_w8.cu) runs K4's int8 main loop with ``w4a8_split``'s K
split, and K9b (csrc/matmul_splitk.cu, bf16 x) plans its launches in pure
Python (``k9b_plan``); here, at every instance chip_smoke.py's phases 3c and
3e run, the splits divide the work, stay within one wave of 132 SMs and are
the deepest that do.

Numbers, against the JAX package on numpy inputs:
  * K5's plain version with the kernel's K split (per-K-tile terms, then
    added to 0 in K-tile order) is bit-equal to the unsplit plain version,
    and both are within 1e-6 of max|y| of ``matmul_w8`` run in interpret
    mode, f32 output (tests/test_torch_shadow.py's tolerance: XLA contracts
    the rescale and the add into fused multiply-adds).
  * K9b's bf16 weights as its kernels decode them (``splitk_weights_plain``:
    a 256-entry byte table, an f32 multiply by the absmax, one rounding)
    equal the JAX package's ``_decode_tile`` cast to bf16 byte for byte, FP4
    and NF4; its plain version with the kernel's K split is within 2^-7 of
    max|y| of ``matmul_fp4`` in interpret mode (bf16 output rounding and f32
    order), and within 1e-5 of the unsplit plain version in f32 output.
  * The in-place x columns of a K-sharded packing (``splitk_x_columns``)
    are the columns ``_shard_reorder_x`` moves to the front, for 1, 2 and 4
    shards.

Index maps, by emulating the kernels' threads in numpy (the CUDA code cannot
run here): K5's producers write the transposed shadow tile byte for byte
into the 128-byte-swizzled [n][k] tile that wgmma reads (each 16-byte chunk
once, the 8 lanes of every store phase on 8 different positions), against
the JAX shadow's [k][n] tile; K9b's large-kernel decoder writes the hi and
lo panels likewise; K9b's small kernel's A fragments (read from the
TMA-swizzled packed box) hold, in the wgmma's fragment layout, the weights
of the columns its epilogue stores.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu.ops import format as jfmt
from torch_bnb_fp4_tpu.ops import kernels as JK
from torch_bnb_fp4_tpu_torch.models.linear import _shard_reorder_x
from torch_bnb_fp4_tpu_torch.ops import format as fmt
from torch_bnb_fp4_tpu_torch.ops import kernels as K

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its instance tables; the module imports only the standard library)

SMS = 132


def _k5_instances():
    out = set()
    for kind, m in chip_smoke.K5_INSTANCES:
        shapes = chip_smoke.UNFUSED_SHAPES if kind == "unfused" else chip_smoke.FUSED_SHAPES
        out |= {(m, k, n) for _, k, n, _ in shapes}
    return sorted(out)


def _k9b_instances():
    ms = {m for m, _ in chip_smoke.SPLITK_INSTANCES} | {1, 3, 4, 8, 9, 32, 33, 64, 128, 200, 256, 300}  # + the card tests' M
    return sorted((m, k, n) for m in ms for _, k, n, _ in chip_smoke.UNFUSED_SHAPES)


@pytest.mark.parametrize("m,k,n", _k5_instances())
def test_k5_split_at_every_phase_3c_instance(m, k, n):
    split = K.w4a8_split(m, k, n, 1024, SMS)
    tiles, nk = -(-m // K.K4_TILE) * (n // K.K4_TILE), k // 1024
    assert 1 <= split <= min(nk, K.K4_MAX_SPLIT)
    assert split == 1 if 2 * tiles > SMS else tiles * split <= SMS or split == 1  # a short grid stays in one wave
    waves = {s: -(-tiles * s // SMS) * -(-nk // s) for s in range(1, min(nk, K.K4_MAX_SPLIT) + 1)}
    if 2 * tiles <= SMS:
        assert waves[split] == min(waves.values())


def test_k5_splits_pinned():
    """M = 256: wk/wv (N = 1024) split their 4 K-tiles 4 ways, wq/wo and w_down 2, gate/up not at all."""
    assert [K.w4a8_split(256, k, n, 1024, SMS) for _, k, n, _ in chip_smoke.UNFUSED_SHAPES] == [2, 4, 1, 2]
    assert K.w4a8_split(6016, 4096, 6144, 1024, SMS) == 1


@pytest.mark.parametrize("m,k,n", _k9b_instances())
def test_k9b_plan_at_every_phase_3e_instance(m, k, n):
    plan = K.k9b_plan(m, k, n, SMS)
    nb = k // 128  # stages of 64 packed rows: two 64-row quant blocks of each half
    assert nb % plan.ksplit == 0 and 2 * (nb // plan.ksplit) >= min(K.SPLIT_MIN_BLOCKS, 2 * nb)
    assert plan.n_tiles * plan.m_tiles * plan.ksplit <= SMS or plan.ksplit == 1  # one wave at most
    if m <= K.K9B_ROWS[-1]:  # the small kernel: every x row in one block, each weight decoded once
        assert plan.m_tiles == 1 and m <= plan.rows in K.K9B_ROWS and plan.n_tiles == -(-n // plan.cols)
        most = max(1, k // (16 * m))
    else:
        assert plan.rows == plan.cols == 128 and plan.m_tiles == -(-m // 128) and plan.n_tiles == n // 128
        most = K.K9B_MAX_SPLIT
    assert plan.ksplit <= most
    deeper = [d for d in range(plan.ksplit + 1, nb + 1) if nb % d == 0 and 2 * (nb // d) >= K.SPLIT_MIN_BLOCKS]
    assert all(plan.n_tiles * plan.m_tiles * d > SMS or d > most for d in deeper)
    assert plan.n_tiles * plan.m_tiles <= K.SPLIT_COUNTERS


def test_k9b_plans_pinned():
    """Batch-1 decode on wq (16 column tiles of 256, 8 splits), wk at 128-column tiles (16 splits of 2
    stages), gate/up at 32 and
    64 rows (the small and the large kernel), a 256-row chunk's wk/wv (two M tiles, 4 splits) and w_down at
    128 rows (4 splits)."""
    assert K.k9b_plan(1, 4096, 4096, SMS) == K.TilePlan(8, 256, 8, 1, 16)
    assert K.k9b_plan(4, 4096, 1024, SMS) == K.TilePlan(8, 128, 16, 1, 8)
    assert K.k9b_plan(32, 4096, 14336, SMS) == K.TilePlan(32, 256, 2, 1, 56)
    assert K.k9b_plan(64, 4096, 14336, SMS) == K.TilePlan(128, 128, 1, 1, 112)
    assert K.k9b_plan(256, 4096, 1024, SMS) == K.TilePlan(128, 128, 4, 2, 8)
    assert K.k9b_plan(128, 14336, 4096, SMS) == K.TilePlan(128, 128, 4, 1, 32)


# ---- K5: the split plain version and the producers' transposed tile ----


def _shadow(k, n, bk, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    packed, scale = jfmt.pack_tpu_pairk(w, variant="ramp")
    return JK.make_int8_shadow(jnp.asarray(packed), jnp.asarray(scale), variant="ramp", block_k=bk, interpret=True)


@pytest.mark.parametrize("m,k,bk", [(256, 4096, 1024), (130, 1536, 512)])
def test_k5_split_plain_bit_equal(m, k, bk):
    n = 256
    jw8, jg = _shadow(k, n, bk, seed=m)
    rng = np.random.default_rng(m + 1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(JK.matmul_w8(jnp.asarray(x, jnp.bfloat16), jw8, jg, jnp.asarray(b), out_dtype=jnp.float32,
                                   block_k=bk, interpret=True))
    x8, rs = K.quantize_activations(torch.from_numpy(x).to(torch.bfloat16), bk)
    w8, g = torch.from_numpy(np.array(jw8)), torch.from_numpy(np.array(jg))
    kw = dict(out_dtype=torch.float32, block_k=bk)
    whole = K.matmul_w8_plain(x8, rs, w8, g, torch.from_numpy(b), **kw)
    np.testing.assert_array_less(np.abs(whole.numpy() - want), 1e-6 * np.abs(want).max())
    for split in range(2, k // bk + 1):
        assert torch.equal(K.matmul_w8_plain(x8, rs, w8, g, torch.from_numpy(b), split=split, **kw), whole)
    with pytest.raises(ValueError, match="split"):
        K.matmul_w8_plain(x8, rs, w8, g, split=k // bk + 1, **kw)


def _byte_perm(x, y, s):
    """__byte_perm on uint32 numpy arrays (selector nibbles 0-7, no sign mode)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        sel = (np.asarray(s) >> (4 * i)) & 7
        out |= np.choose(sel, src) << (8 * i)
    return out


def _sw128(row, chunk):
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _unswizzle(image, rows, row_bytes=128):
    """[rows][128 bytes] in the 128-byte swizzle -> plain rows."""
    out = np.empty((rows, row_bytes), np.uint8)
    for r in range(rows):
        for c in range(8):
            out[r, 16 * c:16 * c + 16] = image[_sw128(r, c):_sw128(r, c) + 16]
    return out


def _check_store_phases(addrs):
    """addrs[lane] of one 16-byte store instruction of a warp: the 8 lanes of each phase on 8 positions."""
    for ph in range(4):
        assert len({(a >> 4) & 7 for a in addrs[8 * ph:8 * ph + 8]}) == 8


def test_k5_producer_tile_equals_jax_shadow_tile():
    jw8, _ = _shadow(1024, 256, 1024, seed=7)
    w8 = np.asarray(jw8).view(np.uint8)
    for kb, n0 in ((0, 0), (384, 128), (896, 128)):  # a few [128 k][128 n] tiles of the shadow
        raw = np.ascontiguousarray(w8[kb:kb + 128, n0:n0 + 128])
        words = raw.view(np.uint32)  # [128 k][32 words]: word l = columns 4l..4l+3
        image, written = np.zeros(128 * 128, np.uint8), np.zeros(1024, int)
        for kq in range(8):  # producer warp kq, lanes l: as csrc/matmul_w8.cu
            lanes = np.arange(32)
            rot = (lanes >> 1) & 3
            c = [(rot + i) & 3 for i in range(4)]
            sel_a = c[0] | (c[0] + 4) << 4 | c[1] << 8 | (c[1] + 4) << 12
            sel_b = c[2] | (c[2] + 4) << 4 | c[3] << 8 | (c[3] + 4) << 12
            w = np.zeros((4, 4, 32), np.uint32)
            for q in range(4):
                r = [words[16 * kq + 4 * q + i, lanes] for i in range(4)]
                t0, t1 = _byte_perm(r[0], r[1], sel_a), _byte_perm(r[2], r[3], sel_a)
                t2, t3 = _byte_perm(r[0], r[1], sel_b), _byte_perm(r[2], r[3], sel_b)
                w[0, q], w[1, q] = _byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632)
                w[2, q], w[3, q] = _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)
            for j in range(4):
                addrs = [_sw128(4 * l + ((rot[l] + j) & 3), kq) for l in lanes]
                _check_store_phases(addrs)
                for l, a in enumerate(addrs):
                    image[a:a + 16] = np.array([w[j, q, l] for q in range(4)], np.uint32).view(np.uint8)
                    written[a >> 4] += 1
        assert (written == 1).all()
        np.testing.assert_array_equal(_unswizzle(image, 128), raw.T)  # [n][k] = the shadow tile transposed


# ---- K9b: the decode, the split plain version, the shard columns ----


def _splitk_operands(k, n, seed, m=1):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    hi, lo = ((rng.random((k // 128, n)) + 0.5).astype(np.float32) * 0.01 for _ in range(2))
    x = rng.standard_normal((m, k)).astype(np.float32)
    return packed, hi, lo, x


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
def test_k9b_decoded_tile_equals_jax_decode_tile(qt):
    cb = None if qt == "fp4" else fmt.NF4_CODE
    packed, hi, lo, _ = _splitk_operands(512, 256, seed=3)
    hi[0, :7] = 0.0  # blocks of zeros
    w_hi, w_lo = JK._decode_tile(jnp.asarray(packed), JK.make_code_table(cb), jnp.asarray(hi), jnp.asarray(lo), 64,
                                 "gather")
    got = K.splitk_weights_plain(torch.from_numpy(packed), torch.from_numpy(hi), torch.from_numpy(lo),
                                 K.code_table(cb, "cpu"))
    for g, w in zip(got, (w_hi, w_lo)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), np.asarray(w.astype(jnp.bfloat16)).view(np.int16))


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("m", [1, 9, 130])
def test_k9b_split_plain_matches_jax(m, qt):
    k, n = 2048, 256
    cb = None if qt == "fp4" else fmt.NF4_CODE
    packed, hi, lo, x = _splitk_operands(k, n, seed=m, m=m)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    want = np.asarray(JK.matmul_fp4(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed),
                                    (jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(b), cb, interpret=True),
                      np.float32)
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed), torch.from_numpy(hi),
            torch.from_numpy(lo), torch.from_numpy(b), K.code_table(cb, "cpu"))
    whole = K.matmul_splitk_plain(*args, out_dtype=torch.float32)
    for split in (K.k9b_plan(m, k, n, SMS).ksplit, 2, 4):
        got = K.matmul_splitk_plain(*args, out_dtype=torch.bfloat16, ksplit=split).float().numpy()
        np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want).max())
        f32 = K.matmul_splitk_plain(*args, out_dtype=torch.float32, ksplit=split)
        assert (f32 - whole).abs().max() <= 1e-5 * whole.abs().max()
    with pytest.raises(ValueError, match="ksplit"):
        K.matmul_splitk_plain(*args, out_dtype=torch.float32, ksplit=3)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_columns_equal_the_reorder(shards):
    k = 2048
    hi, lo = K.splitk_x_columns(k // 2, shards)
    order = _shard_reorder_x(torch.arange(k)[None, :], shards)[0]
    assert torch.equal(torch.cat([hi, lo]), order)
    packed, shi, slo, x = _splitk_operands(k, 128, seed=shards, m=3)
    args = (torch.from_numpy(packed), torch.from_numpy(shi), torch.from_numpy(slo), None, K.code_table(None, "cpu"))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(K.matmul_splitk(xt, *args, out_dtype=torch.float32, k_shards=shards),
                               K.matmul_splitk(_shard_reorder_x(xt, shards), *args, out_dtype=torch.float32),
                               rtol=0, atol=0)


# ---- K9b: the kernels' index maps ----


def test_k9b_small_kernel_fragments_hold_the_epilogue_columns():
    """One box (128 columns, 8 warps: two of the small kernel's warpgroups) of one stage: lane (g, t) of
    warp w loads its 2 columns' packed rows from the TMA-swizzled box with 16-bit loads, decodes them
    through the per-lane byte table and builds the A fragments of its warpgroup's hi and lo wgmmas; the A
    matrices rebuilt from the fragment layout are the decoded weights of the columns its epilogue stores
    (column 16w + 2g <-> A row 16 (w % 4) + g, the next column <-> row + 8)."""
    packed, hi, lo, _ = _splitk_operands(256, 128, seed=11)
    raw = packed[0:64]  # the first 64-row absmax block
    box = np.zeros(64 * 128, np.uint8)
    for r in range(64):  # TMA's 128-byte swizzle
        for c in range(8):
            box[_sw128(r, c):_sw128(r, c) + 16] = raw[r, 16 * c:16 * c + 16]
    tab = K.code_table(fmt.NF4_CODE, "cpu").numpy()
    byte = np.arange(256)
    table = np.stack([tab[byte >> 4], tab[byte & 15]], 1).astype(np.float32)  # one lane's copy
    w_hi, w_lo = (w.float().numpy() for w in K.splitk_weights_plain(
        torch.from_numpy(packed), torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(tab)))

    def bf16(v):
        return torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float().numpy()

    col_of = np.zeros((2, 64), int)  # output column of each A row of the two warpgroups
    for q in range(4):  # k16 steps
        amats = np.zeros((2, 2, 64, 16), np.float32)  # [warpgroup][hi, lo][A row][k]
        for w in range(8):
            wg = w >> 2
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                col, chunk, boff = 16 * w + 2 * g, w & 7, 2 * g
                hv, lv = np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32)
                for r in range(4):
                    row = 16 * q + 2 * t + (r & 1) + 8 * (r >> 1)
                    a = row * 128 + ((chunk ^ (row & 7)) << 4) + boff
                    for j in range(2):
                        pair = table[box[a + j]]
                        hv[r, j] = np.float32(pair[0] * hi[0, col + j])
                        lv[r, j] = np.float32(pair[1] * lo[0, col + j])
                ra = 16 * (w & 3) + g
                for f, v in ((0, hv), (1, lv)):  # A fragment regs (a0..a3) -> A[row][k]
                    amats[wg, f, ra, 2 * t:2 * t + 2] = bf16([v[0, 0], v[1, 0]])
                    amats[wg, f, ra + 8, 2 * t:2 * t + 2] = bf16([v[0, 1], v[1, 1]])
                    amats[wg, f, ra, 2 * t + 8:2 * t + 10] = bf16([v[2, 0], v[3, 0]])
                    amats[wg, f, ra + 8, 2 * t + 8:2 * t + 10] = bf16([v[2, 1], v[3, 1]])
                col_of[wg, ra], col_of[wg, ra + 8] = col, col + 1
        for wg in range(2):
            for f, w_half in ((0, w_hi), (1, w_lo)):
                want = w_half[16 * q:16 * q + 16, col_of[wg]].T  # A row i = column col_of[i], k = packed row
                np.testing.assert_array_equal(amats[wg, f], want)
    # the epilogue: d element 4j + e is A row 16 (w % 4) + g + 8 (e >> 1) -> columns c (d[4j + h]), c + 1
    assert sorted(col_of.ravel()) == list(range(128))


def test_k9b_large_decoder_panels_equal_the_decoded_tile():
    packed, hi, lo, _ = _splitk_operands(256, 128, seed=13)
    tab = K.code_table(None, "cpu").numpy()
    raw = packed[64:128]  # absmax block 1
    words = np.ascontiguousarray(raw).view(np.uint32)  # [64 rows][32 words]
    panels = {"hi": np.zeros(128 * 128, np.uint8), "lo": np.zeros(128 * 128, np.uint8)}
    for rq in range(8):  # decoding warp rq (two warpgroups), lanes cg: as csrc/matmul_splitk.cu's large kernel
        for jj in range(4):
            addrs = {"hi": [], "lo": []}  # one 16-byte store instruction each
            for cg in range(32):
                rot = (cg >> 1) & 3
                j = (jj + rot) & 3
                c = 4 * cg + j
                vals = {"hi": [], "lo": []}
                for p in range(8):
                    byte = (int(words[8 * rq + p, cg]) >> (8 * j)) & 0xFF
                    vals["hi"].append(np.float32(tab[byte >> 4] * hi[1, c]))
                    vals["lo"].append(np.float32(tab[byte & 15] * lo[1, c]))
                for half, v in vals.items():
                    a = _sw128(c, rq)
                    panels[half][a:a + 16] = torch.tensor(v).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8)
                    addrs[half].append(a)
            for store in addrs.values():
                _check_store_phases(store)
    w_hi, w_lo = K.splitk_weights_plain(torch.from_numpy(packed), torch.from_numpy(hi), torch.from_numpy(lo),
                                        torch.from_numpy(tab))
    for half, w in (("hi", w_hi), ("lo", w_lo)):
        got = _unswizzle(panels[half], 128).view(np.int16)  # [128 n][64 k] bf16
        np.testing.assert_array_equal(got, w[64:128].view(torch.int16).numpy().T)
