"""The port's CUDA kernels against their plain PyTorch versions ON THE CARD.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc and skips without
them (the decision is taken inside the fixture, never at import).  Run on a
machine with an H100:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(--noconftest skips tests/conftest.py, which configures JAX; the port and
these tests need no JAX.)

Tolerances as in tests/test_torch_kernels.py: K1 bit-exact; bf16 (and f16) outputs
|dy| <= 2^-7 * max|y_plain|; f32 |dy| <= 1e-5 * max|y_plain|; K4 at most one
bf16 ulp per element (its int8 dots are exact on both sides), and K5 the same
(f32 out within 1e-6 of max|y|).  K8 (the expert forms of K2-K4) bit-equal
to the 2-D kernel on the same expert, and within K2-K4's tolerances of its
plain version.  K6 and the int8 shadow built on the card:
bit-exact with the plain versions on the CPU.  K7 against its
plain version with the kernel's key blocks: |do| <= 2^-7 * max|o_plain| of
its (query, head) row (bf16 output rounding, and the bf16 rounding of p after
exp and summation orders that differ).  K10 against its plain version with
the kernel's key ranges: one bf16 ulp of max|o_plain| of its (slot, head)
row (p stays f32 on both sides; only the order of the f32 sums differs).
"""

import numpy as np
import pytest
import torch

from torch_bnb_fp4_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, dev, seed=0, scale_dtype=torch.float32, x_dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (k // 2, n), generator=g, dtype=torch.uint8, device=dev)
    scale = ((torch.rand((k // 64, n), generator=g, device=dev) + 0.5) * (0.01 / 192)).to(scale_dtype)
    x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
    bias = torch.randn((n,), generator=g, device=dev)
    return x, packed, scale, bias


def _close(y, y_ref, rel):
    y, y_ref = y.float(), y_ref.float()
    assert torch.isfinite(y).all()
    err = (y - y_ref).abs().max().item()
    assert err <= rel * y_ref.abs().max().item(), (err, y_ref.abs().max().item())


def test_build_reports_no_spills(dev):
    from torch_bnb_fp4_tpu_torch.ops import _build

    _build.build_all()
    for src in _build.SOURCES:
        _build.kernel(src)
    print("\n".join(line for log in _build.build_log.values() for line in log.splitlines() if "spill" in line
                    or "registers" in line))


@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp", "lut"])
def test_k1_bit_exact(dev, variant):
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8).to(dev).reshape(2, 128)
    lut = K.make_pairk_lut(np.linspace(-1.0, 1.0, 16, dtype=np.float32), dev) if variant == "lut" else None
    got = K.decode_pairs(b, variant, lut)
    torch.testing.assert_close(got, K.decode_pairs_plain(b, variant, lut), rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["exact", "ramp"])
@pytest.mark.parametrize("m", [1, 3, 8, 16, 17, 32, 64, 128])
@pytest.mark.parametrize("k,n", [(4096, 6144), (14336, 4096)])
def test_k2_vs_plain(dev, k, n, m, variant):
    x, packed, scale, bias = _operands(m, k, n, dev, seed=m)
    got = K.matmul_pk(x, packed, scale, bias, variant=variant)
    _close(got, K.matmul_pk_plain(x, packed, scale, bias, variant=variant), 2.0**-7)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_k2_f32_input_and_scales(dev, scale_dtype, m):
    x, packed, scale, bias = _operands(m, 4096, 1024, dev, scale_dtype=scale_dtype, x_dtype=torch.float32)
    got = K.matmul_pk(x, packed, scale, bias, variant="zramp")
    _close(got, K.matmul_pk_plain(x, packed, scale, bias, variant="zramp"), 1e-5)


def test_k2_lut(dev):
    x, packed, scale, _ = _operands(4, 2048, 512, dev)
    lut = K.make_pairk_lut(np.linspace(-1.0, 1.0, 16, dtype=np.float32), dev)
    _close(K.matmul_pk(x, packed, scale, None, lut, variant="lut"),
           K.matmul_pk_plain(x, packed, scale, None, lut, variant="lut"), 2.0**-7)


@pytest.mark.parametrize("m", [129, 160, 200, 224, 255, 600])
@pytest.mark.parametrize("k,n", [(4096, 28672), (14336, 4096)])
def test_k3_vs_plain(dev, k, n, m):
    x, packed, scale, bias = _operands(m, k, n, dev, seed=m)
    got = K.matmul_pk_minner(x, packed, scale, bias, variant="ramp")
    _close(got, K.matmul_pk_minner_plain(x, packed, scale, bias, variant="ramp"), 2.0**-7)


def test_k3_f32_and_lut(dev):
    x, packed, scale, bias = _operands(300, 2048, 512, dev, x_dtype=torch.float32)
    _close(K.matmul_pk_minner(x, packed, scale, bias, variant="exact"),
           K.matmul_pk_minner_plain(x, packed, scale, bias, variant="exact"), 1e-5)
    lut = K.make_pairk_lut(np.linspace(-1.0, 1.0, 16, dtype=np.float32), dev)
    xb = x.to(torch.bfloat16)
    _close(K.matmul_pk_minner(xb, packed, scale, None, lut, variant="lut"),
           K.matmul_pk_minner_plain(xb, packed, scale, None, lut, variant="lut"), 2.0**-7)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["zramp", "lut"])
@pytest.mark.parametrize("k,n", [(5632, 2048), (2048, 5632), (3584, 3584), (18944, 3584), (1024, 384)])
def test_k2_k3_other_widths(dev, k, n, variant, scale_dtype):
    """TinyLlama (5632), Qwen2 (3584, 18944) and a ragged last column tile (N
    = 384 against K2's 256-column tiles): K2 at M 1 and 64, K3 at 200, bf16
    scales and the lut variant, with a bias."""
    lut = K.make_pairk_lut(np.linspace(-1.0, 1.0, 16, dtype=np.float32), dev) if variant == "lut" else None
    for m, fn, plain in ((1, K.matmul_pk, K.matmul_pk_plain), (64, K.matmul_pk, K.matmul_pk_plain),
                         (200, K.matmul_pk_minner, K.matmul_pk_minner_plain)):
        x, packed, scale, bias = _operands(m, k, n, dev, seed=m + k, scale_dtype=scale_dtype)
        _close(fn(x, packed, scale, bias, lut, variant=variant),
               plain(x, packed, scale, bias, lut, variant=variant), 2.0**-7)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("m", [1, 8, 128, 160])
def test_k2_k3_out_dtypes_and_splits(dev, m, out_dtype):
    """f32 and f16 outputs through the unsplit epilogue (gate|up) and the
    in-kernel split merge (o: K2 at 8-16 splits, K3 at 8)."""
    fn, plain = (K.matmul_pk, K.matmul_pk_plain) if m <= 128 else (K.matmul_pk_minner, K.matmul_pk_minner_plain)
    for k, n in ((4096, 4096), (4096, 28672)):
        x, packed, scale, bias = _operands(m, k, n, dev, seed=m + n)
        got = fn(x, packed, scale, bias, variant="ramp", out_dtype=out_dtype)
        assert got.dtype == out_dtype
        _close(got, plain(x, packed, scale, bias, variant="ramp", out_dtype=out_dtype),
               1e-5 if out_dtype == torch.float32 else 2.0**-7)


@pytest.mark.parametrize("m", [1, 64])
def test_k2_graph_replay_equals_eager_twice(dev, m):
    """A K2 call with a K split (its tile counters re-armed by the kernel)
    replayed from a CUDA graph twice in a row equals the eager call, which
    equals itself; K3 likewise at 200 rows."""
    for m_, fn in ((m, K.matmul_pk), (200, K.matmul_pk_minner)):
        x, packed, scale, bias = _operands(m_, 4096, 4096, dev, seed=m_)
        plan = (K.k2_plan if fn is K.matmul_pk else K.k3_plan)(m_, 4096, 4096, K._sm_count(dev))
        assert plan.ksplit > 1
        eager = fn(x, packed, scale, bias, variant="ramp")
        assert torch.equal(fn(x, packed, scale, bias, variant="ramp"), eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(x, packed, scale, bias, variant="ramp")
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(x, packed, scale, bias, variant="ramp")
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
        assert torch.equal(fn(x, packed, scale, bias, variant="ramp"), eager)


def test_k2_k3_splits_on_two_streams_at_once(dev):
    """Split K2 and K3 calls issued on two streams at once, twenty rounds
    each, equal the eager calls: each stream merges its splits behind tile
    counters of its own."""
    ops = []
    for m, fn in ((1, K.matmul_pk), (64, K.matmul_pk), (200, K.matmul_pk_minner)):
        x, packed, scale, bias = _operands(m, 4096, 4096, dev, seed=m)
        plan = (K.k2_plan if fn is K.matmul_pk else K.k3_plan)(m, 4096, 4096, K._sm_count(dev))
        assert plan.ksplit > 1
        ops.append((fn, (x, packed, scale, bias), fn(x, packed, scale, bias, variant="ramp")))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for s, got in zip(streams, outs):
            with torch.cuda.stream(s):
                got += [fn(*args, variant="ramp") for fn, args, _ in ops]
    counters = []
    for s in streams:
        with torch.cuda.stream(s):
            counters.append(K._split_counters(dev))
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert not counters[0].any() and not counters[1].any()  # every tile's last block re-armed its counter
    for got in outs:
        for i, y in enumerate(got):
            assert torch.equal(y, ops[i % len(ops)][2])


def test_k2_k3_shared_memory_fits(dev):
    """K2's bf16 kernel at every row bucket and K3's, as their kernels lay
    out shared memory, take at most the 227 KB a block may have."""
    for rows in K.K2_ROWS:
        assert 0 < K.pk_tile_smem("K2", rows) <= 227 * 1024
    assert 0 < K.pk_tile_smem("K3") <= 227 * 1024
    assert K.pk_tile_smem("K2", 12) < 0  # no such bucket


@pytest.mark.parametrize("m", [256, 320, 700])
@pytest.mark.parametrize("k,n", [(4096, 6144), (14336, 4096)])
def test_k4_vs_plain(dev, k, n, m):
    x, packed, scale, bias = _operands(m, k, n, dev, seed=m)
    bk = K.a8_block_k(k, scale.dtype)
    x8, rs = K.quantize_activations(x, bk)
    got = K.matmul_pk_w4a8(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk)
    want = K.matmul_pk_w4a8_plain(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="ramp",
                                  a8_block_k=bk).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert ((got.float() - want).abs() <= ulp * 1.0001).all()


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp"])
@pytest.mark.parametrize("n", [1024, 4096, 6144])
@pytest.mark.parametrize("m", [256, 300, 700, 6016])
def test_k4_wgmma_vs_plain(dev, m, n, variant, scale_dtype):
    """The warpgroup-MMA K4 at the M of every prefill bucket and chunk and
    the N of wk|wv, wq|wo and qkv (split and unsplit grids): one bf16 ulp
    of its plain version, with a bias and a zero-scale column."""
    x, packed, scale, bias = _operands(m, 4096, n, dev, seed=m + n, scale_dtype=scale_dtype)
    scale[:, 5] = 0
    bk = K.a8_block_k(4096, scale.dtype)
    x8, rs = K.quantize_activations(x, bk)
    got = K.matmul_pk_w4a8(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant=variant, a8_block_k=bk)
    want = K.matmul_pk_w4a8_plain(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant=variant,
                                  a8_block_k=bk)
    _ulp_close(got, want)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [256, 300])
@pytest.mark.parametrize("k,n", [(3584, 3584), (5632, 2048), (18944, 3584)])
def test_k4_k_tiles_of_the_other_presets(dev, k, n, m, scale_dtype):
    """K-tiles that are not 1024 rows: with bf16 scales the K of Gemma-2's and
    Qwen2's 3584-wide layers, TinyLlama's w_down (5632) and Qwen2's w_down
    (18944) is one whole K-tile; with f32 scales, 512 rows.  One bf16 ulp of
    the plain version, with a bias and a zero-scale column."""
    x, packed, scale, bias = _operands(m, k, n, dev, seed=k + m, scale_dtype=scale_dtype)
    scale[:, 5] = 0
    bk = K.a8_block_k(k, scale.dtype)
    assert bk == (k if scale_dtype == torch.bfloat16 else 512)
    x8, rs = K.quantize_activations(x, bk)
    got = K.matmul_pk_w4a8(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk)
    _ulp_close(got, K.matmul_pk_w4a8_plain(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="ramp",
                                           a8_block_k=bk))


@pytest.mark.parametrize("bk", [128, 384, 1536, 3072])
def test_k4_any_block_k_of_128_rows(dev, bk):
    """Any a8_block_k that is a multiple of 128 and divides K, split grids
    (N 1024 at 256 rows) included: one bf16 ulp of the plain version."""
    x, packed, scale, bias = _operands(256, 3072, 1024, dev, seed=bk)
    x8, rs = K.quantize_activations(x, bk)
    got = K.matmul_pk_w4a8(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="exact", a8_block_k=bk)
    _ulp_close(got, K.matmul_pk_w4a8_plain(x8, rs, packed, scale, bias, out_dtype=torch.bfloat16, variant="exact",
                                           a8_block_k=bk))


def test_k4_launches_at_its_register_count(dev):
    """The setmaxnreg split of K4's warpgroups needs 128 registers per thread."""
    for variant in ("exact", "zramp", "ramp"):
        assert K.w4a8_kernel_regs(variant) == K.K4_THREAD_REGS


def test_k4_split_is_bit_equal_to_unsplit(dev):
    """A K-split grid adds the same per-K-tile terms in the same order."""
    x, packed, scale, bias = _operands(256, 14336, 1024, dev, seed=3)
    bk = K.a8_block_k(14336, scale.dtype)
    x8, rs = K.quantize_activations(x, bk)
    assert K.w4a8_split(256, 14336, 1024, bk, K._sm_count(dev)) > 1
    got = K.matmul_pk_w4a8(x8, rs, packed, scale, bias, out_dtype=torch.float32, variant="ramp", a8_block_k=bk)
    rows = torch.cat([x8, torch.zeros((6016 - 256, 14336), dtype=torch.int8, device=dev)])
    rsp = torch.cat([rs, torch.ones((6016 - 256, rs.shape[1]), device=dev)])
    assert K.w4a8_split(6016, 14336, 1024, bk, K._sm_count(dev)) == 1
    whole = K.matmul_pk_w4a8(rows, rsp, packed, scale, bias, out_dtype=torch.float32, variant="ramp", a8_block_k=bk)
    assert torch.equal(got, whole[:256])


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("variant", ["exact", "zramp", "ramp", "lut"])
@pytest.mark.parametrize("k,n", [(1024, 384), (14336, 4096)])
def test_k6_bit_exact(dev, k, n, variant, out_dtype, scale_dtype):
    _, packed, scale, _ = _operands(1, k, n, dev, seed=k + n, scale_dtype=scale_dtype)
    cb = np.linspace(-1.0, 1.0, 16, dtype=np.float32) if variant == "lut" else None
    before = K.launch_counts()["dequant_pk"]
    got = K.dequantize_tpu_pk(packed, scale, cb, out_dtype=out_dtype, variant=variant)
    assert K.launch_counts()["dequant_pk"] == before + 1 and got.dtype == out_dtype
    want = K.dequantize_tpu_pk(packed.cpu(), scale.cpu(), cb, out_dtype=out_dtype, variant=variant)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["ramp", "lut"])
def test_int8_shadow_on_card_equals_cpu(dev, variant):
    _, packed, scale, _ = _operands(1, 1536, 512, dev, seed=5)
    cb = np.linspace(-1.0, 1.0, 16, dtype=np.float32) if variant == "lut" else None
    w8, g = K.make_int8_shadow(packed, scale, cb, variant=variant, block_k=512)
    w8_c, g_c = K.make_int8_shadow(packed.cpu(), scale.cpu(), cb, variant=variant, block_k=512)
    assert torch.equal(w8.cpu(), w8_c) and torch.equal(g.cpu(), g_c)


def _ulp_close(got, want):
    """At most one ulp of the output type (bf16 or f16, subnormals included)."""
    mant, min_exp = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}[want.dtype]
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))).clamp_min(min_exp) - mant)
    assert ((got - want).abs() <= ulp * 1.0001).all(), (got - want).abs().max().item()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("m,k,n,bk", [(256, 4096, 14336, 1024), (300, 1536, 512, 512), (1000, 14336, 4096, 1024)])
def test_k5_vs_plain(dev, m, k, n, bk, out_dtype, bias):
    x, packed, scale, b = _operands(m, k, n, dev, seed=m + k)
    w8, g = K.make_int8_shadow(packed, scale, variant="ramp", block_k=bk)
    x8, rs = K.quantize_activations(x, bk)
    b = b if bias else None
    before = K.launch_counts()["matmul_w8"]
    got = K.matmul_w8_int8(x8, rs, w8, g, b, out_dtype=out_dtype, block_k=bk)
    assert K.launch_counts()["matmul_w8"] == before + 1 and got.dtype == out_dtype
    want = K.matmul_w8_plain(x8, rs, w8, g, b, out_dtype=out_dtype, block_k=bk)
    torch.cuda.synchronize()
    if out_dtype == torch.float32:
        _close(got, want, 1e-6)
    else:
        _ulp_close(got, want)


@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (1, 255, 256, 300) for k, n in ((4096, 1024), (4096, 6144),
                                                                                     (14336, 4096))]
                         + [(6016, 4096, 1024), (6016, 4096, 6144)])
def test_k5_wgmma_vs_plain(dev, m, k, n):
    """The warpgroup-MMA K5 within one bf16 ulp of its plain version, any M
    (tail tiles masked), on the K-split grids of N = 1024 / 4096 up to 300
    rows and the unsplit ones."""
    x, packed, scale, b = _operands(m, k, n, dev, seed=m + n)
    w8, g = K.make_int8_shadow(packed, scale, variant="ramp", block_k=1024)
    x8, rs = K.quantize_activations(x, 1024)
    split = K.w4a8_split(m, k, n, 1024, K._sm_count(dev))
    got = K.matmul_w8_int8(x8, rs, w8, g, b, out_dtype=torch.bfloat16, block_k=1024)
    _ulp_close(got, K.matmul_w8_plain(x8, rs, w8, g, b, out_dtype=torch.bfloat16, block_k=1024, split=split))


def test_k5_launches_at_its_register_count(dev):
    """K5 shares K4's setmaxnreg split, which needs 128 registers per thread."""
    assert K.w8_kernel_regs() == K.K4_THREAD_REGS


def _graph_equals_eager_twice(fn):
    eager = fn()
    assert torch.equal(fn(), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(fn(), eager)


def _k5_k9b_split_calls(dev):
    """A split K5 call (wk/wv at 256 rows) and split K9b calls (small and large kernels) as closures."""
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    calls = []
    x, packed, scale, b = _operands(256, 4096, 1024, dev, seed=1)
    w8, g = K.make_int8_shadow(packed, scale, variant="ramp", block_k=1024)
    x8, rs = K.quantize_activations(x, 1024)
    assert K.w4a8_split(256, 4096, 1024, 1024, K._sm_count(dev)) > 1
    calls.append(lambda: K.matmul_w8_int8(x8, rs, w8, g, b, out_dtype=torch.bfloat16, block_k=1024))
    for m in (1, 64, 200):
        xs, ps, hi, lo, bs = _splitk_operands(m, 4096, 1024, dev, seed=m)
        assert K.k9b_plan(m, 4096, 1024, K._sm_count(dev)).ksplit > 1
        calls.append(lambda xs=xs, ps=ps, hi=hi, lo=lo, bs=bs: K.matmul_fp4(xs, ps, (hi, lo), bs, fmt.NF4_CODE))
    return calls


def test_k5_k9b_graph_replay_equals_eager_twice(dev):
    """Split K5 and K9b calls replayed from a CUDA graph twice equal the eager call (K9b's tile counters are
    re-armed by the kernel)."""
    for fn in _k5_k9b_split_calls(dev):
        _graph_equals_eager_twice(fn)


def test_k5_k9b_splits_on_two_streams_at_once(dev):
    """Split K5 and K9b calls issued on two streams at once, ten rounds each, equal the eager calls."""
    calls = _k5_k9b_split_calls(dev)
    eager = [fn() for fn in calls]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(10):
        for s, got in zip(streams, outs):
            with torch.cuda.stream(s):
                got += [fn() for fn in calls]
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for got in outs:
        for i, y in enumerate(got):
            assert torch.equal(y, eager[i % len(calls)])


def test_k9b_shared_memory_fits(dev):
    """K9b's bf16 kernels at every row bucket and column tile, as they lay out shared memory, take at most the
    227 KB a block may have."""
    for rows in K.K9B_ROWS:
        for cols in (128, 256):
            assert 0 < K.splitk_tile_smem(rows, cols) <= 227 * 1024
    assert 0 < K.splitk_tile_smem(128) <= 227 * 1024
    assert K.splitk_tile_smem(12, 128) < 0  # no such bucket


def test_k5_f16_input_through_the_shadow_route(dev):
    """apply_linear's shadow branch on the card vs on the CPU, f16 x."""
    from torch_bnb_fp4_tpu_torch.models import linear as L

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((768, 1500)) * 0.02).astype(np.float32)
    q = L.attach_int8_shadow(L.quantize_linear(w, device=dev))
    x = torch.from_numpy(rng.standard_normal((257, 1500)).astype(np.float32)).to(torch.float16)
    before = K.launch_counts()["matmul_w8"]
    got = q(x.to(dev))
    assert K.launch_counts()["matmul_w8"] == before + 1 and got.dtype == torch.float16
    _ulp_close(got.cpu(), L.attach_int8_shadow(q.to("cpu"))(x))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,path", [(1, "mouter"), (8, "mouter"), (64, "mouter"), (128, "mouter"), (160, "minner"),
                                    (256, "w4a8")])
@pytest.mark.parametrize("k,n", [(4096, 28672), (14336, 4096)])
def test_k8_expert_forms(dev, k, n, m, path, bias):
    """K8: the expert form of K2/K3/K4 on a stacked packing of 8 experts,
    the index in device memory, is bit-equal to the 2-D kernel on packed[e]
    and holds its plain version as K2-K4 do; the launch is counted under
    the expert name."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    packed = torch.randint(0, 256, (8, k // 2, n), generator=g, dtype=torch.uint8, device=dev)
    scale = (torch.rand((8, k // 64, n), generator=g, device=dev) + 0.5) * (0.01 / 192)
    b = torch.randn((8, n), generator=g, device=dev) if bias else None
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    assert K.select_path(m, torch.bfloat16, "ramp", None) == path
    name = {"mouter": "matmul_pk", "minner": "matmul_pk_minner", "w4a8": "matmul_pk_w4a8"}[path]
    for e in (0, 7):
        before = K.launch_counts()
        got = K.matmul_fp4_pk(x, packed, scale, b, variant="ramp", expert=idx[e])
        after = K.launch_counts()
        assert after[name + "_expert"] == before[name + "_expert"] + 1 and after[name] == before[name]
        flat = K.matmul_fp4_pk(x, packed[e], scale[e], None if b is None else b[e], variant="ramp")
        assert torch.equal(got, flat)
        assert torch.equal(K.matmul_fp4_pk(x, packed, scale, b, variant="ramp", expert=e), got)
        if path == "w4a8":
            bk = K.a8_block_k(k, scale.dtype)
            x8, rs = K.quantize_activations(x, bk)
            want = K.matmul_pk_w4a8_plain(x8, rs, packed, scale, b, out_dtype=torch.bfloat16, variant="ramp",
                                          a8_block_k=bk, expert=idx[e])
            _ulp_close(got, want)
        else:
            plain = K.matmul_pk_plain if path == "mouter" else K.matmul_pk_minner_plain
            _close(got, plain(x, packed, scale, b, variant="ramp", expert=idx[e]), 2.0**-7)


@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 4096), (4096, 28672)])
def test_k8_w4a8_form_bit_equal_with_bias(dev, k, n):
    """K8's K4 form (split and unsplit grids) with a bias: bit-equal to the
    2-D kernel on packed[e] and one bf16 ulp of the plain version."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    packed = torch.randint(0, 256, (4, k // 2, n), generator=g, dtype=torch.uint8, device=dev)
    scale = (torch.rand((4, k // 64, n), generator=g, device=dev) + 0.5) * (0.01 / 192)
    b = torch.randn((4, n), generator=g, device=dev)
    x = torch.randn((256, k), generator=g, device=dev).to(torch.bfloat16)
    bk = K.a8_block_k(k, scale.dtype)
    x8, rs = K.quantize_activations(x, bk)
    idx = torch.arange(4, dtype=torch.int32, device=dev)
    for e in (1, 3):
        got = K.matmul_pk_w4a8(x8, rs, packed, scale, b, out_dtype=torch.bfloat16, variant="ramp", a8_block_k=bk,
                               expert=idx[e])
        flat = K.matmul_pk_w4a8(x8, rs, packed[e], scale[e], b[e], out_dtype=torch.bfloat16, variant="ramp",
                                a8_block_k=bk)
        assert torch.equal(got, flat)
        _ulp_close(got, K.matmul_pk_w4a8_plain(x8, rs, packed[e], scale[e], b[e], out_dtype=torch.bfloat16,
                                               variant="ramp", a8_block_k=bk))


def test_model_cuda_matches_cpu_tiny(dev):
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    cfg = T.ModelConfig.tiny_test(n_layers=2)
    w = T.random_weights(cfg, seed=3)
    p_gpu = T.quantize_params(cfg, w, fuse=True, device=dev)
    p_cpu = T.quantize_params(cfg, w, fuse=True, device="cpu")
    prompt = torch.tensor([[i % 250 + 1 for i in range(299)]], dtype=torch.int32)
    lg_gpu, _ = T.forward(p_gpu, cfg, prompt.to(dev), T.KVCache.zeros(cfg, 1, 320, device=dev), last_only=True)
    lg_cpu, _ = T.forward(p_cpu, cfg, prompt, T.KVCache.zeros(cfg, 1, 320, device="cpu"), last_only=True)
    # 299 rows take the w4a8 path: a bf16 rounding flip of one activation can
    # move its K-tile's int8 scale, so every quantized value of the tile may
    # shift by one step (~1/127); the port on the CPU and the JAX package
    # differ by the same 1-3% at this shape
    _close(lg_gpu.cpu(), lg_cpu, 6e-2)
    assert (lg_gpu.cpu() - lg_cpu).norm() <= 3e-2 * lg_cpu.norm()


def test_moe_model_cuda_matches_cpu_tiny(dev):
    """A tiny Mixtral-style model on the card (K8) and on the CPU (plain
    versions): a 40-token prefill (all experts) and a batch-1 decode step
    (per-token dispatch); logits within 2^-7 * max, as the bf16 path."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    cfg = T.ModelConfig.tiny_test(n_layers=2, n_experts=4, experts_per_tok=2)
    w = T.random_weights(cfg, seed=3)
    p_gpu = T.quantize_params(cfg, w, fuse=True, device=dev)
    p_cpu = T.quantize_params(cfg, w, fuse=True, device="cpu")
    prompt = torch.tensor([[i % 250 + 1 for i in range(40)]], dtype=torch.int32)
    c_gpu, c_cpu = T.KVCache.zeros(cfg, 1, 48, device=dev), T.KVCache.zeros(cfg, 1, 48, device="cpu")
    K.reset_launch_counts()
    for toks in (prompt, torch.tensor([[5]], dtype=torch.int32)):
        lg_gpu, c_gpu = T.forward(p_gpu, cfg, toks.to(dev), c_gpu, last_only=True)
        lg_cpu, c_cpu = T.forward(p_cpu, cfg, toks, c_cpu, last_only=True)
        _close(lg_gpu.cpu(), lg_cpu, 2.0**-7)
    assert K.launch_counts()["matmul_pk_expert"] > 0


def test_moe_decode_step_needs_no_host_sync_and_replays_as_a_graph(dev):
    """A batch-1 MoE decode step (per-token dispatch: the expert indices stay
    in device memory) runs under set_sync_debug_mode("error") and replays
    from a CUDA graph with the eager step's logits."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    cfg = T.ModelConfig.tiny_test(n_layers=2, n_experts=4, experts_per_tok=2)
    p = T.quantize_params(cfg, T.random_weights(cfg, seed=4), fuse=True, device=dev)
    cache = T.KVCache.zeros(cfg, 1, 16, device=dev)
    _, cache = T.forward(p, cfg, torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev), cache)
    tok = torch.tensor([[7]], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager, _ = T.forward(p, cfg, tok, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        T.forward(p, cfg, tok, cache)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out, _ = T.forward(p, cfg, tok, cache)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# K7 at small shapes of the chip_smoke.py phase-3b cases: (B, Lq, Lk, Hq, Hk,
# D, lens, q_offset, window, softcap, scale)
FLASH_CASES = {
    "mistral_ring_chunk": (1, 64, 576, 32, 8, 128, 700, None, 512, None, None),
    "mistral_ring_chunk_b2_ragged": (2, 77, 640, 32, 8, 128, [700, 650], None, 512, None, None),
    "mistral_causal_prompt": (1, 400, 400, 32, 8, 128, 390, 0, 256, None, None),
    "gemma2_softcap": (1, 96, 256, 16, 8, 256, 256, None, 100, 50.0, 1.0 / 16),
    "tinyllama_mixed_lengths": (2, 128, 320, 32, 4, 64, [320, 200], None, None, None, None),
    "rows_see_no_key": (1, 80, 128, 8, 8, 128, 128, -40, None, None, None),
    "qwen2_group_7": (1, 40, 200, 28, 4, 128, 200, None, None, None, None),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_k7_vs_plain(dev, name):
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale = FLASH_CASES[name]
    ops = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + lk, device=dev)
    before = K.launch_counts()["flash_attention"]
    got = A.flash_attention(*ops, window, scale, cap)
    assert K.launch_counts()["flash_attention"] == before + 1
    split = A.kernel_split(b, lq, lk, hq, hk, K._sm_count(dev), d)
    want = A.flash_attention_plain(*ops, window, scale, cap, block_q=A.kernel_blocks(hq, hk, d)[0],
                                   block_k=A.BLOCK_K, split=split)
    torch.cuda.synchronize()
    _k7_close(got, want)
    if name == "rows_see_no_key":  # queries at positions < 0: their rows are exactly 0
        assert not got[:, :40].any() and got[:, 40:].abs().max() > 0


def _k7_close(got, want):
    """Each (query, head) row against its own max|o|: rows that see many keys
    have small |o| and would hide a dropped key tile under a global scale; a
    row that sees no key is exactly 0 on both sides."""
    d = (got.float() - want.float()).abs()
    row = want.float().abs().amax(-1, keepdim=True)
    assert bool((d <= 2.0**-7 * row).all()), (d / row.clamp_min(2.0**-126)).max().item()


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_k7_split_vs_plain(dev, name, split):
    """K7 with a given split (1: one key range; 3: three, merged by the second
    pass) against its plain version with the same split, on a strided q."""
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale = FLASH_CASES[name]
    q, k, v, qpos, valid, kpos = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + 7,
                                                 device=dev)
    qv = torch.cat([q, torch.zeros_like(q[:, :, :8])], dim=2)[:, :, :hq]  # a head-slice view
    split = min(split, -(-lk // A.BLOCK_K))
    got = A._flash_attention(qv, k, v, qpos, valid, kpos, window, scale, cap, split=split)
    want = A.flash_attention_plain(q, k, v, qpos, valid, kpos, window, scale, cap,
                                   block_q=A.kernel_blocks(hq, hk, d)[0], block_k=A.BLOCK_K, split=split)
    torch.cuda.synchronize()
    _k7_close(got, want)
    if name == "rows_see_no_key":
        assert not got[:, :40].any()


def test_k7_reads_strided_q(dev):
    """q as the model passes it: a head-slice view of the fused q|k tensor."""
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    q, k, v, qpos, valid, kpos = synth_attention(1, 130, 300, 32, 8, 128, lens=300, device=dev)
    qk = torch.cat([q, torch.zeros_like(q[:, :, :8])], dim=2)
    qv = torch.split(qk, [32, 8], dim=2)[0]
    assert not qv.is_contiguous()
    torch.testing.assert_close(A.flash_attention(qv, k, v, qpos, valid, kpos, 256),
                               A.flash_attention(q, k, v, qpos, valid, kpos, 256), rtol=0, atol=0)
    with pytest.raises(ValueError, match="tiles"):
        A.flash_attention(q, k, v, qpos, valid, kpos, block_k=128)


# K10 (decode attention): (B, rows, Hq, Hk, D, lens, window, softcap, scale, K/V dtype)
DECODE_CASES = {
    "mistral_mixed_lengths": (6, 1100, 32, 8, 128, [1, 63, 64, 65, 700, 1100], 4096, None, None, "bf16"),
    "mistral_ring_window": (3, 1088, 32, 8, 128, [2500, 2537, 1093], 1000, None, None, "bf16"),
    "gemma2_softcap": (3, 700, 16, 8, 256, [700, 350, 2], 300, 50.0, 1.0 / 16, "bf16"),
    "gemma_group_1": (2, 600, 16, 16, 256, [600, 129], None, None, None, "bf16"),
    "tinyllama_group_8": (4, 520, 32, 4, 64, [520, 1, 300, 257], None, None, None, "bf16"),
    "qwen2_group_7": (2, 800, 28, 4, 128, [800, 555], None, None, None, "bf16"),
    "fp8_kv": (4, 1100, 32, 8, 128, [1100, 2, 640, 1300], 1000, None, None, "e4m3"),
    "fp8_kv_d64": (2, 300, 16, 2, 64, [300, 77], None, None, None, "e4m3"),
}


def _decode_ops(dev, name, seed=0):
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    b, rows, hq, hk, d, lens, window, cap, scale, kv = DECODE_CASES[name]
    q, k, v, qpos, valid, kpos = synth_attention(b, 1, rows, hq, hk, d, lens=lens, seed=rows + seed, device=dev)
    if kv == "e4m3":
        k, v = T.kv_cast(k, torch.float8_e4m3fn), T.kv_cast(v, torch.float8_e4m3fn)
    return q, k, v, A.decode_keys(qpos, valid, kpos), window, cap, scale


def _k10_close(got, want):
    """Every element within one bf16 ulp of the largest |o| of its (slot,
    head) row: both round the same f32 sums, taken in another order."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().amax(-1, keepdim=True).clamp_min(2.0**-126))) - 7)
    assert torch.isfinite(got).all() and got.dtype == torch.bfloat16
    assert bool(((got.float() - w).abs() <= ulp * 1.0001).all()), ((got.float() - w).abs() / ulp).max().item()


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_k10_vs_plain(dev, name):
    """K10 on the route (its range length from the shape), then at every range
    length, against its plain version with the same ranges."""
    from torch_bnb_fp4_tpu_torch.ops import attention as A

    q, k, v, keys, window, cap, scale = _decode_ops(dev, name)
    before = K.launch_counts()["decode_attention"]
    got = A.decode_attention(q, k, v, keys, window, scale, cap)
    assert K.launch_counts()["decode_attention"] == before + 1
    r = A.decode_range_rows(q.shape[0], k.shape[1], k.shape[2], K._sm_count(dev))
    _k10_close(got, A.decode_attention_plain(q, k, v, keys, window, scale, cap, range_rows=r))
    for r in A.RANGE_ROWS + (64,):
        got = A._decode_attention(q, k, v, keys, window, scale, cap, range_rows=r)
        _k10_close(got, A.decode_attention_plain(q, k, v, keys, window, scale, cap, range_rows=r))
        assert torch.equal(got, A._decode_attention(q, k, v, keys, window, scale, cap, range_rows=r))  # no atomics


def test_k10_never_reads_past_a_slot_length(dev):
    """Rows past each slot's length hold NaN: bit-identical, finite output.
    Slot 0's live rows altered: only slot 0 moves."""
    from torch_bnb_fp4_tpu_torch.ops import attention as A

    q, k, v, keys, window, cap, scale = _decode_ops(dev, "mistral_mixed_lengths")
    lens = DECODE_CASES["mistral_mixed_lengths"][5]
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lens):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
    for r in A.RANGE_ROWS:
        clean = A._decode_attention(q, k, v, keys, window, range_rows=r)
        assert torch.equal(A._decode_attention(q, kp, vp, keys, window, range_rows=r), clean)
        k2, v2 = k.clone(), v.clone()
        k2[0, : lens[0]], v2[0, : lens[0]] = -k2[0, : lens[0]], v2[0, : lens[0]] + 1
        moved = A._decode_attention(q, k2, v2, keys, window, range_rows=r)
        assert torch.equal(moved[1:], clean[1:]) and not torch.equal(moved[0], clean[0])


def test_k10_one_graph_serves_every_length_mix(dev):
    """Captured once, replayed after the lengths (keys) change in place: the
    replay equals an eager call on the new lengths; q read through its
    strides (a head slice of a fused q|k tensor)."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import attention as A

    q, k, v, keys, window, _, _ = _decode_ops(dev, "mistral_mixed_lengths")
    qv = torch.split(torch.cat([q, torch.zeros_like(q[:, :, :8])], dim=2), [32, 8], dim=2)[0]
    assert not qv.is_contiguous()
    torch.testing.assert_close(A.decode_attention(qv, k, v, keys, window), A.decode_attention(q, k, v, keys, window),
                               rtol=0, atol=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.decode_attention(qv, k, v, keys, window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.decode_attention(qv, k, v, keys, window)
    new_len = torch.tensor([1100, 3, 500, 64, 1, 999], dtype=torch.int32, device=dev)
    kpos, valid = T.kv_slot_positions(new_len, k.shape[1])
    fresh = A.decode_keys((new_len - 1)[:, None], valid, kpos)
    for name in ("q_positions", "key_positions", "live"):
        getattr(keys, name).copy_(getattr(fresh, name))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, A.decode_attention(q, k, v, fresh, window), rtol=0, atol=0)


def _splitk_operands(m, k, n, dev, seed=0, x_dtype=torch.bfloat16):
    """Random split-K operands: uniform bytes, true absmax halves in [0.5, 1.5)
    * 0.01, a bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (k // 2, n), generator=g, dtype=torch.uint8, device=dev)
    hi, lo = ((torch.rand((k // 128, n), generator=g, device=dev) + 0.5) * 0.01 for _ in range(2))
    x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
    return x, packed, hi, lo, torch.randn((n,), generator=g, device=dev)


SPLITK_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k,n", [(1024, 384), (14336, 4096)])
def test_k9a_bit_exact(dev, k, n, out_dtype, qt):
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    _, packed, hi, lo, _ = _splitk_operands(1, k, n, dev, seed=k + n)
    cb = None if qt == "fp4" else fmt.NF4_CODE
    before = K.launch_counts()["dequant_splitk"]
    got = K.dequantize_tpu(packed, (hi, lo), cb, out_dtype=out_dtype)
    assert K.launch_counts()["dequant_splitk"] == before + 1
    want = K.dequantize_splitk_plain(packed, hi, lo, K.code_table(cb, dev), out_dtype=out_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("qt", ["fp4", "nf4"])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 32, 33, 64, 128, 200, 256, 300])
@pytest.mark.parametrize("k,n", SPLITK_SHAPES)
def test_k9b_bf16_vs_plain(dev, k, n, m, qt):
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    x, packed, hi, lo, bias = _splitk_operands(m, k, n, dev, seed=m + k)
    cb = None if qt == "fp4" else fmt.NF4_CODE
    before = K.launch_counts()["matmul_splitk"]
    got = K.matmul_fp4(x, packed, (hi, lo), bias, cb)
    assert K.launch_counts()["matmul_splitk"] == before + 1 and got.dtype == torch.bfloat16
    _close(got, K.matmul_splitk_plain(x, packed, hi, lo, bias, K.code_table(cb, dev), out_dtype=torch.bfloat16),
           2.0**-7)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 4096)])
def test_k9b_f32_vs_plain(dev, k, n, m):
    x, packed, hi, lo, bias = _splitk_operands(m, k, n, dev, seed=m, x_dtype=torch.float32)
    got = K.matmul_fp4(x, packed, (hi, lo), bias)
    _close(got, K.matmul_splitk_plain(x, packed, hi, lo, bias, K.code_table(None, dev), out_dtype=torch.float32),
           1e-5)


def test_k9b_f16_computes_in_bf16(dev):
    x, packed, hi, lo, bias = _splitk_operands(4, 4096, 1024, dev, x_dtype=torch.float16)
    got = K.matmul_fp4(x, packed, (hi, lo), bias)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, K.matmul_fp4(x.to(torch.bfloat16), packed, (hi, lo), bias,
                                                 out_dtype=torch.float16), rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 4, 64])
def test_k_sharded_linear_equals_unsharded_on_card(dev, m):
    """w_down at k_shards = 4 through apply_linear (x reordered, one K9b
    call) against the k_shards = 1 packing of the same weight."""
    from torch_bnb_fp4_tpu_torch.models import linear as L

    w = np.random.default_rng(m).standard_normal((512, 4096)).astype(np.float32) * 0.02
    q1 = L.quantize_linear(w, layout="splitk", device=dev)
    q4 = L.quantize_linear(w, layout="splitk", k_shards=4, device=dev)
    x = torch.randn((m, 4096), generator=torch.Generator(device=dev).manual_seed(m), device=dev).to(torch.bfloat16)
    _close(L.apply_linear(q4, x), L.apply_linear(q1, x), 2.0**-7)
    torch.testing.assert_close(L.dequantize_weight(q4, torch.float32), L.dequantize_weight(q1, torch.float32),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 4, 64, 256])
def test_k_sharded_w_down_equals_unsharded_packing(dev, m):
    """A Mistral-7B w_down (14336 -> 4096) packed in 4 K shards, through K9b with x read in place, against
    the same weights in one shard (repack_k_shards: the same codes and absmax): within 2^-7 of max|y| (bf16
    output rounding and the order of the f32 sums), and its f32-x call within 1e-5."""
    from torch_bnb_fp4_tpu_torch.convert.quantize import repack_k_shards

    x, packed, hi, lo, bias = _splitk_operands(m, 14336, 4096, dev, seed=m)
    p4, h4, l4 = repack_k_shards(packed, hi, lo, 64, 1, 4)
    got = K.matmul_fp4(x, p4, (h4, l4), bias, k_shards=4)
    _close(got, K.matmul_fp4(x, packed, (hi, lo), bias), 2.0**-7)
    xf = x.float()
    _close(K.matmul_fp4(xf, p4, (h4, l4), bias, k_shards=4), K.matmul_fp4(xf, packed, (hi, lo), bias), 1e-5)


def test_splitk_model_cuda_matches_cpu_tiny(dev):
    """A tiny split-K model (K-sharded wo/w_down) on the card and on the CPU:
    logits within 2e-2 of max (no int8 path), and its batch-1 decode step
    needs no host sync and replays as a CUDA graph."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg = T.ModelConfig.tiny_test(n_layers=2)
    p = synth_params(cfg, layout="splitk", tp=2, seed=3, device=dev)
    pc = T.params_to(p, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    with torch.no_grad():
        lg, cache = T.forward(p, cfg, toks.to(dev), T.KVCache.zeros(cfg, 1, 48, device=dev), last_only=True)
        lc, _ = T.forward(pc, cfg, toks, T.KVCache.zeros(cfg, 1, 48, device="cpu"), last_only=True)
        _close(lg.cpu(), lc, 2e-2)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager, _ = T.forward(p, cfg, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            T.forward(p, cfg, tok, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = T.forward(p, cfg, tok, cache)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, eager, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mistral_ring_chunk", "mistral_causal_prompt", "gemma2_softcap",
                                  "tinyllama_mixed_lengths", "rows_see_no_key"])
def test_k7_fp8_kv_vs_plain(dev, name):
    """K7's fp8 form (bf16 q, float8_e4m3fn K/V as an fp8 KV cache stores
    them) against its plain version with the kernel's blocks and split, at
    the bf16 cases' per-row tolerance; counted apart from the bf16 form."""
    from torch_bnb_fp4_tpu_torch.models.transformer import kv_cast
    from torch_bnb_fp4_tpu_torch.ops import attention as A
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_attention

    b, lq, lk, hq, hk, d, lens, q_off, window, cap, scale = FLASH_CASES[name]
    q, k, v, *pos = synth_attention(b, lq, lk, hq, hk, d, lens=lens, q_offset=q_off, seed=lq + lk, device=dev)
    k8, v8 = kv_cast(k, torch.float8_e4m3fn), kv_cast(v, torch.float8_e4m3fn)
    before = K.launch_counts()
    got = A.flash_attention(q, k8, v8, *pos, window, scale, cap)
    after = K.launch_counts()
    assert after["flash_attention_fp8"] == before["flash_attention_fp8"] + 1
    assert after["flash_attention"] == before["flash_attention"]
    split = A.kernel_split(b, lq, lk, hq, hk, K._sm_count(dev), d)
    want = A.flash_attention_plain(q, k8, v8, *pos, window, scale, cap, block_q=A.kernel_blocks(hq, hk, d)[0],
                                   block_k=A.BLOCK_K, split=split)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _k7_close(got, want)


def test_kv_cast_on_card_equals_cpu(dev):
    """The fp8 KV write cast (models.transformer.kv_cast) gives the same byte
    on the card as on the CPU for every bf16 bit pattern."""
    from torch_bnb_fp4_tpu_torch.models.transformer import kv_cast

    x = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    got = kv_cast(x.to(dev), torch.float8_e4m3fn).view(torch.uint8).cpu()
    torch.testing.assert_close(got, kv_cast(x, torch.float8_e4m3fn).view(torch.uint8), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["plain", "spec", "fp8_chunked", "rings_chunked"])
def test_graphed_engine_equals_eager_generate(dev, mode):
    """The engine on the card decodes by CUDA-graph replay: after warmup()
    serving captures nothing (traces flat), its greedy tokens equal eager
    ``generate``'s (prompts of whole 32-row buckets, so both prefill the same
    rows), and the launch counts include every replay (K2 at least once per
    linear per decode step).  ``fp8_chunked`` serves from an e4m3 cache with
    chunked prefill: its tokens are not held against the bf16 ``generate``
    (the cache rounds K/V), only its logprobs, flat traces and cache dtype.
    ``rings_chunked`` prefills 256-row chunks as graph replays on 4352-row
    rings (K4 at 256 rows, K3 and K2 below, K7 over the rings): prompts of
    eight buckets, one of each final chunk width 32-256, some wrapping the
    ring, after a warmup given one other length.  No chunk runs eagerly, and
    each request is held against its chunks run eagerly through
    ``T.forward`` on a copy of the static prefill cache (each chunk over the
    leading rows ``Engine._chunk_rows`` gives it) in this test's own loop:
    the first token's logprob within 1e-3, the tokens equal to the loop's
    greedy continuation."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg = T.ModelConfig.tiny_test(n_layers=2, sliding_window=4096 if mode == "rings_chunked" else None)
    params = synth_params(cfg, seed=5, fuse=True, device=dev)
    g = torch.Generator().manual_seed(2)
    lens = (32, 64, 32)
    if mode == "rings_chunked":  # buckets 256 k + 32 j: final widths 32 j, k of 0, 9 or 18 chunks before
        lens = [256 * (0, 9, 18)[j % 3] + 32 * j - 7 for j in range(1, 9)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in lens]
    kw = dict(max_batch=4, max_len=128, inner_steps=4, batch_buckets=True, logprobs=True)
    if mode == "spec":
        kw.update(spec_tokens=3, spec_ngram=2)
        prompts = [(p[:8] * 4)[:32] for p in prompts]  # periodic prompts: drafts get accepted
    if mode == "fp8_chunked":
        kw.update(kv_dtype="float8_e4m3fn", prefill_chunk=32)
    if mode == "rings_chunked":
        kw.update(max_len=8192, prefill_chunk=256)
    eng = Engine(params, cfg, EngineConfig(**kw))
    warm = eng.warmup(prompt_lens=[300]) if mode == "rings_chunked" else eng.warmup(max_prompt_len=64)
    K.reset_launch_counts()
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(prompts)])
    assert eng.traces == warm
    steps = eng.stats()["decode_steps"]
    assert K.launch_counts()["matmul_pk"] >= steps * 4 * cfg.n_layers
    if mode == "rings_chunked":
        assert {a.shape[1] for a in eng.cache.k + eng._pcache.k} == {4352}
        st, n_chunks = eng.stats(), sum(-(-((n + 31) // 32 * 32) // 256) for n in lens)
        assert st["prefill_chunks_eager"] == 0 and st["prefill_chunks_graphed"] == n_chunks, st
        for name in ("matmul_pk_w4a8", "matmul_pk_minner", "flash_attention"):
            assert K.launch_counts()[name] > 0, name
    for i, p in enumerate(prompts):
        c = res[i]
        assert len(c.tokens) == 12 and len(c.logprobs) == 12 and all(lp <= 0 for lp in c.logprobs)
        if mode == "fp8_chunked":
            continue
        if mode == "rings_chunked":
            pc = T.KVCache(k=[a.clone() for a in eng._pcache.k], v=[a.clone() for a in eng._pcache.v],
                           length=torch.zeros(1, dtype=torch.int32, device=dev))  # stale rows past the length
            lp_pad = -(-len(p) // 32) * 32
            with torch.no_grad():
                for lo in range(0, lp_pad, 256):
                    hi = min(lo + 256, lp_pad)
                    toks = torch.zeros((1, hi - lo), dtype=torch.int32)
                    toks[0, : min(len(p), hi) - lo] = torch.tensor(p[lo:hi])
                    rows = eng._chunk_rows(hi - lo, hi, lp_pad)
                    view = T.KVCache(k=[a[:, :r] for a, r in zip(pc.k, rows)],
                                     v=[a[:, :r] for a, r in zip(pc.v, rows)], length=pc.length)
                    lg, view = T.forward(params, cfg, toks.to(dev), view, last_index=min(len(p), hi) - 1 - lo)
                    pc.length = view.length
                pc.length.fill_(len(p))  # decode goes on from the true length, over the bucket's padding rows
                first = int(lg[0, -1].argmax())
                lp0 = torch.log_softmax(lg[0, -1].float(), -1)[first].item()
                want = [first]
                for _ in range(11):
                    lg, pc = T.forward(params, cfg, torch.tensor([[want[-1]]], dtype=torch.int32, device=dev), pc)
                    want.append(int(lg[0, -1].argmax()))
            assert abs(c.logprobs[0] - lp0) <= 1e-3, (i, c.logprobs[0], lp0)
            assert c.tokens == want, (i, c.tokens, want)
            continue
        want = T.generate(params, cfg, torch.tensor([p], dtype=torch.int32, device=dev), 12)[0].tolist()
        assert c.tokens == want, (i, c.tokens, want)
    if mode == "fp8_chunked":
        assert all(a.dtype == torch.float8_e4m3fn for a in eng.cache.k + eng.cache.v)
    if mode == "spec":
        assert eng.stats()["spec_tokens_per_forward"] >= 1.0


@pytest.mark.parametrize("kv_dtype", ["float16", "float32"])
def test_graphed_engine_on_another_kv_dtype_decodes_densely(dev, kv_dtype):
    """A cache in a float dtype that K10 does not read (it takes bf16 and
    e4m3) decodes through the dense route on the card: no K10 launch and
    every request served."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg = T.ModelConfig.tiny_test(n_layers=2)
    params = synth_params(cfg, seed=5, fuse=True, device=dev)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (32, 64)]
    eng = Engine(params, cfg, EngineConfig(max_batch=2, max_len=128, inner_steps=4, kv_dtype=kv_dtype))
    eng.warmup(max_prompt_len=64)
    K.reset_launch_counts()
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)])
    assert K.launch_counts()["decode_attention"] == 0 and eng.stats()["decode_steps"] > 0
    assert all(a.dtype == getattr(torch, kv_dtype) for a in eng.cache.k + eng.cache.v)
    assert sorted(res) == [0, 1] and all(len(c.tokens) == 8 for c in res.values())


@pytest.mark.parametrize("m", [1, 64, 256])
def test_torchfp4linear_cuda_matches_cpu(dev, m):
    """compat.TorchFP4Linear on the card (K2 at M <= 128, K4 at 256) against
    the same layer's plain version on the CPU; QuantData.dequantize (K6)
    bit-exact, gemm_4bit_inference card against CPU."""
    from torch_bnb_fp4_tpu_torch import compat as C
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    torch.manual_seed(0)
    lin = torch.nn.Linear(1024, 768)
    q_dev, q_cpu = C.TorchFP4Linear.from_linear(lin, device=dev), C.TorchFP4Linear.from_linear(lin, device="cpu")
    x = torch.randn(m, 1024).to(torch.bfloat16)
    K.reset_launch_counts()
    y = q_dev(x.to(dev))
    assert y.device.type == "cuda" and y.dtype == torch.bfloat16
    assert K.launch_counts()["matmul_pk_w4a8" if m >= 256 else "matmul_pk"] == 1
    _close(y.cpu(), q_cpu(x), 2.0**-7)
    w = lin.weight.detach().numpy()
    packed, absmax = fmt.quantize_fp4(w)

    class State:
        blocksize, quant_type, shape, code = 64, "fp4", tuple(w.shape), fmt.FP4_CODE

    State.absmax = absmax
    qd = C.QuantData(packed, State(), w.shape, device=dev)
    K.reset_launch_counts()
    d = qd.dequantize("float32")
    assert K.launch_counts()["dequant_pk"] == 1
    assert torch.equal(d.cpu(), C.QuantData(packed, State(), w.shape, device="cpu").dequantize("float32"))
    a = torch.randn(1, 1024)
    g = C.gemm_4bit_inference(a.to(dev), packed, absmax, fmt.FP4_CODE, 64, dtype="float32", Bshape=w.shape)
    _close(g.cpu(), C.gemm_4bit_inference(a, packed, absmax, fmt.FP4_CODE, 64, dtype="float32", Bshape=w.shape), 1e-5)


def test_quant_embed_lookup_cuda_matches_cpu_and_graphs(dev):
    """QuantEmbedding.lookup on the card bit-equal to the CPU, and inside a
    CUDA graph that indexes it with a static token buffer (no host sync)."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.ops import format as fmt

    w = (np.random.default_rng(3).standard_normal((512, 256)) * 0.05).astype(np.float32)
    for code in (fmt.FP4_CODE, fmt.NF4_CODE):
        e_cpu = T.quantize_embedding(w, code=code, device="cpu")
        e_dev = e_cpu.to(dev)
        tokens = torch.randint(0, 512, (4, 9), dtype=torch.int32)
        assert torch.equal(T.embed_lookup(e_dev, tokens.to(dev)).cpu(), T.embed_lookup(e_cpu, tokens))
    static = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        T.embed_lookup(e_dev, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = T.embed_lookup(e_dev, static)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    new = torch.tensor([[5], [511], [0], [77]], dtype=torch.int32)
    static.copy_(new.to(dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), T.embed_lookup(e_cpu, new))


@pytest.mark.parametrize("m", [1, 64, 256])
def test_lora_linears_cuda_match_cpu(dev, m):
    """LoRALinear and MultiLoRALinear on the card (K2 or K4 under the base,
    cuBLAS for the deltas, the per-row gather by index_select) against the
    same layers on the CPU, bf16 and f32 x; stacked rows given a (B,) index
    on the device."""
    from torch_bnb_fp4_tpu_torch.models import linear as L

    rng = np.random.default_rng(m)
    w = (rng.standard_normal((384, 1024)) * 0.02).astype(np.float32)
    ab = [((rng.standard_normal((r, 1024)) * 0.05).astype(np.float32),
           (rng.standard_normal((384, r)) * 0.05).astype(np.float32)) for r in (8, 4)]
    base = L.quantize_linear(w, device="cpu")
    single = L.lora_linear(base, *ab[0], alpha=16.0)
    multi = L.multi_lora_linear(base, [(*ab[0], 16.0), None, (*ab[1], 8.0)])
    idx = torch.tensor([1, 0, 3, 2], dtype=torch.int32)
    for dtype, tol in ((torch.bfloat16, 2.0**-7), (torch.float32, 1e-5)):
        x = torch.from_numpy(rng.standard_normal((4, m, 1024)).astype(np.float32)).to(dtype)
        for lin, kw_cpu, kw_dev in ((single, {}, {}), (multi, dict(adapter_idx=idx), dict(adapter_idx=idx.to(dev)))):
            want = lin(x, **kw_cpu).float()
            got = lin.to(dev)(x.to(dev), **kw_dev).float().cpu()
            assert (got - want).abs().max().item() <= tol * want.abs().max().item(), (type(lin).__name__, dtype)


def test_multi_lora_engine_graphs_on_card(dev):
    """A multi-LoRA engine on the card: warmup captures every graph, serving
    requests under two adapters and none captures nothing more (the adapter
    index is a buffer write), and each request's tokens equal eager
    ``generate`` on its single-attach params (or the base)."""
    from torch_bnb_fp4_tpu_torch.models import lora as LoRA
    from torch_bnb_fp4_tpu_torch.models import transformer as T
    from torch_bnb_fp4_tpu_torch.serve import Engine, EngineConfig, Request
    from torch_bnb_fp4_tpu_torch.utils.synth import synth_params

    cfg = T.ModelConfig.tiny_test(n_layers=2)
    params = synth_params(cfg, seed=5, device=dev)
    rng = np.random.default_rng(9)
    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = {"self_attn.q_proj": (cfg.dim, cfg.dim), "self_attn.v_proj": (kv, cfg.dim),
              "mlp.down_proj": (cfg.dim, cfg.ffn_dim)}

    def adapter(r, names):
        return LoRA.PEFTAdapter(r=r, alpha=2.0 * r, weights={
            f"model.layers.{i}.{t}": ((rng.standard_normal((r, shapes[t][1])) * 0.05).astype(np.float32),
                                      (rng.standard_normal((shapes[t][0], r)) * 0.05).astype(np.float32))
            for i in range(cfg.n_layers) for t in names})

    ads = {"a": adapter(8, shapes), "b": adapter(4, ["self_attn.q_proj", "self_attn.v_proj"])}
    mp, ids = LoRA.attach_multi_lora(params, cfg, ads)
    eng = Engine(mp, cfg, EngineConfig(max_batch=4, max_len=128, inner_steps=4, batch_buckets=True),
                 adapter_ids=ids)
    warm = eng.warmup(max_prompt_len=64)
    n_graphs = len(eng._graphs)
    g = torch.Generator().manual_seed(2)
    reqs = [(torch.randint(0, cfg.vocab_size, (32,), generator=g).tolist(), a) for a in ("a", "b", None, "a")]
    res = eng.run([Request(uid=i, prompt=p, max_new_tokens=12, adapter=a) for i, (p, a) in enumerate(reqs)])
    assert eng.traces == warm and len(eng._graphs) == n_graphs
    oracle = {None: params, **{n: LoRA.attach_lora(params, cfg, ad) for n, ad in ads.items()}}
    for i, (p, a) in enumerate(reqs):
        want = T.generate(oracle[a], cfg, torch.tensor([p], dtype=torch.int32, device=dev), 12)[0].tolist()
        assert res[i].tokens == want, (i, a)
