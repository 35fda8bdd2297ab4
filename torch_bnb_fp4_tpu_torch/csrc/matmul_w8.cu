// K5: int8 GEMM over a pre-built int8 weight shadow (the prefill shadow), on
// Hopper's int8 warpgroup MMA.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_w8_kernel (:813), the
// pallas_call of matmul_w8 (:905).  Every prefill GEMM of 256 rows or more
// of a layer with an attached shadow (models/linear.py::attach_int8_shadow):
// the weights were decoded (K6) and requantized once at attach time, so the
// kernel has no decode of its own.
//
// Numerics (as :828-845), per K-tile of block_k rows (1024, or 512 when the
// padded K is an odd multiple of 512; the shadow fixes it):
//   d   = exact int32 dot of x8 and w8 over the whole K-tile
//   acc = acc + (f32(d) * rs[m][tile]) * g[tile][n]
//   y   = acc (+ bias[n]) rounded once to the output type
// x8 / rs (per row and K-tile int8 activations and r/127) arrive
// pre-quantized from ops/kernels.py::quantize_activations; g is the shadow's
// per-tile column max / 127.
//
// Bound: at M = 256 the 1-byte weights (K*N bytes of w8 over 3.35 TB/s); at
// several thousand rows the int8 tensor cores (2*M*K*N at 1979 TOP/s).
//
// Design: K4's main loop (int8_mainloop.cuh: 512-thread blocks of two
// consumer warpgroups on wgmma.mma_async m64n128k32 .s32.s8.s8 and two
// producer warpgroups, 128 x 128 output tiles, a ring of 4 stages of 128
// K-rows, the int32 drain at each K-tile boundary with g' = g, the raster,
// the K split of short grids and its K-tile-ordered combine).  What differs
// is how a stage is filled:
//  * The shadow stays (K, N) row-major (its bytes are the JAX package's, and
//    a second, transposed copy would cost ~7 GB served unfused), while int8
//    wgmma reads only K-major operands from shared memory.  So each stage
//    holds the raw [128 k][128 n] shadow tile beside the x8 tile and the
//    weight tile, and the producer warpgroups write the raw tile transposed
//    into the swizzled [128 n][128 k] weight tile, where K4's producers write
//    their decoded one.
//  * Both tiles arrive by TMA (x8 [128 rows][128 k] in the 128-byte swizzle
//    wgmma reads, rows past M zero-filled; the raw tile unswizzled), issued
//    by one consumer thread the moment both consumer warpgroups release a
//    slot, so the copies run up to three stages ahead whatever the
//    producers are doing (K4's cp.async copies, issued by the producers
//    themselves, can lead by only two stages, and wait for the consumers).
//  * Thread (warp kq, lane l) of the producers owns columns 4l..4l+3 and k
//    16kq..16kq+15: 16 conflict-free 32-bit loads (a warp reads one 128-byte
//    row), four 4x4 byte transposes (8 prmt each), four 16-byte stores.  Each
//    lane takes its four columns in an order rotated by (l / 2) % 4, folded
//    into the transposes' byte selectors, so the 8 lanes of a store phase
//    hit 8 different 16-byte positions of the swizzle.  The producers also
//    copy each stage's g row (128 floats) into the slot the consumers' drain
//    reads.
#include "int8_mainloop.cuh"
#include "pairk_decode.cuh"  // dtype codes

namespace {

using i8::kBK;
using i8::kBN;
using i8::kTile;
constexpr int kStages = 4;                  // slots of the ring
constexpr int kOffRaw = 2 * kTile;          // in a slot, after the x8 and weight tiles: the raw [128 k][128 n] tile
constexpr int kStage = 3 * kTile;           // 1024-byte aligned: the swizzle reads bits 7-9
constexpr int kOffG = kStages * kStage;     // [kStages][kBN] f32: g of each stage's K-tile
constexpr int kOffBar = kOffG + kStages * kBN * 4;
constexpr int kSmem = 1024 + kOffBar + 3 * kStages * 8;

struct Args {
  const int8_t* x8;
  const float* rs;
  const int8_t* w8;
  const float* g;
  const float* bias;
  void* out;
  float* terms;  // split > 1: (K / block_k, M, N) f32
  int out_dtype, M, K, N, block_k, split;
};

__global__ void __launch_bounds__(i8::kThreads, 1)
    w8_kernel(const Args a, const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* copied = empty + kStages;  // the slot's x8 and raw tiles landed
  float* gs = reinterpret_cast<float*>(smem + kOffG);
  const int tid = threadIdx.x, warp = tid >> 5;
  const i8::Range rg = i8::block_range(a.M, a.N, a.K, a.block_k, a.split);
  const int n_stages = rg.n_stages;
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) hop::mbar_init(&copied[s], 1);
  i8::init_ring(full, empty, kStages);  // fences the inits above too

  // stage j's x8 and raw tiles into slot j % kStages (called by one thread once the slot is free)
  auto issue = [&](int j) {
    const int kb = (rg.s_lo + j) * kBK;
    unsigned char* sp = smem + (j % kStages) * kStage;
    hop::mbar_expect_tx(&copied[j % kStages], 2 * kTile);
    hop::tma_load_2d(sp, &tx, &copied[j % kStages], kb, rg.m0);
    hop::tma_load_2d(sp + kOffRaw, &tw, &copied[j % kStages], rg.n0, kb);
  };
  if (warp >= 8) {
    // ---- producer warpgroups: the transposed weight tile of each landed stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(i8::kProducerRegs));
    const int tp = tid - 256;
    // this thread's part of the transpose: columns 4l.., k 16kq..; byte selectors that take the lane's
    // columns in the rotated order rot, rot + 1, ... (two rows interleaved per selector)
    const int kq = tp >> 5, l = tp & 31, rot = (l >> 1) & 3;
    const uint32_t c0 = rot, c1 = (rot + 1) & 3, c2 = (rot + 2) & 3, c3 = (rot + 3) & 3;
    const uint32_t sel_a = c0 | (c0 + 4) << 4 | c1 << 8 | (c1 + 4) << 12;
    const uint32_t sel_b = c2 | (c2 + 4) << 4 | c3 << 8 | (c3 + 4) << 12;
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % kStages;
      unsigned char* sp = smem + st * kStage;
      const float gv = tp < kBN ? a.g[static_cast<size_t>((rg.s_lo + s) / rg.sub) * a.N + rg.n0 + tp] : 0.f;
      hop::mbar_wait(&copied[st], (s / kStages) & 1);  // and so the slot's previous stage was released
      if (tp < kBN) gs[st * kBN + tp] = gv;
      const unsigned char* raw = sp + kOffRaw + 16 * kq * kBN + 4 * l;
      uint32_t w[4][4];  // [rotated column][4 k] -> one 16-byte chunk per column
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r[4];  // k rows 16kq + 4q + i, columns 4l..4l+3
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = *reinterpret_cast<const uint32_t*>(raw + (4 * q + i) * kBN);
        const uint32_t t0 = __byte_perm(r[0], r[1], sel_a), t1 = __byte_perm(r[2], r[3], sel_a);
        const uint32_t t2 = __byte_perm(r[0], r[1], sel_b), t3 = __byte_perm(r[2], r[3], sel_b);
        w[0][q] = __byte_perm(t0, t1, 0x5410u);
        w[1][q] = __byte_perm(t0, t1, 0x7632u);
        w[2][q] = __byte_perm(t2, t3, 0x5410u);
        w[3][q] = __byte_perm(t2, t3, 0x7632u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint4*>(sp + kTile + hop::sw128(4 * l + ((rot + j) & 3), kq)) =
            make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
      hop::fence_proxy_async();  // the weights (st.shared) are read by wgmma
      hop::mbar_arrive(&full[st]);
    }
  } else {
    // ---- consumer warpgroups; their thread 0 fills the ring: every slot at the start, then each slot as
    // soon as both warpgroups have released it ----
    if (tid == 0)
      for (int j = 0; j < kStages && j < n_stages; ++j) issue(j);
    i8::consume<kStages, kStage>(smem, full, empty, gs, 1.0f, rg,
                                 i8::Out{a.rs, a.bias, a.out, a.terms, a.out_dtype, a.M, a.N, a.split},
                                 [&](int t) {
                                   if (tid == 0 && t + kStages < n_stages) {
                                     hop::mbar_wait(&empty[t % kStages], (t / kStages) & 1);
                                     issue(t + kStages);
                                   }
                                 });
  }
}

// registers per thread the kernel was built with (its setmaxnreg split needs i8::kThreadRegs)
int kernel_regs() {
  static int regs = -1;
  if (regs < 0) regs = i8::kernel_regs(reinterpret_cast<const void*>(w8_kernel));
  return regs;
}

}  // namespace

// x8 (M, K) int8, rs (M, K/block_k) f32, w8 (K, N) int8, g (K/block_k, N)
// f32, bias (N) f32 or null, out (M, N) f32|bf16|f16.  Requires N % 128 == 0,
// K % block_k == 0, block_k % 128 == 0 and block_k <= 2^17; any M.  split:
// K-tile ranges (1 <= split <= K / block_k; ops/kernels.py::w4a8_split); for
// split > 1, terms holds (K / block_k) * M * N floats and a second launch
// sums them.
extern "C" int pk_matmul_w8(const void* x8, const void* rs, const void* w8, const void* g, const void* bias,
                            void* out, int out_dtype, void* terms, int M, int K, int N, int block_k, int split,
                            void* stream) {
  if (M <= 0 || N % kBN || block_k <= 0 || block_k % kBK || block_k > i8::kMaxBlockK || K % block_k || split < 1 ||
      split > K / block_k || (split > 1 && terms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x8 = static_cast<const int8_t*>(x8);
  a.rs = static_cast<const float*>(rs);
  a.w8 = static_cast<const int8_t*>(w8);
  a.g = static_cast<const float*>(g);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.terms = static_cast<float*>(terms);
  a.out_dtype = out_dtype;
  a.M = M;
  a.K = K;
  a.N = N;
  a.block_k = block_k;
  a.split = split;
  // x8 (k, rows) in [128][128] boxes under the 128-byte swizzle; w8 (columns, k) in plain [128][128] boxes
  CUtensorMap tx, tw;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)}, xs[1] = {static_cast<cuuint64_t>(K)};
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)}, ws[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {128, 128};
  int err = hop::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, xd, xs, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = hop::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w8, wd, ws, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  return i8::launch(w8_kernel, kernel_regs(), kSmem, M, N, split, a.terms, a.bias, nullptr, 1, out, out_dtype,
                    K / block_k, static_cast<cudaStream_t>(stream), a, tx, tw);
}

// Registers per thread of the kernel (it launches only at 128), or -cudaError.
extern "C" int pk_matmul_w8_regs() { return kernel_regs(); }
