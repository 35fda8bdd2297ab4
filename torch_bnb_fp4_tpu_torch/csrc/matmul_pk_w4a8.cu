// K4: pair-K w4a8 prefill GEMM on Hopper's int8 warpgroup MMA.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_pk_w4a8_kernel (:750),
// the a8 pallas_call of matmul_fp4_pk (:1185): bf16 prefill buckets of 256
// rows or more with an FP4-family variant.
//
// Numerics (as :776-803), per activation K-tile of a8_block_k rows (1024 for
// every Mistral shape, the whole K where bf16 scales give no 1024-row tile,
// as Qwen2's and Gemma-2's 3584; the caller resolves it exactly as the JAX
// path does):
//   g[n]    = max over the tile's quant blocks of scale[b][n]; 0 -> 1
//   f[b][n] = (scale[b][n] / g[n]) * f32(127/192)
//   w8      = rint(192*code * f[b][n])               (round half to even)
//   d       = exact int32 dot of x8 and w8 over the whole K-tile
//   acc     = acc + (f32(d) * rs[m][tile]) * (g[n] * f32(192/127))
// then the bias.  x8 / rs (per row and K-tile int8 activations and r/127)
// arrive pre-quantized from ops/kernels.py::quantize_activations, as the TPU
// path quantizes them in XLA outside its kernel.  |d| <= 127*127*a8_block_k
// stays inside int32 for a8_block_k <= 2^17.
//
// Bound: int8 tensor-core ops (2*M*K*N at 1979 TOP/s) against the packed
// bytes; at M = 256-320 near the balance point.  What holds it back is the
// decode on CUDA cores (about 4 instructions per weight, once per 128 rows)
// and the x8 / packed copies into shared memory, not the int8 MMA.
//
// Design:
//  * The int8 warpgroup-MMA main loop of int8_mainloop.cuh (shared with K5):
//    a 512-thread block of two consumer and two producer warpgroups, 128 x
//    128 output tiles, a ring of 5 stages of 128 K-rows, the int32 partial
//    drained into f32 at each a8 K-tile boundary (a8_block_k / 128 stages, 8
//    at 1024; g' = g * 192/127), the grouped raster and the K split of short
//    grids (w4a8_split) with its K-tile-ordered combine.
//  * The producer warpgroups copy with cp.async, 2-3 stages ahead of the
//    decode: the x8 tile, the raw packed bytes (64 pair-rows x 128 columns)
//    and the stage's two scale rows; then they decode the weights
//    themselves: each thread owns one column x one 64-row quant block per
//    stage.  g, the column max over a whole K-tile of any length, is
//    reduced one K-tile ahead: each stage also brings the two scale rows at
//    the same place in the next K-tile, whose running max the two threads of
//    a column hand over through shared memory at the K-tile's end (the
//    range's first K-tile is reduced from global memory before the loop).
//    Within one quant block of one column w8 takes only 16
//    values, so it builds that table once (the K1 value of each nibble,
//    pk::decode_pairs, times f with the same __fmul_rn, rounded half to even
//    by adding 1.5 * 2^23: bit-equal to __float2int_rn by construction,
//    without the conversion unit) and maps nibbles to int8 with byte
//    permutes (3 prmt per four weights).
//  * Each weight tile is decoded M/128 times (once per 128-row M tile).
//
// K8 (the expert form, replacing the a8 expert pallas_call :1215 and
// _expertify :946): the same kernels against expert e of a stacked
// (E, K/2, N) packing; each block reads e from device memory
// (pk::expert_index) and offsets packed, scale and bias itself.  Same tiles
// and arithmetic as the 2-D path: bit-equal to a 2-D launch on packed[e].
#include "int8_mainloop.cuh"
#include "pairk_decode.cuh"  // K1 (decode_pairs), scale loads, the expert index

namespace {

using i8::kBK;
using i8::kBN;
using i8::kTile;
constexpr int kStageBytes = 2 * kTile;  // x8 and weights (1024-byte aligned: the swizzle reads bits 7-9)
constexpr int kStages = 5;  // x8 / weight tiles in the ring
constexpr int kAhead = 3;   // stages whose copies fly while one decodes
constexpr int kRaw = kAhead + 1;  // slots of raw packed bytes and scale rows
constexpr int kRawBytes = kBK / 2 * kBN;       // 64 packed pair-rows x 128 columns
constexpr int kSlotBytes = kRawBytes + 4 * kBN * 4;  // + 4 scale rows: the stage's 2, the next K-tile's 2
constexpr int kOffG = kStages * kStageBytes;   // [kStages][kBN] f32: g of each stage's K-tile
constexpr int kOffGp = kOffG + kStages * kBN * 4;  // [2 K-tile parities][2 quant blocks][kBN] f32: g partials
constexpr int kOffRaw = kOffGp + 4 * kBN * 4;
constexpr int kOffBar = kOffRaw + kRaw * kSlotBytes;
constexpr int kSmem = 1024 + kOffBar + 2 * kStages * 8;

struct Args {
  const int8_t* x8;
  const float* rs;
  const uint8_t* packed;
  const void* scale;
  const float* bias;
  void* out;
  float* terms;  // split > 1: (K / a8_block_k, M, N) f32
  const int* expert;
  int scale_dtype, out_dtype, M, K, N, a8_block_k, n_experts, split;
};

// named barrier of the two producer warpgroups alone
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// the x8 tile of rows m0.. and K-columns kb..kb+127 into its swizzled slot ``xs`` (cp.async, rows past M
// zero-filled); called by producer thread ``tp`` (0..255)
__device__ __forceinline__ void copy_x8(unsigned char* xs, const int8_t* x8, int M, int K, int m0, int kb, int tp) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 1024 chunks of 16 bytes
    const int c = tp + 256 * i, r = c >> 3, ch = c & 7, m = m0 + r;
    hop::cp_async16(xs + hop::sw128(r, ch), x8 + static_cast<size_t>(m < M ? m : 0) * K + kb + ch * 16, m < M);
  }
}

// four nibbles (k order, low nibble first) -> four int8 from the 16-entry table t
__device__ __forceinline__ uint32_t lookup4(const uint32_t (&t)[4], uint32_t nib) {
  const uint32_t sel = nib & 0x7777u;
  const uint32_t lo = __byte_perm(t[0], t[1], sel);  // entries 0-7
  const uint32_t hi = __byte_perm(t[2], t[3], sel);  // entries 8-15
  return __byte_perm(lo, hi, 0x3210u | ((nib & 0x8888u) >> 1));  // bit 3 of a nibble picks hi
}

template <int V>
__global__ void __launch_bounds__(i8::kThreads, 1) w4a8_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  const size_t e = pk::expert_index(a.expert, a.n_experts);
  const uint8_t* packed = a.packed + e * (a.K / 2) * static_cast<size_t>(a.N);
  const void* scale = pk::offset_scale(a.scale, a.scale_dtype, e * (a.K / 64) * static_cast<size_t>(a.N));
  const float* bias = a.bias == nullptr ? nullptr : a.bias + e * a.N;

  const int tid = threadIdx.x, warp = tid >> 5;
  const i8::Range rg = i8::block_range(a.M, a.N, a.K, a.a8_block_k, a.split);
  const int m0 = rg.m0, n0 = rg.n0, sub = rg.sub, kt_lo = rg.kt_lo, kt_hi = rg.kt_hi, s_lo = rg.s_lo;
  const int n_stages = rg.n_stages;
  i8::init_ring(full, empty, kStages);

  if (warp >= 8) {
    // ---- producer warpgroups: copies kAhead stages ahead, then the weight decode ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(i8::kProducerRegs));
    const int tp = tid - 256, col = tp & 127, qb = tp >> 7;  // column col, quant block qb of a stage
    const int esz = a.scale_dtype == pk::kBF16 ? 2 : 4, qbk = a.a8_block_k / 64;  // scale rows per K-tile
    const int n_kt = kt_hi - kt_lo;  // K-tiles of this block's range
    const float c127_192 = 127.0f / 192.0f;
    float* gp = reinterpret_cast<float*>(smem + kOffGp);
    float val[16];  // the K1 value (192 * code) of each nibble
#pragma unroll
    for (int j = 0; j < 16; ++j) val[j] = pk::pair_lo(pk::decode_pairs<V>(static_cast<uint32_t>(j), nullptr));

    // stage j's x8 tile; stage j's raw packed bytes and scale rows (its own two and, but in the range's
    // last K-tile, the two at the same place in the next K-tile)
    auto issue_x = [&](int j) {
      copy_x8(smem + (j % kStages) * kStageBytes, a.x8, a.M, a.K, m0, (s_lo + j) * kBK, tp);
    };
    auto issue_raw = [&](int j) {
      const int kb = (s_lo + j) * kBK;
      unsigned char* raw = smem + kOffRaw + (j % kRaw) * kSlotBytes;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // 64 pair-rows x 8 chunks
        const int c = tp + 256 * i, r = c >> 3, ch = c & 7;
        hop::cp_async16(raw + r * kBN + ch * 16, packed + static_cast<size_t>(kb / 2 + r) * a.N + n0 + ch * 16, true);
      }
      const int cpr = kBN * esz / 16, r = tp / cpr, ch = tp % cpr;  // chunks per scale row; this thread's chunk
      if (r < 2 || (r < 4 && j / sub + 1 < n_kt)) {
        const size_t row = kb / 64 + (r & 1) + (r < 2 ? 0 : qbk);
        hop::cp_async16(raw + kRawBytes + r * kBN * 4 + ch * 16,
                        static_cast<const char*>(scale) + (row * a.N + n0) * esz + ch * 16, true);
      }
    };
    // raw bytes fly kAhead stages ahead of the decode, x8 kAhead - 1 (its slot is freed by the consumers);
    // commit group g_s (issued in iteration s) holds raw(s + kAhead) and x8(s + kAhead - 1), after two
    // prologue groups {raw 0, x8 0, raw 1} and {x8 1, raw 2}
    if (n_stages > 0) {
      issue_raw(0);
      issue_x(0);
    }
    if (n_stages > 1) issue_raw(1);
    hop::cp_async_commit();
    if (n_stages > 1) issue_x(1);
    if (n_stages > 2) issue_raw(2);
    hop::cp_async_commit();
    if (n_stages > 0) {  // the first K-tile's g partials, straight from global memory
      float gm = 0.f;
      for (int r = qb; r < qbk; r += 2)
        gm = fmaxf(gm, pk::load_scale(scale, a.scale_dtype, static_cast<size_t>(kt_lo * qbk + r) * a.N + n0 + col));
      gp[qb * kBN + col] = gm;
    }
    float g = 1.f, gnext = 0.f;  // g of this K-tile; this thread's running max over the next one
    for (int s = 0; s < n_stages; ++s) {
      hop::cp_async_wait<1>();  // every group but the newest: raw(s) and x8(s) of this thread have landed
      producer_sync();          // everyone's have, everyone is done decoding stage s - 1, g partials written
      if (s + kAhead < n_stages) issue_raw(s + kAhead);
      const int jx = s + kAhead - 1;
      if (jx < n_stages) {
        if (jx >= kStages) hop::mbar_wait(&empty[jx % kStages], ((jx / kStages) - 1) & 1);
        issue_x(jx);
      }
      hop::cp_async_commit();

      const int st = s % kStages, t = s / sub;  // ring slot; K-tile within the range
      unsigned char* ws = smem + st * kStageBytes + kTile;
      float* gs = reinterpret_cast<float*>(smem + kOffG) + st * kBN;
      const unsigned char* sc = smem + kOffRaw + (s % kRaw) * kSlotBytes + kRawBytes;  // rows at kBN * 4 bytes
      if (s % sub == 0) {  // new activation K-tile: column max of its scales, 0 -> 1
        const float gm = fmaxf(gp[(t & 1) * 2 * kBN + col], gp[(t & 1) * 2 * kBN + kBN + col]);
        g = gm == 0.f ? 1.f : gm;
      }
      if (qb == 0) gs[col] = g;
      if (t + 1 < n_kt) {
        gnext = fmaxf(gnext, pk::load_scale(sc + (2 + qb) * kBN * 4, a.scale_dtype, col));
        if (s % sub == sub - 1) {  // read after the next iteration's producer_sync
          gp[((t + 1) & 1) * 2 * kBN + qb * kBN + col] = gnext;
          gnext = 0.f;
        }
      }
      // this column's 16-entry table of this quant block: rint(v_j * f) as int8, where adding
      // 1.5 * 2^23 rounds a |y| < 2^22 to the nearest integer, ties to even (as __float2int_rn), and
      // leaves it in the low byte of the sum's bits
      const float f = __fmul_rn(__fdiv_rn(pk::load_scale(sc + qb * kBN * 4, a.scale_dtype, col), g), c127_192);
      uint32_t t4[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = __float_as_uint(__fadd_rn(__fmul_rn(val[4 * w + i], f), 12582912.0f));
        t4[w] = __byte_perm(__byte_perm(b[0], b[1], 0x0040u), __byte_perm(b[2], b[3], 0x0040u), 0x5410u);
      }
      // 32 pair-rows = 64 k of the column -> 4 chunks of 16 int8
      const unsigned char* raw = smem + kOffRaw + (s % kRaw) * kSlotBytes + 32 * qb * kBN + col;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t w[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // pair-rows 8p + 4h.. = k 16p + 8h..
          const unsigned char* rp = raw + (8 * p + 4 * h) * kBN;
          const uint32_t bytes = __byte_perm(__byte_perm(rp[0], rp[kBN], 0x0040u),
                                             __byte_perm(rp[2 * kBN], rp[3 * kBN], 0x0040u), 0x5410u);
          w[2 * h] = lookup4(t4, bytes);
          w[2 * h + 1] = lookup4(t4, bytes >> 16);
        }
        *reinterpret_cast<uint4*>(ws + hop::sw128(col, 4 * qb + p)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      hop::fence_proxy_async();  // x8 (cp.async) and the weights (st.shared) are read by wgmma
      hop::mbar_arrive(&full[st]);
    }
    hop::cp_async_wait<0>();
  } else {
    i8::consume<kStages, kStageBytes>(smem, full, empty, reinterpret_cast<const float*>(smem + kOffG),
                                      192.0f / 127.0f, rg, i8::Out{a.rs, bias, a.out, a.terms, a.out_dtype, a.M,
                                      a.N, a.split}, [](int) {});
  }
}

// Registers per thread the kernel was built with (the setmaxnreg split needs i8::kThreadRegs).
template <int V>
int kernel_regs() {
  static int regs = -1;
  if (regs < 0) regs = i8::kernel_regs(reinterpret_cast<const void*>(w4a8_kernel<V>));
  return regs;
}

template <int V>
int launch(const Args& a, cudaStream_t s) {
  return i8::launch(w4a8_kernel<V>, kernel_regs<V>(), kSmem, a.M, a.N, a.split, a.terms, a.bias, a.expert,
                    a.n_experts, a.out, a.out_dtype, a.K / a.a8_block_k, s, a);
}

}  // namespace

// x8 (M, K) int8, rs (M, K/a8_block_k) f32, packed (K/2, N) u8, scale (K/64, N)
// f32|bf16, bias (N) f32 or null.  Requires N % 128 == 0, K % a8_block_k == 0,
// a8_block_k % 128 == 0, a8_block_k <= 2^17, 16-byte aligned rows.  FP4-family variants only.
// split: K-tile ranges (1 <= split <= K / a8_block_k); for split > 1, terms
// holds (K / a8_block_k) * M * N floats.  expert: null for the 2-D path, else
// one int32 in device memory selecting expert e of stacked packed
// (E, K/2, N), scale (E, K/64, N) and bias (E, N), with E = n_experts.
extern "C" int pk_matmul_pk_w4a8(const void* x8, const void* rs, const void* packed, const void* scale,
                                 int scale_dtype, const void* bias, void* out, int out_dtype, void* terms, int M,
                                 int K, int N, int a8_block_k, int split, int variant, const int* expert,
                                 int n_experts, void* stream) {
  if (M <= 0 || N % kBN || a8_block_k <= 0 || a8_block_k % kBK || a8_block_k > i8::kMaxBlockK || K % a8_block_k ||
      split < 1 || split > K / a8_block_k || (split > 1 && terms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x8 = static_cast<const int8_t*>(x8);
  a.rs = static_cast<const float*>(rs);
  a.packed = static_cast<const uint8_t*>(packed);
  a.scale = scale;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.terms = static_cast<float*>(terms);
  a.expert = expert;
  a.scale_dtype = scale_dtype;
  a.out_dtype = out_dtype;
  a.M = M;
  a.K = K;
  a.N = N;
  a.a8_block_k = a8_block_k;
  a.n_experts = n_experts;
  a.split = split;
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case pk::kExact: return launch<pk::kExact>(a, s);
    case pk::kZramp: return launch<pk::kZramp>(a, s);
    case pk::kRamp: return launch<pk::kRamp>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread of the kernel for ``variant`` (K4 launches only at kThreadRegs = 128), or
// -cudaError.
extern "C" int pk_matmul_pk_w4a8_regs(int variant) {
  switch (variant) {
    case pk::kExact: return kernel_regs<pk::kExact>();
    case pk::kZramp: return kernel_regs<pk::kZramp>();
    case pk::kRamp: return kernel_regs<pk::kRamp>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
