// K3: pair-K prefill GEMM that decodes each weight tile once into shared
// memory, prescaled, and runs full-depth dots over it.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_pk_minner_kernel (:702),
// the m-inner pallas_call of matmul_fp4_pk (:1185): bf16 prefill buckets of
// 129-255 rows (and lut-variant buckets of 129+ rows, and f32 input above 256
// rows).
//
// Numerics (as :726-729): the weight tile is w * bf16(scale) computed and
// rounded in bf16 (the integer code values are exact in bf16; the scale's
// cast and the product each round once: one __hmul2 of the decoded pair by
// the duplicated bf16 scale), then f32-accumulated dots over the whole K.
// The f32 variant keeps w * scale in f32 and runs exact f32 FMAs (the TPU's
// HIGHEST-precision dot), on CUDA cores since tensor cores have no full f32.
//
// Bound: at M = 224 the bf16 GEMM does 2*M flops per weight, ~900 per packed
// byte, so the tensor cores bound it (the H100's ridge is ~295 flops/byte).
// On the card the copies (the x tile is read from L2 once per column tile)
// and the producer's decode set the time before the MMAs do (PERF.md).
//
// bf16 x, redesigned for Hopper (K4's main loop with bf16 in place of int8):
//  * One block covers all M <= 256 rows (256-row M tiles above: the lut
//    variant only) and 128 columns, so each weight is decoded once per call.
//  * A ring of 4 stages of one quant block (64 k) each: the x tile [256
//    rows][64 k] by TMA in the 128-byte swizzle (rows past M are TMA's
//    zeros), the packed bytes [32 pair-rows][128 columns] and the scale row
//    by TMA beside it, and the decoded weight tile [128 n][64 k].
//  * A producer warpgroup: one thread issues the copies two stages ahead;
//    every thread owns one column, decodes its 32 packed bytes (K1),
//    prescales each pair with one __hmul2 and stores 16-byte chunks of the
//    [n][k] tile in the 128-byte swizzle (conflict-free: 8 lanes cover the
//    8 chunk positions), then fence.proxy.async and an mbarrier arrive.
//  * Four consumer warpgroups of 64 rows each run wgmma.m64n128k16 .f32.bf16
//    from shared memory over the whole stage with no per-block wait (the
//    scale is folded into the tile), keep one stage in flight while the next
//    lands, and skip their wgmmas where their rows lie past M.
//  * Short grids (N / 128 column tiles under one wave: N = 4096 gives 32)
//    split K into contiguous ranges of >= 4 quant blocks
//    (ops/kernels.py::k3_plan); the last block of each tile sums the f32
//    partials in split order (pk::merge_splits), in the same launch.
//
// K8 (the expert form, replacing the m-inner expert pallas_call :1215 and
// _expertify :946): the same kernels against expert e of a stacked (E, K/2, N)
// packing; each block reads e from device memory (pk::expert_index): the
// TMA maps' third dimension is the expert, and the f32 kernel offsets packed,
// scale and bias itself.  Same tiles and arithmetic as the 2-D path:
// bit-equal to a 2-D launch on packed[e].
#include "hopper.cuh"
#include "pairk_decode.cuh"

namespace {

constexpr int kBM = 256, kBN = 128;      // output tile; each stage is one quant block (64 k)
constexpr int kConsumers = 4;            // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kStages = 4, kAhead = 2;   // ring slots; stages whose copies are issued ahead of the decode
constexpr int kOffW = kBM * 128;         // after the x tile: the decoded weights [kBN n][64 k] bf16
constexpr int kOffRaw = kOffW + kBN * 128;  // the packed bytes [32 pair-rows][kBN]
constexpr int kOffSc = kOffRaw + 32 * kBN;  // the scale row (kBN f32 or bf16)
constexpr int kStage = (kOffSc + kBN * 4 + 1023) / 1024 * 1024;
constexpr int kOffBar = kStages * kStage;
constexpr int kSmem = 1024 + kOffBar + 3 * kStages * 8 + 32 + 16;

struct Args {
  const float* bias;
  const uint16_t* lut;
  const int* expert;
  void* out;
  float* ws;      // ksplit > 1: (ksplit, M, N) f32 partials
  int* counters;  // ksplit > 1: one int32 per output tile, 0 between launches
  int scale_dtype, out_dtype, M, K, N, nbs, n_experts;  // nbs: quant blocks per split
};

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
    minner_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap ts,
                        const __grid_constant__ CUtensorMap tx) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* copied = reinterpret_cast<uint64_t*>(smem + kOffBar);  // x, packed bytes and scale landed
  uint64_t* full = copied + kStages;                                // weights decoded
  uint64_t* empty = full + kStages;                                 // consumers done with the stage
  uint16_t* lut_s = reinterpret_cast<uint16_t*>(empty + kStages);
  int* ticket = reinterpret_cast<int*>(lut_s + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = static_cast<int>(pk::expert_index(a.expert, a.n_experts));
  const float* bias = a.bias == nullptr ? nullptr : a.bias + static_cast<size_t>(e) * a.N;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * kBM, b0 = blockIdx.y * a.nbs;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&copied[s], 1);
      hop::mbar_init(&full[s], 4);  // one arrival per producer warp
      hop::mbar_init(&empty[s], 4 * kConsumers);  // one per consumer warp
    }
    hop::mbar_init_fence();
  }
  if (V == pk::kLut && tid < 16) lut_s[tid] = a.lut[tid];
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer warpgroup: copies by TMA, then the decode of column ``col`` ----
    const int col = tid - 128 * kConsumers;
    auto issue = [&](int j) {
      const int st = j % kStages, b = b0 + j;
      if (j >= kStages) hop::mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
      unsigned char* sp = smem + st * kStage;
      hop::mbar_expect_tx(&copied[st], kBM * 128 + 32 * kBN + kBN * (a.scale_dtype == pk::kBF16 ? 2 : 4));
      hop::tma_load_2d(sp, &tx, &copied[st], 64 * b, m0);
      hop::tma_load_3d(sp + kOffRaw, &tp, &copied[st], n0, 32 * b, e);
      hop::tma_load_3d(sp + kOffSc, &ts, &copied[st], n0, b, e);
    };
    if (col == 0)
      for (int j = 0; j < kAhead && j < a.nbs; ++j) issue(j);
    for (int s = 0; s < a.nbs; ++s) {
      if (col == 0 && s + kAhead < a.nbs) issue(s + kAhead);
      const int st = s % kStages;
      unsigned char* sp = smem + st * kStage;
      hop::mbar_wait(&copied[st], (s / kStages) & 1);
      // bf16(scale), duplicated into both halves: the TPU's prescale
      const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16_rn(pk::load_scale(sp + kOffSc, a.scale_dtype, col)));
      // the column's 32 packed bytes, all loaded before the first store (no store can be taken to alias them)
      const unsigned char* raw = sp + kOffRaw + col;
      uint32_t rb[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) rb[r] = raw[r * kBN];
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // chunk c of the column's row: pair-rows 4c..4c+3 = k 8c..8c+7
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t bits = pk::decode_pairs<V>(rb[4 * c + q], lut_s);
          const __nv_bfloat162 w2 = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits), s2);
          v[q] = *reinterpret_cast<const uint32_t*>(&w2);
        }
        *reinterpret_cast<uint4*>(sp + kOffW + hop::sw128(col, c)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
      hop::fence_proxy_async();  // the st.shared of the weights are read by wgmma
      hop::mbar_arrive_warp(&full[st]);
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: rows 64 * wg.. of the tile ----
    const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
    const bool active = m0 + 64 * wg < a.M;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int pend = -1;  // the stage whose wgmmas may still be in flight
    for (int s = 0; s < a.nbs; ++s) {
      const int st = s % kStages;
      hop::mbar_wait(&copied[st], (s / kStages) & 1);  // x (TMA) landed
      hop::mbar_wait(&full[st], (s / kStages) & 1);    // weights decoded
      if (!active) {
        hop::mbar_arrive_warp(&empty[st]);
        continue;
      }
      const unsigned char* sp = smem + st * kStage;
      const uint64_t xd = hop::desc_sw128(sp + wg * 64 * 128, 16), wd = hop::desc_sw128(sp + kOffW, 16);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::wgmma_m64n128k16_ss(acc, xd + 2 * kk, wd + 2 * kk, 1);
      hop::fence_regs(acc);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous stage's wgmmas are done: free its slot
      if (pend >= 0) hop::mbar_arrive_warp(&empty[pend % kStages]);
      pend = s;
    }
    if (active) {
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (pend >= 0) hop::mbar_arrive_warp(&empty[pend % kStages]);
      // element 4j + 2h + i: row 16 (warp % 4) + gid + 8h of the warpgroup, column 8j + 2 tig + i
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * (warp & 3) + gid + 8 * h;
        if (m >= a.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * tig;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (gridDim.y > 1) {
            *reinterpret_cast<float2*>(a.ws + (static_cast<size_t>(blockIdx.y) * a.M + m) * a.N + n) =
                make_float2(v0, v1);
          } else {
            if (bias != nullptr) {
              v0 = __fadd_rn(v0, bias[n]);
              v1 = __fadd_rn(v1, bias[n + 1]);
            }
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n, v0);
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n + 1, v1);
          }
        }
      }
    }
  }
  if (gridDim.y > 1)
    pk::merge_splits(a.ws, bias, a.out, a.out_dtype, a.M, a.N, gridDim.y, m0, min(m0 + kBM, a.M), n0, n0 + kBN,
                     a.counters + blockIdx.z * gridDim.x + blockIdx.x, ticket);
}

// tensor maps: x (k, rows) in [256][64] tiles under the 128-byte swizzle; packed (columns, pair-rows,
// experts) in [32][128] boxes; scale (columns, quant blocks, experts) in [1][128] rows
template <int V>
int launch_wgmma(const Args& a, const void* x, const void* packed, const void* scale, int ksplit, cudaStream_t s) {
  const cuuint64_t N = a.N, K = a.K, E = a.n_experts, esz = a.scale_dtype == pk::kBF16 ? 2 : 4;
  CUtensorMap tp, ts, tx;
  const cuuint64_t xd[2] = {K, static_cast<cuuint64_t>(a.M)}, xs[1] = {K * 2};
  const cuuint32_t xb[2] = {64, kBM};
  int err = hop::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t pd[3] = {N, K / 2, E}, ps[2] = {N, K / 2 * N};
  const cuuint32_t pb[3] = {kBN, 32, 1};
  if (err == 0)
    err = hop::make_map(&tp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, packed, pd, ps, pb, CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t sd[3] = {N, K / 64, E}, ss[2] = {N * esz, K / 64 * N * esz};
  const cuuint32_t sb[3] = {kBN, 1, 1};
  if (err == 0)
    err = hop::make_map(&ts, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scale,
                        sd, ss, sb, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  cudaError_t ce = cudaFuncSetAttribute(minner_wgmma_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  minner_wgmma_kernel<V><<<dim3(a.N / kBN, ksplit, (a.M + kBM - 1) / kBM), kThreads, kSmem, s>>>(a, tp, ts, tx);
  return static_cast<int>(cudaGetLastError());
}

// f32 input: 64x64 tile, 256 threads, 4x4 outputs per thread, exact f32 FMAs
template <int V>
__global__ void __launch_bounds__(256) minner_f32_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ packed, const void* __restrict__ scale,
    int scale_dtype, const float* __restrict__ bias, const uint16_t* __restrict__ lut, void* __restrict__ out,
    int out_dtype, int M, int K, int N, const int* __restrict__ expert, int n_experts) {
  constexpr int TB = 64;
  const size_t e = pk::expert_index(expert, n_experts);
  packed += e * (K / 2) * static_cast<size_t>(N);
  scale = pk::offset_scale(scale, scale_dtype, e * (K / 64) * static_cast<size_t>(N));
  if (bias != nullptr) bias += e * N;
  __shared__ float xs[TB][TB + 4];  // [k][m]
  __shared__ __align__(16) float wsm[TB][TB];  // [k][n]
  __shared__ uint16_t lut_s[16];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m_blk = blockIdx.y * TB, n_blk = blockIdx.x * TB;
  if (V == pk::kLut && tid < 16) lut_s[tid] = lut[tid];
  float acc[4][4] = {};
  for (int kb = 0; kb < K; kb += TB) {
    for (int e = tid; e < TB * TB; e += 256) {
      const int r = e >> 6, k = e & 63, m = m_blk + r;
      xs[k][r] = m < M ? x[static_cast<size_t>(m) * K + kb + k] : 0.f;
    }
    __syncthreads();  // lut_s ready on the first step
    {
      const int i = tid >> 3, c0 = (tid & 7) * 8;  // pair-row 0..31, 8 columns
      const uint2 v = *reinterpret_cast<const uint2*>(packed + static_cast<size_t>(kb / 2 + i) * N + n_blk + c0);
      const uint32_t words[2] = {v.x, v.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = c0 + q * 4 + b;
          const uint32_t bits = pk::decode_pairs<V>((words[q] >> (8 * b)) & 0xFFu, lut_s);
          const float s = pk::load_scale(scale, scale_dtype, static_cast<size_t>(kb / 64) * N + n_blk + c);
          wsm[2 * i][c] = pk::pair_lo(bits) * s;
          wsm[2 * i + 1][c] = pk::pair_hi(bits) * s;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TB; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wsm[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m_blk + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n_blk + tx * 4 + j;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      pk::store_out(out, out_dtype, static_cast<size_t>(m) * N + n, v);
    }
  }
}

template <int V>
int launch(const void* x, int x_dtype, const uint8_t* p, const void* scale, int scale_dtype, const float* bias,
           const uint16_t* lut, float* ws, int* counters, void* out, int out_dtype, int M, int K, int N, int ksplit,
           const int* ex, int ne, cudaStream_t s) {
  if (x_dtype == pk::kF32) {
    const dim3 grid(N / 64, (M + 63) / 64);
    minner_f32_kernel<V><<<grid, 256, 0, s>>>(static_cast<const float*>(x), p, scale, scale_dtype, bias, lut,
                                              out, out_dtype, M, K, N, ex, ne);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype != pk::kBF16 || (ksplit > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.bias = bias;
  a.lut = lut;
  a.expert = ex;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.scale_dtype = scale_dtype;
  a.out_dtype = out_dtype;
  a.M = M;
  a.K = K;
  a.N = N;
  a.nbs = K / 64 / ksplit;
  a.n_experts = ne;
  return launch_wgmma<V>(a, x, p, scale, ksplit, s);
}

}  // namespace

// x (M, K) bf16 (tensor cores) or f32 (CUDA cores); packed (K/2, N) u8;
// scale (K/64, N) f32|bf16; bias (N) f32 or null; lut (16) bf16 bits or null.
// Requires N % 128 == 0, K % 64 == 0, (K/64) % ksplit == 0.  bf16 x with
// ksplit > 1 needs ws (ksplit, M, N) f32 and counters (one int32 per output
// tile, all 0); f32 x takes ksplit 1.
// expert: null for the 2-D path, else one int32 in device memory selecting
// expert e of stacked packed (E, K/2, N), scale (E, K/64, N) and bias (E, N),
// with E = n_experts.
extern "C" int pk_matmul_pk_minner(const void* x, int x_dtype, const void* packed, const void* scale,
                                   int scale_dtype, const void* bias, const void* lut, void* ws, void* counters,
                                   void* out, int out_dtype, int M, int K, int N, int ksplit, int variant,
                                   const int* expert, int n_experts, void* stream) {
  if (M <= 0 || K % 64 || N % 128 || ksplit < 1 || (K / 64) % ksplit || (x_dtype == pk::kF32 && ksplit != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(packed);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const uint16_t*>(lut);
  auto w = static_cast<float*>(ws);
  auto c = static_cast<int*>(counters);
  switch (variant) {
    case pk::kExact: return launch<pk::kExact>(x, x_dtype, p, scale, scale_dtype, b, l, w, c, out, out_dtype, M, K, N, ksplit, expert, n_experts, s);
    case pk::kZramp: return launch<pk::kZramp>(x, x_dtype, p, scale, scale_dtype, b, l, w, c, out, out_dtype, M, K, N, ksplit, expert, n_experts, s);
    case pk::kRamp: return launch<pk::kRamp>(x, x_dtype, p, scale, scale_dtype, b, l, w, c, out, out_dtype, M, K, N, ksplit, expert, n_experts, s);
    case pk::kLut: return launch<pk::kLut>(x, x_dtype, p, scale, scale_dtype, b, l, w, c, out, out_dtype, M, K, N, ksplit, expert, n_experts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory per block of the bf16 (warpgroup-MMA) kernel.
extern "C" int pk_matmul_pk_minner_smem() { return kSmem; }
