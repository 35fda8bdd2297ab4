// K2: pair-K GEMV / small-M fused dequant-matmul, y = x . Wt + bias.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_pk_kernel (:655), the
// m-outer pallas_call of matmul_fp4_pk (:1254) and gemv_fp4_pk (:1309): every
// decode step (M = 1 or the decode batch) and bf16 prefill buckets up to 128
// rows; all f32 input up to 256 rows.
//
// Numerics (as :680-691): per 64-row quant block b, part = f32 dot of x with
// the INTEGER code values 192*code, then acc = acc + part * scale[b] in that
// order (explicit _rn intrinsics keep nvcc from contracting it into an fma).
//
// Bound: HBM bytes of the packed weights (K*N/2) and scales up to a few tens
// of rows (2 flops per weight per row, ~4*M flops per weight byte, far under
// the card's ~295); at 128 rows the bf16 tensor-core work (2*M*K*N) bounds it.
// On the card the decode set the time before either: ~5 integer ops a byte on
// Hopper's ALU pipe, which issues at half the FMA pipe's rate (hence the
// decode table below).
//
// bf16 x (the serving path), redesigned for Hopper:
//  * One block covers every row of x (M <= 128; a taller x, which the path
//    choice never sends here, takes 128-row M tiles) and 256 columns (128 at
//    128 rows), so each weight byte is read and decoded once per call.
//  * The WEIGHTS are operand A of wgmma.m64nNk16 from registers (the rs
//    form), x^T operand B from shared memory (N = the x rows rounded up to 8,
//    16, 32, 64 or 128; rows past M are TMA's zero fill).  A decoded pair word
//    (K1) is one A-fragment register: the two K-adjacent values of one column.
//    Warp w of the block owns 16 columns, MMA row g <-> column 2g and row g +
//    8 <-> column 2g + 1, so a lane fetches both of its columns of a pair-row
//    with one 16-bit load (8 per quant block).
//  * The decode is a table: K1 of all 256 byte values, built once per block
//    in shared memory with a copy per lane (64 KB), so a byte costs one byte
//    permute and one conflict-free shared load instead of ~5 integer ALU ops.
//  * A quant block's 4 wgmmas (k16 each) start from zero: the tensor-core sum
//    is that block's f32 part, folded into acc with the _rn intrinsics after
//    its wait.
//  * One producer warp keeps a TMA ring full (8 stages of 8 KB of weights
//    up to 64 rows: ~80 KB in flight per SM): per quant block the packed bytes
//    in 128-column boxes under the 128-byte swizzle (the 16-bit fragment
//    loads of a warp then hit 16 different banks), the scale row and the x
//    tile, over tensor maps whose third dimension is the expert (K8 reads e
//    on the device and passes it as a TMA coordinate).
//  * The grid takes the deepest K split that stays within one wave of
//    blocks (one per SM) with >= 4 quant blocks a split
//    (ops/kernels.py::k2_plan); the splits' f32 partials meet in a workspace
//    and the last block of each column tile sums them in split order
//    (pk::merge_splits): one launch per call, deterministic, graph-safe.
// f32 x only: CUDA cores (the TPU's HIGHEST-precision dot has no tensor-core
// equivalent).  Each thread owns 4 adjacent columns (one 32-bit load of 4
// packed bytes per pair-row) and keeps a quant block's 32 loads in flight;
// K splits fill about K2_BLOCKS_PER_SM blocks per SM, and a second kernel
// sums the splits in a fixed order and adds the bias.
// K8 (the expert form, replacing the m-outer expert pallas_call :1295 and
// _expertify :946): the same kernels against expert e of a stacked (E, K/2, N)
// packing, e read from device memory by every block (pk::expert_index).
// Launch geometry and arithmetic are those of the 2-D path, so the result is
// bit-equal to a 2-D launch on packed[e].
#include "hopper.cuh"
#include "pairk_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;  // output columns per thread

template <int V, int MT>
__global__ void __launch_bounds__(kThreads) matmul_pk_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ packed,
    const void* __restrict__ scale, int scale_dtype, const uint16_t* __restrict__ lut,
    float* __restrict__ ws, int M, int K, int N, int kchunk, const int* __restrict__ expert, int n_experts) {
  extern __shared__ float xs[];  // [MT][kchunk] activations as f32
  const size_t e = pk::expert_index(expert, n_experts);
  packed += e * (K / 2) * static_cast<size_t>(N);
  scale = pk::offset_scale(scale, scale_dtype, e * (K / 64) * static_cast<size_t>(N));
  __shared__ uint16_t lut_s[16];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int k_begin = blockIdx.y * kchunk;
  const int m0 = blockIdx.z * MT;
  for (int idx = threadIdx.x; idx < MT * kchunk; idx += kThreads) {
    const int r = idx / kchunk, c = idx - r * kchunk;
    const int m = m0 + r;
    xs[idx] = m < M ? x[static_cast<size_t>(m) * K + k_begin + c] : 0.f;
  }
  if (V == pk::kLut && threadIdx.x < 16) lut_s[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  if (n0 >= N) return;

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const int nblk = kchunk / 64;
  for (int b = 0; b < nblk; ++b) {
    const int kb = k_begin + b * 64;
    const uint8_t* p = packed + static_cast<size_t>(kb / 2) * N + n0;
    uint32_t w[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = __ldg(reinterpret_cast<const uint32_t*>(p + static_cast<size_t>(i) * N));
    float part[MT][kCols];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[r][c] = 0.f;
    const float* xb = xs + b * 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t bits = pk::decode_pairs<V>((w[i] >> (8 * c)) & 0xFFu, lut_s);
        const float w0 = pk::pair_lo(bits), w1 = pk::pair_hi(bits);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          part[r][c] = fmaf(xb[r * kchunk + 2 * i], w0, part[r][c]);
          part[r][c] = fmaf(xb[r * kchunk + 2 * i + 1], w1, part[r][c]);
        }
      }
    }
    const size_t srow = static_cast<size_t>(kb / 64) * N + n0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float s = pk::load_scale(scale, scale_dtype, srow + c);
#pragma unroll
      for (int r = 0; r < MT; ++r) acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(part[r][c], s));
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int m = m0 + r;
    if (m < M) {
      float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.y) * M + m) * N + n0) = v;
    }
  }
}

// ---- bf16 x: warpgroup MMA, weights from registers ----------------------------

// NR = x rows of a block (M rounded up to 8, 16, 32, 64 or 128): the n of the
// wgmma.  CW consumer warpgroups of 64 columns each: four (256 columns) up to
// 64 rows, two at 128 rows, where the f32 accumulators and parts (64 + 64 per
// thread) need the registers of 288 threads.  Shared memory: the decode table
// (64 KB), then the ring (8 stages, 6 at 128 rows).
constexpr int kTable = 256 * 256;  // the decode table at the start of shared memory: [256 bytes][256 B]

template <int NR>
struct Cfg {
  static constexpr int CW = NR <= 64 ? 4 : 2;
  static constexpr int BN = 64 * CW;  // output columns per block
  static constexpr int STAGES = NR < 128 ? 8 : 6;  // TMA ring depth (quant blocks in flight per block)
  static constexpr int THREADS = 128 * CW + 32;    // + one producer warp
  static constexpr int W_BYTES = BN * 32;          // BN / 128 boxes of [32 pair-rows][128 columns]
  static constexpr int OFF_X = W_BYTES;            // [NR rows][64 k] bf16 (1024-byte aligned)
  static constexpr int OFF_S = OFF_X + NR * 128;   // the scale row (BN f32 or bf16)
  static constexpr int STAGE = (OFF_S + BN * 4 + 1023) / 1024 * 1024;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr int SMEM = kTable + 1024 + OFF_BAR + 2 * STAGES * 8 + 32 + 16;
};

struct Args {
  const float* bias;
  const uint16_t* lut;
  const int* expert;
  void* out;
  float* ws;      // ksplit > 1: (ksplit, M, N) f32 partials
  int* counters;  // ksplit > 1: one int32 per output tile, 0 between launches
  int scale_dtype, out_dtype, M, K, N, nbs, n_experts;  // nbs: quant blocks per split
};

template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&d)[NR / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (NR == 8) hop::wgmma_m64n8k16_rs(d, a, db, scale_d);
  else if constexpr (NR == 16) hop::wgmma_m64n16k16_rs(d, a, db, scale_d);
  else if constexpr (NR == 32) hop::wgmma_m64n32k16_rs(d, a, db, scale_d);
  else if constexpr (NR == 64) hop::wgmma_m64n64k16_rs(d, a, db, scale_d);
  else hop::wgmma_m64n128k16_rs(d, a, db, scale_d);
}

template <int V, int NR>
__global__ void __launch_bounds__(Cfg<NR>::THREADS, 1)
    matmul_pk_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tp,
                           const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tx) {
  using C = Cfg<NR>;
  constexpr int NA = NR / 2;  // f32 accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw + kTable) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint16_t* lut_s = reinterpret_cast<uint16_t*>(empty + C::STAGES);
  int* ticket = reinterpret_cast<int*>(lut_s + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = static_cast<int>(pk::expert_index(a.expert, a.n_experts));
  const float* bias = a.bias == nullptr ? nullptr : a.bias + static_cast<size_t>(e) * a.N;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.z * 128, b0 = blockIdx.y * a.nbs;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * C::CW);  // one arrival per consumer warp
    }
    hop::mbar_init_fence();
  }
  if (V == pk::kLut && tid < 16) lut_s[tid] = a.lut[tid];
  __syncthreads();

  if (warp == 4 * C::CW) {
    // ---- producer warp: the ring of quant blocks, by TMA ----
    if (lane == 0) {
      const int esz = a.scale_dtype == pk::kBF16 ? 2 : 4;
      for (int i = 0; i < a.nbs; ++i) {
        const int st = i % C::STAGES, b = b0 + i;
        if (i >= C::STAGES) hop::mbar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        unsigned char* sp = smem + st * C::STAGE;
        hop::mbar_expect_tx(&full[st], C::W_BYTES + NR * 128 + C::BN * esz);  // out-of-bounds boxes count in full
#pragma unroll
        for (int h = 0; h < C::BN / 128; ++h) hop::tma_load_3d(sp + h * 4096, &tp, &full[st], n0 + 128 * h, 32 * b, e);
        hop::tma_load_3d(sp + C::OFF_S, &ts, &full[st], n0, b, e);
        hop::tma_load_2d(sp + C::OFF_X, &tx, &full[st], 64 * b, m0);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: warp w owns columns 16w..16w+15 of the tile; MMA row g <-> column 2g,
    // row g + 8 <-> column 2g + 1, so lane (g, t) reads both of its columns with one 16-bit load ----
    const int gid = lane >> 2, tig = lane & 3, cw = warp & 7;  // cw: the warp's 16-byte chunk in its box
    const int col = 16 * warp + 2 * gid;                        // this lane's columns col, col + 1
    const uint32_t lane4 = 4 * lane;                            // this lane's copy of the decode table
    // K1 of every byte value, once per block while the first copies fly, in a copy per lane: lane l reads byte
    // X's word at 256 X + 4 l, so a warp's 32 lookups hit 32 banks whatever its bytes, and one byte permute
    // makes that offset from the packed pair.  The arithmetic decode takes ~5 integer ops a byte on Hopper's
    // ALU pipe (half the rate of the FMA pipe), which then bounds the stage
    for (int idx = tid; idx < 256 * 32; idx += 128 * C::CW)
      reinterpret_cast<uint32_t*>(smem_raw)[(idx >> 5) * 64 + (idx & 31)] =
          pk::decode_pairs<V>(static_cast<uint32_t>(idx >> 5), lut_s);
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * C::CW) : "memory");  // the consumer warps alone
    float acc[NA], part[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) acc[q] = 0.f;
    for (int i = 0; i < a.nbs; ++i) {
      const int st = i % C::STAGES;
      hop::mbar_wait(&full[st], (i / C::STAGES) & 1);
      const unsigned char* sp = smem + st * C::STAGE;
      // the A fragments of quant block i: k-step j reads pair-rows 8j + t (k 16j + 2t, + 1) and 8j + t + 4 (k + 8)
      const unsigned char* wb = sp + (warp >> 3) * 4096 + 2 * gid;
      uint32_t fr[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u0 = *reinterpret_cast<const uint16_t*>(wb + (8 * j + tig) * 128 + ((cw ^ tig) << 4));
        const uint32_t u1 = *reinterpret_cast<const uint16_t*>(wb + (8 * j + tig + 4) * 128 + ((cw ^ (tig + 4)) << 4));
        // table offset 256 X + 4 l of byte X of the pair: [4 l, X, 0, 0] by one byte permute
        fr[j][0] = *reinterpret_cast<const uint32_t*>(smem_raw + __byte_perm(u0, lane4, 0x2204));
        fr[j][1] = *reinterpret_cast<const uint32_t*>(smem_raw + __byte_perm(u0, lane4, 0x2214));
        fr[j][2] = *reinterpret_cast<const uint32_t*>(smem_raw + __byte_perm(u1, lane4, 0x2204));
        fr[j][3] = *reinterpret_cast<const uint32_t*>(smem_raw + __byte_perm(u1, lane4, 0x2214));
      }
      const float s0 = pk::load_scale(sp + C::OFF_S, a.scale_dtype, col);
      const float s1 = pk::load_scale(sp + C::OFF_S, a.scale_dtype, col + 1);
      // 4 wgmmas from zero: part is the quant block's f32 tensor-core sum
      const uint64_t xd = hop::desc_sw128(sp + C::OFF_X, 16);
      hop::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<NR>(part, fr[j], xd + 2 * j, j > 0);
      hop::fence_regs(part);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(part);
#pragma unroll
      for (int j = 0; j < 4; ++j) hop::fence_regs(fr[j]);
      hop::mbar_arrive_warp(&empty[st]);
#pragma unroll
      for (int q = 0; q < NA; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(part[q], (q & 3) < 2 ? s0 : s1));
    }
    // element 4j + q: column col + (q >> 1), x row 8j + 2t + (q & 1)
    const int c = n0 + col;
    if (c < a.N) {
#pragma unroll
      for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * tig + h;
          if (m >= a.M) continue;
          float v0 = acc[4 * j + h], v1 = acc[4 * j + 2 + h];
          if (gridDim.y > 1) {
            *reinterpret_cast<float2*>(a.ws + (static_cast<size_t>(blockIdx.y) * a.M + m) * a.N + c) =
                make_float2(v0, v1);
          } else {
            if (bias != nullptr) {
              v0 = __fadd_rn(v0, bias[c]);
              v1 = __fadd_rn(v1, bias[c + 1]);
            }
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + c, v0);
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + c + 1, v1);
          }
        }
      }
    }
  }
  if (gridDim.y > 1)
    pk::merge_splits(a.ws, bias, a.out, a.out_dtype, a.M, a.N, gridDim.y, m0, min(m0 + 128, a.M), n0,
                     min(n0 + C::BN, a.N), a.counters + blockIdx.z * gridDim.x + blockIdx.x, ticket);
}

// the tensor maps of one launch: packed (columns, pair-rows, experts) in [32][128] boxes under the
// 128-byte swizzle; scale (columns, quant blocks, experts) in [1][BN] rows; x (k, rows) in [NR][64] tiles
template <int V, int NR>
int launch_mma(const Args& a, const void* x, const void* packed, const void* scale, int ksplit, cudaStream_t s) {
  using C = Cfg<NR>;
  const cuuint64_t N = a.N, K = a.K, E = a.n_experts, esz = a.scale_dtype == pk::kBF16 ? 2 : 4;
  CUtensorMap tp, ts, tx;
  const cuuint64_t pd[3] = {N, K / 2, E}, ps[2] = {N, K / 2 * N};
  const cuuint32_t pb[3] = {128, 32, 1};
  int err = hop::make_map(&tp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, packed, pd, ps, pb, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t sd[3] = {N, K / 64, E}, ss[2] = {N * esz, K / 64 * N * esz};
  const cuuint32_t sb[3] = {static_cast<cuuint32_t>(C::BN), 1, 1};
  if (err == 0)
    err = hop::make_map(&ts, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scale,
                        sd, ss, sb, CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t xd[2] = {K, static_cast<cuuint64_t>(a.M)}, xs[1] = {K * 2};
  const cuuint32_t xb[2] = {64, NR};
  if (err == 0)
    err = hop::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  cudaError_t ce = cudaFuncSetAttribute(matmul_pk_wgmma_kernel<V, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((a.N + C::BN - 1) / C::BN, ksplit, (a.M + 127) / 128);
  matmul_pk_wgmma_kernel<V, NR><<<grid, C::THREADS, C::SMEM, s>>>(a, tp, ts, tx);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_tc(int rows, const Args& a, const void* x, const void* packed, const void* scale, int ksplit,
              cudaStream_t s) {
  switch (rows) {
    case 8: return launch_mma<V, 8>(a, x, packed, scale, ksplit, s);
    case 16: return launch_mma<V, 16>(a, x, packed, scale, ksplit, s);
    case 32: return launch_mma<V, 32>(a, x, packed, scale, ksplit, s);
    case 64: return launch_mma<V, 64>(a, x, packed, scale, ksplit, s);
    case 128: return launch_mma<V, 128>(a, x, packed, scale, ksplit, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y[m, n] = sum over splits (in order) + bias, cast to the output dtype
__global__ void reduce_splits_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                     void* __restrict__ out, int out_dtype, int M, int N, int ksplit,
                                     const int* __restrict__ expert, int n_experts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  if (bias != nullptr) bias += pk::expert_index(expert, n_experts) * N;  // a stacked (E, N) bias
  float acc = ws[i];
  for (int s = 1; s < ksplit; ++s) acc = __fadd_rn(acc, ws[static_cast<size_t>(s) * mn + i]);
  if (bias != nullptr) acc = __fadd_rn(acc, bias[i % N]);
  pk::store_out(out, out_dtype, i, acc);
}

template <int V, int MT>
void launch(dim3 grid, size_t smem, cudaStream_t s, const void* x, const uint8_t* p, const void* scale,
            int scale_dtype, const uint16_t* lut, float* ws, int M, int K, int N, int kchunk, const int* ex, int ne) {
  matmul_pk_kernel<V, MT><<<grid, kThreads, smem, s>>>(static_cast<const float*>(x), p, scale, scale_dtype, lut,
                                                       ws, M, K, N, kchunk, ex, ne);
}

template <int V>
void launch_mt(int mt, dim3 grid, size_t smem, cudaStream_t s, const void* x, const uint8_t* p, const void* scale,
               int scale_dtype, const uint16_t* lut, float* ws, int M, int K, int N, int kchunk, const int* ex, int ne) {
  switch (mt) {
    case 1: launch<V, 1>(grid, smem, s, x, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
    case 2: launch<V, 2>(grid, smem, s, x, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
    case 4: launch<V, 4>(grid, smem, s, x, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
    default: launch<V, 8>(grid, smem, s, x, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
  }
}


}  // namespace

// x (M, K) f32|bf16, packed (K/2, N) u8, scale (K/64, N) f32|bf16, bias (N) f32
// or null, lut (16) bf16 bits or null, out (M, N).
// expert: null for the 2-D path, else one int32 in device memory selecting
// expert e of stacked packed (E, K/2, N), scale (E, K/64, N) and bias (E, N),
// with E = n_experts.  Requires N % 128 == 0, (K/64) % ksplit == 0.
// bf16 x: the warpgroup-MMA kernel, rows in {8, 16, 32, 64, 128} and >= M (or
// 128 for a taller x: 128-row M tiles), ws (ksplit, M, N) f32 and counters
// (one int32 per output tile, all 0) for ksplit > 1; one launch.
// f32 x: CUDA cores with rows = 1, 2, 4 or 8 x rows per block, ws (ksplit, M,
// N) f32 always, and the split reduction as a second launch; counters unused.
extern "C" int pk_matmul_pk(const void* x, int x_dtype, const void* packed, const void* scale, int scale_dtype,
                            const void* bias, const void* lut, void* ws, void* counters, void* out, int out_dtype,
                            int M, int K, int N, int ksplit, int rows, int variant, const int* expert, int n_experts,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K % 64 || N % 128 || ksplit < 1 || (K / 64) % ksplit) return static_cast<int>(cudaErrorInvalidValue);
  const int kchunk = K / ksplit;
  auto p = static_cast<const uint8_t*>(packed);
  auto l = static_cast<const uint16_t*>(lut);
  auto w = static_cast<float*>(ws);
  if (x_dtype == pk::kBF16) {
    if (rows < (M < 128 ? M : 128) || (ksplit > 1 && (ws == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.bias = static_cast<const float*>(bias);
    a.lut = l;
    a.expert = expert;
    a.out = out;
    a.ws = w;
    a.counters = static_cast<int*>(counters);
    a.scale_dtype = scale_dtype;
    a.out_dtype = out_dtype;
    a.M = M;
    a.K = K;
    a.N = N;
    a.nbs = K / 64 / ksplit;
    a.n_experts = n_experts;
    switch (variant) {
      case pk::kExact: return launch_tc<pk::kExact>(rows, a, x, packed, scale, ksplit, s);
      case pk::kZramp: return launch_tc<pk::kZramp>(rows, a, x, packed, scale, ksplit, s);
      case pk::kRamp: return launch_tc<pk::kRamp>(rows, a, x, packed, scale, ksplit, s);
      case pk::kLut: return launch_tc<pk::kLut>(rows, a, x, packed, scale, ksplit, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (x_dtype != pk::kF32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows) * kchunk * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads * kCols - 1) / (kThreads * kCols), ksplit, (M + rows - 1) / rows);
  switch (variant) {
    case pk::kExact: launch_mt<pk::kExact>(rows, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
    case pk::kZramp: launch_mt<pk::kZramp>(rows, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
    case pk::kRamp: launch_mt<pk::kRamp>(rows, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
    case pk::kLut: launch_mt<pk::kLut>(rows, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const int threads = 256;
  reduce_splits_kernel<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0, s>>>(
      w, static_cast<const float*>(bias), out, out_dtype, M, N, ksplit, expert, n_experts);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory per block of the bf16 (warpgroup-MMA) kernel at ``rows`` x rows, or
// -cudaErrorInvalidValue for another row count.
extern "C" int pk_matmul_pk_smem(int rows) {
  switch (rows) {
    case 8: return Cfg<8>::SMEM;
    case 16: return Cfg<16>::SMEM;
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 128: return Cfg<128>::SMEM;
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
