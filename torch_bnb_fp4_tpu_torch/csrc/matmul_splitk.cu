// K9b: split-K fused dequant-matmul, y = x_hi . W_hi + x_lo . W_lo + bias.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_kernel (:322), the
// pallas_call of matmul_fp4 (:472) and gemv_fp4 (:485): every linear of a
// split-K model (bnb-exact FP4/NF4 checkpoints, K-sharded wo/w_down).
//
// Layout: packed (K/2, N) u8, byte (i, n) = code(Wt[i, n]) << 4 |
// code(Wt[K/2 + i, n]); absmax_hi / absmax_lo (K/128, N) f32, the TRUE absmax
// of the 64-row blocks of the two halves.  x's columns [0, K/2) meet the high
// nibbles and [K/2, K) the low ones.  A K-sharded packing is the caller's
// business (ops/kernels.py reorders x); this kernel sees one packing.
//
// Numerics (as :346-363): each weight is decoded in f32 as table[nibble] *
// absmax (one __fmul_rn, never contracted).  bf16 x: the weight is rounded
// once to bf16, products of two bf16 values are exact in f32 and accumulate
// in f32.  f32 x: the weight stays f32 and the dot is a true f32 dot of
// fmaf steps on the CUDA cores (the TPU's Precision.HIGHEST; TF32 tensor
// cores would miss the 1e-5 tolerance).  Bias is added in f32; one cast to
// the output type at the end.
//
// Two kernels, one contract:
//  * stream (M <= 8 rows of bf16 x, and f32 x at every M, 8 rows per block):
//    K2's CUDA-core structure.  Each thread owns 4 adjacent columns (one
//    32-bit load of 4 packed bytes per packed row, 32 loads in flight), the
//    block's x rows sit in shared memory as f32, hi and lo halves.  K is
//    split across blocks until the grid fills the SMs; every split writes its
//    f32 partial to a workspace and a second kernel sums the splits in a
//    fixed order (deterministic) and adds the bias.  Bound: HBM bytes of the
//    packed weight (K*N/2) and absmax (K*N/16); at M = 1 the decode (two table
//    reads, two multiplies, two roundings per byte) is about as many
//    instructions as the CUDA cores issue per byte of HBM traffic.
//  * mma (bf16 x, M > 8): K3's structure.  A 128 (or 64) x 128 output tile
//    per 256-thread block; a K step is 32 packed rows = 64 rows of Wt (32 hi,
//    32 lo), decoded once into a [n][k] bf16 tile of shared memory (k < 32:
//    rows kp0 + k; k >= 32: rows K/2 + kp0 + k - 32) beside the matching x
//    tile, then mma.sync.m16n8k16 bf16 with f32 accumulators.  The next step's
//    x chunk and packed bytes are loaded into registers while the current
//    step's MMAs run; no cp.async/TMA pipeline or wgmma yet.  Each thread
//    decodes 2 packed rows x 8 columns and writes bf16 pairs; it walks its 8
//    columns starting at a lane-dependent offset so that a warp's stores
//    spread over the banks (2-way instead of 16-way conflicts).
#include "pairk_decode.cuh"  // dtype codes and output stores

namespace {

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// ---------------------------------------------------------------------------
// stream: CUDA cores, K split across blocks
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kCols = 4;  // output columns per thread

template <bool kBf16, int MT>
__global__ void __launch_bounds__(kThreads) splitk_stream_kernel(
    const void* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ absmax_hi,
    const float* __restrict__ absmax_lo, const float* __restrict__ table, float* __restrict__ ws, int M, int KP,
    int N, int kchunk) {
  extern __shared__ float xs[];  // [MT][2][kchunk]: rows of x_hi then x_lo, as f32
  __shared__ float tab[16];
  const int K = 2 * KP;
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int k_begin = blockIdx.y * kchunk;  // first packed row of this split
  const int m0 = blockIdx.z * MT;
  for (int idx = threadIdx.x; idx < MT * 2 * kchunk; idx += kThreads) {
    const int rh = idx / kchunk, c = idx - rh * kchunk, r = rh >> 1, h = rh & 1;
    const int m = m0 + r;
    float v = 0.f;
    if (m < M) {
      const size_t off = static_cast<size_t>(m) * K + static_cast<size_t>(h) * KP + k_begin + c;
      v = kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[off]) : static_cast<const float*>(x)[off];
    }
    xs[idx] = v;
  }
  if (threadIdx.x < 16) tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  if (n0 >= N) return;

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int b = 0; b < kchunk / 64; ++b) {
    const int kb = k_begin + b * 64;
    const size_t srow = static_cast<size_t>(kb / 64) * N + n0;
    const float4 shi = __ldg(reinterpret_cast<const float4*>(absmax_hi + srow));
    const float4 slo = __ldg(reinterpret_cast<const float4*>(absmax_lo + srow));
    const float sh[kCols] = {shi.x, shi.y, shi.z, shi.w}, sl[kCols] = {slo.x, slo.y, slo.z, slo.w};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint8_t* p = packed + static_cast<size_t>(kb + half * 32) * N + n0;
      uint32_t w[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) w[i] = __ldg(reinterpret_cast<const uint32_t*>(p + static_cast<size_t>(i) * N));
      const int kk0 = b * 64 + half * 32;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t byte = (w[i] >> (8 * c)) & 0xFFu;
          float wh = __fmul_rn(tab[byte >> 4], sh[c]);
          float wl = __fmul_rn(tab[byte & 0xFu], sl[c]);
          if (kBf16) {
            wh = round_bf16(wh);
            wl = round_bf16(wl);
          }
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc[r][c] = fmaf(xs[(2 * r) * kchunk + kk0 + i], wh, acc[r][c]);
            acc[r][c] = fmaf(xs[(2 * r + 1) * kchunk + kk0 + i], wl, acc[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int m = m0 + r;
    if (m < M) {
      *reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.y) * M + m) * N + n0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// y[m, n] = sum over splits (in order) + bias, cast to the output dtype
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                                     void* __restrict__ out, int out_dtype, int M, int N, int ksplit) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  float acc = ws[i];
  for (int s = 1; s < ksplit; ++s) acc = __fadd_rn(acc, ws[static_cast<size_t>(s) * mn + i]);
  if (bias != nullptr) acc = __fadd_rn(acc, bias[i % N]);
  pk::store_out(out, out_dtype, i, acc);
}

template <bool kBf16, int MT>
void launch_stream(dim3 grid, size_t smem, cudaStream_t s, const void* x, const uint8_t* p, const float* hi,
                   const float* lo, const float* tab, float* ws, int M, int KP, int N, int kchunk) {
  splitk_stream_kernel<kBf16, MT><<<grid, kThreads, smem, s>>>(x, p, hi, lo, tab, ws, M, KP, N, kchunk);
}

template <bool kBf16>
void launch_stream_mt(int mt, dim3 grid, size_t smem, cudaStream_t s, const void* x, const uint8_t* p,
                      const float* hi, const float* lo, const float* tab, float* ws, int M, int KP, int N,
                      int kchunk) {
  switch (mt) {
    case 1: launch_stream<kBf16, 1>(grid, smem, s, x, p, hi, lo, tab, ws, M, KP, N, kchunk); break;
    case 2: launch_stream<kBf16, 2>(grid, smem, s, x, p, hi, lo, tab, ws, M, KP, N, kchunk); break;
    case 4: launch_stream<kBf16, 4>(grid, smem, s, x, p, hi, lo, tab, ws, M, KP, N, kchunk); break;
    default: launch_stream<kBf16, 8>(grid, smem, s, x, p, hi, lo, tab, ws, M, KP, N, kchunk); break;
  }
}

// ---------------------------------------------------------------------------
// mma: bf16 tensor cores, each weight tile decoded once into shared memory
// ---------------------------------------------------------------------------

constexpr int kBN = 128, kStep = 32, kLds = 2 * kStep + 8;  // packed rows per K step; bf16 per smem row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <int BM>
__global__ void __launch_bounds__(256) splitk_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ absmax_hi,
    const float* __restrict__ absmax_lo, const float* __restrict__ bias, const float* __restrict__ table,
    void* __restrict__ out, int out_dtype, int M, int KP, int N) {
  constexpr int WM = BM / 2, MT = WM / 16, NT = 4;  // 2 x 4 warps, warp tile WM x 32
  constexpr int XV = BM * 8 / 256;                  // 16-byte x chunks per thread per K step
  __shared__ __align__(16) __nv_bfloat16 xs[BM * kLds];
  __shared__ __align__(16) __nv_bfloat16 wsm[kBN * kLds];  // [n][k]
  __shared__ float tab[16];
  __shared__ float s_hi[kBN], s_lo[kBN];
  const int K = 2 * KP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * kBN;
  const int pr = tid >> 4, grp = tid & 15, pc0 = grp * 8;  // packed rows 2pr, 2pr+1 of a step; 8 columns
  if (tid < 16) tab[tid] = table[tid];

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 xr[XV];
  uint2 p0, p1;
  float shr = 0.f, slr = 0.f;
  auto load_step = [&](int kp0) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int c = tid + j * 256, r = c >> 3, cc = c & 7, m = m_blk + r;
      const int col = cc < 4 ? kp0 + cc * 8 : KP + kp0 + (cc - 4) * 8;
      xr[j] = m < M ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + col)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    const uint8_t* p = packed + static_cast<size_t>(kp0 + 2 * pr) * N + n_blk + pc0;
    p0 = *reinterpret_cast<const uint2*>(p);
    p1 = *reinterpret_cast<const uint2*>(p + N);
    if (tid < kBN) {
      const size_t srow = static_cast<size_t>(kp0 / 64) * N + n_blk + tid;
      shr = absmax_hi[srow];
      slr = absmax_lo[srow];
    }
  };
  load_step(0);

  for (int kp0 = 0; kp0 < KP; kp0 += kStep) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int c = tid + j * 256;
      *reinterpret_cast<uint4*>(xs + (c >> 3) * kLds + (c & 7) * 8) = xr[j];
    }
    if (tid < kBN) {
      s_hi[tid] = shr;
      s_lo[tid] = slr;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = (j + grp) & 7, c = pc0 + jj, sh = 8 * (jj & 3);
      const uint32_t b0 = ((jj < 4 ? p0.x : p0.y) >> sh) & 0xFFu;  // packed row 2pr
      const uint32_t b1 = ((jj < 4 ? p1.x : p1.y) >> sh) & 0xFFu;  // packed row 2pr + 1
      const float hs = s_hi[c], ls = s_lo[c];
      uint32_t* col = reinterpret_cast<uint32_t*>(wsm + c * kLds);
      col[pr] = bf16_pair(__fmul_rn(tab[b0 >> 4], hs), __fmul_rn(tab[b1 >> 4], hs));
      col[kStep / 2 + pr] = bf16_pair(__fmul_rn(tab[b0 & 0xFu], ls), __fmul_rn(tab[b1 & 0xFu], ls));
    }
    __syncthreads();
    if (kp0 + kStep < KP) load_step(kp0 + kStep);
#pragma unroll
    for (int ks = 0; ks < 2 * kStep; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = wm * WM + mt * 16 + gid, col = ks + tig * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + col);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + col);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + col + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + col + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * 32 + nt * 8 + gid, k = ks + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wsm + n * kLds + k);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wsm + n * kLds + k + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n_blk + wn * 32 + nt * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m_blk + wm * WM + mt * 16 + gid + (e >> 1) * 8;
        const int nn = n + (e & 1);
        if (m < M) {
          float v = acc[mt][nt][e];
          if (bias != nullptr) v = __fadd_rn(v, bias[nn]);
          pk::store_out(out, out_dtype, static_cast<size_t>(m) * N + nn, v);
        }
      }
    }
  }
}

}  // namespace

// x (M, K) f32|bf16; packed (K/2, N) u8; absmax_hi / absmax_lo (K/128, N)
// f32; bias (N) f32 or null; table (16) f32; ws f32 (ksplit, M, N) for the
// stream path (null for mma); out (M, N) f32|bf16|f16.
// path 0 = stream (rows x rows per block: 1, 2, 4 or 8; ksplit divides K/128),
// path 1 = mma (bf16 x only; rows = the M tile, 64 or 128).  Requires
// blocksize 64, N % 128 == 0, (K/2) % 64 == 0.
extern "C" int pk_matmul_splitk(const void* x, int x_dtype, const void* packed, const void* absmax_hi,
                                const void* absmax_lo, const void* bias, const void* table, void* ws, void* out,
                                int out_dtype, int M, int K, int N, int path, int ksplit, int rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(packed);
  auto hi = static_cast<const float*>(absmax_hi);
  auto lo = static_cast<const float*>(absmax_lo);
  auto b = static_cast<const float*>(bias);
  auto tab = static_cast<const float*>(table);
  const int KP = K / 2;
  if (path == 1) {
    if (x_dtype != pk::kBF16) return static_cast<int>(cudaErrorInvalidValue);
    auto xb = static_cast<const __nv_bfloat16*>(x);
    if (rows == 64) {
      splitk_mma_kernel<64><<<dim3(N / kBN, (M + 63) / 64), 256, 0, s>>>(xb, p, hi, lo, b, tab, out, out_dtype, M,
                                                                          KP, N);
    } else {
      splitk_mma_kernel<128><<<dim3(N / kBN, (M + 127) / 128), 256, 0, s>>>(xb, p, hi, lo, b, tab, out, out_dtype,
                                                                            M, KP, N);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (ksplit <= 0 || (KP / 64) % ksplit) return static_cast<int>(cudaErrorInvalidValue);
  const int kchunk = KP / ksplit;
  const size_t smem = static_cast<size_t>(rows) * 2 * kchunk * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads * kCols - 1) / (kThreads * kCols), ksplit, (M + rows - 1) / rows);
  auto w = static_cast<float*>(ws);
  if (x_dtype == pk::kBF16) {
    launch_stream_mt<true>(rows, grid, smem, s, x, p, hi, lo, tab, w, M, KP, N, kchunk);
  } else if (x_dtype == pk::kF32) {
    launch_stream_mt<false>(rows, grid, smem, s, x, p, hi, lo, tab, w, M, KP, N, kchunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const int threads = 256;
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0, s>>>(w, b, out, out_dtype,
                                                                                                M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}
