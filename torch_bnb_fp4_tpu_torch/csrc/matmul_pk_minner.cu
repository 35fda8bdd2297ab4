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
// cast and the product each round once), then f32-accumulated dots.  The
// f32 variant keeps w * scale in f32 and runs exact f32 FMAs (the TPU's
// HIGHEST-precision dot), on CUDA cores since tensor cores have no full f32.
//
// Bound: at M = 224 the bf16 GEMM does 2*M flops per weight; the H100 ridge
// is ~295 flops per byte, and each weight is half a byte, so the kernel sits
// near the tensor-core/HBM balance.  Design (simple version): 128x128 (or
// 64x128) output tile per 256-thread block, K step 64 = one quant block.  Per
// step the block stages the bf16 x tile and decodes 32 packed rows x 128
// columns (K1); the decoded word is already a bf16 pair, so one __hmul2 by
// the bf16 scale prescales both values and one 32-bit store lands the
// K-adjacent pair in a [n][k] tile, which is exactly the col-major B
// fragment of mma.sync.m16n8k16.  Rows are padded to 72 elements so the
// fragment reads are conflict-free.  The next step's x chunk and packed
// bytes are loaded into registers while the current step's MMAs run; no
// cp.async/TMA pipeline or wgmma yet.
//
// K8 (the expert form, replacing the m-inner expert pallas_call :1215 and
// _expertify :946): the same kernels against expert e of a stacked (E, K/2, N)
// packing; each block reads e from device memory (pk::expert_index) and offsets
// packed, scale and bias itself.  Same tiles and arithmetic as the 2-D path:
// bit-equal to a 2-D launch on packed[e].
#include "pairk_decode.cuh"

namespace {

constexpr int kBN = 128, kBK = 64, kLds = kBK + 8;  // bf16 elements per smem row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int V, int BM>
__global__ void __launch_bounds__(256) minner_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed, const void* __restrict__ scale,
    int scale_dtype, const float* __restrict__ bias, const uint16_t* __restrict__ lut, void* __restrict__ out,
    int out_dtype, int M, int K, int N, const int* __restrict__ expert, int n_experts) {
  constexpr int WM = BM / 2, MT = WM / 16, NT = 4;  // 2 x 4 warps, warp tile WM x 32
  const size_t e = pk::expert_index(expert, n_experts);
  packed += e * (K / 2) * static_cast<size_t>(N);
  scale = pk::offset_scale(scale, scale_dtype, e * (K / 64) * static_cast<size_t>(N));
  if (bias != nullptr) bias += e * N;
  constexpr int XV = BM * 8 / 256;                  // 16-byte x chunks per thread per K step
  __shared__ __align__(16) __nv_bfloat16 xs[BM * kLds];
  __shared__ __align__(16) __nv_bfloat16 wsm[kBN * kLds];  // [n][k]
  __shared__ __nv_bfloat162 ss[kBN];  // bf16(scale), duplicated into both halves
  __shared__ uint16_t lut_s[16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * kBN;
  const int prow = tid >> 3, pc0 = (tid & 7) * 16;  // this thread's pair-row and 16 columns
  if (V == pk::kLut && tid < 16) lut_s[tid] = lut[tid];

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the next K step's global data, loaded into registers while the current
  // step's MMAs run (register double buffering)
  uint4 xr[XV], pr;
  float sr = 0.f;
  auto load_step = [&](int kb) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int c = tid + j * 256, r = c >> 3, m = m_blk + r;
      xr[j] = m < M ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + kb + (c & 7) * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    pr = *reinterpret_cast<const uint4*>(packed + static_cast<size_t>(kb / 2 + prow) * N + n_blk + pc0);
    if (tid < kBN) sr = pk::load_scale(scale, scale_dtype, static_cast<size_t>(kb / 64) * N + n_blk + tid);
  };
  load_step(0);

  for (int kb = 0; kb < K; kb += kBK) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int c = tid + j * 256;
      *reinterpret_cast<uint4*>(xs + (c >> 3) * kLds + (c & 7) * 8) = xr[j];
    }
    if (tid < kBN) ss[tid] = __bfloat162bfloat162(__float2bfloat16_rn(sr));  // bf16(scale), as the TPU prescale
    __syncthreads();
    {
      // decode (K1) and prescale in bf16: the decoded word IS a bf16 pair, and
      // __hmul2 rounds each product to nearest even, like the TPU's bf16 multiply
      const uint32_t words[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = pc0 + q * 4 + b;
          uint32_t bits = pk::decode_pairs<V>((words[q] >> (8 * b)) & 0xFFu, lut_s);
          __nv_bfloat162 w2 = *reinterpret_cast<__nv_bfloat162*>(&bits);
          *reinterpret_cast<__nv_bfloat162*>(wsm + c * kLds + 2 * prow) = __hmul2(w2, ss[c]);
        }
      }
    }
    __syncthreads();
    if (kb + kBK < K) load_step(kb + kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
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
           const uint16_t* lut, void* out, int out_dtype, int M, int K, int N, int bm, const int* ex, int ne,
           cudaStream_t s) {
  if (x_dtype == pk::kF32) {
    const dim3 grid(N / 64, (M + 63) / 64);
    minner_f32_kernel<V><<<grid, 256, 0, s>>>(static_cast<const float*>(x), p, scale, scale_dtype, bias, lut,
                                              out, out_dtype, M, K, N, ex, ne);
  } else if (bm == 64) {
    const dim3 grid(N / kBN, (M + 63) / 64);
    minner_bf16_kernel<V, 64><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), p, scale, scale_dtype,
                                                   bias, lut, out, out_dtype, M, K, N, ex, ne);
  } else {
    const dim3 grid(N / kBN, (M + 127) / 128);
    minner_bf16_kernel<V, 128><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), p, scale,
                                                    scale_dtype, bias, lut, out, out_dtype, M, K, N, ex, ne);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 (tensor cores) or f32 (CUDA cores); packed (K/2, N) u8;
// scale (K/64, N) f32|bf16; bias (N) f32 or null; lut (16) bf16 bits or null.
// Requires N % 128 == 0, K % 64 == 0; bm in {64, 128} picks the bf16 M tile.
// expert: null for the 2-D path, else one int32 in device memory selecting
// expert e of stacked packed (E, K/2, N), scale (E, K/64, N) and bias (E, N),
// with E = n_experts.
extern "C" int pk_matmul_pk_minner(const void* x, int x_dtype, const void* packed, const void* scale,
                                   int scale_dtype, const void* bias, const void* lut, void* out, int out_dtype,
                                   int M, int K, int N, int bm, int variant, const int* expert, int n_experts,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(packed);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const uint16_t*>(lut);
  switch (variant) {
    case pk::kExact: return launch<pk::kExact>(x, x_dtype, p, scale, scale_dtype, b, l, out, out_dtype, M, K, N, bm, expert, n_experts, s);
    case pk::kZramp: return launch<pk::kZramp>(x, x_dtype, p, scale, scale_dtype, b, l, out, out_dtype, M, K, N, bm, expert, n_experts, s);
    case pk::kRamp: return launch<pk::kRamp>(x, x_dtype, p, scale, scale_dtype, b, l, out, out_dtype, M, K, N, bm, expert, n_experts, s);
    case pk::kLut: return launch<pk::kLut>(x, x_dtype, p, scale, scale_dtype, b, l, out, out_dtype, M, K, N, bm, expert, n_experts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
