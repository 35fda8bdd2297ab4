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
// Bound: HBM bytes of the packed weights (K*N/2) and scales; at M <= 8 the
// arithmetic is ~2-16 flops per weight byte, far under the card's ridge, but
// on CUDA cores the decode plus 2*M FMAs per byte make the kernel
// instruction-bound well before it is byte-bound.
//
// Two kernels, one contract:
//  * bf16 x (the serving path): tensor cores.  mma.sync.m16n8k16 takes the
//    WEIGHT as operand A (16 output columns x 16 k) and x^T as operand B
//    (16 k x 8 rows of x).  A decoded pair word (K1) is exactly one A-fragment
//    register: the two K-adjacent values of one column, low half first.  Each
//    lane loads 32-bit words of 4 adjacent columns and spreads the 4 bytes
//    over 4 MMA tiles, so a warp reads whole 32-byte sectors of 64 columns and
//    the decode costs the same for M = 1 or 8.  The 4 MMAs of a quant block
//    start from zero, so the tensor-core sum is that block's f32 partial.
//  * f32 x only: CUDA cores (the TPU's HIGHEST-precision dot has no
//    tensor-core equivalent).  Each thread owns 4 adjacent columns (one 32-bit load of 4
//    packed bytes per pair-row) and keeps a quant block's 32 loads in flight.
// K8 (the expert form, replacing the m-outer expert pallas_call :1295 and
// _expertify :946): the same kernels against expert e of a stacked (E, K/2, N)
// packing, e read from device memory by every block (pk::expert_index), which
// offsets packed, scale and (in the split reduction) bias itself.  Launch
// geometry and arithmetic are those of the 2-D path, so the result is
// bit-equal to a 2-D launch on packed[e].
// Both split K across blocks until the grid fills the SMs (N = 4096 for wo
// and w_down gives few column blocks); every split writes its f32 partial to
// a workspace and a second kernel sums the splits in a fixed order
// (deterministic, no atomics) and adds the bias.
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

constexpr int kMmaWarps = 4;
constexpr int kMmaCols = 64 * kMmaWarps;  // output columns per block (64 per warp)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT n-tiles of 8 x rows: a block covers 8*NT rows of x and 256 columns
template <int V, int NT>
__global__ void __launch_bounds__(32 * kMmaWarps) matmul_pk_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed, const void* __restrict__ scale,
    int scale_dtype, const uint16_t* __restrict__ lut, float* __restrict__ ws, int M, int K, int N, int kchunk,
    const int* __restrict__ expert, int n_experts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t e = pk::expert_index(expert, n_experts);
  packed += e * (K / 2) * static_cast<size_t>(N);
  scale = pk::offset_scale(scale, scale_dtype, e * (K / 64) * static_cast<size_t>(N));
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [8*NT][kchunk + 8]
  __shared__ uint16_t lut_s[16];
  const int lds = kchunk + 8;  // padded row: conflict-free B-fragment reads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int k_begin = blockIdx.y * kchunk;
  const int m0 = blockIdx.z * 8 * NT;
  const int chunks = kchunk / 8;
  for (int c = tid; c < 8 * NT * chunks; c += 32 * kMmaWarps) {
    const int r = c / chunks, cc = c - r * chunks, m = m0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k_begin + cc * 8);
    *reinterpret_cast<uint4*>(xs + r * lds + cc * 8) = v;
  }
  if (V == pk::kLut && tid < 16) lut_s[tid] = lut[tid];
  __syncthreads();
  const int base = blockIdx.x * kMmaCols + warp * 64;
  if (base >= N) return;
  // MMA tile t, A row gid <-> column c0 + t; A row gid + 8 <-> column c1 + t
  const int c0 = base + 4 * gid, c1 = base + 32 + 4 * gid;

  float acc[NT][4][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][t][e] = 0.f;

  for (int b = 0; b < kchunk / 64; ++b) {
    const int kb = k_begin + b * 64;
    const uint8_t* p = packed + static_cast<size_t>(kb / 2) * N;
    // k-step j reads pair-rows 8j + tig (k 2tig, 2tig+1) and 8j + tig + 4 (k + 8)
    uint32_t w[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t r0 = static_cast<size_t>(8 * j + tig) * N, r1 = r0 + 4 * static_cast<size_t>(N);
      w[j][0] = __ldg(reinterpret_cast<const uint32_t*>(p + r0 + c0));
      w[j][1] = __ldg(reinterpret_cast<const uint32_t*>(p + r0 + c1));
      w[j][2] = __ldg(reinterpret_cast<const uint32_t*>(p + r1 + c0));
      w[j][3] = __ldg(reinterpret_cast<const uint32_t*>(p + r1 + c1));
    }
    const size_t srow = static_cast<size_t>(kb / 64) * N;
    float s0[4], s1[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      s0[t] = pk::load_scale(scale, scale_dtype, srow + c0 + t);
      s1[t] = pk::load_scale(scale, scale_dtype, srow + c1 + t);
    }
    float part[NT][4][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][t][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* xr = xs + (nt * 8 + gid) * lds + b * 64 + 16 * j + 2 * tig;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t a[4] = {pk::decode_pairs<V>((w[j][0] >> (8 * t)) & 0xFFu, lut_s),
                               pk::decode_pairs<V>((w[j][1] >> (8 * t)) & 0xFFu, lut_s),
                               pk::decode_pairs<V>((w[j][2] >> (8 * t)) & 0xFFu, lut_s),
                               pk::decode_pairs<V>((w[j][3] >> (8 * t)) & 0xFFu, lut_s)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(part[nt][t], a, bf[nt][0], bf[nt][1]);
      }
    }
    // D: d0/d1 = column c0 + t, x rows 2tig / 2tig+1; d2/d3 = column c1 + t
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][t][e] = __fadd_rn(acc[nt][t][e], __fmul_rn(part[nt][t][e], e < 2 ? s0[t] : s1[t]));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + nt * 8 + 2 * tig + h;
      if (m >= M) continue;
      float* row = ws + (static_cast<size_t>(blockIdx.y) * M + m) * N;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        row[c0 + t] = acc[nt][t][h];
        row[c1 + t] = acc[nt][t][2 + h];
      }
    }
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


template <int V>
void launch_tc(int nt, dim3 grid, size_t smem, cudaStream_t s, const void* x, const uint8_t* p, const void* scale,
               int scale_dtype, const uint16_t* lut, float* ws, int M, int K, int N, int kchunk, const int* ex, int ne) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  switch (nt) {
    case 1: matmul_pk_mma_kernel<V, 1><<<grid, 32 * kMmaWarps, smem, s>>>(xb, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
    case 2: matmul_pk_mma_kernel<V, 2><<<grid, 32 * kMmaWarps, smem, s>>>(xb, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
    default: matmul_pk_mma_kernel<V, 4><<<grid, 32 * kMmaWarps, smem, s>>>(xb, p, scale, scale_dtype, lut, ws, M, K, N, kchunk, ex, ne); break;
  }
}

}  // namespace

// x (M, K) f32|bf16, packed (K/2, N) u8, scale (K/64, N) f32|bf16, bias (N) f32
// or null, lut (16) bf16 bits or null, ws f32 (ksplit, M, N), out (M, N).
// expert: null for the 2-D path, else one int32 in device memory selecting
// expert e of stacked packed (E, K/2, N), scale (E, K/64, N) and bias (E, N),
// with E = n_experts.
// bf16 x runs on the tensor cores with rows = 8, 16 or 32 x rows per block;
// f32 x on CUDA cores with rows = 1, 2, 4 or 8.  Requires N % 128 == 0,
// (K/64) % ksplit == 0.
extern "C" int pk_matmul_pk(const void* x, int x_dtype, const void* packed, const void* scale, int scale_dtype,
                            const void* bias, const void* lut, void* ws, void* out, int out_dtype, int M, int K,
                            int N, int ksplit, int rows, int variant, const int* expert, int n_experts,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int kchunk = K / ksplit;
  auto p = static_cast<const uint8_t*>(packed);
  auto l = static_cast<const uint16_t*>(lut);
  auto w = static_cast<float*>(ws);
  if (x_dtype == pk::kBF16) {
    const size_t smem = static_cast<size_t>(rows) * (kchunk + 8) * 2;
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kMmaCols - 1) / kMmaCols, ksplit, (M + rows - 1) / rows);
    const int nt = rows / 8;
    switch (variant) {
      case pk::kExact: launch_tc<pk::kExact>(nt, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
      case pk::kZramp: launch_tc<pk::kZramp>(nt, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
      case pk::kRamp: launch_tc<pk::kRamp>(nt, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
      case pk::kLut: launch_tc<pk::kLut>(nt, grid, smem, s, x, p, scale, scale_dtype, l, w, M, K, N, kchunk, expert, n_experts); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
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
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const int threads = 256;
  reduce_splits_kernel<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0, s>>>(
      w, static_cast<const float*>(bias), out, out_dtype, M, N, ksplit, expert, n_experts);
  return static_cast<int>(cudaGetLastError());
}
