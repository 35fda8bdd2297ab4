// K4: pair-K w4a8 prefill GEMM on the int8 tensor cores.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_pk_w4a8_kernel (:750),
// the a8 pallas_call of matmul_fp4_pk (:1185): bf16 prefill buckets of 256
// rows or more with an FP4-family variant.
//
// Numerics (as :776-803), per activation K-tile of a8_block_k rows (1024 for
// every Mistral shape; the caller resolves it exactly as the JAX path does):
//   g[n]    = max over the tile's quant blocks of scale[b][n]; 0 -> 1
//   f[b][n] = (scale[b][n] / g[n]) * f32(127/192)
//   w8      = rint(192*code * f[b][n])               (round half to even)
//   d       = exact int32 dot of x8 and w8 over the whole K-tile
//   acc     = acc + (f32(d) * rs[m][tile]) * (g[n] * f32(192/127))
// x8 / rs (per row and K-tile int8 activations and r/127) arrive
// pre-quantized from ops/kernels.py::quantize_activations, as the TPU path
// quantizes them in XLA outside its kernel.  The mma tiling (64-row K steps)
// is finer than a8_block_k, but the int32 partial always covers exactly one
// K-tile before its rescale, so the granularity of the numerics is the JAX
// path's.  |d| <= 127*127*a8_block_k stays far inside int32.
//
// Bound: int8 tensor-core ops (2*M*K*N at 1979 TOP/s) against the packed
// bytes; at M = 320 near the balance point, like K3.  Design (simple
// version): 64x128 output tile per 256-thread block (the int32 and f32
// accumulators both live in registers, so a 128-row tile would leave one
// block per SM), 64-row K steps; each step stages 64 int8 columns of x and
// decodes + requantizes 32 packed rows x 128 columns into an int8 [n][k] tile
// (the col-major B fragment of mma.sync.m16n8k32), rows padded to 80 bytes for
// conflict-free fragment reads.  The requant factor of each column is
// computed once per step into shared memory, and the next step's global data
// is loaded into registers while the current step's MMAs run.
//
// K8 (the expert form, replacing the a8 expert pallas_call :1215 and
// _expertify :946): the same kernel against expert e of a stacked (E, K/2, N)
// packing; each block reads e from device memory (pk::expert_index) and offsets
// packed, scale and bias itself.  Same tiles and arithmetic as the 2-D path:
// bit-equal to a 2-D launch on packed[e].
#include "pairk_decode.cuh"

namespace {

constexpr int kBN = 128, kBK = 64, kLds = kBK + 16;  // int8 bytes per smem row

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int V>
__global__ void __launch_bounds__(256) w4a8_kernel(
    const int8_t* __restrict__ x8, const float* __restrict__ rs, const uint8_t* __restrict__ packed,
    const void* __restrict__ scale, int scale_dtype, const float* __restrict__ bias, void* __restrict__ out,
    int out_dtype, int M, int K, int N, int a8_block_k, const int* __restrict__ expert, int n_experts) {
  constexpr int BM = 64, WM = 32, MT = 2, NT = 4;  // 2 x 4 warps, warp tile 32 x 32
  const size_t e = pk::expert_index(expert, n_experts);
  packed += e * (K / 2) * static_cast<size_t>(N);
  scale = pk::offset_scale(scale, scale_dtype, e * (K / 64) * static_cast<size_t>(N));
  if (bias != nullptr) bias += e * N;
  __shared__ __align__(16) int8_t xs[BM * kLds];
  __shared__ __align__(16) int8_t wsm[kBN * kLds];  // [n][k]
  __shared__ float g_s[kBN];  // tile column max of the scales (0 -> 1)
  __shared__ float f_s[kBN];  // this step's requant factor scale / g * 127/192
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * kBN;
  const int nk = K / a8_block_k, nsub = a8_block_k / kBK, nsteps = K / kBK;
  const int prow = tid >> 3, pc0 = (tid & 7) * 16;     // pair-row and 16 columns decoded by this thread
  const int xrow = tid >> 2, xc = (tid & 3) * 16;      // 16 bytes of the x8 tile staged by this thread
  const float c127_192 = 127.0f / 192.0f, c192_127 = 192.0f / 127.0f;

  float acc[MT][NT][4];
  int dacc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        dacc[i][j][e] = 0;
      }

  // the next step's global data, loaded while the current step's MMAs run
  uint4 xr, pr;
  float sr = 0.f, g = 1.f;
  auto load_step = [&](int s) {
    const int kb = s * kBK, m = m_blk + xrow;
    xr = m < M ? *reinterpret_cast<const uint4*>(x8 + static_cast<size_t>(m) * K + kb + xc)
               : make_uint4(0u, 0u, 0u, 0u);
    pr = *reinterpret_cast<const uint4*>(packed + static_cast<size_t>(kb / 2 + prow) * N + n_blk + pc0);
    if (tid < kBN) sr = pk::load_scale(scale, scale_dtype, static_cast<size_t>(s) * N + n_blk + tid);
  };
  load_step(0);

  for (int s = 0; s < nsteps; ++s) {
    const int kt = s / nsub, sub = s - kt * nsub;
    if (tid < kBN) {
      if (sub == 0) {  // new activation K-tile: column max of its scales
        float gm = sr;
        for (int b = 1; b < nsub; ++b)
          gm = fmaxf(gm, pk::load_scale(scale, scale_dtype, static_cast<size_t>(s + b) * N + n_blk + tid));
        g = gm == 0.f ? 1.f : gm;
        g_s[tid] = g;
      }
      f_s[tid] = __fmul_rn(__fdiv_rn(sr, g), c127_192);
    }
    *reinterpret_cast<uint4*>(xs + xrow * kLds + xc) = xr;
    __syncthreads();
    {
      const uint32_t words[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = pc0 + q * 4 + b;
          const uint32_t bits = pk::decode_pairs<V>((words[q] >> (8 * b)) & 0xFFu, nullptr);
          const float f = f_s[c];
          const int lo = __float2int_rn(__fmul_rn(pk::pair_lo(bits), f));  // round half to even
          const int hi = __float2int_rn(__fmul_rn(pk::pair_hi(bits), f));
          *reinterpret_cast<uint16_t*>(wsm + c * kLds + 2 * prow) =
              static_cast<uint16_t>((lo & 0xFF) | ((hi & 0xFF) << 8));
        }
      }
    }
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = wm * WM + mt * 16 + gid, col = ks + tig * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + col);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + col);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + col + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + col + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * 32 + nt * 8 + gid, k = ks + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wsm + n * kLds + k);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wsm + n * kLds + k + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(dacc[mt][nt], a[mt], b0, b1);
      }
    }
    if (sub == nsub - 1) {
      // rescale this K-tile's exact int32 partial: acc + (d * rs) * (g * 192/127)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int nl = wn * 32 + nt * 8 + tig * 2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m_blk + wm * WM + mt * 16 + gid + (e >> 1) * 8;
            const float r = m < M ? rs[static_cast<size_t>(m) * nk + kt] : 0.f;
            const float gn = __fmul_rn(g_s[nl + (e & 1)], c192_127);
            acc[mt][nt][e] =
                __fadd_rn(acc[mt][nt][e], __fmul_rn(__fmul_rn(static_cast<float>(dacc[mt][nt][e]), r), gn));
            dacc[mt][nt][e] = 0;
          }
        }
      }
    }
    __syncthreads();  // xs, wsm, f_s and g_s are rewritten by the next step
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

template <int V>
int launch(const int8_t* x8, const float* rs, const uint8_t* p, const void* scale, int scale_dtype,
           const float* bias, void* out, int out_dtype, int M, int K, int N, int a8_block_k, const int* ex, int ne,
           cudaStream_t s) {
  w4a8_kernel<V><<<dim3(N / kBN, (M + 63) / 64), 256, 0, s>>>(x8, rs, p, scale, scale_dtype, bias, out, out_dtype,
                                                              M, K, N, a8_block_k, ex, ne);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x8 (M, K) int8, rs (M, K/a8_block_k) f32, packed (K/2, N) u8, scale (K/64, N)
// f32|bf16, bias (N) f32 or null.  Requires N % 128 == 0, K % a8_block_k == 0,
// a8_block_k % 64 == 0.  FP4-family variants only.  expert: null for the 2-D
// path, else one int32 in device memory selecting expert e of stacked packed
// (E, K/2, N), scale (E, K/64, N) and bias (E, N), with E = n_experts.
extern "C" int pk_matmul_pk_w4a8(const void* x8, const void* rs, const void* packed, const void* scale,
                                 int scale_dtype, const void* bias, void* out, int out_dtype, int M, int K,
                                 int N, int a8_block_k, int variant, const int* expert, int n_experts,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(x8);
  auto r = static_cast<const float*>(rs);
  auto p = static_cast<const uint8_t*>(packed);
  auto b = static_cast<const float*>(bias);
  switch (variant) {
    case pk::kExact: return launch<pk::kExact>(x, r, p, scale, scale_dtype, b, out, out_dtype, M, K, N, a8_block_k, expert, n_experts, s);
    case pk::kZramp: return launch<pk::kZramp>(x, r, p, scale, scale_dtype, b, out, out_dtype, M, K, N, a8_block_k, expert, n_experts, s);
    case pk::kRamp: return launch<pk::kRamp>(x, r, p, scale, scale_dtype, b, out, out_dtype, M, K, N, a8_block_k, expert, n_experts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
