// K5: int8 GEMM over a pre-built int8 weight shadow (the prefill shadow).
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_w8_kernel (:813), the
// pallas_call of matmul_w8 (:905).  Every prefill GEMM of 256 rows or more
// of a layer with an attached shadow (models/linear.py::attach_int8_shadow):
// the weights were decoded (K6) and requantized once at attach time, so the
// kernel has no weight pass of its own.
//
// Numerics (as :828-845), per K-tile of block_k rows (1024, or 512 when the
// padded K is an odd multiple of 512; the shadow fixes it):
//   d   = exact int32 dot of x8 and w8 over the whole K-tile
//   acc = acc + (f32(d) * rs[m][tile]) * g[tile][n]
//   y   = acc (+ bias[n]) rounded once to the output type
// x8 / rs (per row and K-tile int8 activations and r/127) arrive
// pre-quantized from ops/kernels.py::quantize_activations; g is the shadow's
// per-tile column max / 127.  |d| <= 127*127*1024 < 2^24, so f32(d) is exact.
//
// Bound: at M = 256 the 1-byte weights (K*N bytes of w8 over 3.35 TB/s); at
// several thousand rows the int8 tensor cores (2*M*K*N at 1979 TOP/s).
// Design (simple version, K4's tiling without its decode): 64x128 output
// tile per 256-thread block, 64-row K steps on mma.sync.m16n8k32.s8.  The
// shadow is (K, N) row-major while the B fragment wants 4 consecutive k of
// one column, and 8-bit operands have no ldmatrix.trans: each thread loads a
// 4 (k) x 8 (n) byte block as four 8-byte row segments and transposes it in
// registers with __byte_perm, storing k-contiguous words into an int8 [n][k]
// tile whose rows are padded to 80 bytes (conflict-free fragment reads).  The
// next step's global data is loaded into registers while the current step's
// MMAs run.
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

// 4x4 byte transpose: r[i] holds row k+i, bytes = columns c..c+3; col[j]
// gets column c+j, bytes = rows k..k+3
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__global__ void __launch_bounds__(256) w8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                                                 const int8_t* __restrict__ w8, const float* __restrict__ g,
                                                 const float* __restrict__ bias, void* __restrict__ out,
                                                 int out_dtype, int M, int K, int N, int block_k) {
  constexpr int BM = 64, WM = 32, MT = 2, NT = 4;  // 2 x 4 warps, warp tile 32 x 32
  __shared__ __align__(16) int8_t xs[BM * kLds];
  __shared__ __align__(16) int8_t wsm[kBN * kLds];  // [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * kBN;
  const int nk = K / block_k, nsub = block_k / kBK, nsteps = K / kBK;
  const int wrg = tid & 15, wcg = tid >> 4;        // 4-row group and 8-column group of w8 staged by this thread
  const int xrow = tid >> 2, xc = (tid & 3) * 16;  // 16 bytes of the x8 tile staged by this thread

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
  uint4 xr;
  uint2 wr[4];
  auto load_step = [&](int s) {
    const int kb = s * kBK, m = m_blk + xrow;
    xr = m < M ? *reinterpret_cast<const uint4*>(x8 + static_cast<size_t>(m) * K + kb + xc)
               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wr[i] = *reinterpret_cast<const uint2*>(w8 + static_cast<size_t>(kb + 4 * wrg + i) * N + n_blk + 8 * wcg);
  };
  load_step(0);

  for (int s = 0; s < nsteps; ++s) {
    const int kt = s / nsub, sub = s - kt * nsub;
    *reinterpret_cast<uint4*>(xs + xrow * kLds + xc) = xr;
    {
      const uint32_t lo[4] = {wr[0].x, wr[1].x, wr[2].x, wr[3].x};
      const uint32_t hi[4] = {wr[0].y, wr[1].y, wr[2].y, wr[3].y};
      uint32_t col[4];
      transpose4x4(lo, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(wsm + (8 * wcg + j) * kLds + 4 * wrg) = col[j];
      transpose4x4(hi, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(wsm + (8 * wcg + 4 + j) * kLds + 4 * wrg) = col[j];
    }
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = wm * WM + mt * 16 + gid, c = ks + tig * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + c);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + c);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xs + r0 * kLds + c + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xs + (r0 + 8) * kLds + c + 16);
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
      // rescale this K-tile's exact int32 partial: acc + (d * rs) * g
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n_blk + wn * 32 + nt * 8 + tig * 2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m_blk + wm * WM + mt * 16 + gid + (e >> 1) * 8;
            const float r = m < M ? rs[static_cast<size_t>(m) * nk + kt] : 0.f;
            const float gn = __ldg(g + static_cast<size_t>(kt) * N + n + (e & 1));
            acc[mt][nt][e] =
                __fadd_rn(acc[mt][nt][e], __fmul_rn(__fmul_rn(static_cast<float>(dacc[mt][nt][e]), r), gn));
            dacc[mt][nt][e] = 0;
          }
        }
      }
    }
    __syncthreads();  // xs and wsm are rewritten by the next step
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

// x8 (M, K) int8, rs (M, K/block_k) f32, w8 (K, N) int8, g (K/block_k, N)
// f32, bias (N) f32 or null, out (M, N) f32|bf16|f16.  Requires N % 128 == 0,
// K % block_k == 0 and block_k % 64 == 0; any M.
extern "C" int pk_matmul_w8(const void* x8, const void* rs, const void* w8, const void* g, const void* bias,
                            void* out, int out_dtype, int M, int K, int N, int block_k, void* stream) {
  if (M <= 0) return 0;
  w8_kernel<<<dim3(N / kBN, (M + 63) / 64), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(rs), static_cast<const int8_t*>(w8),
      static_cast<const float*>(g), static_cast<const float*>(bias), out, out_dtype, M, K, N, block_k);
  return static_cast<int>(cudaGetLastError());
}
