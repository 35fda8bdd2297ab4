// The int8 warpgroup-MMA GEMM main loop that K4 (matmul_pk_w4a8.cu, with its
// K8 form) and K5 (matmul_w8.cu) share.  The two kernels differ in how a
// stage is filled (K4's producer warpgroups copy with cp.async and decode
// packed FP4 bytes; K5's consumers issue TMA copies and its producers
// transpose an int8 shadow) and in the factor on g below.
//
//  * Block = two consumer and two producer warpgroups (512 threads;
//    setmaxnreg gives the consumers 176 registers and the producers 80,
//    which only adds up when ptxas launches the kernel at 128 per thread:
//    each launch checks it and refuses any other count), output tile 128 x
//    128 (each consumer warpgroup 64 rows), a ring of stages of 128 K-rows:
//    the x8 tile [128 rows][128 k] and the weight tile [128 n][128 k], both
//    K-major in the 128-byte swizzle of hopper.cuh, which wgmma.mma_async
//    m64n128k32 .s32.s8.s8 reads from shared memory; mbarriers hand stages
//    over (full: x landed and weights written, 256 producer arrivals; empty:
//    both consumer warpgroups are done with it, 256 arrivals).
//  * The int32 accumulators drain into f32 ones at each K-tile boundary
//    (block_k / 128 stages): the int32 partial d covers exactly one K-tile,
//    then acc = acc + (f32(d) * rs[m][tile]) * (g[n] * gmul), where g is the
//    stage's column row in shared memory (written by the producers) and gmul
//    the kernel's constant (K4: 192/127; K5: 1, an exact multiply).  The
//    consumers keep one stage's wgmmas in flight while they wait for the next.
//  * Raster: groups of 8 M tiles walk every N tile with M fastest, so the
//    blocks sharing an N tile run together (its weight bytes stay in L2) and
//    a wave reads only 8 slabs of x8 rows (which stay in L2 too).
//  * Short grids (fewer than half a wave of output tiles; ops/kernels.py::
//    w4a8_split): blockIdx.z splits the K-tiles into S contiguous ranges;
//    every block then writes each K-tile's f32 term (d * rs) * g' to scratch
//    and combine_terms adds them to 0 in K-tile order, then the bias: the
//    same additions in the same order as the unsplit kernel, so bit-equal to
//    it (a second launch).
#pragma once

#include "hopper.cuh"
#include "pairk_decode.cuh"

namespace i8 {

constexpr int kBM = 128, kBN = 128, kBK = 128, kThreads = 512;
constexpr int kProducerRegs = 80, kConsumerRegs = 176;  // setmaxnreg: 256 * (80 + 176) = the SM's 65536
constexpr int kThreadRegs = (kProducerRegs + kConsumerRegs) / 2;  // what each thread must be launched with
constexpr int kGroupM = 8;           // M tiles per raster group
constexpr int kMaxBlockK = 1 << 17;  // 127 * 127 * block_k stays inside int32
constexpr int kTile = kBM * kBK;     // bytes of the x8 tile (= the weight tile)

// one block's output tile (rows m0.., columns n0..) and its range of 128-row stages
struct Range {
  int m0, n0, nk, sub;  // nk: K-tiles of the whole K; sub: stages per K-tile
  int kt_lo, kt_hi;     // this block's K-tiles
  int s_lo, n_stages;   // its first stage and stage count
};

__device__ __forceinline__ Range block_range(int M, int N, int K, int block_k, int split) {
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = N / kBN;
  const int grp = blockIdx.x / (kGroupM * n_tiles), first_m = grp * kGroupM;
  const int gm = min(kGroupM, m_tiles - first_m), local = blockIdx.x - grp * kGroupM * n_tiles;
  Range r;
  r.m0 = (first_m + local % gm) * kBM;
  r.n0 = (local / gm) * kBN;
  r.nk = K / block_k;
  r.sub = block_k / kBK;
  r.kt_lo = blockIdx.z * r.nk / split;
  r.kt_hi = (blockIdx.z + 1) * r.nk / split;
  r.s_lo = r.kt_lo * r.sub;
  r.n_stages = (r.kt_hi - r.kt_lo) * r.sub;
  return r;
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 256);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
}

// where the consumers' results go
struct Out {
  const float* rs;    // (M, nk) f32
  const float* bias;  // (N) f32 or null (already offset to the block's expert)
  void* out;
  float* terms;       // split > 1: (nk, M, N) f32
  int out_dtype, M, N, split;
};

// The consumer warpgroups' whole part: setmaxnreg, the ring's wgmmas, the K-tile drains and the epilogue.
// Ring slot s starts at smem + s * kStride with the x8 tile, the weight tile after it; ``gs`` holds one f32
// row of kBN column factors per slot.  ``refill(t)`` runs in every consumer thread right after it released
// stage t (a kernel whose copies the consumers issue refills the slot there).
template <int kStages, int kStride, typename Refill>
__device__ __forceinline__ void consume(const unsigned char* smem, uint64_t* full, uint64_t* empty, const float* gs,
                                        float gmul, const Range& r, const Out& o, Refill refill) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wg = warp >> 2, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int ra = r.m0 + wg * 64 + (warp & 3) * 16 + gid;  // this thread's rows ra and ra + 8
  int d[64];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d[i] = 0;
    acc[i] = 0.f;
  }
  int pend = -1;  // the stage whose wgmmas may still be in flight
  for (int s = 0; s < r.n_stages; ++s) {
    const int st = s % kStages;
    hop::mbar_wait(&full[st], (s / kStages) & 1);
    const unsigned char* xs = smem + st * kStride;
    const unsigned char* ws = xs + kTile;
    const uint64_t xdesc = hop::desc_sw128(xs + wg * 64 * 128, 16), wdesc = hop::desc_sw128(ws, 16);
    const int first = s % r.sub == 0;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      hop::wgmma_m64n128k32_s8(d, xdesc + ((kk * 32) >> 4), wdesc + ((kk * 32) >> 4), !(first && kk == 0));
    hop::wgmma_commit();
    if (s % r.sub != r.sub - 1) {  // keep this stage's wgmmas in flight; the previous one is done
      hop::wgmma_wait<1>();
      if (pend >= 0) {
        hop::mbar_arrive(&empty[pend % kStages]);
        refill(pend);
      }
      pend = s;
      continue;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
    if (pend >= 0) {
      hop::mbar_arrive(&empty[pend % kStages]);
      refill(pend);
    }
    pend = -1;
    // rescale this K-tile's exact int32 partial: (d * rs) * (g * gmul)
    const int kt = r.kt_lo + s / r.sub;
    const float* g = gs + st * kBN;
    const float r0 = ra < o.M ? o.rs[static_cast<size_t>(ra) * r.nk + kt] : 0.f;
    const float r1 = ra + 8 < o.M ? o.rs[static_cast<size_t>(ra + 8) * r.nk + kt] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gn = __fmul_rn(g[8 * j + 2 * tig + (q & 1)], gmul);
        const float term = __fmul_rn(__fmul_rn(static_cast<float>(d[4 * j + q]), q < 2 ? r0 : r1), gn);
        if (o.split == 1) {
          acc[4 * j + q] = __fadd_rn(acc[4 * j + q], term);
        } else {
          const int m = q < 2 ? ra : ra + 8;
          if (m < o.M) o.terms[(static_cast<size_t>(kt) * o.M + m) * o.N + r.n0 + 8 * j + 2 * tig + (q & 1)] = term;
        }
      }
    }
    hop::mbar_arrive(&empty[st]);
    refill(s);
  }
  if (o.split == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = q < 2 ? ra : ra + 8, n = r.n0 + 8 * j + 2 * tig + (q & 1);
        if (m < o.M) {
          float v = acc[4 * j + q];
          if (o.bias != nullptr) v = __fadd_rn(v, o.bias[n]);
          pk::store_out(o.out, o.out_dtype, static_cast<size_t>(m) * o.N + n, v);
        }
      }
    }
  }
}

// split > 1: out = ((0 + term_0) + term_1) + ... in K-tile order, then the bias (row e of a stacked (E, N)
// bias for a K8 launch); four outputs a thread
__global__ void combine_terms(const float* terms, const float* bias, const int* expert, int n_experts, void* out,
                              int out_dtype, int M, int N, int nk) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const float4 t = *reinterpret_cast<const float4*>(terms + kt * mn + i);
    v[0] = __fadd_rn(v[0], t.x);
    v[1] = __fadd_rn(v[1], t.y);
    v[2] = __fadd_rn(v[2], t.z);
    v[3] = __fadd_rn(v[3], t.w);
  }
  if (bias != nullptr) {
    const float* b = bias + pk::expert_index(expert, n_experts) * N + i % N;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], b[j]);
  }
  pk::store_out4(out, out_dtype, i, v);
}

// Launch ``kernel`` with ``params`` on the (M/128 x N/128, 1, split) grid with ``smem`` bytes, then, for
// split > 1, combine_terms: a cudaError_t.  Refuses a kernel whose registers per thread (``regs``) are not
// kThreadRegs: the setmaxnreg split would leave the consumers waiting forever.
template <typename... P, typename... Q>
int launch(void (*kernel)(P...), int regs, int smem, int M, int N, int split, const float* terms, const float* bias,
           const int* expert, int n_experts, void* out, int out_dtype, int nk, cudaStream_t s, const Q&... params) {
  if (regs != kThreadRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((M + kBM - 1) / kBM * (N / kBN), 1, split), kThreads, smem, s>>>(params...);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  combine_terms<<<static_cast<unsigned>((mn / 4 + 255) / 256), 256, 0, s>>>(terms, bias, expert, n_experts, out,
                                                                           out_dtype, M, N, nk);
  return static_cast<int>(cudaGetLastError());
}

// registers per thread ``kernel`` was built with, or -cudaError
inline int kernel_regs(const void* kernel) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  return err == cudaSuccess ? fa.numRegs : -static_cast<int>(err);
}

}  // namespace i8
