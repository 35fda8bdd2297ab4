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
//  * Block = two consumer warpgroups and two producer warpgroups (512
//    threads; setmaxnreg gives the consumers 176 registers and the producers
//    80, which only adds up when ptxas launches the kernel at 128 per thread:
//    the launch checks it and refuses any other count), output tile 128 x 128 (each consumer warpgroup 64 rows), a ring of
//    5 stages of 128 K-rows: the x8 tile [128 rows][128 k] and the decoded
//    weight tile [128 n][128 k], both K-major in the 128-byte swizzle of
//    hopper.cuh, which wgmma.mma_async m64n128k32 .s32.s8.s8 reads from
//    shared memory; mbarriers hand stages over (full: x landed and weights
//    decoded; empty: both consumer warpgroups are done with it).
//  * The int32 accumulators (64 per thread) drain into the f32 ones (64 more)
//    at each a8 K-tile boundary (a8_block_k / 128 stages, 8 at 1024): the int32
//    partial always covers exactly one K-tile before its rescale, so the
//    granularity of the numerics is the JAX path's.
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
//    permutes (3 prmt per four weights).  The consumers keep one stage's
//    wgmmas in flight while they wait for the next.
//  * Each weight tile is decoded M/128 times (once per 128-row M tile, was
//    M/64).  Raster: groups of 8 M tiles walk every N tile with M fastest,
//    so the blocks sharing an N tile run together (its packed bytes stay in
//    L2) and a wave reads only 8 slabs of x8 rows (which stay in L2 too).
//  * Short grids (fewer than half a wave of output tiles; ops/kernels.py::
//    w4a8_split): blockIdx.z splits the K-tiles into S contiguous ranges;
//    every block then writes each K-tile's f32 term (d * rs) * g' to scratch
//    and w4a8_combine adds them to 0 in K-tile order, then the bias: the same
//    additions in the same order as the unsplit kernel, so bit-equal to it.
//
// K8 (the expert form, replacing the a8 expert pallas_call :1215 and
// _expertify :946): the same kernels against expert e of a stacked
// (E, K/2, N) packing; each block reads e from device memory
// (pk::expert_index) and offsets packed, scale and bias itself.  Same tiles
// and arithmetic as the 2-D path: bit-equal to a 2-D launch on packed[e].
#include "hopper.cuh"
#include "pairk_decode.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128, kThreads = 512;
constexpr int kProducerRegs = 80, kConsumerRegs = 176;  // setmaxnreg: 256 * (80 + 176) = the SM's 65536
constexpr int kThreadRegs = (kProducerRegs + kConsumerRegs) / 2;  // what each thread must be launched with
constexpr int kStages = 5;  // x8 / weight tiles in the ring
constexpr int kAhead = 3;   // stages whose copies fly while one decodes
constexpr int kRaw = kAhead + 1;  // slots of raw packed bytes and scale rows
constexpr int kGroupM = 8;  // M tiles per raster group
constexpr int kMaxBlockK = 1 << 17;  // 127 * 127 * a8_block_k stays inside int32
constexpr int kTile = kBM * kBK;                  // bytes of the x8 tile (= the weight tile)
constexpr int kStageBytes = 2 * kTile;         // x8 and weights (1024-byte aligned: the swizzle reads bits 7-9)
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

// four nibbles (k order, low nibble first) -> four int8 from the 16-entry table t
__device__ __forceinline__ uint32_t lookup4(const uint32_t (&t)[4], uint32_t nib) {
  const uint32_t sel = nib & 0x7777u;
  const uint32_t lo = __byte_perm(t[0], t[1], sel);  // entries 0-7
  const uint32_t hi = __byte_perm(t[2], t[3], sel);  // entries 8-15
  return __byte_perm(lo, hi, 0x3210u | ((nib & 0x8888u) >> 1));  // bit 3 of a nibble picks hi
}

// named barrier of the producer warpgroup alone
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

template <int V>
__global__ void __launch_bounds__(kThreads, 1) w4a8_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  const size_t e = pk::expert_index(a.expert, a.n_experts);
  const uint8_t* packed = a.packed + e * (a.K / 2) * static_cast<size_t>(a.N);
  const void* scale = pk::offset_scale(a.scale, a.scale_dtype, e * (a.K / 64) * static_cast<size_t>(a.N));
  const float* bias = a.bias == nullptr ? nullptr : a.bias + e * a.N;

  const int tid = threadIdx.x, warp = tid >> 5;
  // grouped raster: kGroupM M tiles walk every N tile together, M fastest, so
  // a wave holds a few x8 row slabs and the N tiles' packed bytes in L2
  const int m_tiles = (a.M + kBM - 1) / kBM, n_tiles = a.N / kBN;
  const int grp = blockIdx.x / (kGroupM * n_tiles), first_m = grp * kGroupM;
  const int gm = min(kGroupM, m_tiles - first_m), local = blockIdx.x - grp * kGroupM * n_tiles;
  const int m0 = (first_m + local % gm) * kBM, n0 = (local / gm) * kBN;
  const int nk = a.K / a.a8_block_k, sub = a.a8_block_k / kBK;  // K-tiles, stages per K-tile
  const int kt_lo = blockIdx.z * nk / a.split, kt_hi = (blockIdx.z + 1) * nk / a.split;
  const int s_lo = kt_lo * sub, n_stages = (kt_hi - kt_lo) * sub;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 256);
      hop::mbar_init(&empty[s], 256);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroups: copies kAhead stages ahead, then the weight decode ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
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
      const int kb = (s_lo + j) * kBK;
      unsigned char* xs = smem + (j % kStages) * kStageBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 1024 chunks of 16 bytes
        const int c = tp + 256 * i, r = c >> 3, ch = c & 7, m = m0 + r;
        hop::cp_async16(xs + hop::sw128(r, ch), a.x8 + static_cast<size_t>(m < a.M ? m : 0) * a.K + kb + ch * 16,
                        m < a.M);
      }
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
    // ---- consumer warpgroups: rows 64 * wg.. of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    const int ra = m0 + wg * 64 + (warp & 3) * 16 + gid;  // this thread's rows ra and ra + 8
    const float c192_127 = 192.0f / 127.0f;
    int d[64];
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      d[i] = 0;
      acc[i] = 0.f;
    }
    int pend = -1;  // the stage whose wgmmas may still be in flight
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % kStages;
      hop::mbar_wait(&full[st], (s / kStages) & 1);
      const unsigned char* xs = smem + st * kStageBytes;
      const unsigned char* ws = xs + kTile;
      const uint64_t xdesc = hop::desc_sw128(xs + wg * 64 * 128, 16), wdesc = hop::desc_sw128(ws, 16);
      const int first = s % sub == 0;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        hop::wgmma_m64n128k32_s8(d, xdesc + ((kk * 32) >> 4), wdesc + ((kk * 32) >> 4), !(first && kk == 0));
      hop::wgmma_commit();
      if (s % sub != sub - 1) {  // keep this stage's wgmmas in flight; the previous one is done
        hop::wgmma_wait<1>();
        if (pend >= 0) hop::mbar_arrive(&empty[pend % kStages]);
        pend = s;
        continue;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(d);
      if (pend >= 0) hop::mbar_arrive(&empty[pend % kStages]);
      pend = -1;
      // rescale this K-tile's exact int32 partial: (d * rs) * (g * 192/127)
      const int kt = kt_lo + s / sub;
      const float* gs = reinterpret_cast<const float*>(smem + kOffG) + st * kBN;
      const float r0 = ra < a.M ? a.rs[static_cast<size_t>(ra) * nk + kt] : 0.f;
      const float r1 = ra + 8 < a.M ? a.rs[static_cast<size_t>(ra + 8) * nk + kt] : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float gn = __fmul_rn(gs[8 * j + 2 * tig + (q & 1)], c192_127);
          const float term = __fmul_rn(__fmul_rn(static_cast<float>(d[4 * j + q]), q < 2 ? r0 : r1), gn);
          if (a.split == 1) {
            acc[4 * j + q] = __fadd_rn(acc[4 * j + q], term);
          } else {
            const int m = q < 2 ? ra : ra + 8;
            if (m < a.M) a.terms[(static_cast<size_t>(kt) * a.M + m) * a.N + n0 + 8 * j + 2 * tig + (q & 1)] = term;
          }
        }
      }
      hop::mbar_arrive(&empty[st]);
    }
    if (a.split == 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = q < 2 ? ra : ra + 8, n = n0 + 8 * j + 2 * tig + (q & 1);
          if (m < a.M) {
            float v = acc[4 * j + q];
            if (bias != nullptr) v = __fadd_rn(v, bias[n]);
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n, v);
          }
        }
      }
    }
  }
}

// split > 1: out = ((0 + term_0) + term_1) + ... in K-tile order, then the bias; four outputs a thread
__global__ void w4a8_combine(const Args a) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  if (i >= mn) return;
  const size_t e = pk::expert_index(a.expert, a.n_experts);
  const int nk = a.K / a.a8_block_k;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const float4 t = *reinterpret_cast<const float4*>(a.terms + kt * mn + i);
    v[0] = __fadd_rn(v[0], t.x);
    v[1] = __fadd_rn(v[1], t.y);
    v[2] = __fadd_rn(v[2], t.z);
    v[3] = __fadd_rn(v[3], t.w);
  }
  if (a.bias != nullptr) {
    const float* b = a.bias + e * a.N + i % a.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], b[j]);
  }
  pk::store_out4(a.out, a.out_dtype, i, v);
}

// Registers per thread the kernel was built with.  The setmaxnreg split above needs exactly
// kThreadRegs: a lower count leaves the consumers' setmaxnreg.inc waiting forever.
template <int V>
int kernel_regs() {
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, w4a8_kernel<V>);
    if (err != cudaSuccess) return -static_cast<int>(err);
    regs = fa.numRegs;
  }
  return regs;
}

template <int V>
int launch(const Args& a, cudaStream_t s) {
  if (kernel_regs<V>() != kThreadRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(w4a8_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  w4a8_kernel<V><<<dim3((a.M + kBM - 1) / kBM * (a.N / kBN), 1, a.split), kThreads, kSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  w4a8_combine<<<static_cast<unsigned>((mn / 4 + 255) / 256), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  if (M <= 0 || N % kBN || a8_block_k <= 0 || a8_block_k % kBK || a8_block_k > kMaxBlockK || K % a8_block_k ||
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
