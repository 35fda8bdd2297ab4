// K9b: split-K fused dequant-matmul, y = x_hi . W_hi + x_lo . W_lo + bias.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_matmul_kernel (:322), the
// pallas_call of matmul_fp4 (:472) and gemv_fp4 (:485): every linear of a
// split-K model (bnb-exact FP4/NF4 checkpoints, K-sharded wo/w_down).
//
// Layout: packed (K/2, N) u8, byte (i, n) = code(Wt[i, n]) << 4 |
// code(Wt[K/2 + i, n]); absmax_hi / absmax_lo (K/128, N) f32, the TRUE absmax
// of the 64-row blocks of the two halves.  With k_shards = D the packing is
// D self-contained slices along K: packed row i of shard d = i / (K/2D)
// meets x column d*K/D + i % (K/2D) with its high nibble and the column K/2D
// further with its low one (D = 1: columns i and K/2 + i).  The bf16
// kernels compute those columns themselves, so a K-sharded layer's x is read
// in place (ops/kernels.py::splitk_x_columns is the same map in Python); the
// f32 stream takes one shard (its wrapper gathers a sharded x).
//
// Numerics (as :346-363): each weight is decoded in f32 as table[nibble] *
// absmax (one __fmul_rn, never contracted).  bf16 x: the weight is rounded
// once to bf16, products of two bf16 values are exact in f32 and accumulate
// in f32 (the tensor cores).  f32 x: the weight stays f32 and the dot is a
// true f32 dot of fmaf steps on the CUDA cores (the TPU's Precision.HIGHEST;
// TF32 tensor cores would miss the 1e-5 tolerance).  Bias is added in f32;
// one cast to the output type at the end.
//
// Bound: the HBM bytes of the packed weights (K*N/2) and absmax (K*N/16) up
// to a few tens of rows, the bf16 tensor cores (2*M*K*N) at 128+.  The
// absmax multiply comes before the bf16 rounding, so it cannot move onto
// partial sums (as K2's scale does): every weight costs a table value, an
// f32 multiply and a rounding.  At M = 1 the card must decode ~14.5 HBM
// bytes per SM per clock, so the decode is the budget to watch.
//
// Three kernels, one contract:
//  * small (bf16 x, M <= 32; ops/kernels.py::k9b_plan): K2's structure.  One
//    block takes every x row (NR = 8, 16 or 32 rows, the n of its wgmma;
//    rows past M are TMA's zero fill) and 256 columns (128 below N = 4096):
//    CW = 4 (2) consumer warpgroups of 64 columns.  The decoded weights are
//    the register A operand of wgmma.m64nNRk16, x^T the B tile: each stage
//    (one 64-row absmax block) brings by TMA, from one producer warp, the
//    packed bytes in [64 rows][128 columns] boxes under the 128-byte swizzle,
//    the two absmax rows and two x boxes [NR][64] (the hi and the lo columns
//    of the block, in its shard).  Warp w owns 16 columns; MMA row g is
//    column 2g, row g + 8 column 2g + 1, so one 16-bit load brings both of a
//    lane's bytes of a packed row (K2's map).  The decode: a per-lane table
//    of all 256 byte values, (table[X >> 4], table[X & 15]) as two f32,
//    built once per block (64 KB; lane l's copy at X * 256 + 8 l, so a
//    warp's 32 lookups hit 32 bank pairs whatever its bytes), addressed by
//    one byte permute; then two __fmul_rn by the column's absmax and one
//    cvt.rn.bf16x2 per two weights.  Two k16 steps' fragments are decoded
//    (16 table reads in flight, the next steps' packed rows loading) while
//    the previous two steps' 4 wgmmas run (two register buffers).  K splits
//    within one wave (>= 4 quant blocks of 64 K-rows a split, d <= K / (16 M)) are
//    summed by the last block of each column tile in split order
//    (pk::merge_splits): one launch, deterministic, graph-safe.
//  * large (bf16 x, M > 32): K3's structure with 128 x 128 tiles.  Two
//    consumer warpgroups of 64 rows run wgmma.m64n128k16 from shared memory;
//    one warp keeps a ring of 3 stages filled by TMA (x hi and lo boxes
//    [128 rows][64], the packed bytes [64 rows][128], the two absmax rows),
//    and two decoding warpgroups write each stage's packed bytes into its
//    swizzled hi and lo weight panels [128 n][64 k]: thread (warp rq, lane c)
//    takes columns 4c..4c+3 of rows 8rq..8rq+7, 8 conflict-free 32-bit loads,
//    table[nibble] from a 16-entry table in shared memory (all lanes read the
//    same 64 bytes: no conflicts), __fmul_rn, cvt.rn.bf16x2, 16-byte stores
//    in a lane-rotated column order (8 lanes of a store phase hit 8 swizzle
//    positions).  The same in-launch K split (at most 4) fills the SMs at N
//    = 1024 / 4096.
//  * stream (f32 x, any M): CUDA cores.  Each thread owns 4 adjacent columns
//    (one 32-bit load of 4 packed bytes per packed row, 32 loads in flight),
//    the block's x rows sit in shared memory as f32, hi and lo halves.  K is
//    split across blocks until the grid fills the SMs; every split writes
//    its f32 partial to a workspace and a second kernel sums the splits in a
//    fixed order (deterministic) and adds the bias.
#include "hopper.cuh"
#include "pairk_decode.cuh"  // dtype codes, output stores, the split merge

namespace {

// the x column that packed row i meets with its high nibble, for shards of kpl packed rows (the low
// nibble's is kpl further)
__device__ __forceinline__ int x_col_hi(int i, int kpl) { return (i / kpl) * 2 * kpl + i % kpl; }

// ---------------------------------------------------------------------------
// stream: f32 x on the CUDA cores, K split across blocks
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kCols = 4;  // output columns per thread

template <int MT>
__global__ void __launch_bounds__(kThreads) splitk_stream_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ absmax_hi,
    const float* __restrict__ absmax_lo, const float* __restrict__ table, float* __restrict__ ws, int M, int KP,
    int N, int kchunk) {
  extern __shared__ float xs[];  // [MT][2][kchunk]: rows of x_hi then x_lo
  __shared__ float tab[16];
  const int K = 2 * KP;
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int k_begin = blockIdx.y * kchunk;  // first packed row of this split
  const int m0 = blockIdx.z * MT;
  for (int idx = threadIdx.x; idx < MT * 2 * kchunk; idx += kThreads) {
    const int rh = idx / kchunk, c = idx - rh * kchunk, r = rh >> 1, h = rh & 1;
    const int m = m0 + r;
    xs[idx] = m < M ? x[static_cast<size_t>(m) * K + static_cast<size_t>(h) * KP + k_begin + c] : 0.f;
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
          const float wh = __fmul_rn(tab[byte >> 4], sh[c]);
          const float wl = __fmul_rn(tab[byte & 0xFu], sl[c]);
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

template <int MT>
void launch_stream(dim3 grid, size_t smem, cudaStream_t s, const float* x, const uint8_t* p, const float* hi,
                   const float* lo, const float* tab, float* ws, int M, int KP, int N, int kchunk) {
  splitk_stream_kernel<MT><<<grid, kThreads, smem, s>>>(x, p, hi, lo, tab, ws, M, KP, N, kchunk);
}

// ---------------------------------------------------------------------------
// bf16 x: what the two warpgroup-MMA kernels share
// ---------------------------------------------------------------------------

struct Args {
  const float* bias;
  const float* table;  // (16) f32
  void* out;
  float* ws;      // ksplit > 1: (ksplit, M, N) f32 partials
  int* counters;  // ksplit > 1: one int32 per output tile, 0 between launches
  int out_dtype, M, K, N, nbs, kpl;  // nbs: absmax blocks (64 packed rows) per split; kpl: packed rows per shard
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {  // lo -> bits 0-15, both rounded to nearest even
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// small: every x row in one block, the decoded weights as the register A operand
// ---------------------------------------------------------------------------

constexpr int kTable = 256 * 256;  // the per-lane decode table at the start of shared memory: [256 bytes][32 lanes] float2
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may take

template <int NR, int CW>
struct Small {
  static constexpr int BN = 64 * CW;             // output columns per block
  static constexpr int THREADS = 128 * CW + 32;  // + one producer warp
  static constexpr int W_BYTES = 64 * BN;        // BN / 128 boxes of [64 packed rows][128 columns]
  static constexpr int OFF_XH = W_BYTES;         // [NR rows][64 k] bf16, the hi columns (1024-byte aligned)
  static constexpr int OFF_XL = OFF_XH + NR * 128;  // the lo columns
  static constexpr int OFF_A = OFF_XL + NR * 128;   // absmax hi row (BN f32), then the lo row
  static constexpr int STAGE = (OFF_A + 2 * BN * 4 + 1023) / 1024 * 1024;
  static constexpr int TAIL = 1024 + 64 + 16;  // alignment slack, the f32 table, the merge ticket
  static constexpr int STAGES = (kSmemMax - kTable - TAIL) / (STAGE + 16) < 8 ? (kSmemMax - kTable - TAIL) / (STAGE + 16) : 8;
  static constexpr int OFF_BAR = STAGES * STAGE;
  static constexpr int SMEM = kTable + 1024 + OFF_BAR + 2 * STAGES * 8 + 64 + 16;
};

template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&d)[NR / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NR == 8) hop::wgmma_m64n8k16_rs(d, a, db, 1);
  else if constexpr (NR == 16) hop::wgmma_m64n16k16_rs(d, a, db, 1);
  else hop::wgmma_m64n32k16_rs(d, a, db, 1);
}

template <int NR, int CW>
__global__ void __launch_bounds__(Small<NR, CW>::THREADS, 1)
    splitk_small_kernel(const Args a, const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tl) {
  using C = Small<NR, CW>;
  constexpr int NA = NR / 2;  // f32 accumulators per thread and wgmma
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw + kTable) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  float* tab_s = reinterpret_cast<float*>(empty + C::STAGES);
  int* ticket = reinterpret_cast<int*>(tab_s + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * C::BN, b0 = blockIdx.y * a.nbs;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * CW);  // one arrival per consumer warp
    }
    hop::mbar_init_fence();
  }
  if (tid < 16) tab_s[tid] = a.table[tid];
  __syncthreads();

  if (warp == 4 * CW) {
    // ---- producer warp: the ring of absmax blocks, by TMA ----
    if (lane == 0) {
      for (int i = 0; i < a.nbs; ++i) {
        const int st = i % C::STAGES, b = b0 + i, xh = x_col_hi(64 * b, a.kpl);
        if (i >= C::STAGES) hop::mbar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
        unsigned char* sp = smem + st * C::STAGE;
        hop::mbar_expect_tx(&full[st], C::W_BYTES + 2 * NR * 128 + 2 * C::BN * 4);  // out-of-bounds boxes count in full
#pragma unroll
        for (int h = 0; h < C::BN / 128; ++h) hop::tma_load_2d(sp + h * 8192, &tp, &full[st], n0 + 128 * h, 64 * b);
        hop::tma_load_2d(sp + C::OFF_XH, &tx, &full[st], xh, 0);
        hop::tma_load_2d(sp + C::OFF_XL, &tx, &full[st], xh + a.kpl, 0);
        hop::tma_load_2d(sp + C::OFF_A, &th, &full[st], n0, b);
        hop::tma_load_2d(sp + C::OFF_A + C::BN * 4, &tl, &full[st], n0, b);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: warp w owns columns 16w..16w+15 of the block tile; lane (g, t) its columns
    // c = 16w + 2g (MMA row g of the warp) and c + 1 (row g + 8), both in one 16-bit load of a packed row ----
    const int gid = lane >> 2, tig = lane & 3;
    const int col = 16 * warp + 2 * gid;               // in the block tile
    const int chunk = warp & 7, boff = 2 * gid;       // the warp's 16-byte chunk in its box, the lane's bytes
    const uint32_t lane8 = 8 * lane;
    // (table[X >> 4], table[X & 15]) of every byte X, lane l's copy at X * 256 + 8 l
    for (int idx = tid; idx < 256 * 32; idx += 128 * CW) {
      const int X = idx >> 5;
      *reinterpret_cast<float2*>(smem_raw + X * 256 + (idx & 31) * 8) = make_float2(tab_s[X >> 4], tab_s[X & 15]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");  // the consumer warps alone
    float d[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) d[q] = 0.f;
    uint32_t fr[2][2][2][4] = {};  // [group][step][hi, lo][A fragment]
    int prev = -1;                 // the stage whose last wgmmas may still be in flight
    for (int i = 0; i < a.nbs; ++i) {
      const int st = i % C::STAGES;
      hop::mbar_wait(&full[st], (i / C::STAGES) & 1);
      const unsigned char* sp = smem + st * C::STAGE;
      const float2 ah = *reinterpret_cast<const float2*>(sp + C::OFF_A + col * 4);
      const float2 al = *reinterpret_cast<const float2*>(sp + C::OFF_A + (C::BN + col) * 4);
      const float sh[2] = {ah.x, ah.y}, sl[2] = {al.x, al.y};
      const unsigned char* box = sp + (warp >> 3) * 8192 + boff;
      const uint64_t xdh = hop::desc_sw128(sp + C::OFF_XH, 16), xdl = hop::desc_sw128(sp + C::OFF_XL, 16);
      // step q's packed rows 16q + 2t, + 1, + 8, + 9 (A's k 2t, 2t+1, 2t+8, 2t+9), 2 columns each
      auto load_rows = [&](int q, uint32_t (&u)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * q + 2 * tig + (r & 1) + 8 * (r >> 1);
          u[r] = *reinterpret_cast<const uint16_t*>(box + row * 128 + ((chunk ^ (row & 7)) << 4));
        }
      };
      uint32_t u[2][2][4];  // [group][step of the group][row]: the next group's rows load while one decodes
      load_rows(0, u[0][0]);
      load_rows(1, u[0][1]);
#pragma unroll
      for (int gq = 0; gq < 2; ++gq) {  // two groups of two k16 steps: 16 table reads in flight per group
        if (gq == 0) {
          load_rows(2, u[1][0]);
          load_rows(3, u[1][1]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float hv[4][2], lv[4][2];  // [row][column]
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // byte j of the row's pair at [8 l, X, 0, 0]: offset X * 256 + 8 l of lane l's table
              const float2 t =
                  *reinterpret_cast<const float2*>(smem_raw + __byte_perm(u[gq][e][r], lane8, 0x5504u | (j << 4)));
              hv[r][j] = __fmul_rn(t.x, sh[j]);
              lv[r][j] = __fmul_rn(t.y, sl[j]);
            }
          }
          uint32_t (&fh)[4] = fr[gq][e][0];
          uint32_t (&fl)[4] = fr[gq][e][1];
          fh[0] = bf16x2(hv[0][0], hv[1][0]);
          fh[1] = bf16x2(hv[0][1], hv[1][1]);
          fh[2] = bf16x2(hv[2][0], hv[3][0]);
          fh[3] = bf16x2(hv[2][1], hv[3][1]);
          fl[0] = bf16x2(lv[0][0], lv[1][0]);
          fl[1] = bf16x2(lv[0][1], lv[1][1]);
          fl[2] = bf16x2(lv[2][0], lv[3][0]);
          fl[3] = bf16x2(lv[2][1], lv[3][1]);
        }
        hop::wgmma_fence();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wgmma_rs<NR>(d, fr[gq][e][0], xdh + 2 * (2 * gq + e));
          wgmma_rs<NR>(d, fr[gq][e][1], xdl + 2 * (2 * gq + e));
        }
        hop::fence_regs(d);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the previous group's wgmmas are done: its fragments and, at gq = 0, its stage free
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) hop::fence_regs(fr[gq ^ 1][e][h]);
        if (gq == 0 && prev >= 0) hop::mbar_arrive_warp(&empty[prev % C::STAGES]);
      }
      prev = i;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(d);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) hop::fence_regs(fr[1][e][h]);
    // element 4j + q of d: column col + (q >> 1), x row 8j + 2t + (q & 1)
    const int n = n0 + col;
    if (n < a.N) {
#pragma unroll
      for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * j + 2 * tig + h;
          if (m >= a.M) continue;
          float v0 = d[4 * j + h], v1 = d[4 * j + 2 + h];
          if (gridDim.y > 1) {
            *reinterpret_cast<float2*>(a.ws + (static_cast<size_t>(blockIdx.y) * a.M + m) * a.N + n) =
                make_float2(v0, v1);
          } else {
            if (a.bias != nullptr) {
              v0 = __fadd_rn(v0, a.bias[n]);
              v1 = __fadd_rn(v1, a.bias[n + 1]);
            }
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n, v0);
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n + 1, v1);
          }
        }
      }
    }
  }
  if (gridDim.y > 1)
    pk::merge_splits(a.ws, a.bias, a.out, a.out_dtype, a.M, a.N, gridDim.y, 0, a.M, n0, min(n0 + C::BN, a.N),
                     a.counters + blockIdx.x, ticket);
}

// ---------------------------------------------------------------------------
// large: 128 x 128 tiles, a producer warpgroup decoding into shared memory
// ---------------------------------------------------------------------------

namespace big {
constexpr int kBM = 128, kBN = 128, kConsumers = 2, kDecoders = 2;  // warpgroups: 64 rows / 32 packed rows each
constexpr int kThreads = 128 * (kConsumers + kDecoders) + 32;      // + one copying warp
constexpr int kStages = 3;                  // ring slots
constexpr int kOffXL = kBM * 128;           // after the x hi box [128 rows][64 k] bf16: the lo box
constexpr int kOffWH = 2 * kBM * 128;       // the decoded hi weights [128 n][64 k] bf16
constexpr int kOffWL = kOffWH + kBN * 128;  // the lo weights
constexpr int kOffRaw = kOffWL + kBN * 128; // the packed bytes [64 rows][128 columns]
constexpr int kOffA = kOffRaw + 64 * kBN;   // absmax hi row (128 f32), then the lo row
constexpr int kStage = (kOffA + 2 * kBN * 4 + 1023) / 1024 * 1024;
constexpr int kOffBar = kStages * kStage;
constexpr int kSmem = 1024 + kOffBar + 3 * kStages * 8 + 64 + 16;
}  // namespace big

__global__ void __launch_bounds__(big::kThreads, 1)
    splitk_large_kernel(const Args a, const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tl) {
  using namespace big;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* copied = reinterpret_cast<uint64_t*>(smem + kOffBar);  // x, packed bytes and absmax landed
  uint64_t* full = copied + kStages;                                // weights decoded
  uint64_t* empty = full + kStages;                                 // consumers done with the stage
  float* tab_s = reinterpret_cast<float*>(empty + kStages);
  int* ticket = reinterpret_cast<int*>(tab_s + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * kBM, b0 = blockIdx.y * a.nbs;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&copied[s], 1);
      hop::mbar_init(&full[s], 4 * kDecoders);    // one arrival per decoding warp
      hop::mbar_init(&empty[s], 4 * kConsumers);  // one per consumer warp
    }
    hop::mbar_init_fence();
  }
  if (tid < 16) tab_s[tid] = a.table[tid];
  __syncthreads();

  if (warp == 4 * (kConsumers + kDecoders)) {
    // ---- copying warp: the ring by TMA, as far ahead as the slots allow ----
    if (lane == 0) {
      for (int j = 0; j < a.nbs; ++j) {
        const int st = j % kStages, b = b0 + j, xh = x_col_hi(64 * b, a.kpl);
        if (j >= kStages) hop::mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        unsigned char* sp = smem + st * kStage;
        hop::mbar_expect_tx(&copied[st], 2 * kBM * 128 + 64 * kBN + 2 * kBN * 4);
        hop::tma_load_2d(sp, &tx, &copied[st], xh, m0);
        hop::tma_load_2d(sp + kOffXL, &tx, &copied[st], xh + a.kpl, m0);
        hop::tma_load_2d(sp + kOffRaw, &tp, &copied[st], n0, 64 * b);
        hop::tma_load_2d(sp + kOffA, &th, &copied[st], n0, b);
        hop::tma_load_2d(sp + kOffA + kBN * 4, &tl, &copied[st], n0, b);
      }
    }
    __syncwarp();
  } else if (warp >= 4 * kConsumers) {
    // ---- decoding warpgroups: thread (warp rq, lane cg) takes columns 4 cg.. of packed rows 8 rq.. ----
    const int pt = tid - 128 * kConsumers, cg = pt & 31, rq = pt >> 5, rot = (cg >> 1) & 3;
    for (int s = 0; s < a.nbs; ++s) {
      const int st = s % kStages;
      unsigned char* sp = smem + st * kStage;
      hop::mbar_wait(&copied[st], (s / kStages) & 1);
      uint32_t rw[8];  // all loaded before the first store
#pragma unroll
      for (int r = 0; r < 8; ++r) rw[r] = *reinterpret_cast<const uint32_t*>(sp + kOffRaw + (8 * rq + r) * kBN + 4 * cg);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = (jj + rot) & 3, c = 4 * cg + j;  // rotated: a store phase's 8 lanes hit 8 swizzle positions
        const float ahi = reinterpret_cast<const float*>(sp + kOffA)[c];
        const float alo = reinterpret_cast<const float*>(sp + kOffA + kBN * 4)[c];
        uint32_t vh[4], vl[4];  // bf16 pairs of k 8 rq + 2p, + 1 (hi and lo)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t u0 = rw[2 * p] >> (8 * j), u1 = rw[2 * p + 1] >> (8 * j);
          vh[p] = bf16x2(__fmul_rn(tab_s[(u0 >> 4) & 15u], ahi), __fmul_rn(tab_s[(u1 >> 4) & 15u], ahi));
          vl[p] = bf16x2(__fmul_rn(tab_s[u0 & 15u], alo), __fmul_rn(tab_s[u1 & 15u], alo));
        }
        // chunk rq of the column's row: k 8 rq..8 rq + 7
        *reinterpret_cast<uint4*>(sp + kOffWH + hop::sw128(c, rq)) = make_uint4(vh[0], vh[1], vh[2], vh[3]);
        *reinterpret_cast<uint4*>(sp + kOffWL + hop::sw128(c, rq)) = make_uint4(vl[0], vl[1], vl[2], vl[3]);
      }
      hop::fence_proxy_async();  // the st.shared of the weights are read by wgmma
      hop::mbar_arrive_warp(&full[st]);
    }
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
      const uint64_t xh = hop::desc_sw128(sp + wg * 64 * 128, 16), xl = hop::desc_sw128(sp + kOffXL + wg * 64 * 128, 16);
      const uint64_t wh = hop::desc_sw128(sp + kOffWH, 16), wl = hop::desc_sw128(sp + kOffWL, 16);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::wgmma_m64n128k16_ss(acc, xh + 2 * kk, wh + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::wgmma_m64n128k16_ss(acc, xl + 2 * kk, wl + 2 * kk, 1);
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
            if (a.bias != nullptr) {
              v0 = __fadd_rn(v0, a.bias[n]);
              v1 = __fadd_rn(v1, a.bias[n + 1]);
            }
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n, v0);
            pk::store_out(a.out, a.out_dtype, static_cast<size_t>(m) * a.N + n + 1, v1);
          }
        }
      }
    }
  }
  if (gridDim.y > 1)
    pk::merge_splits(a.ws, a.bias, a.out, a.out_dtype, a.M, a.N, gridDim.y, m0, min(m0 + kBM, a.M), n0, n0 + kBN,
                     a.counters + blockIdx.z * gridDim.x + blockIdx.x, ticket);
}

// the tensor maps of one bf16 launch: packed (columns, rows) in [64][128] boxes (swizzled for the small
// kernel's register loads, plain for the large kernel's producer); x (k, rows) in [rows][64] boxes; the
// absmax halves (columns, blocks) in [1][cols] rows
int make_maps(CUtensorMap* m, const void* x, const void* packed, const void* hi, const void* lo, int M, int K, int N,
              int rows, int cols, bool swizzle_packed) {
  const cuuint64_t KP = K / 2;
  const cuuint64_t pd[2] = {static_cast<cuuint64_t>(N), KP}, ps[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t pb[2] = {128, 64};
  int err = hop::make_map(&m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, pd, ps, pb,
                          swizzle_packed ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)}, xs[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xb[2] = {64, static_cast<cuuint32_t>(rows)};
  if (err == 0) err = hop::make_map(&m[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t ad[2] = {static_cast<cuuint64_t>(N), KP / 64}, as[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t ab[2] = {static_cast<cuuint32_t>(cols), 1};
  if (err == 0) err = hop::make_map(&m[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, hi, ad, as, ab, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0) err = hop::make_map(&m[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, lo, ad, as, ab, CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

template <int NR, int CW>
int launch_small(const Args& a, const CUtensorMap* m, int ksplit, cudaStream_t s) {
  using C = Small<NR, CW>;
  const cudaError_t ce = cudaFuncSetAttribute(splitk_small_kernel<NR, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  splitk_small_kernel<NR, CW><<<dim3((a.N + C::BN - 1) / C::BN, ksplit, 1), C::THREADS, C::SMEM, s>>>(a, m[0], m[1], m[2], m[3]);
  return static_cast<int>(cudaGetLastError());
}

template <int CW>
int launch_small_rows(int rows, const Args& a, const CUtensorMap* m, int ksplit, cudaStream_t s) {
  switch (rows) {
    case 8: return launch_small<8, CW>(a, m, ksplit, s);
    case 16: return launch_small<16, CW>(a, m, ksplit, s);
    case 32: return launch_small<32, CW>(a, m, ksplit, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int CW>
int small_smem(int rows) {
  switch (rows) {
    case 8: return Small<8, CW>::SMEM;
    case 16: return Small<16, CW>::SMEM;
    case 32: return Small<32, CW>::SMEM;
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, K) f32|bf16; packed (K/2, N) u8; absmax_hi / absmax_lo (K/128, N)
// f32; bias (N) f32 or null; table (16) f32; out (M, N) f32|bf16|f16.
// k_shards: K shards of the packing (K/2 % (64 k_shards) == 0; 1 for f32 x).  Requires
// blocksize 64, N % 128 == 0, (K/2) % 64 == 0, 16-byte aligned buffers.
// bf16 x: rows = 8, 16 or 32 (>= M; the small kernel, cols 128 or 256
// output columns per block) or 128 (the large kernel, 128-row M tiles);
// ksplit divides K/128, and ksplit > 1 needs ws (ksplit, M, N) f32 and
// counters (one int32 per output tile, all 0); one launch.
// f32 x: the stream, rows = 1, 2, 4 or 8 x rows per block, ksplit divides
// K/128 with the block's x slice inside 48 KB, ws (ksplit, M, N) f32 always,
// and the split reduction as a second launch; counters and cols unused.
extern "C" int pk_matmul_splitk(const void* x, int x_dtype, const void* packed, const void* absmax_hi,
                                const void* absmax_lo, const void* bias, const void* table, void* ws, void* counters,
                                void* out, int out_dtype, int M, int K, int N, int k_shards, int ksplit, int rows,
                                int cols, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int KP = K / 2;
  if (M <= 0 || N % 128 || KP % 64 || k_shards < 1 || KP % (64 * k_shards) || ksplit < 1 || (KP / 64) % ksplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kpl = KP / k_shards;
  auto hi = static_cast<const float*>(absmax_hi);
  auto lo = static_cast<const float*>(absmax_lo);
  auto b = static_cast<const float*>(bias);
  auto w = static_cast<float*>(ws);
  if (x_dtype == pk::kBF16) {
    const bool large = rows == 128;
    if ((!large && (rows < M || (cols != 128 && cols != 256))) || (ksplit > 1 && (ws == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.bias = b;
    a.table = static_cast<const float*>(table);
    a.out = out;
    a.ws = w;
    a.counters = static_cast<int*>(counters);
    a.out_dtype = out_dtype;
    a.M = M;
    a.K = K;
    a.N = N;
    a.nbs = KP / 64 / ksplit;
    a.kpl = kpl;
    CUtensorMap m[4];
    const int err = make_maps(m, x, packed, hi, lo, M, K, N, large ? big::kBM : rows, large ? big::kBN : cols, !large);
    if (err != 0) return err;
    if (large) {
      const cudaError_t ce = cudaFuncSetAttribute(splitk_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, big::kSmem);
      if (ce != cudaSuccess) return static_cast<int>(ce);
      splitk_large_kernel<<<dim3(N / big::kBN, ksplit, (M + big::kBM - 1) / big::kBM), big::kThreads, big::kSmem, s>>>(
          a, m[0], m[1], m[2], m[3]);
      return static_cast<int>(cudaGetLastError());
    }
    return cols == 256 ? launch_small_rows<4>(rows, a, m, ksplit, s) : launch_small_rows<2>(rows, a, m, ksplit, s);
  }
  if (x_dtype != pk::kF32 || k_shards != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int kchunk = KP / ksplit;
  const size_t smem = static_cast<size_t>(rows) * 2 * kchunk * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads * kCols - 1) / (kThreads * kCols), ksplit, (M + rows - 1) / rows);
  auto xf = static_cast<const float*>(x);
  auto p = static_cast<const uint8_t*>(packed);
  auto tab = static_cast<const float*>(table);
  switch (rows) {
    case 1: launch_stream<1>(grid, smem, s, xf, p, hi, lo, tab, w, M, KP, N, kchunk); break;
    case 2: launch_stream<2>(grid, smem, s, xf, p, hi, lo, tab, w, M, KP, N, kchunk); break;
    case 4: launch_stream<4>(grid, smem, s, xf, p, hi, lo, tab, w, M, KP, N, kchunk); break;
    default: launch_stream<8>(grid, smem, s, xf, p, hi, lo, tab, w, M, KP, N, kchunk); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const int threads = 256;
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + threads - 1) / threads), threads, 0, s>>>(w, b, out, out_dtype,
                                                                                                M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory per block of the bf16 kernel for ``rows`` x rows and ``cols`` columns (rows 128:
// the large kernel), or -cudaErrorInvalidValue for a configuration it has not.
extern "C" int pk_matmul_splitk_smem(int rows, int cols) {
  if (rows == 128) return big::kSmem;
  if (cols == 128) return small_smem<2>(rows);
  if (cols == 256) return small_smem<4>(rows);
  return -static_cast<int>(cudaErrorInvalidValue);
}
