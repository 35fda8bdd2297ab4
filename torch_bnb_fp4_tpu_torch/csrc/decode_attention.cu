// K10: decode attention.  One query row per slot (Lq = 1) against the
// slot's KV cache, read as stored (bf16, or float8_e4m3fn from an fp8 KV
// cache) and only up to the slot's last valid row.
//
// Replaces no TPU kernel.  The JAX package's decode attention is plain jnp
// (models/transformer.py::_attention_dense): its astype(f32) of the whole
// cache is fused by XLA into the dot, so nothing is widened in device memory.
// The port's dense route ran the same code in eager PyTorch, where k.float()
// and v.float() write an f32 copy of every row of every slot in every layer.
//
// What it computes is the dense route for Lq = 1, up to the order of the f32
// sums: s = (q . k) in f32 from q and K as stored, times the scale, then
// cap * tanh(s / cap) (Gemma-2's softcap), then -1e30 where the key is not
// visible (its position is past the query's, it holds nothing, or it lies at
// or before the query's position less the window); p = exp(s - max) in f32,
// out = (sum p v) / (sum p) with P and V in f32 (P is never rounded), cast
// to bf16.  Rows at or past a slot's bound (1 + its last valid row) are never
// read: they add nothing to the dense route's softmax either (exp(-1e30 - m)
// = 0), unless no key at all is visible, which a decode query never meets
// (its own key, just written, always is).
//
// Bound: the live K/V bytes (rows below each slot's bound, every kv head),
// plus q and out, at 3.35 TB/s.  The work is 4 * D flops per (query head,
// live key), far below the card's ops-per-byte line at every group size.
//
// Design:
//  * Grid (key range, kv head, slot).  A block holds all G = Hq / Hk query
//    heads of its kv head (G <= 8), so every K/V byte is read once per step.
//    The number of ranges follows from the shape (ops/attention.py::
//    decode_range_rows); a block whose range starts at or past its slot's
//    bound exits before any load, so a step's work is in proportion to the
//    live rows while one CUDA graph serves every mix of lengths.
//  * 64-row K/V tiles (and their key positions) arrive by cp.async into two
//    stages, one loading while the other is read; rows past the bound are
//    zero-filled, never read.  Nothing is written back wider.  Two stages
//    keep a block at 68 KB of shared memory at D = 128, so three blocks fit
//    an SM; a third stage (two blocks per SM) measured 5-11% slower.
//  * S = q K^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//    accumulate; the products of bf16 values are exact): q's G heads are the
//    rows of A (padded to 16 with zeros), each warp's 16 keys two 8-key
//    column tiles.  e4m3 K is widened to bf16 in registers (exact).  Each
//    lane feeds the same 8 head-dim columns of q and K into the two k-steps
//    of a 32-column slice, so K comes in as one 16-byte (8-byte for e4m3)
//    shared-memory load per lane and slice; the dot is the same, its order
//    of summation another.
//  * Softmax and P.V on the CUDA cores in f32: each warp keeps its own
//    running max and sum per head over its 16 keys of every tile; P and the
//    rescale factors go through a small shared buffer to all 32 lanes, each
//    of which owns D / 32 columns of V for every head.  The four warps'
//    (m, l, acc) are merged in warp order at the end of the range.
//  * More than one range: each range writes its f32 (m, l, acc) to scratch
//    and decode_attn_merge_kernel merges the live ranges in range order, so
//    results do not change from run to run.
//  * Its device functions are named decode_attn_*: no name of K2, K4 or K7.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;                  // key rows per ring stage
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kTile / kWarps;  // keys of each tile per warp
constexpr int kNT = kWarpKeys / 8;         // its 8-key MMA column tiles
constexpr int kStages = 2;                  // see the design note: a third stage costs a resident block
constexpr int kMaxGroup = 8;               // query heads per kv head: the rows of the MMA's A that lanes fill
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeAttnArgs {
  const __nv_bfloat16* q;  // (B, 1, Hq, D)
  const uint8_t* k;        // (B, rows, Hk, D): bf16, or e4m3 bytes
  const uint8_t* v;
  __nv_bfloat16* o;        // (B, 1, Hq, D) contiguous
  float* part_acc;         // (B, Hk, n_ranges, G, D)
  float* part_ml;          // (B, Hk, n_ranges, G, 2)
  const int* qpos;         // (B,)
  const int* kpos;         // (B, rows_pad): a row's position, or INT_MAX where it holds nothing
  const int* live;         // (B,): rows at or past it are never read
  int B, rows, rows_pad, Hk, G, range_rows, n_ranges;
  int64_t sqb, sqh, skb, skl, skh, svb, svl, svh;  // element strides
  float scale, cap;
  int use_cap, window, use_window;
};

template <int D, bool F8>
struct Geo {
  static constexpr int ESZ = F8 ? 1 : 2;
  static constexpr int ROWB = D * ESZ;      // bytes of one key row of one head
  static constexpr int CH = ROWB / 16;      // its 16-byte chunks
  static constexpr int TILEB = kTile * ROWB;
  static constexpr int STAGEB = 2 * TILEB + kTile * 4;  // K tile, V tile, key positions
  static constexpr int E = D / 32;          // V columns per lane
  static constexpr int SMEM = kStages * STAGEB + (kWarps * kWarpKeys * kMaxGroup + kWarps * kMaxGroup) * 4;
};

// chunk swizzle of the K tile: a quarter-warp's (bf16) or half-warp's (e4m3) S-loads hit distinct banks
template <int D, bool F8>
__device__ __forceinline__ int kswz(int r) {
  if constexpr (!F8) return (r & 1) << 2;
  else if constexpr (Geo<D, F8>::CH >= 8) return (r & 3) << 1;
  else return ((r >> 1) & 1) << 1;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two e4m3 values (low byte first) as two floats; e4m3 -> f16 -> f32 is exact
__device__ __forceinline__ float2 e4m3x2_float2(uint32_t two) {
  return __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3)));
}

// two e4m3 values as a bf16 pair (exact)
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t two) {
  const float2 f = e4m3x2_float2(two);
  return bf16x2_bits(f.x, f.y);
}

// c += A B over k = 16: A's row gid holds (a0: k 2t, 2t+1; a2: k 2t+8, 2t+9), its rows 8-15 are zero
__device__ __forceinline__ void mma_row8(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// the tile of key rows r0.. into ring stage st: K (swizzled), V and the rows' key positions; rows at or past
// the bound are zero-filled
template <int D, bool F8>
__device__ __forceinline__ void load_tile(uint8_t* st, const DecodeAttnArgs& a, const uint8_t* kb, const uint8_t* vb,
                                          const int* kpos_b, int r0, int bound, int tid) {
  using Gm = Geo<D, F8>;
#pragma unroll
  for (int i = 0; i < kTile * Gm::CH / kThreads; ++i) {
    const int c = tid + i * kThreads, r = c / Gm::CH, ch = c % Gm::CH;
    const bool ok = r0 + r < bound;
    const int64_t row = ok ? r0 + r : 0;
    hop::cp_async16(st + r * Gm::ROWB + ((ch ^ kswz<D, F8>(r)) << 4), kb + row * a.skl * Gm::ESZ + ch * 16, ok);
    hop::cp_async16(st + Gm::TILEB + r * Gm::ROWB + (ch << 4), vb + row * a.svl * Gm::ESZ + ch * 16, ok);
  }
  if (tid < kTile / 4) hop::cp_async16(st + 2 * Gm::TILEB + tid * 16, kpos_b + r0 + tid * 4, true);
}

// lane's D / 32 columns of one V row, as floats
template <int D, bool F8>
__device__ __forceinline__ void load_v(const uint8_t* p, float (&f)[D / 32]) {
  constexpr int E = D / 32;
  uint32_t w[(E * Geo<D, F8>::ESZ + 3) / 4];
  if constexpr (E * Geo<D, F8>::ESZ == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (E * Geo<D, F8>::ESZ == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (E * Geo<D, F8>::ESZ == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    if constexpr (F8) {
      const float2 t = e4m3x2_float2(w[i / 2] >> (16 * (i & 1)));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int D, int GP, bool F8>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const DecodeAttnArgs a) {
  using Gm = Geo<D, F8>;
  constexpr int E = Gm::E;
  static_assert((2 * kWarps * kMaxGroup + kWarps * GP * D) * 4 <= kStages * Gm::STAGEB,
                "the warps' merge must fit in the ring");
  extern __shared__ __align__(128) uint8_t smem[];
  const int z = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int bound = a.live[b];
  const int r_begin = z * a.range_rows;
  if (r_begin >= bound) return;  // this range holds nothing of the slot: no load, no partial (the merge skips it)
  const int r_end = min(r_begin + a.range_rows, bound);
  const int t0 = r_begin / kTile, n_t = (r_end - r_begin + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;

  const uint8_t* kb = a.k + (static_cast<int64_t>(b) * a.skb + static_cast<int64_t>(kvh) * a.skh) * Gm::ESZ;
  const uint8_t* vb = a.v + (static_cast<int64_t>(b) * a.svb + static_cast<int64_t>(kvh) * a.svh) * Gm::ESZ;
  const int* kpos_b = a.kpos + static_cast<int64_t>(b) * a.rows_pad;
  float* sp = reinterpret_cast<float*>(smem + kStages * Gm::STAGEB);  // [warp][key][head]: P
  float* sa = sp + kWarps * kWarpKeys * kMaxGroup;                    // [warp][head]: the rescale factors

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_t) load_tile<D, F8>(smem + s * Gm::STAGEB, a, kb, vb, kpos_b, (t0 + s) * kTile, bound, tid);
    hop::cp_async_commit();
  }

  // A: q's head gid, columns 32j + 8 tig .. +8 of each 32-column slice j (zero for padded heads)
  uint32_t qw[D / 32][4];
  {
    const bool real = gid < a.G;
    const __nv_bfloat16* qh = a.q + static_cast<int64_t>(b) * a.sqb +
                              static_cast<int64_t>(kvh * a.G + (real ? gid : 0)) * a.sqh;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const uint4 w = real ? *reinterpret_cast<const uint4*>(qh + 32 * j + 8 * tig) : make_uint4(0u, 0u, 0u, 0u);
      qw[j][0] = w.x;
      qw[j][1] = w.y;
      qw[j][2] = w.z;
      qw[j][3] = w.w;
    }
  }
  const int qp = a.qpos[b];
  const int64_t lo = static_cast<int64_t>(qp) - a.window;  // with a window a key is seen iff lo < kpos <= qp

  float m = -INFINITY, l = 0.f;  // head gid's running max, and this lane's share of its running sum
  float acc[GP][E];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    hop::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed for every thread; every warp is done with tile i - 1's stage
    if (i + kStages - 1 < n_t)
      load_tile<D, F8>(smem + ((i + kStages - 1) % kStages) * Gm::STAGEB, a, kb, vb, kpos_b,
                       (t0 + i + kStages - 1) * kTile, bound, tid);
    hop::cp_async_commit();
    const uint8_t* st = smem + (i % kStages) * Gm::STAGEB;
    const int r0 = (t0 + i) * kTile;

    // S for this warp's keys: c[nt][e] = head gid, key kWarpKeys warp + 8 nt + 2 tig + e
    float c[kNT][4] = {};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int kr = warp * kWarpKeys + nt * 8 + gid;
      const uint8_t* krow = st + kr * Gm::ROWB;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        uint32_t kw[4];
        if constexpr (F8) {
          const uint2 w =
              *reinterpret_cast<const uint2*>(krow + (((2 * j + (tig >> 1)) ^ kswz<D, F8>(kr)) << 4) + ((tig & 1) << 3));
          kw[0] = e4m3x2_bf16x2(w.x);
          kw[1] = e4m3x2_bf16x2(w.x >> 16);
          kw[2] = e4m3x2_bf16x2(w.y);
          kw[3] = e4m3x2_bf16x2(w.y >> 16);
        } else {
          const uint4 w = *reinterpret_cast<const uint4*>(krow + (((4 * j + tig) ^ kswz<D, F8>(kr)) << 4));
          kw[0] = w.x;
          kw[1] = w.y;
          kw[2] = w.z;
          kw[3] = w.w;
        }
        mma_row8(c[nt], qw[j][0], qw[j][1], kw[0], kw[1]);
        mma_row8(c[nt], qw[j][2], qw[j][3], kw[2], kw[3]);
      }
    }

    // scale, softcap, mask; the tile's max over the warp's 16 keys; p
    const int* kp = reinterpret_cast<const int*>(st + 2 * Gm::TILEB);
    float s[2 * kNT];
    bool in[2 * kNT];
#pragma unroll
    for (int x = 0; x < 2 * kNT; ++x) {
      const int kr = warp * kWarpKeys + (x >> 1) * 8 + 2 * tig + (x & 1);
      const int pos = kp[kr];
      in[x] = r0 + kr < bound;
      const bool seen = in[x] && pos <= qp && (!a.use_window || static_cast<int64_t>(pos) > lo);
      float y = c[x >> 1][x & 1] * a.scale;
      if (a.use_cap) y = a.cap * tanhf(y / a.cap);
      s[x] = seen ? y : kNeg;
    }
    float mx = s[0];
#pragma unroll
    for (int x = 1; x < 2 * kNT; ++x) mx = fmaxf(mx, s[x]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f((m - mn) * kLog2e);  // 0 on the first tile (m = -inf)
    float p[2 * kNT], ps = 0.f;
#pragma unroll
    for (int x = 0; x < 2 * kNT; ++x) {
      p[x] = in[x] ? exp2f((s[x] - mn) * kLog2e) : 0.f;
      ps += p[x];
    }
    l = l * alpha + ps;
    m = mn;

    // P and alpha to every lane of the warp
    float* spw = sp + warp * kWarpKeys * kMaxGroup;
    if (gid < GP) {
#pragma unroll
      for (int x = 0; x < 2 * kNT; ++x) spw[((x >> 1) * 8 + 2 * tig + (x & 1)) * kMaxGroup + gid] = p[x];
      if (tig == 0) sa[warp * kMaxGroup + gid] = alpha;
    }
    __syncwarp();

    // acc = acc * alpha + P V over the warp's 16 keys, lane's columns lane * E ..
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float al = sa[warp * kMaxGroup + g];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= al;
    }
    const uint8_t* vt = st + Gm::TILEB + lane * E * Gm::ESZ;
#pragma unroll 4
    for (int kk = 0; kk < kWarpKeys; ++kk) {
      float vf[E];
      load_v<D, F8>(vt + (warp * kWarpKeys + kk) * Gm::ROWB, vf);
      float pv[GP];
      const float* pk = spw + kk * kMaxGroup;
      if constexpr (GP >= 4) {
#pragma unroll
        for (int g = 0; g < GP; g += 4) {
          const float4 t = *reinterpret_cast<const float4*>(pk + g);
          pv[g] = t.x;
          pv[g + 1] = t.y;
          pv[g + 2] = t.z;
          pv[g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < GP; ++g) pv[g] = pk[g];
      }
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
    }
  }

  // merge the four warps in warp order, then write the output or the range's partial
  hop::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* em = reinterpret_cast<float*>(smem);  // [warp][head]
  float* el = em + kWarps * kMaxGroup;
  float* ea = el + kWarps * kMaxGroup;  // [warp][head][D]
  if (tig == 0 && gid < GP) {
    em[warp * kMaxGroup + gid] = m;
    el[warp * kMaxGroup + gid] = l;
  }
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) ea[(warp * GP + g) * D + lane * E + e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < a.G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mw = em[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mw = fmaxf(mw, em[w * kMaxGroup + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f((em[w * kMaxGroup + g] - mw) * kLog2e);
      num = fmaf(ea[(w * GP + g) * D + d], f, num);
      den = fmaf(el[w * kMaxGroup + g], f, den);
    }
    if (a.n_ranges == 1) {
      a.o[(static_cast<int64_t>(b) * a.Hk * a.G + kvh * a.G + g) * D + d] = __float2bfloat16_rn(num / den);
    } else {
      const int64_t pr = ((static_cast<int64_t>(b) * a.Hk + kvh) * a.n_ranges + z) * a.G + g;
      a.part_acc[pr * D + d] = num;
      if (d == 0) {
        a.part_ml[2 * pr] = mw;
        a.part_ml[2 * pr + 1] = den;
      }
    }
  }
}

// out = merge of the slot's live ranges in range order: M = max m_z, sum acc_z e^(m_z - M) / sum l_z e^(m_z - M)
template <int D>
__global__ void __launch_bounds__(D) decode_attn_merge_kernel(const DecodeAttnArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / a.G, g = h % a.G;
  const int nr = min(a.n_ranges, (a.live[b] + a.range_rows - 1) / a.range_rows);
  const int64_t r0 = (static_cast<int64_t>(b) * a.Hk + kvh) * a.n_ranges * a.G + g;  // range z: r0 + z G
  float mx = -INFINITY;
  for (int z = 0; z < nr; ++z) mx = fmaxf(mx, a.part_ml[2 * (r0 + static_cast<int64_t>(z) * a.G)]);
  float num = 0.f, den = 0.f;
  for (int z = 0; z < nr; ++z) {
    const int64_t pr = r0 + static_cast<int64_t>(z) * a.G;
    const float f = exp2f((a.part_ml[2 * pr] - mx) * kLog2e);
    num = fmaf(a.part_acc[pr * D + d], f, num);
    den = fmaf(a.part_ml[2 * pr + 1], f, den);
  }
  a.o[(static_cast<int64_t>(b) * a.Hk * a.G + h) * D + d] = __float2bfloat16_rn(num / den);
}

template <int D, int GP, bool F8>
int launch(const DecodeAttnArgs& a, cudaStream_t s) {
  constexpr int smem = Geo<D, F8>::SMEM;
  static_assert(smem <= 232448, "K10: shared memory past the 227 KB a block may take");
  cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<D, GP, F8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_attn_kernel<D, GP, F8><<<dim3(a.n_ranges, a.Hk, a.B), kThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_ranges == 1) return static_cast<int>(e);
  decode_attn_merge_kernel<D><<<dim3(a.Hk * a.G, a.B), D, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool F8>
int launch_group(const DecodeAttnArgs& a, cudaStream_t s) {
  if (a.G == 1) return launch<D, 1, F8>(a, s);
  if (a.G == 2) return launch<D, 2, F8>(a, s);
  if (a.G <= 4) return launch<D, 4, F8>(a, s);
  return launch<D, 8, F8>(a, s);
}

}  // namespace

// q (B, 1, Hq, D) bf16 with element strides sqb, sqh (contiguous last dim);
// k and v (B, rows, Hk, D) bf16 (kv_fp8: e4m3 bytes) with element strides
// s*b, s*l, s*h and a contiguous last dim; every row 16-byte aligned; o (B, 1,
// Hq, D) bf16 contiguous.  qpos (B,) i32; kpos (B, rows_pad) i32 with
// rows_pad a multiple of 64 >= rows (INT_MAX: no key there); live (B,) i32 in
// [1, rows].  D in {64, 128, 256}, G = Hq / Hk in [1, 8].  range_rows a
// multiple of 64 and n_ranges = ceil(rows / range_rows); for n_ranges > 1
// part_acc holds B * Hk * n_ranges * G * D floats and part_ml twice B * Hk *
// n_ranges * G.  use_cap / use_window switch the softcap and the window on.
extern "C" int pk_decode_attention(const void* q, const void* k, const void* v, void* o, void* part_acc,
                                   void* part_ml, const void* qpos, const void* kpos, const void* live, int B,
                                   int rows, int rows_pad, int Hq, int Hk, int D, int range_rows, int n_ranges,
                                   int64_t sqb, int64_t sqh, int64_t skb, int64_t skl, int64_t skh, int64_t svb,
                                   int64_t svl, int64_t svh, float scale, float cap, int use_cap, int window,
                                   int use_window, int kv_fp8, void* stream) {
  if (B <= 0 || rows <= 0 || Hk <= 0 || Hq % Hk || Hq / Hk > kMaxGroup || range_rows <= 0 || range_rows % kTile ||
      n_ranges != (rows + range_rows - 1) / range_rows || rows_pad % kTile || rows_pad < rows ||
      (n_ranges > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeAttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.qpos = static_cast<const int*>(qpos);
  a.kpos = static_cast<const int*>(kpos);
  a.live = static_cast<const int*>(live);
  a.B = B;
  a.rows = rows;
  a.rows_pad = rows_pad;
  a.Hk = Hk;
  a.G = Hq / Hk;
  a.range_rows = range_rows;
  a.n_ranges = n_ranges;
  a.sqb = sqb;
  a.sqh = sqh;
  a.skb = skb;
  a.skl = skl;
  a.skh = skh;
  a.svb = svb;
  a.svl = svl;
  a.svh = svh;
  a.scale = scale;
  a.cap = cap;
  a.use_cap = use_cap;
  a.window = window;
  a.use_window = use_window;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return kv_fp8 ? launch_group<64, true>(a, s) : launch_group<64, false>(a, s);
    case 128: return kv_fp8 ? launch_group<128, true>(a, s) : launch_group<128, false>(a, s);
    case 256: return kv_fp8 ? launch_group<256, true>(a, s) : launch_group<256, false>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
