// K7: causal GQA flash attention (online softmax) with the mask taken from
// per-slot key positions, key validity, an optional sliding window and an
// optional logit softcap; Hopper warpgroup-MMA design.
//
// Replaces torch_bnb_fp4_tpu/ops/attention.py::_flash_kernel (:40), the
// pallas_call of flash_attention (:89, :151): long prefill, i.e. every
// attention with Lq * Lk >= 256 * 4096 and Lq >= 128.
//
// What it computes (as :53-81): s = (q . k) in f32, then * scale, then
// cap * tanh(s / cap), then masked to -1e30 where the key is not visible
// (kpos > qpos, !valid, or kpos <= qpos - window); running max m and sum l;
// p = exp(s - m) and an explicit 0 where masked (a row that sees no key keeps
// m = -1e30, where exp(s - m) would be 1); p is rounded to bf16 for the PV dot;
// out = acc / max(l, 1e-30), so a row with no visible key writes zeros.
//
// Bound: the two products take 4 * D flops per visible (query, key) pair and
// query head; at Lq = 256 against a 4352-row Mistral ring that is ~70 flops
// per byte of q/k/v/o, so bf16 tensor-core bound.  Each K/V tile feeds 128
// (query, head) rows, so the tiles brought from L2 into shared memory, not
// the tensor cores, are what a block waits on first; then the softmax.
//
// Design:
//  * Rows: a block takes ROWS = 64 * NC (query, head) rows, BQ = ROWS / G
//    query positions for all G = Hq / Hk query heads of one kv head (row
//    r = query r / G, head r % G), so every K/V tile brought into shared
//    memory serves G heads and NC consumer warpgroups of 64 rows each.
//    NC = 2 for D = 64 and 128; D = 256 keeps NC = 1: its f32 output
//    accumulator alone is 128 registers per thread, and a second warpgroup
//    with a third K/V stage would not fit the SM's registers and 227 KB of
//    shared memory next to it.
//  * Warpgroup MMA: S = Q K^T is wgmma m64n64k16 (bf16 -> f32) with Q and the
//    K tile in shared memory (K-major); P V is wgmma with P from registers
//    (the S accumulator rewritten as A fragments, FlashAttention-2's register
//    reuse) and V from shared memory read through trans-b (MN-major).  Q, K
//    and V tiles are stored in the 128-byte swizzle of hopper.cuh.
//  * A ring of STAGES K/V tiles (4; 2 at D = 256) filled by one producer warp:
//    one lane issues TMA loads (tensor maps of the cache built on the host
//    from its strides, cuTensorMapEncodeTiled fetched from the driver; keys
//    past Lk read as zeros) and all lanes write the tile's key positions (and
//    their min / max) into the same stage; mbarriers hand stages over (full:
//    the bytes landed and the positions are written; empty: every consumer
//    thread is done with it, which it says after the next tile's S, so that
//    P V of one tile overlaps the next tile's wait).  TMA takes the copy off
//    the load/store path, which cp.async from the producer warp saturated.
//  * Softmax: exp(y) as exp2(y * log2 e); a tile whose every key both of a
//    thread's rows see (min / max of its positions) skips the mask; acc is
//    rescaled only when a row's running max moved.
//  * Split over Lk: when the grid (query blocks x B * Hk) is short of about
//    two waves, the wrapper (ops/attention.py::kernel_split) cuts the key
//    tiles into S contiguous ranges (blockIdx.z).  Each split writes its f32
//    (m, l, acc) to scratch and flash_combine merges them in split order
//    0..S-1: M = max m_s, out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s -
//    M), 1e-30), so a row that no split sees writes 0.  Deterministic: no
//    atomics, keys visited in order within a split.
//  * Tile skipping, per block and split: a ring cache is not monotone after a
//    wrap, so a tile is never skipped by its index.  Before the loop the block
//    marks each key tile of its range that holds at least one valid key with
//    kpos <= max qpos (and kpos > min qpos - window) among its rows and lists
//    them; an unlisted tile can be seen by none of the block's rows and leaves
//    m, l and acc unchanged, so skipping it is exact.
//  * q (B, Lq, Hq, D) and the cache (B, rows, Hk, D) are read in place
//    through their strides; ragged Lq / Lk edges are masked here (keys past
//    Lk are zero-filled and invalid).  No transposes, no padding copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;  // keys per tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* part_acc;  // split > 1: (S, B, Lq, Hq, D) f32
  float* part_ml;   // split > 1: (S, 2, B, Lq, Hq) f32, m then l
  const int* qpos;
  const int* kpos;
  const uint8_t* kval;
  int B, Lq, Lk, Hq, Hk, G, BQ, nk, S;
  int64_t sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
  float scale, cap;
  int use_cap, window, use_window;
};

template <int D>
struct Cfg {
  static constexpr int NC = D == 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int ROWS = 64 * NC;
  static constexpr int STAGES = D == 256 ? 2 : 4;
  static constexpr int THREADS = 128 * NC + 32;  // + one producer warp
  static constexpr int CH = D / 8;               // 16-byte chunks per row
  static constexpr int KV_BYTES = kBK * D * 2;   // one K or V tile: D / 64 panels of kBK rows
  static constexpr int OFF_KV = ROWS * D * 2;    // after the Q tile (D / 64 panels of ROWS rows)
  static constexpr int OFF_KPOS = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr int OFF_KRANGE = OFF_KPOS + STAGES * kBK * 4;  // the tiles' key-position ranges
  static constexpr int OFF_RPOS = OFF_KRANGE + STAGES * 8;
  static constexpr int OFF_BAR = OFF_RPOS + ROWS * 4;  // full[STAGES], empty[STAGES]
  static constexpr int OFF_CNT = OFF_BAR + 2 * STAGES * 8;
  static constexpr int OFF_LIST = OFF_CNT + 16;  // listed tiles (int), then the need flags (bytes)
  static size_t smem(int nk) { return 1024 + OFF_LIST + static_cast<size_t>(nk) * 5; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_kernel(const Params p, const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  // operand panels need 1024-byte alignment (the swizzle reads address bits 7-9)
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  int* kpos_s = reinterpret_cast<int*>(smem + C::OFF_KPOS);  // [STAGES][kBK], INT_MAX where invalid
  int* krange_s = reinterpret_cast<int*>(smem + C::OFF_KRANGE);  // [STAGES][2]: min, max of the tile's kpos_s
  int* rpos_s = reinterpret_cast<int*>(smem + C::OFF_RPOS);  // [ROWS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  int* count_s = reinterpret_cast<int*>(smem + C::OFF_CNT);
  int* list = reinterpret_cast<int*>(smem + C::OFF_LIST);
  uint8_t* need = reinterpret_cast<uint8_t*>(list + p.nk);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / p.Hk, hk = blockIdx.y % p.Hk, z = blockIdx.z;
  const int q0 = blockIdx.x * p.BQ;
  const int nq = min(p.BQ, p.Lq - q0);  // real query positions of this block
  const int t_lo = z * p.nk / p.S, t_hi = (z + 1) * p.nk / p.S;  // this split's key tiles
  const int* qpos = p.qpos + static_cast<int64_t>(b) * p.Lq + q0;
  const int* kpos = p.kpos + static_cast<int64_t>(b) * p.Lk;
  const uint8_t* kval = p.kval + static_cast<int64_t>(b) * p.Lk;

  // the block's query rows: positions and the Q tile (rows past nq * G are zero)
  for (int r = tid; r < C::ROWS; r += C::THREADS) rpos_s[r] = r / p.G < nq ? qpos[r / p.G] : 0;
  for (int c = tid; c < C::ROWS * C::CH; c += C::THREADS) {
    const int r = c / C::CH, ch = c % C::CH, qi = r / p.G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < nq)
      val = *reinterpret_cast<const uint4*>(p.q + b * p.sqb + (q0 + qi) * p.sql +
                                            (static_cast<int64_t>(hk) * p.G + r % p.G) * p.sqh + ch * 8);
    *reinterpret_cast<uint4*>(qs + (ch >> 3) * (C::ROWS * 128) + hop::sw128(r, ch & 7)) = val;
  }
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll 8
  for (int i = 0; i < nq; ++i) {
    const int v = qpos[i];
    qmin = min(qmin, v);
    qmax = max(qmax, v);
  }
  // key tiles of this split some row of the block may see (exact: see the header);
  // every thread scans its own keys, so the loads are all in flight at once
  for (int t = t_lo + tid; t < t_hi; t += C::THREADS) need[t] = 0;
  __syncthreads();
  const int k_hi = min(t_hi * kBK, p.Lk);
#pragma unroll 4
  for (int key = t_lo * kBK + tid; key < k_hi; key += C::THREADS) {
    const int kp = kpos[key];
    if (kval[key] != 0 && kp <= qmax && (!p.use_window || kp > qmin - p.window)) need[key / kBK] = 1;
  }
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 33);  // the producer's 32 lanes + its expect_tx
      hop::mbar_init(&empty[s], 128 * C::NC);
    }
    hop::mbar_init_fence();
  }
  hop::fence_proxy_async();  // the Q tile is read by wgmma
  __syncthreads();
  if (warp == 0) {  // compact the needed tiles into a list, in key order
    int n = 0;
    for (int base = t_lo; base < t_hi; base += 32) {
      const bool f = base + lane < t_hi && need[base + lane];
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(mask & ((1u << lane) - 1u))] = base + lane;
      n += __popc(mask);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int ntiles = *count_s;

  if (warp == 4 * C::NC) {
    // ---- producer warp: K/V tiles by TMA, key positions into the ring ----
    // this lane's two key positions of tile t, INT_MAX where invalid (no query sees them);
    // fetched one tile ahead
    auto fetch = [&](int t) {
      const int k0 = t * kBK + lane, k1 = k0 + 32;
      const int c0 = k0 < p.Lk ? k0 : 0, c1 = k1 < p.Lk ? k1 : 0;
      const int p0 = kpos[c0], p1 = kpos[c1];
      const bool v0 = k0 < p.Lk && kval[c0] != 0, v1 = k1 < p.Lk && kval[c1] != 0;
      return make_int2(v0 ? p0 : INT_MAX, v1 ? p1 : INT_MAX);
    };
    int2 kp_next = ntiles > 0 ? fetch(list[0]) : make_int2(0, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % C::STAGES;
      if (i >= C::STAGES) hop::mbar_wait(&empty[st], ((i / C::STAGES) - 1) & 1);
      const int t = list[i];
      if (lane == 0) {  // D / 64 boxes of [64 keys][64 columns] each for K and V; keys past Lk read as 0
        unsigned char* kd = smem + C::OFF_KV + st * 2 * C::KV_BYTES;
        hop::mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < D / 64; ++pn) {
          hop::tma_load_4d(kd + pn * (kBK * 128), &tk, &full[st], pn * 64, hk, t * kBK, b);
          hop::tma_load_4d(kd + C::KV_BYTES + pn * (kBK * 128), &tv, &full[st], pn * 64, hk, t * kBK, b);
        }
      }
      const int2 kp = kp_next;
      if (i + 1 < ntiles) kp_next = fetch(list[i + 1]);
      kpos_s[st * kBK + lane] = kp.x;
      kpos_s[st * kBK + lane + 32] = kp.y;
      const int kmin = __reduce_min_sync(0xffffffffu, min(kp.x, kp.y));
      const int kmax = __reduce_max_sync(0xffffffffu, max(kp.x, kp.y));
      if (lane == 0) {
        krange_s[2 * st] = kmin;
        krange_s[2 * st + 1] = kmax;
      }
      __syncwarp();
      hop::mbar_arrive(&full[st]);
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    constexpr int NCH = D > 128 ? D / 128 : 1;  // P.V wgmmas per k-step (n = min(D, 128) each)
    constexpr int OW = (D > 128 ? 128 : D) / 2;  // f32 accumulators per thread per P.V wgmma
    const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + gid;  // this thread's rows r0 and r0 + 8
    const int qp0 = rpos_s[r0], qp1 = rpos_s[r0 + 8];
    float o[NCH][OW];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < OW; ++e) o[c][e] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    const uint64_t qdesc = hop::desc_sw128(qs + wg * 64 * 128, 16);

    for (int i = 0; i < ntiles; ++i) {
      const int st = i % C::STAGES;
      hop::mbar_wait(&full[st], (i / C::STAGES) & 1);
      const unsigned char* kt = smem + C::OFF_KV + st * 2 * C::KV_BYTES;
      const unsigned char* vt = kt + C::KV_BYTES;
      const int* kp = kpos_s + st * kBK;
      // every key of the tile visible to both of this thread's rows: no mask
      const bool all_vis = krange_s[2 * st + 1] <= min(qp0, qp1) &&
                           (!p.use_window || krange_s[2 * st] > max(qp0, qp1) - p.window);

      // S = Q K^T: 64 rows x 64 keys per warpgroup, f32
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      const uint64_t kdesc = hop::desc_sw128(kt, 16);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t aq = ((kk >> 2) * (C::ROWS * 128) + (kk & 3) * 32) >> 4;
        const uint32_t ak = ((kk >> 2) * (kBK * 128) + (kk & 3) * 32) >> 4;
        hop::wgmma_m64n64k16_ss(s, qdesc + aq, kdesc + ak, kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();  // this S and the previous tile's P V
      hop::fence_regs(s);
#pragma unroll
      for (int c = 0; c < NCH; ++c) hop::fence_regs(o[c]);
      if (i > 0) hop::mbar_arrive(&empty[(i - 1) % C::STAGES]);

      // scale, softcap, mask; element 4j + e is row gid + 8 * (e >> 1), key 8j + 2 * tig + (e & 1)
      uint32_t vis = 0xffffffffu;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = s[e] * p.scale;
        if (p.use_cap) x = p.cap * tanhf(x / p.cap);
        s[e] = x;
      }
      if (!all_vis) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kpv = *reinterpret_cast<const int2*>(kp + j * 8 + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = e < 2 ? qp0 : qp1, kq = e & 1 ? kpv.y : kpv.x;
            const bool ok = kq <= qp && (!p.use_window || kq > qp - p.window);
            s[4 * j + e] = ok ? s[4 * j + e] : kNeg;
            vis &= ~(static_cast<uint32_t>(!ok) << (4 * j + e));
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if ((e & 3) < 2)
          mx0 = fmaxf(mx0, s[e]);
        else
          mx1 = fmaxf(mx1, s[e]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // exp(y) as exp2(y * log2 e): MUFU.EX2 and one multiply
      const float al0 = exp2f((m0 - mn0) * kLog2e), al1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      const float mb0 = mn0 * kLog2e, mb1 = mn1 * kLog2e;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float pe = (vis >> e) & 1u ? exp2f(s[e] * kLog2e - ((e & 3) < 2 ? mb0 : mb1)) : 0.f;
        s[e] = pe;
        if ((e & 3) < 2)
          ps0 += pe;
        else
          ps1 += pe;
      }
      // l and acc of each row are the quad's partial sums: alpha is the same on all four lanes
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      if (al0 != 1.f || al1 != 1.f) {  // the running max moved: rescale acc
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < OW; ++e) o[c][e] *= (e & 3) < 2 ? al0 : al1;
      }

      // acc += P V, P rounded to bf16 (the S accumulator is P's A fragment)
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]), pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                               pack_bf16(s[8 * kk + 4], s[8 * kk + 5]), pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          // keys 16kk.. of the panels holding columns 128c.. (two 64-column panels kBK * 128 bytes apart)
          const uint64_t vdesc = hop::desc_sw128(vt + c * 2 * (kBK * 128) + kk * 16 * 128, kBK * 128);
          if constexpr (D == 64)
            hop::wgmma_m64n64k16_rs_tb(o[c], a, vdesc);
          else
            hop::wgmma_m64n128k16_rs_tb(o[c], a, vdesc);
        }
      }
      hop::wgmma_commit();  // completes under the next tile's S (its wait releases this stage)
    }
    hop::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) hop::fence_regs(o[c]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, qi = r / p.G;
      if (qi >= nq) continue;
      const int64_t row = (static_cast<int64_t>(b) * p.Lq + q0 + qi) * p.Hq + static_cast<int64_t>(hk) * p.G + r % p.G;
      if (p.S == 1) {
        const float den = fmaxf(h ? l1 : l0, 1e-30f);
        __nv_bfloat16* dst = p.o + row * D;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < OW / 4; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + c * 128 + j * 8 + 2 * tig) =
                __floats2bfloat162_rn(o[c][4 * j + 2 * h] / den, o[c][4 * j + 2 * h + 1] / den);
      } else {
        const int64_t rows = static_cast<int64_t>(p.B) * p.Lq * p.Hq;
        float* dst = p.part_acc + (z * rows + row) * D;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < OW / 4; ++j)
            *reinterpret_cast<float2*>(dst + c * 128 + j * 8 + 2 * tig) =
                make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
        if (tig == 0) {
          p.part_ml[(2 * z) * rows + row] = h ? m1 : m0;
          p.part_ml[(2 * z + 1) * rows + row] = h ? l1 : l0;
        }
      }
    }
  }
}

// merge the S splits' (m, l, acc) of each (row, column) in split order
__global__ void flash_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                              __nv_bfloat16* __restrict__ o, int64_t rows, int D, int S) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int64_t row = i / D;
  float mx = kNeg;
  for (int z = 0; z < S; ++z) mx = fmaxf(mx, part_ml[2 * z * rows + row]);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < S; ++z) {
    const float e = expf(part_ml[2 * z * rows + row] - mx);
    l = __fadd_rn(l, __fmul_rn(part_ml[(2 * z + 1) * rows + row], e));
    acc = __fadd_rn(acc, __fmul_rn(part_acc[z * rows * D + i], e));
  }
  o[i] = __float2bfloat16_rn(acc / fmaxf(l, 1e-30f));
}

// the cache (B, Lk, Hk, D) as a TMA tensor map with [64 keys][64 columns] boxes in the 128-byte swizzle
int cache_map(CUtensorMap* map, const void* base, const Params& p, int D, int64_t sb, int64_t sl, int64_t sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(p.Hk),
                              static_cast<cuuint64_t>(p.Lk), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kBK, 1};
  return hop::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch(Params p, cudaStream_t s) {
  using C = Cfg<D>;
  const size_t smem = C::smem(p.nk);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  int st = cache_map(&tk, p.k, p, D, p.skb, p.skl, p.skh);
  if (st == 0) st = cache_map(&tv, p.v, p, D, p.svb, p.svl, p.svh);
  if (st != 0) return st;
  cudaError_t e =
      cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Lq + p.BQ - 1) / p.BQ, p.B * p.Hk, p.S);
  flash_kernel<D><<<grid, C::THREADS, smem, s>>>(p, tk, tv);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.S == 1) return static_cast<int>(e);
  const int64_t rows = static_cast<int64_t>(p.B) * p.Lq * p.Hq;
  const int64_t n = rows * D;
  flash_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(p.part_acc, p.part_ml, p.o, rows, D, p.S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, Hq, D), k and v (B, Lk, Hk, D) bf16 with element strides s*b,
// s*l, s*h and a contiguous last dim (16-byte aligned rows); o (B, Lq, Hq, D)
// bf16 contiguous; qpos (B, Lq) i32, kpos (B, Lk) i32, kval (B, Lk) bytes 0/1.
// D in {64, 128, 256}; Hq % Hk == 0 with G = Hq / Hk <= rows (128 for D <= 128,
// 64 for D = 256) and block_q = rows / G.  split S >= 1 key ranges; for S > 1
// part_acc holds S * B * Lq * Hq * D floats and part_ml 2 * S * B * Lq * Hq.
// use_cap / use_window switch the softcap and the sliding window on.
extern "C" int pk_flash_attention(const void* q, const void* k, const void* v, void* o, void* part_acc,
                                  void* part_ml, const void* qpos, const void* kpos, const void* kval, int B, int Lq,
                                  int Lk, int Hq, int Hk, int D, int block_q, int split, int64_t sqb, int64_t sql,
                                  int64_t sqh, int64_t skb, int64_t skl, int64_t skh, int64_t svb, int64_t svl,
                                  int64_t svh, float scale, float cap, int use_cap, int window, int use_window,
                                  void* stream) {
  const int rows = D == 256 ? Cfg<256>::ROWS : Cfg<128>::ROWS;
  if (Hk <= 0 || Hq % Hk || Hq / Hk > rows || block_q != rows / (Hq / Hk) || Lq <= 0 || Lk <= 0 || B <= 0 ||
      split < 1 || (split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.kval = static_cast<const uint8_t*>(kval);
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Hq = Hq;
  p.Hk = Hk;
  p.G = Hq / Hk;
  p.BQ = block_q;
  p.nk = (Lk + kBK - 1) / kBK;
  p.S = split < p.nk ? split : p.nk;
  if (p.S != split) return static_cast<int>(cudaErrorInvalidValue);
  p.sqb = sqb;
  p.sql = sql;
  p.sqh = sqh;
  p.skb = skb;
  p.skl = skl;
  p.skh = skh;
  p.svb = svb;
  p.svl = svl;
  p.svh = svh;
  p.scale = scale;
  p.cap = cap;
  p.use_cap = use_cap;
  p.window = window;
  p.use_window = use_window;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
