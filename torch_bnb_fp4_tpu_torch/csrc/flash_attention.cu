// K7: causal GQA flash attention (online softmax) with the mask taken from
// per-slot key positions, key validity, an optional sliding window and an
// optional logit softcap.
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
// per byte of q/k/v/o, so tensor-core bound in principle, but this simple
// version issues mma.sync only (no wgmma/TMA) and is latency bound.
//
// Design:
//  * Grid (ceil(Lq / BQ), B * Hk).  One block of 4 warps takes 64 (query,
//    head) rows: BQ = 64 / G query positions for all G = Hq / Hk query heads
//    of one kv head (row r = query r / G, head r % G), so every K/V tile read
//    from device memory serves G heads.  Each warp owns 16 rows.
//  * q (B, Lq, Hq, D) and the cache (B, rows, Hk, D) are read in place
//    through their strides; the ragged Lq / Lk edges are masked here (keys
//    past Lk are zero-filled and invalid).  No transposes, no padding copies.
//  * Keys go 64 at a time through a two-stage cp.async ring of K/V tiles
//    (row pitch D + 8 elements: conflict-free ldmatrix).  S = Q K^T and
//    P V use mma.sync m16n8k16 bf16 -> f32; the S accumulator is rewritten in
//    place as P's A fragments (the FlashAttention-2 register reuse).
//  * Tile skipping: a ring cache is not monotone after a wrap, so a tile is
//    never skipped by its index.  Before the loop the block marks each key
//    tile that holds at least one valid key with kpos <= max qpos (and
//    kpos > min qpos - window) among its rows; an unmarked tile can be seen by
//    none of the block's rows and leaves m, l and acc unchanged, so skipping
//    it is exact.
//  * Deterministic: no atomics, no split over Lk; keys are visited in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128, kRows = 64, kBK = 64;
constexpr float kNeg = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* qpos;
  const int* kpos;
  const uint8_t* kval;
  int B, Lq, Lk, Hq, Hk, G, BQ, nk;
  int64_t sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
  float scale, cap;
  int use_cap, window, use_window;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t smem_bytes(int nk) {
  // q tile, two stages of K and V, two stages of key positions and validity,
  // the rows' query positions, one "needed" byte per key tile
  return static_cast<size_t>(kRows + 4 * kBK) * (D + 8) * 2 + 4 * kBK * 4 + kRows * 4 + nk;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int LD = D + 8;  // bf16 elements per shared row
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int NS = kBK / 8;  // score n-tiles per warp
  constexpr int NO = D / 8;  // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][LD]
  __nv_bfloat16* ks = qs + kRows * LD;                          // [2][kBK][LD]
  __nv_bfloat16* vs = ks + 2 * kBK * LD;                        // [2][kBK][LD]
  int* kpos_s = reinterpret_cast<int*>(vs + 2 * kBK * LD);      // [2][kBK]
  int* kval_s = kpos_s + 2 * kBK;                               // [2][kBK]
  int* rpos_s = kval_s + 2 * kBK;                               // [kRows]
  uint8_t* need = reinterpret_cast<uint8_t*>(rpos_s + kRows);   // [nk]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y / p.Hk, hk = blockIdx.y % p.Hk;
  const int q0 = blockIdx.x * p.BQ;
  const int nq = min(p.BQ, p.Lq - q0);  // real query positions of this block
  const int* qpos = p.qpos + static_cast<int64_t>(b) * p.Lq + q0;
  const int* kpos = p.kpos + static_cast<int64_t>(b) * p.Lk;
  const uint8_t* kval = p.kval + static_cast<int64_t>(b) * p.Lk;

  // the block's query rows: positions and the q tile (rows past nq * G are zero)
  if (tid < kRows) rpos_s[tid] = tid / p.G < nq ? qpos[tid / p.G] : 0;
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, cc = c % CH, qi = r / p.G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < nq)
      val = *reinterpret_cast<const uint4*>(p.q + b * p.sqb + (q0 + qi) * p.sql +
                                            (static_cast<int64_t>(hk) * p.G + r % p.G) * p.sqh + cc * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + cc * 8) = val;
  }
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    const int v = qpos[i];
    qmin = min(qmin, v);
    qmax = max(qmax, v);
  }
  // key tiles some row of this block may see (exact: see the header)
  for (int t = warp; t < p.nk; t += kThreads / 32) {
    bool any = false;
    for (int j = lane; j < kBK; j += 32) {
      const int key = t * kBK + j;
      if (key < p.Lk) {
        const int kp = kpos[key];
        any |= kval[key] != 0 && kp <= qmax && (!p.use_window || kp > qmin - p.window);
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) need[t] = any;
  }
  __syncthreads();

  auto load_tile = [&](int t, int st) {
    __nv_bfloat16* kd = ks + st * kBK * LD;
    __nv_bfloat16* vd = vs + st * kBK * LD;
    for (int c = tid; c < kBK * CH; c += kThreads) {
      const int r = c / CH, cc = c % CH, key = t * kBK + r;
      const bool in = key < p.Lk;
      const int64_t row = in ? key : 0;  // a valid address for the zero-fill
      cp_async16(kd + r * LD + cc * 8, p.k + b * p.skb + row * p.skl + hk * p.skh + cc * 8, in);
      cp_async16(vd + r * LD + cc * 8, p.v + b * p.svb + row * p.svl + hk * p.svh + cc * 8, in);
    }
    if (tid < kBK) {
      const int key = t * kBK + tid;
      const bool in = key < p.Lk;
      kpos_s[st * kBK + tid] = in ? kpos[key] : 0;
      kval_s[st * kBK + tid] = in ? static_cast<int>(kval[key] != 0) : 0;
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // rows gid and gid + 8 of this warp
  const int qp0 = rpos_s[warp * 16 + gid], qp1 = rpos_s[warp * 16 + gid + 8];
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix: this lane's matrix and row

  int t = 0;
  while (t < p.nk && !need[t]) ++t;
  if (t < p.nk) load_tile(t, 0);
  int st = 0;
  while (t < p.nk) {
    int tn = t + 1;
    while (tn < p.nk && !need[tn]) ++tn;
    if (tn < p.nk) {
      load_tile(tn, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + st * kBK * LD;
    const __nv_bfloat16* vt = vs + st * kBK * LD;
    const int* kp = kpos_s + st * kBK;
    const int* kv = kval_s + st * kBK;

    // S = Q K^T (16 x 64 per warp), f32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3, qs + (warp * 16 + (li & 1) * 8 + lr) * LD + kk * 16 + (li >> 1) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, kt + ((j + (li >> 1)) * 8 + lr) * LD + kk * 16 + (li & 1) * 8);
        mma_bf16(s[j], a0, a1, a2, a3, b0, b1);
        mma_bf16(s[j + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // scale, softcap, mask; element (j, e) is row gid + 8 * (e >> 1), key j * 8 + 2 * tig + (e & 1)
    uint32_t vis = 0u;
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * tig + (e & 1);
        const int qp = e < 2 ? qp0 : qp1, kpv = kp[key];
        const bool ok = kv[key] != 0 && kpv <= qp && (!p.use_window || kpv > qp - p.window);
        float x = s[j][e] * p.scale;
        if (p.use_cap) x = p.cap * tanhf(x / p.cap);
        x = ok ? x : kNeg;
        s[j][e] = x;
        vis |= static_cast<uint32_t>(ok) << (j * 4 + e);
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (vis >> (j * 4 + e)) & 1u ? expf(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[j][e] = pe;
        if (e < 2)
          ps0 += pe;
        else
          ps1 += pe;
      }
    }
    // l and acc of each row are the quad's partial sums: alpha is the same on all four lanes
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // acc += P V, P rounded to bf16 (the S accumulator is P's A fragment)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3, vt + (kk * 16 + (li & 1) * 8 + lr) * LD + (n + (li >> 1)) * 8);
        mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
        mma_bf16(o[n + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's prefetch
    st ^= 1;
    t = tn;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h, qi = r / p.G;
    if (qi >= nq) continue;
    const float den = h ? d1 : d0;
    __nv_bfloat16* dst =
        p.o + ((static_cast<int64_t>(b) * p.Lq + q0 + qi) * p.Hq + static_cast<int64_t>(hk) * p.G + r % p.G) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(o[n][2 * h] / den, o[n][2 * h + 1] / den);
  }
}

template <int D>
int launch(Params p, cudaStream_t s) {
  const size_t smem = smem_bytes<D>(p.nk);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Lq + p.BQ - 1) / p.BQ, p.B * p.Hk);
  flash_kernel<D><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, Hq, D), k and v (B, Lk, Hk, D) bf16 with element strides s*b,
// s*l, s*h and a contiguous last dim (16-byte aligned rows); o (B, Lq, Hq, D)
// bf16 contiguous; qpos (B, Lq) i32, kpos (B, Lk) i32, kval (B, Lk) bytes 0/1.
// D in {64, 128, 256}; Hq % Hk == 0 with Hq / Hk <= 64.  use_cap / use_window
// switch the softcap and the sliding window on.
extern "C" int pk_flash_attention(const void* q, const void* k, const void* v, void* o, const void* qpos,
                                  const void* kpos, const void* kval, int B, int Lq, int Lk, int Hq, int Hk, int D,
                                  int64_t sqb, int64_t sql, int64_t sqh, int64_t skb, int64_t skl, int64_t skh,
                                  int64_t svb, int64_t svl, int64_t svh, float scale, float cap, int use_cap,
                                  int window, int use_window, void* stream) {
  if (Hk <= 0 || Hq % Hk || Hq / Hk > kRows || Lq <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.kval = static_cast<const uint8_t*>(kval);
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Hq = Hq;
  p.Hk = Hk;
  p.G = Hq / Hk;
  p.BQ = kRows / p.G;
  p.nk = (Lk + kBK - 1) / kBK;
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
