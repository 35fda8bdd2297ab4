// K1: pair-K byte decode, the device routine every pair-K kernel shares.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_decode_pairs (:573),
// make_pairk_lut (:621) and _pairs_weight_tile (:631), which the TPU kernels
// inline into K2-K4.  One packed byte X becomes two bf16 bit patterns of
// 192 * code in one 32-bit word: the low 16 bits decode the LOW nibble (Wt row
// 2i), the high 16 bits the HIGH nibble (row 2i+1).  A 32-bit store of the
// word therefore lands the pair K-contiguous, which is what the tensor-core
// fragments of K3/K4 read.
//
// Bound: integer ALU.  ramp 6 ops, zramp 11, exact 16 per byte; lut is two
// table reads from shared memory.  Inside K2 the decode hides under the HBM
// stream of the packed bytes.
//
// The TPU code relies on int32 wraparound (X * 0x01001000 puts byte bit 7 at
// bit 31) and on arithmetic right shifts whose sign-extended bits the masks
// drop.  Signed overflow is undefined in C++, so everything here is uint32_t:
// unsigned multiply wraps mod 2^32 and the logical shifts keep the same
// masked bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pk {

enum Variant : int { kExact = 0, kZramp = 1, kRamp = 2, kLut = 3 };

template <int V>
__device__ __forceinline__ uint32_t decode_pairs(uint32_t X, const uint16_t* lut) {
  if constexpr (V == kRamp) {
    const uint32_t t = X * 0x01001000u;  // lo nibble -> bits 12..15, hi -> 28..31
    return (0x41804180u + ((t >> 6) & 0x01C001C0u)) | (t & 0x80008000u);
  } else if constexpr (V == kZramp) {
    const uint32_t t = X * 0x01001000u;
    const uint32_t q12 = t & 0x70007000u;
    const uint32_t bits = 0x41804180u + (q12 >> 6);
    // [rank >= 1] per half: adding 0x7000 to rank<<12 carries into bit 15/31
    const uint32_t s1 = ((q12 + 0x70007000u) >> 15) & 0x00010001u;
    return (bits & (s1 * 0xFFFFu)) | (t & 0x80008000u);
  } else if constexpr (V == kExact) {
    const uint32_t t = X * 0x1001u;  // lo nibble -> bits 0..3, hi -> 16..19
    const uint32_t q2 = t & 0x00070007u;
    uint32_t bits = 0x41804180u + (q2 << 6);
    // [rank >= 2] per half: bit 3 of rank + 6
    const uint32_t s1 = ((q2 + 0x00060006u) >> 3) & 0x00010001u;
    bits &= s1 * 0xFFFFu;
    const uint32_t one = q2 & (s1 ^ 0x00010001u);  // rank 1 -> bf16(1.0)
    bits |= one * 0x3F80u;
    return bits | ((t & 0x00080008u) << 12);
  } else {
    return static_cast<uint32_t>(lut[X & 0xFu]) | (static_cast<uint32_t>(lut[(X >> 4) & 0xFu]) << 16);
  }
}

// bf16 bit pair -> the two float values (exact: bf16 widens without rounding)
__device__ __forceinline__ float pair_lo(uint32_t bits) { return __uint_as_float(bits << 16); }
__device__ __forceinline__ float pair_hi(uint32_t bits) { return __uint_as_float(bits & 0xFFFF0000u); }

// dtype codes shared by every C entry point (ops/kernels.py _DTYPE_CODE)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float load_scale(const void* scale, int scale_dtype, size_t i) {
  if (scale_dtype == kBF16) {
    const uint16_t b = static_cast<const uint16_t*>(scale)[i];
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  return static_cast<const float*>(scale)[i];
}

// K8: the expert a stacked launch runs against.  ``expert`` points at one
// int32 in device memory (an element of the router's top-k indices, or of a
// cached arange for a static index), read here so that the host never reads
// it; clamped into [0, n_experts) as jax.lax.dynamic_index_in_dim clamps.  A
// 2-D launch passes null and gets expert 0 of a one-expert "stack".
__device__ __forceinline__ size_t expert_index(const int* expert, int n_experts) {
  if (expert == nullptr) return 0;
  return static_cast<size_t>(min(max(__ldg(expert), 0), n_experts - 1));
}

// scale pointer advanced by ``elems`` elements of its dtype
__device__ __forceinline__ const void* offset_scale(const void* scale, int scale_dtype, size_t elems) {
  return static_cast<const char*>(scale) + elems * (scale_dtype == kBF16 ? 2 : 4);
}

// f32 result -> output element (round to nearest even, like XLA's astype)
__device__ __forceinline__ void store_out(void* out, int out_dtype, size_t i, float v) {
  if (out_dtype == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else if (out_dtype == kF16) {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// four f32 results -> four consecutive output elements (one 16- or 8-byte store)
__device__ __forceinline__ void store_out4(void* out, int out_dtype, size_t i, const float (&v)[4]) {
  if (out_dtype == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  uint16_t h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = out_dtype == kBF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(v[j]))
                              : __half_as_ushort(__float2half_rn(v[j]));
  }
  *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + i) =
      make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16), h[2] | (static_cast<uint32_t>(h[3]) << 16));
}

// The ordered merge of a K-split launch (K2, K3): every block of split
// blockIdx.y has written its f32 partial of the output tile rows [m0, m1) x
// columns [n0, n1) to ws (ksplit, M, N); the last block of the tile to arrive
// on ``counter`` (the tile's int32 in device memory, 0 at entry) sums the
// partials in split order, ((ws_0 + ws_1) + ...) + bias, writes the output
// and sets the counter back to 0 for the next launch.  Which block is last
// does not change the sums, so the result is deterministic; the host resets
// nothing, so the launch replays from a CUDA graph.  Called by every thread
// of the block; ``ticket`` is one int of shared memory.
__device__ __forceinline__ void merge_splits(const float* ws, const float* bias, void* out, int out_dtype, int M, int N,
                                             int ksplit, int m0, int m1, int n0, int n1, int* counter, int* ticket) {
  __threadfence();  // this thread's partials reach L2 before the block's arrival
  __syncthreads();
  if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (*ticket != ksplit - 1) return;
  __threadfence();
  const int w = n1 - n0, cnt = (m1 - m0) * w;
  const size_t mn = static_cast<size_t>(M) * N;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const size_t o = static_cast<size_t>(m0 + i / w) * N + n0 + i % w;
    float v = __ldcg(ws + o);  // L2: the other blocks' partials never sat in this SM's L1
    for (int s = 1; s < ksplit; ++s) v = __fadd_rn(v, __ldcg(ws + s * mn + o));
    if (bias != nullptr) v = __fadd_rn(v, bias[n0 + i % w]);
    store_out(out, out_dtype, o, v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace pk
