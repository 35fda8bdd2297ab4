// K9a: split-K dequantize, Wt (K, N) = code[nibble] * absmax.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_dequant_kernel (:243), the
// pallas_call of dequantize_tpu (:303), with its helpers make_code_table
// (:167), _decode_fp4_f32 (:177), _gather_decode (:194) and _decode_tile
// (:217).  Runs in dequantize_weight of split-K layers (bnb-exact FP4 and NF4
// checkpoints).
//
// Numerics (as :232-248): the nibble indexes a 16-entry f32 codebook (FP4 or
// NF4 or any bnb table, passed as data), the product with the absmax of the
// weight's 64-row block is ONE f32 multiply (__fmul_rn: nvcc may not contract
// it into anything), cast once to the output type (round to nearest even).
// Bit-exact with ops/kernels.py::dequantize_splitk_plain and with bnb's own
// dequantize.  The TPU's arithmetic FP4 decode gives the same bits as the
// table (tests/test_kernels.py::test_decode_fp4_bits_exact), so one table
// kernel serves both decode_impl values.
//
// Bound: bytes.  K*N/2 packed bytes and K*N/16 absmax bytes in, K*N*out_bytes
// out.  Design: one streaming pass, one thread per 4 consecutive bytes along
// N of packed row i (one 32-bit load); the high nibbles go to Wt row i with
// absmax_hi[i/64], the low nibbles to row K/2 + i with absmax_lo[i/64]; each
// half is written as 4 consecutive outputs, so a warp reads 512 contiguous
// bytes and writes two contiguous row segments.  The table is staged in
// shared memory (16 floats in 16 banks: no conflicts).
#include "pairk_decode.cuh"  // dtype codes and output stores

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) dequant_splitk_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ absmax_hi, const float* __restrict__ absmax_lo,
    const float* __restrict__ table, void* __restrict__ out, int out_dtype, int KP, int N) {
  __shared__ float tab[16];
  if (threadIdx.x < 16) tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const int groups = N / 4;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(KP) * groups) return;
  const int i = static_cast<int>(t / groups), c = static_cast<int>(t - static_cast<int64_t>(i) * groups) * 4;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(packed + static_cast<size_t>(i) * N + c);
  const size_t srow = static_cast<size_t>(i / 64) * N + c;
  const float4 shi = *reinterpret_cast<const float4*>(absmax_hi + srow);
  const float4 slo = *reinterpret_cast<const float4*>(absmax_lo + srow);
  const float sh[4] = {shi.x, shi.y, shi.z, shi.w}, sl[4] = {slo.x, slo.y, slo.z, slo.w};
  float hi[4], lo[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t byte = (word >> (8 * b)) & 0xFFu;
    hi[b] = __fmul_rn(tab[byte >> 4], sh[b]);
    lo[b] = __fmul_rn(tab[byte & 0xFu], sl[b]);
  }
  pk::store_out4(out, out_dtype, static_cast<size_t>(i) * N + c, hi);
  pk::store_out4(out, out_dtype, static_cast<size_t>(KP + i) * N + c, lo);
}

}  // namespace

// packed (K/2, N) u8, absmax_hi / absmax_lo (K/128, N) f32 each, table (16)
// f32, out (K, N) f32|bf16|f16.  Requires blocksize 64, K/2 % 64 == 0 and
// N % 4 == 0 (the wrapper checks N % 128 and 16-byte alignment).
extern "C" int pk_dequant_splitk(const void* packed, const void* absmax_hi, const void* absmax_lo, const void* table,
                                 void* out, int out_dtype, int KP, int N, void* stream) {
  const int64_t threads = static_cast<int64_t>(KP) * (N / 4);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (blocks > 0) {
    dequant_splitk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax_hi),
        static_cast<const float*>(absmax_lo), static_cast<const float*>(table), out, out_dtype, KP, N);
  }
  return static_cast<int>(cudaGetLastError());
}
