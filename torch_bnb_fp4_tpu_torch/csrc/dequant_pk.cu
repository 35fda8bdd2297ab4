// K6: pair-K dequantize, Wt (K, N) = w * s.
//
// Replaces torch_bnb_fp4_tpu/ops/kernels.py::_dequant_pk_kernel (:1329), the
// pallas_call of dequantize_tpu_pk (:1353).  Runs once per linear when the
// int8 prefill shadow is attached (f32 out) and in dequantize_weight (bf16).
//
// Numerics (as :1330-1332): w = 192*code (FP4 variants) or bf16(code) (lut)
// from the shared K1 decode, s = the scale row of the weight's 64-row block
// (f32, or bf16 widened exactly), Wt = f32(w * s) rounded once to the output
// type (round to nearest even).  One f32 multiply and one cast: bit-exact with
// the plain version (ops/kernels.py::dequantize_pk_plain).
//
// Bound: bytes.  K*N/2 packed bytes and the scales in, K*N*out_bytes out
// (gate|up of Mistral-7B at f32 out: 58.7 MB in, 470 MB out, ~0.16 ms at
// 3.35 TB/s).  Design: a streaming pass, one thread per 4 consecutive bytes
// along N of one packed row i (one 32-bit load); it decodes them, multiplies
// rows 2i and 2i+1 by their shared scale row (blocksize 64 keeps a pair in
// one block) and writes 4 consecutive outputs of each row, so a warp reads
// 512 contiguous bytes and writes two contiguous row segments.  The lut
// variant reads its 16-entry table from shared memory.
#include "pairk_decode.cuh"

namespace {

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads) dequant_pk_kernel(const uint8_t* __restrict__ packed,
                                                              const void* __restrict__ scale, int scale_dtype,
                                                              const uint16_t* __restrict__ lut,
                                                              void* __restrict__ out, int out_dtype, int KP, int N) {
  __shared__ uint16_t lut_s[16];
  if (V == pk::kLut && threadIdx.x < 16) lut_s[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const int groups = N / 4;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(KP) * groups) return;
  const int i = static_cast<int>(t / groups), c = static_cast<int>(t - static_cast<int64_t>(i) * groups) * 4;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(packed + static_cast<size_t>(i) * N + c);
  const size_t srow = static_cast<size_t>(i / 32) * N + c;  // block (2i)/64 of rows 2i and 2i+1
  float lo[4], hi[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t bits = pk::decode_pairs<V>((word >> (8 * b)) & 0xFFu, lut_s);
    const float s = pk::load_scale(scale, scale_dtype, srow + b);
    lo[b] = __fmul_rn(pk::pair_lo(bits), s);
    hi[b] = __fmul_rn(pk::pair_hi(bits), s);
  }
  pk::store_out4(out, out_dtype, static_cast<size_t>(2 * i) * N + c, lo);
  pk::store_out4(out, out_dtype, static_cast<size_t>(2 * i + 1) * N + c, hi);
}

template <int V>
int launch(const uint8_t* p, const void* scale, int scale_dtype, const uint16_t* lut, void* out, int out_dtype,
           int KP, int N, cudaStream_t s) {
  const int64_t threads = static_cast<int64_t>(KP) * (N / 4);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (blocks > 0) dequant_pk_kernel<V><<<blocks, kThreads, 0, s>>>(p, scale, scale_dtype, lut, out, out_dtype, KP, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed (K/2, N) u8, scale (K/64, N) f32|bf16, lut (16) int16 bf16 bit
// patterns (lut variant only, else null), out (K, N) f32|bf16|f16.  Requires
// N % 4 == 0 and blocksize 64 (the wrapper checks N % 128 and alignment).
extern "C" int pk_dequant_pk(const void* packed, const void* scale, int scale_dtype, const void* lut, void* out,
                             int out_dtype, int KP, int N, int variant, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(packed);
  auto l = static_cast<const uint16_t*>(lut);
  switch (variant) {
    case pk::kExact: return launch<pk::kExact>(p, scale, scale_dtype, l, out, out_dtype, KP, N, s);
    case pk::kZramp: return launch<pk::kZramp>(p, scale, scale_dtype, l, out, out_dtype, KP, N, s);
    case pk::kRamp: return launch<pk::kRamp>(p, scale, scale_dtype, l, out, out_dtype, KP, N, s);
    case pk::kLut: return launch<pk::kLut>(p, scale, scale_dtype, l, out, out_dtype, KP, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
