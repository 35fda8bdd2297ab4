// K1 test kernel: expands packed bytes through pk::decode_pairs so the shared
// device routine can be held bit-for-bit against its plain PyTorch version
// (ops/kernels.py::decode_pairs_plain).  One thread per byte; the output word
// holds the two bf16 bit patterns (low 16 bits = low nibble = Wt row 2i).
// Not on the serving path: K2-K4 inline the same routine.
#include "pairk_decode.cuh"

namespace {

template <int V>
__global__ void decode_pairs_kernel(const uint8_t* __restrict__ packed, uint32_t* __restrict__ out,
                                    int64_t n, const uint16_t* __restrict__ lut) {
  __shared__ uint16_t lut_s[16];
  if (V == pk::kLut && threadIdx.x < 16) lut_s[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pk::decode_pairs<V>(packed[i], lut_s);
}

}  // namespace

extern "C" int pk_decode_pairs(const void* packed, void* out, int64_t n, int variant, const void* lut,
                               void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint8_t*>(packed);
  auto o = static_cast<uint32_t*>(out);
  auto l = static_cast<const uint16_t*>(lut);
  if (n > 0) {
    switch (variant) {
      case pk::kExact: decode_pairs_kernel<pk::kExact><<<blocks, threads, 0, s>>>(p, o, n, l); break;
      case pk::kZramp: decode_pairs_kernel<pk::kZramp><<<blocks, threads, 0, s>>>(p, o, n, l); break;
      case pk::kRamp: decode_pairs_kernel<pk::kRamp><<<blocks, threads, 0, s>>>(p, o, n, l); break;
      case pk::kLut: decode_pairs_kernel<pk::kLut><<<blocks, threads, 0, s>>>(p, o, n, l); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
