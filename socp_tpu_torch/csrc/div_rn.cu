// div_rn.cu -- div_rn (div_rn.cuh) elementwise, so a check on the card can
// hold it to x / p bit for bit on any inputs (chip_smoke.py, the card
// tests).  No solver path calls it.

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

template <typename T>
__global__ void div_rn_kernel(const T* __restrict__ x, const T* __restrict__ p,
                              T* __restrict__ out, long n) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long>(gridDim.x) * blockDim.x) {
    out[i] = div_rn(x[i], p[i], rcp_of(p[i]));
  }
}

template <typename T>
int launch(const T* x, const T* p, T* out, long n, void* stream) {
  if (n <= 0) return 0;
  const long blocks = (n + 255) / 256;
  div_rn_kernel<T><<<blocks < 4096 ? blocks : 4096, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, p, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[i] = x[i] / p[i] through div_rn, for n entries on the device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int div_rn_f64(const double* x, const double* p, double* out,
                          long n, void* stream) {
  return launch(x, p, out, n, stream);
}

extern "C" int div_rn_f32(const float* x, const float* p, float* out, long n,
                          void* stream) {
  return launch(x, p, out, n, stream);
}
