// chol_column.cuh -- the right-looking column loop of a lower Cholesky
// factor (f64 or f32) with the whole n x n matrix in one block's shared
// memory, and the correctly rounded scalar operations the kernels share.
// The loop is chol_batched.cu's (one instance per block); the other sources
// use the scalar operations.  chol_batched.cu's note says what bounds the
// loop and why it is written this way.
//
// Step j: col[i] = M[i][j] / sqrt(M[j][j]) for i >= j, then the rank-1
// update M[i][k] -= col[i] col[k] of the trailing lower triangle, written
// with mul_rn / sub_rn (__dmul_rn / __dsub_rn, __fmul_rn / __fsub_rn) so
// that it is never contracted into an FMA and rounds as the plain PyTorch
// version (ops/chol.py) does.  sqrt_rn and IEEE `/` are correctly rounded
// in both types: the build has no --use_fast_math.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sqrt_rn(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return sqrtf(a); }

// H, L: one n x n row-major matrix in device memory (L gets zeros above the
// diagonal); M: n * n and col: n entries of shared memory.  Every thread of
// the block calls it.
template <typename T>
__device__ __forceinline__ void chol_column_loop(const T* __restrict__ H,
                                                 T* __restrict__ L, T* M,
                                                 T* col, int n) {
  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) M[e] = H[e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const T d = sqrt_rn(M[j * n + j]);
    for (int i = j + threadIdx.x; i < n; i += blockDim.x) {
      col[i] = M[i * n + j] / d;
    }
    __syncthreads();
    for (int i = j + threadIdx.x; i < n; i += blockDim.x) {
      M[i * n + j] = col[i];
    }
    const int t = n - j - 1;
    for (int e = threadIdx.x; e < t * t; e += blockDim.x) {
      const int r = e / t;
      const int c = e - r * t;
      if (c <= r) {
        const int i = j + 1 + r;
        const int k = j + 1 + c;
        M[i * n + k] = sub_rn(M[i * n + k], mul_rn(col[i], col[k]));
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n;
    const int c = e - r * n;
    L[e] = c <= r ? M[e] : T(0);
  }
}
