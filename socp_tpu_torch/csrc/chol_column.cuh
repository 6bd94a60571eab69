// chol_column.cuh -- the right-looking column loop of a lower f64 Cholesky
// factor with the whole n x n matrix in one block's shared memory.  Shared
// by chol_batched.cu (one instance per block) and chol_single.cu (n <= 169);
// their notes say what bounds it and why it is written this way.
//
// Step j: col[i] = M[i][j] / sqrt(M[j][j]) for i >= j, then the rank-1
// update M[i][k] -= col[i] col[k] of the trailing lower triangle, written
// with __dmul_rn / __dsub_rn so that it is never contracted into an FMA and
// rounds as the plain PyTorch version (ops/chol.py) does.

#pragma once

#include <cuda_runtime.h>

// H, L: one n x n row-major matrix in device memory (L gets zeros above the
// diagonal); M: n * n doubles and col: n doubles of shared memory.  Every
// thread of the block calls it.
__device__ __forceinline__ void chol_column_loop(const double* __restrict__ H,
                                                 double* __restrict__ L,
                                                 double* M, double* col,
                                                 int n) {
  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) M[e] = H[e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const double d = sqrt(M[j * n + j]);
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
        M[i * n + k] = __dsub_rn(M[i * n + k], __dmul_rn(col[i], col[k]));
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / n;
    const int c = e - r * n;
    L[e] = c <= r ? M[e] : 0.0;
  }
}
