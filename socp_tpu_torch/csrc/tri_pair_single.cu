// tri_pair_single.cu -- (L L')^-1 B in f64 or f32 for ONE (n, n) lower
// factor and an (n, k) right-hand side: forward substitution on L, then
// backward substitution on L' read from the same L.
//
// tri_pair_single_f64 replaces socp_tpu/ops/pallas_chol.py:_tri_pair_kernel
// (entry point tri_pair_solve), the single-instance dd32 pair solve of the
// reference's single solve, which keeps L, its transpose LT and the rhs in
// VMEM; it computes the same function in f64.  tri_pair_single_f32 replaces
// pallas_chol.py:_f32_tri_kernel (entry point tri_solve_f32): the same
// forward-then-backward pair solve of one instance in f32, the back-solve
// of the solver's mixed-precision mode (factor_dtype="float32") on the
// single path.  Both TPU kernels took LT as a second operand so that both
// passes read rows along the lane axis; here that operand is gone (see the
// forward pass below).
//
// What bounds it on this card.  It must read the lower triangle of L
// (n^2 / 2 entries), n k of rhs and write n k, and does 2 n^2 k flops: at
// n = 500, k = 1 in f64 that is 1 MB and 0.5 MFLOP, a quarter flop a byte,
// so the least time is the bytes' time, 0.3 us.  In f32 the bytes halve
// (4 B an entry over 3.35 TB/s) and the flops run at 67 TFLOP/s FP32
// (non-tensor; H100 SXM data sheet): bytes again.  This simple design is
// far from that: 2 n dependent substitution steps, each ending in a block
// barrier, set its time.
//
// What the design does about it.  At n = 500 L is 2 MB in f64: it does not fit
// shared memory, but it fits the 50 MB L2, so one block streams L's entries
// from device memory and keeps only the pivots and the rhs columns it is
// working on in shared memory (kCols columns at a time; more columns run
// as further passes in the same launch).  Each thread owns rows i = tid,
// tid + blockDim, ... for the whole solve.
//   forward   step j: x_i -= L[i][j] * (x_j / L_jj) for i > j.  A thread
//             walks its own row of L left to right, one entry a step, so
//             each 128-byte line it loads serves 16 steps from L1.
//   backward  step j: x_i -= L[j][i] * (x_j / L_jj) for i < j.  Neighbouring
//             threads read neighbouring entries of row j: coalesced.
// Both passes keep the plain version's axpy order (ops/chol.py) rather
// than a dot-product form, because a different summation order would not
// round as the plain version does: with mul_rn / sub_rn (chol_column.cuh;
// never contracted into an FMA) every value is rounded as the plain version
// rounds it and the two agree bit for bit on the card.  Each step has ONE
// barrier: every thread computes x_j / L_jj itself and no thread writes
// row j while another reads it; the division of each row by its pivot
// happens in one pass after each loop.  The block has one thread per row
// (rounded up to a warp) up to 1024, so a small n pays for small barriers.

#include <cuda_runtime.h>

#include "chol_column.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCols = 8;  // rhs columns held per pass

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
tri_pair_single_kernel(const T* __restrict__ L, const T* __restrict__ B,
                       T* __restrict__ X, int n, int k, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* diag = reinterpret_cast<T*>(smem_raw);  // n pivots L_ii
  T* xs = diag + n;  // n x w columns of the current pass, row-major

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    diag[i] = L[static_cast<size_t>(i) * n + i];
  }

  for (int c0 = 0; c0 < k; c0 += kc) {
    const int w = min(kc, k - c0);
    __syncthreads();  // pivots loaded; the previous pass is done with xs
    for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
      const int i = e / w;
      const int c = e - i * w;
      xs[e] = B[static_cast<size_t>(i) * k + c0 + c];
    }
    __syncthreads();

    // forward: L y = b
    for (int j = 0; j < n - 1; ++j) {
      const T ljj = diag[j];
      T q[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) q[c] = c < w ? xs[j * w + c] / ljj : T(0);
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (i > j) {
          const T lij = L[static_cast<size_t>(i) * n + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (c < w) {
              xs[i * w + c] = sub_rn(xs[i * w + c], mul_rn(lij, q[c]));
            }
          }
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
      xs[e] = xs[e] / diag[e / w];
    }
    __syncthreads();

    // backward: L' x = y
    for (int j = n - 1; j > 0; --j) {
      const T ljj = diag[j];
      T q[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) q[c] = c < w ? xs[j * w + c] / ljj : T(0);
      const T* row = L + static_cast<size_t>(j) * n;
      for (int i = threadIdx.x; i < j; i += blockDim.x) {
        const T lji = row[i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < w) {
            xs[i * w + c] = sub_rn(xs[i * w + c], mul_rn(lji, q[c]));
          }
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
      const int i = e / w;
      const int c = e - i * w;
      X[static_cast<size_t>(i) * k + c0 + c] = xs[e] / diag[i];
    }
  }
}

// Largest shared-memory allocation of one block on Hopper (bytes).
constexpr size_t kSmemLimit = 232448;

template <typename T>
int launch(const T* L, const T* B, T* X, int n, int k, void* stream) {
  const size_t per_col = static_cast<size_t>(n) * sizeof(T);
  const size_t room = kSmemLimit / per_col;  // n-vectors that fit
  if (room < 2) return static_cast<int>(cudaErrorInvalidValue);
  int kc = static_cast<int>(room - 1);
  if (kc > kCols) kc = kCols;
  if (kc > k) kc = k;
  const size_t smem = per_col * (1 + kc);
  cudaError_t err = cudaFuncSetAttribute(
      tri_pair_single_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (n + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  tri_pair_single_kernel<T><<<1, threads, smem, static_cast<cudaStream_t>(
                                                    stream)>>>(L, B, X, n, k,
                                                               kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: (n, n) lower factor; B, X: (n, k); all row-major on the device.
// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue when not even one rhs column fits shared memory.
extern "C" int tri_pair_single_f64(const double* L, const double* B,
                                   double* X, int n, int k, void* stream) {
  return launch(L, B, X, n, k, stream);
}

extern "C" int tri_pair_single_f32(const float* L, const float* B, float* X,
                                   int n, int k, void* stream) {
  return launch(L, B, X, n, k, stream);
}
