// tri_pair_batched.cu -- batched (L L')^-1 B in f64 or f32: forward
// substitution on L, then backward substitution on L' read from the same L,
// one instance per thread block.
//
// tri_pair_batched_f64 replaces
// socp_tpu/ops/pallas_chol.py:_tri_pair_batch_kernel (entry point
// tri_pair_solve_batched), the instance-tiled dd32 pair solve of the TPU's
// batched lockstep path; it computes the same function in f64.
// tri_pair_batched_f32 replaces pallas_chol.py:_f32_tri_kernel (entry point
// tri_solve_f32, a one-instance f32 kernel that jax.vmap batches): the same
// forward-then-backward pair solve in f32, the back-solve of the solver's
// mixed-precision mode (factor_dtype="float32") on the batched path.  Both
// TPU kernels took L' as a second operand so that both passes read rows
// along the lane axis; here both passes read L from shared memory, so that
// operand is gone.
//
// What bounds it on this card.  Per instance it must read 8 n^2 bytes of L
// and 8 n k of rhs and write 8 n k, and does 2 n^2 k FP64 flops: at n = 102,
// k = 1 that is 85 KB and 21 kFLOP, a quarter flop a byte, so the least
// time is the bytes' time, and reading L dominates.  In f32 every byte
// count halves (4 B an entry over 3.35 TB/s) and the flops run at 67
// TFLOP/s FP32 (non-tensor; H100 SXM data sheet): still a quarter flop a
// byte, still bound by bytes.  This simple design is
// not there yet: 2 n dependent substitution steps, each ending in a block
// barrier, set its time.
//
// What the design does about it.  L and the k rhs columns live in dynamic
// shared memory ((n^2 + n k) entries: n <= 169 at k = 1 in f64, n <= 240
// in f32), so L is read from device memory once, coalesced, and
// both passes run on chip.  Each step has ONE barrier: the threads of step
// j read x_j = b_j / L_jj without writing it back (every thread computes
// the same quotient), update the rows below (forward) or above (backward),
// and the division of each row by its pivot happens in one pass after the
// loop -- so no thread writes row j while another reads it.  Threads are
// spread over rows x rhs columns.  Updates use mul_rn / sub_rn
// (chol_column.cuh: __dmul_rn / __dsub_rn, __fmul_rn / __fsub_rn, never
// contracted into an FMA), so each value is rounded as the plain PyTorch
// version rounds it and the two agree bit for bit on the card.

#include <cuda_runtime.h>

#include "chol_column.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
tri_pair_batched_kernel(const T* __restrict__ L, const T* __restrict__ B,
                        T* __restrict__ X, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);  // n x n factor, row-major
  T* xs = Ls + n * n;                      // n x k right-hand sides, row-major
  const int nn = n * n;
  const int nk = n * k;
  const size_t lbase = static_cast<size_t>(blockIdx.x) * nn;
  const size_t bbase = static_cast<size_t>(blockIdx.x) * nk;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) Ls[e] = L[lbase + e];
  for (int e = threadIdx.x; e < nk; e += blockDim.x) xs[e] = B[bbase + e];
  __syncthreads();

  // forward: L y = b.  Step j: b_i -= L[i][j] * (b_j / L[j][j]), i > j.
  for (int j = 0; j < n - 1; ++j) {
    const T ljj = Ls[j * n + j];
    const int len = (n - j - 1) * k;
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int r = e / k;
      const int c = e - r * k;
      const int i = j + 1 + r;
      xs[i * k + c] = sub_rn(xs[i * k + c],
                             mul_rn(Ls[i * n + j], xs[j * k + c] / ljj));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nk; e += blockDim.x) {
    const int i = e / k;
    xs[e] = xs[e] / Ls[i * n + i];
  }
  __syncthreads();

  // backward: L' x = y.  Step j: y_i -= L[j][i] * (y_j / L[j][j]), i < j.
  for (int j = n - 1; j > 0; --j) {
    const T ljj = Ls[j * n + j];
    const int len = j * k;
    for (int e = threadIdx.x; e < len; e += blockDim.x) {
      const int i = e / k;
      const int c = e - i * k;
      xs[i * k + c] = sub_rn(xs[i * k + c],
                             mul_rn(Ls[j * n + i], xs[j * k + c] / ljj));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nk; e += blockDim.x) {
    const int i = e / k;
    X[bbase + e] = xs[e] / Ls[i * n + i];
  }
}

template <typename T>
int launch(const T* L, const T* B, T* X, int batch, int n, int k,
           void* stream) {
  const size_t smem =
      (static_cast<size_t>(n) * n + static_cast<size_t>(n) * k) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      tri_pair_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_pair_batched_kernel<T><<<batch, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(L, B, X,
                                                                    n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: (batch, n, n) lower factor; B, X: (batch, n, k); all row-major on the
// device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int tri_pair_batched_f64(const double* L, const double* B,
                                    double* X, int batch, int n, int k,
                                    void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}

extern "C" int tri_pair_batched_f32(const float* L, const float* B, float* X,
                                    int batch, int n, int k, void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}
