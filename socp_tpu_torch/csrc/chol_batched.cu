// chol_batched.cu -- batched lower Cholesky factor in f64 or f32, one
// instance per thread block.
//
// chol_batched_f64 replaces socp_tpu/ops/pallas_chol.py:_dd_chol_batch_kernel
// (entry point cholesky_dd_batched): the instance-tiled, right-looking dd32
// Cholesky of the TPU's batched lockstep path.  The H100 has native FP64, so
// it computes the same function -- the lower factor L of H = L L', zeros
// above the diagonal -- in f64 instead of double-word f32, and drops the
// TPU's masked lane reductions: column j is read directly.
//
// chol_batched_f32 replaces pallas_chol.py:_f32_chol_kernel (entry point
// cholesky_f32, a one-instance f32 kernel that jax.vmap batches): the same
// right-looking factor in f32, the factor of the solver's mixed-precision
// mode (factor_dtype="float32") on the batched path.
//
// What bounds it on this card.  Per instance it must move 2 * 8 n^2 bytes
// (H in, L out) and does about n^3 / 3 FP64 flops: at n = 102 that is
// 166 KB and 0.35 MFLOP, about 2 flops a byte, well below the FP64 ridge of
// the card (about 10 flops a byte at 34 TFLOP/s over 3.35 TB/s).  So the
// least time is the bytes' time.  In f32 it moves 2 * 4 n^2 bytes (83 KB at
// n = 102) for the same flops, over 67 TFLOP/s FP32 (non-tensor; H100 SXM
// data sheet) against 3.35 TB/s: about 4 flops a byte against a ridge of
// 20, so the bytes bound it too.  This simple design is not there yet: a
// factor is a chain of n dependent column steps, each ending in a block
// barrier, and that chain's latency, not device memory, sets the time.
//
// What the design does about it.  The whole n x n matrix lives in dynamic
// shared memory (83,232 B at n = 102 in f64, half that in f32, plus one
// column; so n <= 169 in f64 and n <= 240 in f32), so device memory is
// read once and written once, both coalesced, and every column step runs
// on chip.  The scaled column is copied to a small array so the rank-1
// update reads it contiguously instead of at stride n (bank conflicts).
// Two blocks fit on one SM at n = 102, so one block's barrier wait can
// overlap the other's update.  A non-positive pivot gives NaN from sqrt
// (or 0/0) and the NaN flows on through the later columns: there is no
// early exit, so the caller sees a non-finite factor, as with the
// reference's jnp.linalg.cholesky.  The update is written with __dmul_rn /
// __dsub_rn (__fmul_rn / __fsub_rn in f32), which the compiler never
// contracts into an FMA: every value is rounded as the plain PyTorch
// version rounds it, so the two agree bit for bit on the card (sqrt and
// division are IEEE-rounded in both).  The column loop itself is in
// chol_column.cuh, shared with chol_single.cu.

#include <cuda_runtime.h>

#include "chol_column.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_batched_kernel(const T* __restrict__ H, T* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  // the n x n working matrix, then the scaled column j
  chol_column_loop(H + base, L + base, smem, smem + n * n, n);
}

template <typename T>
int launch(const T* H, T* L, int batch, int n, void* stream) {
  const size_t smem = (static_cast<size_t>(n) * n + n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_batched_kernel<T><<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(H, L, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H, L: (batch, n, n) row-major on the device; L may not alias H.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int chol_batched_f64(const double* H, double* L, int batch, int n,
                                void* stream) {
  return launch(H, L, batch, n, stream);
}

extern "C" int chol_batched_f32(const float* H, float* L, int batch, int n,
                                void* stream) {
  return launch(H, L, batch, n, stream);
}
