// chol_batched.cu -- batched lower Cholesky factor in f64, one instance per
// thread block.
//
// Replaces socp_tpu/ops/pallas_chol.py:_dd_chol_batch_kernel (entry point
// cholesky_dd_batched): the instance-tiled, right-looking dd32 Cholesky of
// the TPU's batched lockstep path.  The H100 has native FP64, so this
// kernel computes the same function -- the lower factor L of H = L L',
// zeros above the diagonal -- in f64 instead of double-word f32, and drops
// the TPU's masked lane reductions: column j is read directly.
//
// What bounds it on this card.  Per instance it must move 2 * 8 n^2 bytes
// (H in, L out) and does about n^3 / 3 FP64 flops: at n = 102 that is
// 166 KB and 0.35 MFLOP, about 2 flops a byte, well below the FP64 ridge of
// the card (about 10 flops a byte at 34 TFLOP/s over 3.35 TB/s).  So the
// least time is the bytes' time.  This simple design is not there yet: a
// factor is a chain of n dependent column steps, each ending in a block
// barrier, and that chain's latency, not device memory, sets the time.
//
// What the design does about it.  The whole n x n matrix lives in dynamic
// shared memory (83,232 B at n = 102, plus one column), so device memory is
// read once and written once, both coalesced, and every column step runs
// on chip.  The scaled column is copied to a small array so the rank-1
// update reads it contiguously instead of at stride n (bank conflicts).
// Two blocks fit on one SM at n = 102, so one block's barrier wait can
// overlap the other's update.  A non-positive pivot gives NaN from sqrt
// (or 0/0) and the NaN flows on through the later columns: there is no
// early exit, so the caller sees a non-finite factor, as with the
// reference's jnp.linalg.cholesky.  The update is written with __dmul_rn /
// __dsub_rn, which the compiler never contracts into an FMA: every value
// is rounded as the plain PyTorch version rounds it, so the two agree bit
// for bit on the card (sqrt and division are IEEE-rounded in both).  The
// column loop itself is in chol_column.cuh, shared with chol_single.cu.

#include <cuda_runtime.h>

#include "chol_column.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chol_batched_kernel(const double* __restrict__ H, double* __restrict__ L, int n) {
  extern __shared__ double smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  // the n x n working matrix, then the scaled column j
  chol_column_loop(H + base, L + base, smem, smem + n * n, n);
}

}  // namespace

// H, L: (batch, n, n) row-major f64 on the device; L may not alias H.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int chol_batched_f64(const double* H, double* L, int batch, int n,
                                void* stream) {
  const size_t smem = (static_cast<size_t>(n) * n + n) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      chol_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_batched_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(H, L, n);
  return static_cast<int>(cudaGetLastError());
}
