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
// passes read rows along the lane axis; here that operand is gone.
//
// What bounds it on this card.  It must read the lower triangle of L
// (n^2 / 2 entries), n k of rhs and write n k, and does 2 n^2 k flops: at
// n = 500, k = 1 in f64 that is 1 MB and 0.5 MFLOP, 0.3 us of bytes.  The
// work is not what sets its time: the 2 n substitution steps form one
// dependent chain (x_j is final only after step j - 1), and each step is an
// IEEE division, a broadcast and a multiply-subtract: the chain's latency
// bounds it (PERF.md has its times), and the design keeps everything else
// off the chain.
//
// What the design does about it.  Panels of 32 rows, one warp wide
// (csrc/tri_pair_panels.cuh, the schedule tri_pair_batched.cu also runs on
// a batch above its warp-per-instance panels' orders; here the batch is
// one): a chain warp a rhs column (up to 4 side by side) runs each panel's
// 32 steps with nothing else on the chain (div_rn on every lane, the
// quotient broadcast by __shfl_sync, the panel's diagonal block in shared
// memory), while row threads apply the last panel's quotients to every row
// beyond it and copy the next diagonal block in.  One barrier a panel:
// ceil(n / 32) a pass instead of the 2 n of a design with a barrier a step.
// L is read from device memory (L2 holds it: 2 MB in f64 at n = 500);
// shared memory holds the pass's rhs columns, the two diagonal blocks and
// two panels' quotients.  More than 4 rhs columns run as further blocks.
//
// Agreement with the plain version (ops/chol.py).  Every x_i sees the plain
// loops' operations in their order; the panels change only which thread
// applies which j (tri_pair_panels.cuh), so the kernel agrees with the
// plain version bit for bit in either type.

#include <cuda_runtime.h>

#include "tri_pair_panels.cuh"

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(pair_panels::threads_of(W))
tri_pair_single_kernel(const T* __restrict__ L, const T* __restrict__ B,
                       T* __restrict__ X, int n, int k) {
  pair_panels::run<T, W>(L, B, X, n, k);
}

template <typename T>
int launch(const T* L, const T* B, T* X, int n, int k, void* stream) {
  static bool set[2][pair_panels::kMaxDevices] = {};
  return pair_panels::launch<T>(tri_pair_single_kernel<T, 1>,
                                tri_pair_single_kernel<T, pair_panels::kCols>,
                                set, L, B, X, 1, n, k,
                                static_cast<cudaStream_t>(stream));
}

}  // namespace

// The largest n the kernels take for entries of `itemsize` bytes: one rhs
// column of n entries must fit the shared memory the panels leave.
extern "C" int tri_pair_single_max_n(int itemsize) {
  return pair_panels::max_n(itemsize);
}

// L: (n, n) lower factor; B, X: (n, k); all row-major on the device.
// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue when n is above tri_pair_single_max_n.
extern "C" int tri_pair_single_f64(const double* L, const double* B,
                                   double* X, int n, int k, void* stream) {
  return launch(L, B, X, n, k, stream);
}

extern "C" int tri_pair_single_f32(const float* L, const float* B, float* X,
                                   int n, int k, void* stream) {
  return launch(L, B, X, n, k, stream);
}
