// chol_single.cu -- lower Cholesky factor of ONE (n, n) f64 or f32 matrix,
// any n, in one kernel launch.
//
// chol_single_f64 replaces socp_tpu/ops/pallas_chol.py:_dd_chol_kernel
// (entry point cholesky_dd): the single-instance, right-looking dd32
// Cholesky that the reference's single solve runs for n <= 768 with the
// whole matrix in VMEM.  The H100 has native FP64, so it computes the same
// function -- the lower factor L of H = L L', zeros above the diagonal --
// in f64.  chol_single_f32 replaces pallas_chol.py:_f32_chol_kernel (entry
// point cholesky_f32): the same right-looking factor of one matrix in f32,
// the factor of the solver's mixed-precision mode (factor_dtype="float32")
// on the single path.  At n = 128 it is also the port of the Mosaic probe
// scripts/pallas_probe.py:_chol_kernel (P1), the same function.
//
// What bounds it on this card.  It must read the lower triangle of H and
// write the n x n factor, about n^3 / 3 flops: at n = 500 in f64, 3 MB and
// 42 MFLOP, under 1 us of bytes or flops.  Neither sets its time.  Column
// t needs the square root of its pivot, final only once column t - 1 is
// applied, and each of its entries a division by it: n square roots and n
// rounds of IEEE divisions in one dependent chain, each link a barrier or
// a flag apart.  The chain's latency bounds the kernel (PERF.md has its
// times): per 32 columns one block factors a diagonal tile and solves the
// tile below it, 64 steps of a division, a barrier and a multiply-subtract
// each, plus a tile update and two hand-overs between blocks.
//
// What the design does about it.  A dataflow over 32 x 32 lower tiles in
// one launch (csrc/chol_tiles.cuh, the schedule chol_batched.cu also runs
// on a batch above its register tiles' orders; here the batch is one), built
// so that the chain runs in ONE block with nothing else on it: the walker
// runs the diagonal, factoring each diagonal tile and solving the tile below
// it, while the other blocks apply each tile's updates panel by panel as
// the panels are published and solve the tiles below the sub-diagonal, on
// every SM.  Every division is div_rn (div_rn.cuh) on every lane of its
// warp, the divisor's reciprocal taken once.  Blocks take tickets from an
// atomic counter in a dependency order, so progress needs no co-residency
// and no scheduling order.  The entry point zeroes the ticket and the
// flags in the wrapper's scratch buffer (cudaMemsetAsync on the call's
// stream) before every launch, so no call reads another's flags, and both
// are plain stream operations, which a CUDA graph captures.  One tile (n
// <= 32) is the walker alone: no scratch.  At n = 50 and 128 the tiles
// also beat one-block designs that keep the whole matrix in one block's
// shared memory or registers (one or two barriers a column), and the
// walker's column loop beat one that factors and solves a tile on one warp
// with the rows in registers (no barrier, but unrolled code too large for
// the instruction cache; PERF.md).
//
// Agreement with the plain version.  Every entry (i, c) of L sees the plain
// column loop's rounded operations in its order (ops/chol.py); the tiles
// change only which block applies which t (chol_tiles.cuh), so the kernel
// agrees with the plain version bit for bit in either type.  A
// non-positive pivot gives NaN, which flows on: the caller sees a
// non-finite factor.

#include <cuda_runtime.h>

#include "chol_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(chol_tiles::kThreads)
chol_single_tiles_kernel(const T* __restrict__ H, T* __restrict__ L,
                         int* __restrict__ scratch, int batch, int n,
                         int group) {
  chol_tiles::run(H, L, scratch, batch, n, group);
}

template <typename T>
int launch(const T* H, T* L, int* scratch, int n, void* stream) {
  static int grid[chol_tiles::kMaxDevices] = {};   // per process and device
  return chol_tiles::launch(chol_single_tiles_kernel<T>, grid, H, L, scratch,
                            1, n, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The ints of scratch memory chol_single_f64 / _f32 take at order n (8-byte
// aligned device memory; its contents need not be set): 0 for n <= 32,
// where the kernel takes none.
extern "C" int chol_single_scratch_ints(int n) {
  return chol_tiles::scratch_ints(1, n);
}

// H, L: (n, n) row-major on the device; L may not alias H.  scratch:
// chol_single_scratch_ints(n) ints of device memory, which the call zeroes
// in part on the stream before its kernel; may be null for n <= 32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int chol_single_f64(const double* H, double* L, int* scratch,
                               int n, void* stream) {
  return launch(H, L, scratch, n, stream);
}

extern "C" int chol_single_f32(const float* H, float* L, int* scratch, int n,
                               void* stream) {
  return launch(H, L, scratch, n, stream);
}
