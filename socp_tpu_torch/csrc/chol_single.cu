// chol_single.cu -- lower Cholesky factor of ONE (n, n) f64 or f32 matrix,
// any n.
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
// What bounds it on this card.  It must read the lower triangle of H
// (n^2 / 2 entries) and write the n x n factor (n^2 entries), and does about
// n^3 / 3 flops: at n = 500 in f64 that is 3 MB and 42 MFLOP, 0.9 us at
// 3.35 TB/s against 0.6 us at the card's fastest FP64 rate (67 TFLOP/s),
// so the bytes bound it; in f32, 1.5 MB (4 B an entry) against the same
// flops at 67 TFLOP/s FP32 (non-tensor; H100 SXM data sheet), bytes again.
// This design is far from that: n dependent column steps, each ending in a
// barrier or (every 32 columns) a launch, set its time.
//
// What the design does about it.  Two regimes:
//
//  * n <= one_block_max_n<T>() (169 in f64, 240 in f32): the whole matrix
//    fits one block's 227 KB of shared memory, so one block runs the
//    right-looking column loop on chip (chol_column.cuh, as
//    chol_batched.cu runs it for each instance): device memory is read
//    once and written once, one launch.  It is a kernel of its own, not
//    chol_batched at B = 1, for its thread count: with one block on the
//    card, 512 threads instead of 256 share each column's update, and at
//    n = 50 it took 0.059 ms against the batched kernel's 0.070 ms in f64
//    (chip_smoke.py's single_kernels phase, batched_kernel_b1_ms; H100
//    80GB HBM3 at 700 W).
//  * above (500 x 500 is 2 MB in f64, 1 MB in f32): a blocked right-looking
//    factor over panels of kNb = 32 columns, 2 ceil(n / 32) launches on one
//    stream:
//      init    L = tril(H) (many blocks);
//      panel   ONE block factors the 32 x 32 diagonal block in shared memory
//              (the column loop), then each thread finishes whole rows below
//              it (a triangular solve against the diagonal block, no
//              barriers, the row in registers);
//      update  the trailing lower triangle, tiles of 32 x 32 over many
//              blocks, each tile's two 32 x 32 panel slices in shared
//              memory: A[i][c] -= sum_t L[i][t] L[c][t].  This is the TPU
//              kernel's rank-1 update (pallas_chol.py:183-185) applied 32
//              columns at a time; it is hand-written, not a library GEMM.
//    The factor lives in device memory (50 MB of L2 holds it) and never
//    needs more shared memory than two 32 x 33 tiles, so every n works.
//
// Agreement with the plain version.  Every entry (i, c) of L sees the same
// rounded operations in the same order in both regimes as in the plain
// PyTorch column loop (ops/chol.py): acc -= L[i][t] * L[c][t] for t = 0, 1,
// ..., c - 1, then L[i][c] = acc / sqrt(pivot).  Blocking only changes
// which launch applies which t, never the order per entry, and the update
// uses mul_rn / sub_rn (chol_column.cuh), which the compiler never
// contracts into an FMA.  So the kernel agrees with the plain version bit
// for bit in either type (sqrt and division are IEEE-rounded in both).
//
// A non-positive pivot gives NaN from sqrt (or 0/0), and the NaN flows on
// through the later columns and panels: there is no early exit and no
// error, so the caller sees a non-finite factor.

#include <cuda_runtime.h>

#include "chol_column.cuh"

namespace {

constexpr int kSmallThreads = 512;
constexpr int kNb = 32;            // panel width
constexpr int kPanelThreads = 512;
constexpr int kTileThreads = 256;  // trailing update: kNb x kNb tiles

// ---- n <= one_block_max_n<T>(): the whole matrix in one block's shared
// memory

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
chol_single_small_kernel(const T* __restrict__ H, T* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // the n x n working matrix, then the scaled column j
  chol_column_loop(H, L, smem, smem + n * n, n);
}

// ---- larger n: blocked right-looking factor, in place in L --------------

template <typename T>
__global__ void chol_single_init_kernel(const T* __restrict__ H,
                                        T* __restrict__ L, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < nn; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = e / n;
    const size_t c = e - r * n;
    L[e] = c <= r ? H[e] : T(0);
  }
}

// Columns [k0, k0 + nb) of L, nb = min(kNb, n - k0), one block.  Earlier
// panels' updates are already in L.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
chol_single_panel_kernel(T* __restrict__ L, int n, int k0) {
  __shared__ T D[kNb][kNb + 1];  // diagonal block (+1: fewer conflicts)
  __shared__ T col[kNb];         // scaled column j of the block
  __shared__ T piv[kNb];         // sqrt of each updated pivot
  const int nb = min(kNb, n - k0);
  const int tid = threadIdx.x;

  for (int e = tid; e < kNb * kNb; e += blockDim.x) {
    const int r = e / kNb;
    const int c = e - r * kNb;
    if (r < nb && c <= r) D[r][c] = L[static_cast<size_t>(k0 + r) * n + k0 + c];
  }
  __syncthreads();

  // the column loop on the diagonal block
  for (int j = 0; j < nb; ++j) {
    if (tid >= j && tid < nb) {
      const T d = sqrt_rn(D[j][j]);
      col[tid] = D[tid][j] / d;
      if (tid == j) piv[j] = d;
    }
    __syncthreads();
    for (int e = tid; e < kNb * kNb; e += blockDim.x) {
      const int r = e / kNb;
      const int c = e - r * kNb;
      if (r < nb && c <= r && c >= j) {
        D[r][c] = c == j ? col[r]
                         : sub_rn(D[r][c], mul_rn(col[r], col[c]));
      }
    }
    __syncthreads();
  }

  // rows below the block: a thread finishes row i left to right.  Rows
  // exist only when the panel is full (nb == kNb), so the loops are fixed.
  for (int i = k0 + kNb + tid; i < n; i += blockDim.x) {
    // a compiler barrier: without it nvcc hoists all 528 reads of D out of
    // this loop into registers and spills them
    asm volatile("" ::: "memory");
    T* row = L + static_cast<size_t>(i) * n + k0;
    T v[kNb];
#pragma unroll
    for (int c = 0; c < kNb; ++c) v[c] = row[c];
#pragma unroll
    for (int c = 0; c < kNb; ++c) {
      T acc = v[c];
#pragma unroll
      for (int t = 0; t < c; ++t) acc = sub_rn(acc, mul_rn(v[t], D[c][t]));
      v[c] = acc / piv[c];
    }
#pragma unroll
    for (int c = 0; c < kNb; ++c) row[c] = v[c];
  }

  for (int e = tid; e < kNb * kNb; e += blockDim.x) {
    const int r = e / kNb;
    const int c = e - r * kNb;
    if (r < nb && c <= r) L[static_cast<size_t>(k0 + r) * n + k0 + c] = D[r][c];
  }
}

// Trailing update after the (full) panel at k0: tile (blockIdx.y,
// blockIdx.x) of the lower triangle of [k0 + kNb, n)^2.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
chol_single_update_kernel(T* __restrict__ L, int n, int k0) {
  const int tr = blockIdx.y;
  const int tc = blockIdx.x;
  if (tc > tr) return;
  __shared__ T Pr[kNb][kNb + 1];  // L[r0 + a][k0 + t]
  __shared__ T Pc[kNb][kNb + 1];  // L[c0 + b][k0 + t]
  const int r0 = k0 + kNb + tr * kNb;
  const int c0 = k0 + kNb + tc * kNb;

  for (int e = threadIdx.x; e < kNb * kNb; e += blockDim.x) {
    const int a = e / kNb;
    const int t = e - a * kNb;
    Pr[a][t] = r0 + a < n ? L[static_cast<size_t>(r0 + a) * n + k0 + t] : T(0);
    Pc[a][t] = c0 + a < n ? L[static_cast<size_t>(c0 + a) * n + k0 + t] : T(0);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kNb * kNb; e += blockDim.x) {
    const int a = e / kNb;
    const int b = e - a * kNb;
    const int i = r0 + a;
    const int c = c0 + b;
    if (i < n && c <= i) {
      T* p = L + static_cast<size_t>(i) * n + c;
      T acc = *p;
#pragma unroll 8
      for (int t = 0; t < kNb; ++t) {
        acc = sub_rn(acc, mul_rn(Pr[a][t], Pc[b][t]));
      }
      *p = acc;
    }
  }
}

template <typename T>
int launch(const T* H, T* L, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= one_block_max_n<T>()) {
    const size_t smem = (static_cast<size_t>(n) * n + n) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        chol_single_small_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    chol_single_small_kernel<T><<<1, kSmallThreads, smem, s>>>(H, L, n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t nn = static_cast<size_t>(n) * n;
  const int init_blocks = static_cast<int>((nn + 1023) / 1024);
  chol_single_init_kernel<T><<<init_blocks < 1024 ? init_blocks : 1024, 1024,
                               0, s>>>(H, L, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k0 = 0; k0 < n; k0 += kNb) {
    chol_single_panel_kernel<T><<<1, kPanelThreads, 0, s>>>(L, n, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rest = n - k0 - kNb;
    if (rest > 0) {
      const int tiles = (rest + kNb - 1) / kNb;
      chol_single_update_kernel<T><<<dim3(tiles, tiles), kTileThreads, 0, s>>>(
          L, n, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// H, L: (n, n) row-major on the device; L may not alias H.  Returns the
// CUDA error code of the first launch that failed (0 on success).
extern "C" int chol_single_f64(const double* H, double* L, int n,
                               void* stream) {
  return launch(H, L, n, stream);
}

extern "C" int chol_single_f32(const float* H, float* L, int n, void* stream) {
  return launch(H, L, n, stream);
}
