// chol_batched.cu -- batched lower Cholesky factor in f64 or f32, one
// instance per thread block, the trailing matrix in registers.
//
// chol_batched_f64 replaces socp_tpu/ops/pallas_chol.py:_dd_chol_batch_kernel
// (entry point cholesky_dd_batched): the instance-tiled, right-looking dd32
// Cholesky of the TPU's batched lockstep path.  The H100 has native FP64, so
// it computes the same function -- the lower factor L of H = L L', zeros
// above the diagonal -- in f64 instead of double-word f32, and drops the
// TPU's masked lane reductions.  chol_batched_f32 replaces
// pallas_chol.py:_f32_chol_kernel (entry point cholesky_f32, a one-instance
// f32 kernel that jax.vmap batches): the same factor in f32, the factor of
// the solver's mixed-precision mode (factor_dtype="float32") on the batched
// path.
//
// What bounds it on this card.  Per instance it must read H's lower
// triangle and write the n x n factor, and it does n^3 / 3 multiplies and
// subtractions: at n = 102 in f64, 125 KB and 0.35 MFLOP, so for B = 4096
// about 0.15 ms of bytes and 0.1 ms of the vector FP64 units (the tensor
// cores are no use: an MMA fuses and reorders the sums, and every entry
// must round as the plain loop rounds it).  Neither sets its time.  A
// factor is a chain of n - 1 column steps, each ending in a block barrier,
// and at n = 102 a step takes about 1 us whatever the number of blocks
// on an SM (the f32 instance, with 5 blocks an SM against 3, is faster by
// that ratio): the step's latency bounds the kernel, and resident blocks
// divide it.  Of a step, the pivot's square root, its reciprocal and the
// column's divisions are about a third (PERF.md has the times and the
// variants measured).
//
// What the design does about it.  The lower triangle is cut into 4 x 4
// micro-tiles held in registers, kSlots of them a thread, dealt round-robin
// in the order tile column descending (so at every step the tiles still
// being updated are spread evenly over the threads).  H's lower triangle
// comes in packed in dynamic shared memory (cp.async, every row coalesced)
// and goes to the registers; L goes back the same way, every row written
// whole.  Step j, between two barriers:
//   lookahead  the owners of column j + 1 apply column j to it first, take
//              the pivot's square root (each from the pivot published one
//              step earlier, minus its own update: the same rounded
//              operations as the pivot's owner, so every thread gets the
//              same bits), its reciprocal once (div_rn.cuh), divide their
//              entries and publish the column to a double-buffered vector;
//   update     every thread applies column j to its micro-tiles: r + c
//              shared loads for r c multiply-subtracts (8 for 16; the
//              column is stored by row mod 4, so the lanes of a warp read
//              neighbouring words), and the owner of entry (j + 2, j + 2)
//              publishes it.
// So one barrier a step, no integer division in the loop (the step loop is
// unrolled by 4, so a column's place in its tile is a constant: a rolled
// loop with runtime places was slower), and no work above the diagonal but
// in the diagonal tiles.  Registers set the blocks an SM (3 in f64 at
// n = 102, 158 registers a thread).  Two schedules, chosen by n: 128
// threads with 3 tiles each up to n = 108 (the main path's n = 102), 256
// threads with 4 (f64) or 8 (f32) tiles each above, up to n = 176 (f64)
// and 252 (f32).
//
// Agreement with the plain version (ops/chol.py).  Every entry (i, k) of L
// sees the plain column loop's rounded operations in its order: acc -=
// L[i][t] * L[k][t] for t = 0, 1, ..., k - 1, then acc / sqrt(pivot k).
// mul_rn / sub_rn (chol_column.cuh) are never contracted into an FMA and
// div_rn is x / p bit for bit, so the kernel agrees with the plain version
// bit for bit in either type.  A non-positive pivot gives NaN from sqrt (or
// 0/0) and the NaN flows on through the later columns: no early exit, so
// the caller sees a non-finite factor, as with the reference's
// jnp.linalg.cholesky.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "chol_column.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kQ = 4;         // micro-tile edge
constexpr int kMaxN = 256;    // the published column and pivots' length
constexpr int kMaxDevices = 64;

// The first schedule: up to 3 x 128 tiles (n <= 108); the second: up to
// 256 x kSlots2 tiles.
constexpr int kThreads1 = 128, kSlots1 = 3;
constexpr int kThreads2 = 256;
template <typename T>
constexpr int slots2() { return sizeof(T) == 8 ? 4 : 8; }

__host__ __device__ constexpr int tiles_of(int n) {
  return (n + kQ - 1) / kQ * ((n + kQ - 1) / kQ + 1) / 2;
}

// A published column: entry i at [i % 4][i / 4], so that the lanes of a
// warp, on neighbouring tiles of one tile column, read neighbouring words.
template <typename T>
using Column = T[kQ][kMaxN / kQ];

// Step j = 4 cj + kBj: column j (published in col[j & 1]) to the trailing
// tiles; column j + 1 first, divided and published in col[(j + 1) & 1];
// then pivot j + 2 published in pv.
template <int kBj, typename T, int kSlots>
__device__ __forceinline__ void step(T (&acc)[kSlots][kQ][kQ],
                                     const int (&tr)[kSlots],
                                     const int (&tc)[kSlots],
                                     Column<T> (&col)[2], T (&pv)[kMaxN],
                                     int j, int cj, int n) {
  constexpr int kCur = kBj & 1;            // j's parity (j - kBj is 4 cj)
  constexpr int kB1 = (kBj + 1) % kQ;      // column j + 1's place in its tile
  constexpr int kA2 = (kBj + 2) % kQ;      // entry (j + 2, j + 2)'s place
  const int c1 = kBj == kQ - 1 ? cj + 1 : cj;   // column j + 1's tile column
  const int c2 = kBj >= kQ - 2 ? cj + 1 : cj;   // entry (j + 2, j + 2)'s
  const Column<T>& cv = col[kCur];

  bool look = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) look |= tc[s] == c1;
  if (look) {
    const T c = cv[kB1][c1];                      // entry j + 1
    const T p = sub_rn(pv[j + 1], mul_rn(c, c));  // pivot j + 1, updated
    const T d = sqrt_rn(p);
    const T r = rcp_of(d);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tc[s] != c1) continue;
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
        const int i = kQ * tr[s] + a;
        const T v = sub_rn(acc[s][a][kB1], mul_rn(cv[a][tr[s]], c));
        const bool own = i > j && i < n;
        // every row divides (the others 1 by d): no division in a branch
        const T q = div_rn(own ? v : T(1), d, r);
        acc[s][a][kB1] = own ? q : v;
        if (own) col[kCur ^ 1][a][tr[s]] = q;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (tc[s] < c1) continue;       // no column right of j
    const bool full = tc[s] > cj;   // else only the columns right of j
    const bool done = tc[s] == c1;  // column kB1 is the lookahead's
    T ci[kQ], ck[kQ];
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
      ci[a] = cv[a][tr[s]];
      ck[a] = cv[a][tc[s]];
    }
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
#pragma unroll
      for (int b = 0; b < kQ; ++b) {
        if ((full || b > kBj) && !(done && b == kB1)) {
          acc[s][a][b] = sub_rn(acc[s][a][b], mul_rn(ci[a], ck[b]));
        }
      }
    }
    if (tr[s] == c2 && tc[s] == c2 && j + 2 < n) pv[j + 2] = acc[s][kA2][kA2];
  }
  __syncthreads();
}

template <typename T, int kThreads, int kSlots, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chol_batched_kernel(const T* __restrict__ H, T* __restrict__ L, int n) {
  __shared__ Column<T> col[2];      // column j, by parity
  __shared__ T pv[kMaxN];           // pivot j + 1, published at step j - 1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* low = reinterpret_cast<T*>(smem_raw);  // H's, then L's lower triangle
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  H += base;
  L += base;
  const int nt = (n + kQ - 1) / kQ;

  // this thread's tiles (tr, tc): number tid + s kThreads of the order
  // tc = nt - 1 ... 0, tr = tc ... nt - 1; tc = -1 for none
  int tr[kSlots], tc[kSlots];
  {
    int c = nt - 1, first = 0;  // tile (c, c)'s number
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int m = tid + s * kThreads;
      while (c >= 0 && m >= first + nt - c) {
        first += nt - c;
        --c;
      }
      tc[s] = c;
      tr[s] = c < 0 ? -1 : c + m - first;
    }
  }

  // H's lower triangle into the packed buffer (row i at i (i + 1) / 2),
  // every row coalesced and asynchronous, then each thread takes its tiles
  for (int i = 0; i < n; ++i) {
    for (int k = tid; k <= i; k += kThreads) {
      __pipeline_memcpy_async(&low[i * (i + 1) / 2 + k],
                              H + static_cast<size_t>(i) * n + k, sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  T acc[kSlots][kQ][kQ];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
      const int i = kQ * tr[s] + a;
#pragma unroll
      for (int b = 0; b < kQ; ++b) {
        const int k = kQ * tc[s] + b;
        acc[s][a][b] = tc[s] >= 0 && i < n && k <= i ? low[i * (i + 1) / 2 + k]
                                                     : T(0);
      }
    }
  }
  for (int i = tid; i < n; i += kThreads) pv[i] = low[i * (i + 1) / 2 + i];
  __syncthreads();

  // column 0
  {
    const T d = sqrt_rn(pv[0]);
    const T r = rcp_of(d);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tc[s] != 0) continue;
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
        const int i = kQ * tr[s] + a;
        const bool own = i < n;
        const T q = div_rn(own ? acc[s][a][0] : T(1), d, r);
        if (own) {
          acc[s][a][0] = q;
          col[0][a][tr[s]] = q;
        }
      }
    }
  }
  __syncthreads();

  // steps j = 0 .. n - 2, four to a tile column
  for (int j = 0, cj = 0;; j += kQ, ++cj) {
    if (j > n - 2) break;
    step<0>(acc, tr, tc, col, pv, j, cj, n);
    if (j + 1 > n - 2) break;
    step<1>(acc, tr, tc, col, pv, j + 1, cj, n);
    if (j + 2 > n - 2) break;
    step<2>(acc, tr, tc, col, pv, j + 2, cj, n);
    if (j + 3 > n - 2) break;
    step<3>(acc, tr, tc, col, pv, j + 3, cj, n);
  }

  // L: the tiles into the packed buffer, then every row out whole and
  // coalesced, zeros above the diagonal
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
      const int i = kQ * tr[s] + a;
#pragma unroll
      for (int b = 0; b < kQ; ++b) {
        const int k = kQ * tc[s] + b;
        if (tc[s] >= 0 && i < n && k <= i) low[i * (i + 1) / 2 + k] = acc[s][a][b];
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const T* row = low + i * (i + 1) / 2;
    for (int k = tid; k < n; k += kThreads) {
      L[static_cast<size_t>(i) * n + k] = k <= i ? row[k] : T(0);
    }
  }
}

// The packed lower triangle's bytes at order n.
template <typename T>
constexpr size_t low_bytes(int n) {
  return static_cast<size_t>(n) * (n + 1) / 2 * sizeof(T);
}

// The largest n whose tiles kThreads threads of kSlots tiles hold.
constexpr int max_n(int threads, int slots) {
  int n = 0;
  while (n < kMaxN && tiles_of(n + 1) <= threads * slots) ++n;
  return n;
}

template <typename T, int kThreads, int kSlots, int kMinBlocks>
int launch_k(const T* H, T* L, int batch, int n, cudaStream_t s) {
  // the attribute once per process and device: the largest allocation
  static bool attribute_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(
        chol_batched_kernel<T, kThreads, kSlots, kMinBlocks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(low_bytes<T>(max_n(kThreads, kSlots))));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  chol_batched_kernel<T, kThreads, kSlots, kMinBlocks>
      <<<batch, kThreads, low_bytes<T>(n), s>>>(H, L, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* H, T* L, int batch, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(n);
  if (tiles <= kThreads1 * kSlots1) {
    return launch_k<T, kThreads1, kSlots1, 3>(H, L, batch, n, s);
  }
  if (tiles <= kThreads2 * slots2<T>() && n <= kMaxN) {
    return launch_k<T, kThreads2, slots2<T>(), 1>(H, L, batch, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// H, L: (batch, n, n) row-major on the device; L may not alias H.  Returns
// the CUDA error code of the launch (0 on success); cudaErrorInvalidValue
// when n is above 176 (f64) or 252 (f32), where the register tiles end.
extern "C" int chol_batched_f64(const double* H, double* L, int batch, int n,
                                void* stream) {
  return launch(H, L, batch, n, stream);
}

extern "C" int chol_batched_f32(const float* H, float* L, int batch, int n,
                                void* stream) {
  return launch(H, L, batch, n, stream);
}
