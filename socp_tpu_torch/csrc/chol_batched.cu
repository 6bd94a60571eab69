// chol_batched.cu -- batched lower Cholesky factor in f64 or f32, any order,
// in one launch: several instances a warp up to n = 32, one instance per
// thread block with the trailing matrix in registers up to n = 108, and
// above the register tiles the 32 x 32 tile dataflow of csrc/chol_tiles.cuh
// over the whole batch.
//
// chol_batched_f64 replaces socp_tpu/ops/pallas_chol.py:_dd_chol_batch_kernel
// (entry point cholesky_dd_batched): the instance-tiled, right-looking dd32
// Cholesky of the TPU's batched lockstep path, which takes any order in one
// pallas_call.  The H100 has native FP64, so it computes the same
// function -- the lower factor L of H = L L', zeros above the diagonal --
// in f64 instead of double-word f32, and drops the TPU's masked lane
// reductions.  chol_batched_f32 replaces pallas_chol.py:_f32_chol_kernel
// (entry point cholesky_f32, a one-instance f32 kernel that jax.vmap
// batches): the same factor in f32, the factor of the solver's
// mixed-precision mode (factor_dtype="float32") on the batched path.
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
// n = 102, 158 registers a thread).  Three schedules, chosen by n in
// launch(): up to n = 32 the small-order one below; 128 threads with 3
// tiles each up to n = 108 (config 3's n = 102); above, the tile dataflow,
// which beat 256 threads of 4 (f64) or 8 (f32) register tiles at every
// shape measured from n = 109 (B = 64 to 4096, both dtypes; PERF.md).
//
// The small-order schedule (n <= 32: config 4's blocks at n = 10, config
// 5's H at n = 21 and its 1 x 1 Schur complement).  At such n the tiled
// block leaves most of its 128 threads idle (6 of them work at n = 10) and
// ends every step in a block barrier.  Here a warp holds 32 / W instances,
// W lanes each (W the power of two at or above n), and a block holds
// kSmallWarps independent warps: no block barrier, only __syncwarp and
// __shfl_sync.  Lane i of an instance holds row i of its lower triangle in
// registers, kR entries (kR >= n a compile-time bucket, so every register
// index is a constant: the step loop is unrolled and breaks at n).  The
// warp's instances are contiguous in memory, so their lower triangles come
// in by flat, coalesced cp.async copies into a packed buffer (row i at
// i (i + 1) / 2: a lane reading its own row touches its own banks), and L
// goes out the same way, every row whole, zeros above the diagonal.  Step
// j: the pivot is lane j's entry (j, j), broadcast by __shfl_sync within
// the instance; every lane takes its square root d and its reciprocal and
// divides its entry (i, j) by d with div_rn (the lanes that own no entry
// divide 1, so no division sits in a divergent branch); the column goes
// to a per-warp double-buffered row in shared memory, one __syncwarp, and
// each lane applies it to its entries k > j.  At config 5's (65,536, 21)
// in f64 the copies alone take about half the kernel's time and the chain
// (square root, reciprocal, division) about a third; a persistent grid
// that copies a warp's next instances in while it factors these was
// slower: the warps of an SM already overlap one's copies with another's
// steps (PERF.md, kernel_variants.py).
//
// The tile dataflow (n above the register tiles: config 2's width, n = 500,
// in a batch).  A block an instance leaves the card idle at B = 64 and runs
// one chain of n steps, each a block barrier; the register tiles end where
// a thread's registers do.  Here every instance gets a walker, one
// block that runs its chain of 32 x 32 diagonal tiles (a factor and a
// solve, a barrier a column), and its off-diagonal tiles are jobs that any
// block takes: tickets from one global counter, dealt ticket-major over a
// group of instances, so the group's walkers start together on as many SMs
// and the jobs spread over the rest (chol_tiles.cuh, where the progress
// argument is).  Each instance's flags and pivot roots live in a scratch
// buffer the wrapper allocates (chol_batched_scratch_ints) and the entry
// point zeroes on the stream before the kernel.  The tiles are
// chol_single's, shared through chol_tiles.cuh, so a batch factors bit for
// bit as B calls of chol_single.  What bounds it: at (64, 500) in f64 its
// 192 MB (H's lower triangle in, L out) take 0.057 ms at 3.35 TB/s and its
// 2.7 GFLOP 0.04 ms at 67 TFLOP/s; the walkers' chains (about 0.25 ms
// each, chol_single's time at n = 500) run side by side, so the chain and
// the tile updates' shared-memory traffic set the time (PERF.md).
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
#include "chol_tiles.cuh"
#include "div_rn.cuh"
#include "packed_copy.cuh"

namespace {

constexpr int kQ = 4;         // micro-tile edge
constexpr int kMaxDevices = 64;

// The register tiles: 3 x 128 of them, which hold n <= kMaxN (the
// small-order schedule, n <= kSmallMaxN, is chol_small_kernel below); the
// tile dataflow takes every larger n.
constexpr int kTileThreads = 128, kTileSlots = 3;
constexpr int kMaxN = 108;    // the published column and pivots' length
constexpr int kDataflowFrom = kMaxN + 1;

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

// The largest n (at most kMaxN) whose tiles kThreads threads of kSlots
// tiles hold.
constexpr int max_n(int threads, int slots) {
  int n = 0;
  while (n < kMaxN && tiles_of(n + 1) <= threads * slots) ++n;
  return n;
}
static_assert(max_n(kTileThreads, kTileSlots) == kMaxN,
              "the register tiles hold up to kMaxN");

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

// ---- the small-order schedule: n <= kSmallMaxN, a warp an instance or
// 32 / W instances a warp

constexpr int kSmallMaxN = 32;
constexpr int kSmallWarps = 4;       // independent warps a block
constexpr unsigned kFull = 0xffffffffu;

// The lanes an instance takes at order n: the power of two at or above n.
__host__ __device__ constexpr int small_lanes(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

template <typename T, int kW, int kR>
__global__ void __launch_bounds__(kSmallWarps * 32)
chol_small_kernel(const T* __restrict__ H, T* __restrict__ L, int batch, int n,
                  unsigned long long magic) {
  constexpr int kG = 32 / kW;                 // instances a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kSmallWarps + w) * kG;
  if (first >= batch) return;                 // a whole warp
  const int count = static_cast<int>(min(static_cast<long long>(kG), batch - first));
  const int tri = n * (n + 1) / 2;
  // the warp's packed lower triangles, then its two column buffers
  T* low = reinterpret_cast<T*>(smem_raw) + w * (kG * tri + 64);
  T* colv = low + kG * tri;
  H += static_cast<size_t>(first) * n * n;
  L += static_cast<size_t>(first) * n * n;

  copy_lower(low, H, count, n, magic, lane);   // packed_copy.cuh
  __pipeline_wait_prior(0);
  __syncwarp();                               // (every lane's copies)

  const int g = lane / kW, i = lane % kW;     // instance, row
  const bool live = g < count && i < n;
  T* row = low + g * tri + i * (i + 1) / 2;
  // an instance past the batch's end holds the identity and publishes
  // zero columns: its pivots stay 1, so it divides nothing by zero
  T acc[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    acc[k] = live && k <= i ? row[k] : k == i ? T(1) : T(0);
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j >= n) break;
    const T p = __shfl_sync(kFull, acc[j], j, kW);  // pivot j, updated
    const T d = sqrt_rn(p), r = rcp_of(d);
    // every lane divides (the others 1 by d): no division in a branch
    const T q = div_rn(live && i >= j ? acc[j] : T(1), d, r);
    acc[j] = q;
    T* cv = colv + (j & 1) * 32;              // column j, by parity
    cv[lane] = g < count ? q : T(0);
    __syncwarp();
    const T* mine = cv + g * kW;
#pragma unroll
    for (int k = j + 1; k < kR; ++k) {
      if (k >= n) break;
      acc[k] = sub_rn(acc[k], mul_rn(q, mine[k]));
    }
  }

  // L: the rows into the packed buffer, then out whole, zeros above the
  // diagonal
  if (live) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (k <= i) row[k] = acc[k];
    }
  }
  __syncwarp();
  for (int idx = lane; idx < count * n * n; idx += 32) {
    int gi, r, c;
    split_flat(idx, n, magic, gi, r, c);
    L[idx] = c <= r ? low[gi * tri + r * (r + 1) / 2 + c] : T(0);
  }
}

template <typename T, int kW, int kR>
int launch_small_k(const T* H, T* L, int batch, int n, cudaStream_t s) {
  constexpr int kG = 32 / kW;
  const long long warps = (static_cast<long long>(batch) + kG - 1) / kG;
  const long long blocks = (warps + kSmallWarps - 1) / kSmallWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      static_cast<size_t>(kSmallWarps) * (kG * n * (n + 1) / 2 + 64) * sizeof(T);
  chol_small_kernel<T, kW, kR>
      <<<static_cast<unsigned>(blocks), kSmallWarps * 32, bytes, s>>>(
          H, L, batch, n, magic_of(n));
  return static_cast<int>(cudaGetLastError());
}

// The register row's length: the lanes an instance takes, but 24 for
// 17 <= n <= 24 (fewer registers at config 5's n = 21).
template <typename T>
int launch_small(const T* H, T* L, int batch, int n, cudaStream_t s) {
  if (batch <= 0 || n <= 0) return 0;         // nothing to factor
  switch (small_lanes(n)) {
    case 1: return launch_small_k<T, 1, 1>(H, L, batch, n, s);
    case 2: return launch_small_k<T, 2, 2>(H, L, batch, n, s);
    case 4: return launch_small_k<T, 4, 4>(H, L, batch, n, s);
    case 8: return launch_small_k<T, 8, 8>(H, L, batch, n, s);
    case 16: return launch_small_k<T, 16, 16>(H, L, batch, n, s);
    default:
      return n <= 24 ? launch_small_k<T, 32, 24>(H, L, batch, n, s)
                     : launch_small_k<T, 32, 32>(H, L, batch, n, s);
  }
}

// ---- the tile dataflow: n >= kDataflowFrom, the whole batch in one launch
// (chol_tiles.cuh)

template <typename T>
__global__ void __launch_bounds__(chol_tiles::kThreads)
chol_batched_tiles_kernel(const T* __restrict__ H, T* __restrict__ L,
                          int* __restrict__ scratch, int batch, int n,
                          int group) {
  chol_tiles::run(H, L, scratch, batch, n, group);
}

template <typename T>
int launch(const T* H, T* L, int* scratch, int batch, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmallMaxN) return launch_small(H, L, batch, n, s);
  if (n >= kDataflowFrom) {
    static int grid[chol_tiles::kMaxDevices] = {};   // per process and device
    return chol_tiles::launch(chol_batched_tiles_kernel<T>, grid, H, L,
                              scratch, batch, n, s);
  }
  return launch_k<T, kTileThreads, kTileSlots, 3>(H, L, batch, n, s);
}

}  // namespace

// The ints of scratch memory chol_batched_f64 / _f32 take for a batch at
// order n (8-byte aligned device memory; its contents need not be set): 0
// below the tile dataflow, which alone takes scratch; -1 if the batch is
// too large for the dataflow's int counters.
extern "C" int chol_batched_scratch_ints(int batch, int n) {
  return n >= kDataflowFrom ? chol_tiles::scratch_ints(batch, n) : 0;
}

// H, L: (batch, n, n) row-major on the device; L may not alias H.  scratch:
// chol_batched_scratch_ints(batch, n) ints of device memory (null when
// that is 0), which the call zeroes in part on the stream before its
// kernel.  Returns the CUDA error code of the launch (0 on success).
extern "C" int chol_batched_f64(const double* H, double* L, int* scratch,
                                int batch, int n, void* stream) {
  return launch(H, L, scratch, batch, n, stream);
}

extern "C" int chol_batched_f32(const float* H, float* L, int* scratch,
                                int batch, int n, void* stream) {
  return launch(H, L, scratch, batch, n, stream);
}

// The schedule launch() takes at order n (both dtypes): the instances a
// warp holds in the small-order schedule (1 ... 32), or -1 for the
// register tiles (128 threads with 3 tiles each), -2 for the tile
// dataflow.
extern "C" int chol_batched_schedule(int n) {
  if (n <= kSmallMaxN) return 32 / small_lanes(n);
  return n >= kDataflowFrom ? -2 : -1;
}
