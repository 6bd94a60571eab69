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
// one launch, built so that the chain runs in ONE block with nothing else
// on it:
//   the walker  (ticket 0) runs the diagonal: for K = 0, 1, ... it applies
//               panel K - 1 to tile (K, K) from tile (K, K - 1), which it
//               solved itself and still holds, factors the tile (the column
//               loop, 8 warps, one barrier a column), then solves tile
//               (K + 1, K).  Both tiles come to it with every other update
//               applied; the next diagonal tile is copied in (cp.async)
//               during the solve when it is ready.
//   the rest    (tickets 1, 2, ...) apply each tile's updates panel by
//               panel, 32 columns a panel, as the panels are published, and
//               solve the tiles below the sub-diagonal against the published
//               diagonal tile: that work spreads over every SM.
// A step's division is div_rn (div_rn.cuh): IEEE division with the
// divisor's reciprocal taken once (at the factor step for the square root,
// then kept for the solves), done by every lane of the owner warp -- lanes
// whose quotient is not wanted divide 1 -- so that no division sits in a
// divergent branch.  Between the factor and the solve, one thread releases
// the diagonal tile's flag while two others wait for the sub-diagonal tile
// and look at the next diagonal tile's flag, behind one barrier.
// Blocks take tickets from an atomic counter in a dependency order (see the
// kernel), so the lowest unfinished ticket always has its inputs and a
// running block: progress needs no co-residency and no scheduling order.
// A finished tile publishes a flag (release at device scope; a reader
// acquires it, then reads L from L2 with __ldcg or cp.async.cg).  The
// entry point zeroes the ticket and the flags in the wrapper's scratch
// buffer (cudaMemsetAsync on the call's stream) before every launch, so no
// call reads another's flags, and both are plain stream operations, which
// a CUDA graph captures.  One tile (n <= 32) is the walker alone: no
// scratch.  At n = 50 and 128 the tiles also beat one-block designs that
// keep the whole matrix in one block's shared memory or registers (one or
// two barriers a column), and the walker's column loop beat one that
// factors and solves a tile on one warp with the rows in registers (no
// barrier, but unrolled code too large for the instruction cache; PERF.md).

// Agreement with the plain version.  Every entry (i, c) of L sees the plain
// column loop's rounded operations in its order (ops/chol.py): acc -=
// L[i][t] * L[c][t] for t = 0, 1, ..., c - 1, then L[i][c] = acc /
// sqrt(pivot c).  The tiles change only which block applies which t,
// mul_rn / sub_rn (chol_column.cuh) are never contracted into an FMA and
// div_rn is x / p bit for bit, so the kernel agrees with the plain version
// bit for bit in either type.
//
// A non-positive pivot gives NaN from sqrt (or 0/0), and the NaN flows on:
// no early exit and no error, every tile still publishes its flag, and the
// caller sees a non-finite factor.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "chol_column.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kT = 32;                     // tile width
constexpr int kTileThreads = 256;          // 8 warps a tile
constexpr int kWarps = kTileThreads / 32;
constexpr int kRows = kT / kWarps;         // tile rows a thread updates
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <typename T>
using Tile = T[kT][kT + 1];  // a 32 x 32 tile in shared memory (+1: banks)

// The scratch buffer, in ints: [0] the ticket counter, then one flag a
// tile (nt x nt, nt = ceil(n / 32)), then from an even offset the n square
// roots of the pivots (of type T).  The flags and the ticket are zeroed for
// every call; the square roots are written before they are read.
__host__ __device__ constexpr int tiles_of(int n) { return (n + kT - 1) / kT; }
__host__ __device__ constexpr int roots_offset(int nt) {
  return (1 + nt * nt + 1) & ~1;
}

// A[a][b] -= Si[a][t] Sb[b][t] for t = 0 .. 31 in order: the thread's
// kRows entries (rows ty + 8 m, column tx) as independent chains.
template <typename T>
__device__ __forceinline__ void update_tile(Tile<T>& A, const Tile<T>& Si,
                                            const Tile<T>& Sb) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  T acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = A[ty + m * kWarps][tx];
#pragma unroll 8
  for (int t = 0; t < kT; ++t) {
    const T b = Sb[tx][t];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      acc[m] = sub_rn(acc[m], mul_rn(Si[ty + m * kWarps][t], b));
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) A[ty + m * kWarps][tx] = acc[m];
}

// The diagonal tile's column loop (factor) and an off-diagonal tile's row
// solve against a factored diagonal tile D (solve) share one schedule:
// warp w owns the columns c = w mod 8 of X, lane l row l.  v[0] is always
// the warp's next column: a finished column goes back to X and the row
// shifts, so every register index is fixed.  Step t: the owner of column t
// scales it (factor: by the square root of its pivot, kept in pv with its
// reciprocal in pr; solve: by pv[t]) and shares it through cs[t & 1]; one
// barrier; every warp applies it to its columns c > t (factor: L[l][t]
// L[c][t], rows l >= c; solve: X[l][t] D[c][t]).  `rows`: X's rows inside
// the matrix (a zero numerator would send a division down its slow path).
template <bool kFactor, typename T>
__device__ __forceinline__ void column_steps(Tile<T>& X, const Tile<T>& D,
                                             T (&pv)[kT], T (&pr)[kT],
                                             T (&cs)[2][kT], int nb,
                                             int rows) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  T v[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) v[q] = X[tx][ty + q * kWarps];
  __syncthreads();  // X is read before any column goes back to it
  int done = 0;     // this warp's finished columns
  for (int t = 0; t < nb; ++t) {
    T p = T(1), r = T(1);  // the divisor and its reciprocal (div_rn.cuh)
    if (!kFactor) {  // early: off the owner's chain
      p = pv[t];
      r = pr[t];
    }
    if (ty == (t & (kWarps - 1))) {
      T x = v[0];
      bool own = tx < rows;  // whether this lane's quotient is wanted
      if (kFactor) {
        p = sqrt_rn(__shfl_sync(kFull, x, t));
        r = rcp_of(p);
        if (tx == t) {
          pv[t] = p;
          pr[t] = r;
        }
        own = own && tx >= t;
      }
      // every lane divides, the others 1 by p: no division in a branch
      const T quotient = div_rn(own ? x : T(1), p, r);
      if (own) x = quotient;
      cs[t & 1][tx] = x;
      X[tx][t] = x;
#pragma unroll
      for (int q = 0; q + 1 < kRows; ++q) v[q] = v[q + 1];
      ++done;
    }
    __syncthreads();
    const T xl = cs[t & 1][tx];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int c = ty + (done + q) * kWarps;
      if (c < kT && c > t && (!kFactor || tx >= c)) {
        v[q] = sub_rn(v[q], mul_rn(xl, kFactor ? cs[t & 1][c] : D[c][t]));
      }
    }
  }
  __syncthreads();  // every column is back in X
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Set a flag, a release at device scope: it orders the stores that came
// before it, the block's own after a barrier, for a reader that acquires it.
__device__ __forceinline__ void release(int* flag) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(1)
               : "memory");
}

// Every thread's stores first (the barrier), then the flag.
__device__ __forceinline__ void publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) release(flag);
}

// Thread 0 waits for the flag, then the block goes on together.
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (threadIdx.x == 0) {
    while (load_acquire(flag) == 0) {
    }
  }
  __syncthreads();
}

// Tile (I, P) of L, published by another block, into S (through L2);
// zeros outside the matrix.
template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& S, const T* L, int n,
                                          int I, int P) {
  const int tx = threadIdx.x & 31;
  const int c = P * kT + tx;
  for (int a = threadIdx.x >> 5; a < kT; a += kWarps) {
    const int i = I * kT + a;
    S[a][tx] = i < n && c < n ? __ldcg(L + static_cast<size_t>(i) * n + c)
                              : T(0);
  }
}

// The same, as asynchronous copies (cp.async) that land while the block
// goes on: __pipeline_wait_prior(0) and a barrier before S is read.
template <typename T>
__device__ __forceinline__ void load_tile_async(Tile<T>& S, const T* L, int n,
                                                int I, int P) {
  const int tx = threadIdx.x & 31;
  const int c = P * kT + tx;
  for (int a = threadIdx.x >> 5; a < kT; a += kWarps) {
    const int i = I * kT + a;
    if (i < n && c < n) {
      __pipeline_memcpy_async(&S[a][tx], L + static_cast<size_t>(i) * n + c,
                              sizeof(T));
    } else {
      S[a][tx] = T(0);
    }
  }
  __pipeline_commit();
}

// S into tile (I, C) of L (a diagonal tile: zeros above its diagonal).
template <typename T>
__device__ __forceinline__ void store_tile(const Tile<T>& S, T* L, int n,
                                           int I, int C) {
  const int tx = threadIdx.x & 31;
  for (int a = threadIdx.x >> 5; a < kT; a += kWarps) {
    const int i = I * kT + a, c = C * kT + tx;
    if (i < n && c < n) {
      L[static_cast<size_t>(i) * n + c] = I == C && tx > a ? T(0) : S[a][tx];
    }
  }
}

// Zeros into tile (C, I) of L, the mirror of a lower tile (I, C), I > C.
template <typename T>
__device__ __forceinline__ void zero_mirror(T* L, int n, int I, int C) {
  const int tx = threadIdx.x & 31;
  for (int a = threadIdx.x >> 5; a < kT; a += kWarps) {
    if (I * kT + tx < n) L[static_cast<size_t>(C * kT + a) * n + I * kT + tx] = T(0);
  }
}

// Load tile (I, C) of H's lower triangle into S (zeros above it).
template <typename T>
__device__ __forceinline__ void load_h(Tile<T>& S, const T* H, int n, int I,
                                       int C) {
  const int tx = threadIdx.x & 31;
  for (int a = threadIdx.x >> 5; a < kT; a += kWarps) {
    const int i = I * kT + a, c = C * kT + tx;
    S[a][tx] = i < n && c <= i ? H[static_cast<size_t>(i) * n + c] : T(0);
  }
}

// Apply panels P = 0 .. p1 - 1 to tile (I, C) in A, each once tiles
// (I, P) and (C, P) are published: A[a][b] -= L[i][t] L[c][t].
template <typename T>
__device__ __forceinline__ void update_panels(Tile<T>& A, Tile<T>& Si,
                                              Tile<T>& Sc, const T* L,
                                              const int* flags, int n, int nt,
                                              int I, int C, int p1) {
  for (int P = 0; P < p1; ++P) {
    wait_flag(flags + I * nt + P);
    if (I != C) wait_flag(flags + C * nt + P);
    load_tile(Si, L, n, I, P);
    if (I != C) {
      load_tile(Sc, L, n, C, P);
      __syncthreads();
      update_tile(A, Si, Sc);
    } else {
      __syncthreads();
      update_tile(A, Si, Si);
    }
    __syncthreads();
  }
}

// Jobs.  Ticket 0 is the walker, the one block that runs the critical path
// along the diagonal: for K = 0, 1, ..., it takes tile (K, K) with every
// update but panel K - 1's already applied, applies that one from tile
// (K, K - 1), which it solved itself and still holds, factors the tile,
// then solves tile (K + 1, K), also handed over with every update but its
// last applied, so no flag round trip and no reload lies between two
// diagonal tiles.  Tickets 1, 2, ... are the rest, in this order for
// C = 0, 1, ...: the tiles (I, C), I >= C + 2, which apply their updates,
// wait for diagonal tile C and solve themselves; then tile (C + 2, C + 1)
// with panels 0 .. C applied (for the walker's solve at K = C + 1, flag at
// the upper position (C + 1, C + 2)); then tile (C + 2, C + 2) likewise
// (for its factor at K = C + 2, flag at (C, C + 2)).  Each job waits only
// for jobs earlier in this order or for walker steps whose own inputs come
// earlier still, so the lowest unfinished ticket can always run: progress
// needs no co-residency and no scheduling order.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
chol_single_tiles_kernel(const T* __restrict__ H, T* __restrict__ L,
                         int* __restrict__ scratch, int n) {
  // a job's tiles: A, the tile being computed; Si, L tile (I, P); Sc, L
  // tile (C, P) or the diagonal tile (C, C).  The walker's: diagonal tiles
  // and sub-diagonal tiles, each by step parity.
  __shared__ Tile<T> tiles[4];
  Tile<T>& A = tiles[0];
  Tile<T>& Si = tiles[1];
  Tile<T>& Sc = tiles[2];
  __shared__ T pv[kT];    // the diagonal tile's square roots
  __shared__ T pr[kT];    // and their reciprocals (div_rn.cuh)
  __shared__ T cs[2][kT]; // the column just scaled, by step parity
  __shared__ int ticket;
  const int nt = tiles_of(n);
  int* flags = scratch + 1;     // scratch[0]: the ticket counter
  T* piv = reinterpret_cast<T*>(scratch + roots_offset(nt));
  const int tid = threadIdx.x;

  if (tid == 0) ticket = scratch ? atomicAdd(scratch, 1) : 0;
  __syncthreads();
  if (ticket == 0) {  // the walker
    // a tile's inputs are copied in while the block works on the one
    // before, when the job that prepares them has already published
    __shared__ int seen;
    bool have_a = false;   // A[K & 1] already holds tile (K, K)
    for (int K = 0; K < nt; ++K) {
      const int c0 = K * kT;
      Tile<T>& D = tiles[K & 1];         // tile (K, K)
      Tile<T>& Sp = tiles[2 + (K & 1)];  // tile (K + 1, K)
      Tile<T>& Sq = tiles[3 - (K & 1)];  // tile (K, K - 1), solved last step
      if (K < 2) {
        load_h(D, H, n, K, K);
      } else if (!have_a) {
        wait_flag(flags + (K - 2) * nt + K);
        load_tile(D, L, n, K, K);
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      if (K > 0) update_tile(D, Sq, Sq);  // panel K - 1
      __syncthreads();
      const int nb = min(kT, n - c0);
      column_steps<true>(D, D, pv, pr, cs, nb, nb);
      store_tile(D, L, n, K, K);
      if (K + 1 == nt) break;  // (one tile: no scratch, nothing to publish)
      if (tid < nb) piv[c0 + tid] = pv[tid];
      // One barrier, then three threads of three warps at once: the
      // release of tile (K, K), the wait for tile (K + 1, K) and a look at
      // tile (K + 1, K + 1)'s flag; one more barrier, and the copies.
      __syncthreads();
      if (tid == 2 * kT) release(flags + K * nt + K);
      if (K > 0 && tid == 0) {
        while (load_acquire(flags + K * nt + K + 1) == 0) {
        }
      }
      if (tid == kT) {
        seen = K > 0 ? load_acquire(flags + (K - 1) * nt + K + 1) : 0;
      }
      __syncthreads();
      if (K == 0) {
        load_h(Sp, H, n, 1, 0);
      } else {
        load_tile(Sp, L, n, K + 1, K);
      }
      have_a = seen != 0;
      if (have_a) load_tile_async(tiles[(K + 1) & 1], L, n, K + 1, K + 1);
      __syncthreads();
      column_steps<false>(Sp, D, pv, pr, cs, kT, n - c0 - kT);
      store_tile(Sp, L, n, K + 1, K);
      zero_mirror(L, n, K + 1, K);
      publish(flags + (K + 1) * nt + K);
    }
    return;
  }
  for (;;) {
    int k = ticket - 1;  // job k -> its kind and tile
    int I = -1, C = 0, kind = 0;  // 0: full, 1: sub-diagonal, 2: diagonal
    for (; C < nt; ++C) {
      const int full = max(0, nt - C - 2);
      if (k < full) {
        I = C + 2 + k;
        break;
      }
      k -= full;
      if (C + 2 < nt) {
        if (k < 2) {
          I = C + 2;
          kind = 1 + k;
          break;
        }
        k -= 2;
      }
    }
    if (I < 0) break;  // every job is taken
    if (kind == 1) {          // tile (C + 2, C + 1), panels 0 .. C
      load_h(A, H, n, I, C + 1);
      __syncthreads();
      update_panels(A, Si, Sc, L, flags, n, nt, I, C + 1, C + 1);
      store_tile(A, L, n, I, C + 1);
      publish(flags + (C + 1) * nt + I);
    } else if (kind == 2) {   // tile (C + 2, C + 2), panels 0 .. C
      load_h(A, H, n, I, I);
      __syncthreads();
      update_panels(A, Si, Sc, L, flags, n, nt, I, I, C + 1);
      store_tile(A, L, n, I, I);
      publish(flags + C * nt + I);
    } else {                  // tile (I, C), I >= C + 2: all of it
      const int r0 = I * kT, c0 = C * kT;
      load_h(A, H, n, I, C);
      zero_mirror(L, n, I, C);
      __syncthreads();
      update_panels(A, Si, Sc, L, flags, n, nt, I, C, C);
      __syncthreads();
      wait_flag(flags + C * nt + C);
      load_tile(Sc, L, n, C, C);
      if (tid < kT) {
        const T root = __ldcg(piv + c0 + tid);
        pv[tid] = root;
        pr[tid] = rcp_of(root);
      }
      __syncthreads();
      column_steps<false>(A, Sc, pv, pr, cs, kT, n - r0);
      store_tile(A, L, n, I, C);
      publish(flags + I * nt + C);
    }
    __syncthreads();  // all have read the ticket before thread 0 takes one
    if (tid == 0) ticket = atomicAdd(scratch, 1);
    __syncthreads();
  }
}

template <typename T>
int launch(const T* H, T* L, int* scratch, int n, void* stream) {
  // the dataflow's grid, once per process and device: the blocks that fit
  // the card at once (more would only wait for a ticket)
  static int grid[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_single_tiles_kernel<T>, kTileThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int nt = tiles_of(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt > 1) {  // the ticket and the flags start at zero in every call
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(scratch, 0, roots_offset(nt) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = nt * (nt + 1) / 2;  // more blocks than jobs: none
  chol_single_tiles_kernel<T><<<tiles < grid[dev] ? tiles : grid[dev],
                                kTileThreads, 0, s>>>(H, L, scratch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ints of scratch memory chol_single_f64 / _f32 take at order n (8-byte
// aligned device memory; its contents need not be set): 0 for n <= 32,
// where the kernel takes none.
extern "C" int chol_single_scratch_ints(int n) {
  const int nt = tiles_of(n);
  return nt > 1 ? roots_offset(nt) + 2 * n : 0;
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
