// chol_tiles.cuh -- the 32 x 32 tile dataflow of a lower Cholesky factor,
// for one (n, n) matrix or a batch of them, in one launch: the schedule of
// csrc/chol_single.cu (a batch of one) and of csrc/chol_batched.cu above
// the orders its register tiles hold.  Each source wraps run() below in a
// kernel of its own name, so a profile tells the two apart.
//
// One instance.  A dataflow over 32 x 32 lower tiles, built so that the
// chain of square roots and divisions runs in ONE block with nothing else
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
// and look at the next diagonal tile's flag, behind one barrier.  A
// finished tile publishes a flag (release at device scope; a reader
// acquires it, then reads L from L2 with __ldcg or cp.async.cg).
//
// A batch.  Every instance has its walker and its jobs, its own flags and
// its own pivot roots in the scratch buffer.  Blocks take tickets from one
// global counter, dealt ticket-major over a group of instances: ticket t
// of every instance of the group comes before ticket t + 1 of any, so the
// group's walkers start at once, side by side on as many SMs, and the
// jobs of all its instances spread over the rest; the next group's
// tickets follow.  A block that finishes a walk or a job takes the next
// ticket, until none is left.
//
// Progress.  Within an instance the tickets come in a dependency order
// (see run()): a job waits only for jobs earlier in it or for walker steps
// whose own inputs come earlier still.  The ticket-major deal keeps that
// order inside each instance.  So if the lowest unfinished ticket that is
// not a walker's has been taken, it can run; and it is taken as soon as a
// block is free, since the blocks that wait without it are walkers of the
// current group (those of earlier groups wait on nothing unfinished).  A
// group holds at most half the blocks the card runs at once (kGroupShare),
// so a block is always left for the jobs: progress needs no scheduling
// order, only that the grid's blocks become resident, which launch()
// sizes the grid to.  For one instance the group is that instance and the
// argument is chol_single's.
//
// Agreement with the plain version (ops/chol.py).  Every entry (i, c) of L
// sees the plain column loop's rounded operations in its order: acc -=
// L[i][t] * L[c][t] for t = 0, 1, ..., c - 1, then L[i][c] = acc /
// sqrt(pivot c).  The tiles change only which block applies which t,
// mul_rn / sub_rn (chol_column.cuh) are never contracted into an FMA and
// div_rn is x / p bit for bit, so the factor agrees with the plain version
// bit for bit in either type, whatever the batch.
//
// A non-positive pivot gives NaN from sqrt (or 0/0), and the NaN flows on:
// no early exit and no error, every tile still publishes its flag, and the
// caller sees a non-finite factor.

#pragma once

#include <climits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "chol_column.cuh"
#include "div_rn.cuh"

namespace chol_tiles {

constexpr int kT = 32;                     // tile width
constexpr int kThreads = 256;              // 8 warps a tile
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kT / kWarps;         // tile rows a thread updates
constexpr int kGroupShare = 2;             // a group: 1 / 2 of the grid
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
using Tile = T[kT][kT + 1];  // a 32 x 32 tile in shared memory (+1: banks)

__host__ __device__ constexpr int tiles_of(int n) { return (n + kT - 1) / kT; }

// Tickets of one instance: its walker, then its jobs (for nt >= 3, the
// nt - C - 2 tiles below the sub-diagonal of each tile column C and the
// two tiles the walker takes next: nt (nt + 1) / 2 - 3 in all).
__host__ __device__ constexpr int tickets_of(int nt) {
  return nt >= 3 ? nt * (nt + 1) / 2 - 2 : 1;
}

// The scratch buffer, in ints: [0] the ticket counter, [1] unused, then
// one flag a tile (nt x nt an instance, instance after instance), then
// from an even offset the n square roots of the pivots of each instance
// (of type T).  The counter and the flags are zeroed for every call; the
// square roots are written before they are read.
__host__ __device__ constexpr long long roots_offset(long long batch, int nt) {
  return (2 + batch * nt * nt + 1) & ~1LL;
}

// The ints launch() takes for a batch at order n (8-byte aligned device
// memory; its contents need not be set): 0 for one tile of one instance,
// the walker alone; -1 if the buffer or the ticket count would not fit an
// int.
inline int scratch_ints(int batch, int n) {
  const int nt = tiles_of(n);
  if (batch <= 0 || n <= 0 || (nt == 1 && batch == 1)) return 0;
  const long long ints = roots_offset(batch, nt) + 2LL * batch * n;
  const long long tickets = static_cast<long long>(batch) * tickets_of(nt);
  return ints < INT_MAX && tickets < INT_MAX ? static_cast<int>(ints) : -1;
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

// The tiles a block works in: a job's A (the tile being computed), Si (L
// tile (I, P)) and Sc (L tile (C, P) or the diagonal tile (C, C)); the
// walker's diagonal and sub-diagonal tiles, each by step parity.
template <typename T>
struct Smem {
  Tile<T> tiles[4];
  T pv[kT];     // the diagonal tile's square roots
  T pr[kT];     // and their reciprocals (div_rn.cuh)
  T cs[2][kT];  // the column just scaled, by step parity
  int seen;     // the walker's look at the next diagonal tile's flag
};

// The walker of one instance: for K = 0, 1, ..., it takes tile (K, K) with
// every update but panel K - 1's already applied, applies that one from
// tile (K, K - 1), which it solved itself and still holds, factors the
// tile, then solves tile (K + 1, K), also handed over with every update
// but its last applied, so no flag round trip and no reload lies between
// two diagonal tiles.  A tile's inputs are copied in while the block works
// on the one before, when the job that prepares them has already
// published.
template <typename T>
__device__ __forceinline__ void walk(Smem<T>& sm, const T* H, T* L,
                                     int* flags, T* piv, int n, int nt) {
  const int tid = threadIdx.x;
  bool have_a = false;   // tiles[K & 1] already holds tile (K, K)
  for (int K = 0; K < nt; ++K) {
    const int c0 = K * kT;
    Tile<T>& D = sm.tiles[K & 1];         // tile (K, K)
    Tile<T>& Sp = sm.tiles[2 + (K & 1)];  // tile (K + 1, K)
    Tile<T>& Sq = sm.tiles[3 - (K & 1)];  // tile (K, K - 1), solved last step
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
    column_steps<true>(D, D, sm.pv, sm.pr, sm.cs, nb, nb);
    store_tile(D, L, n, K, K);
    if (K + 1 == nt) break;  // (one tile: nothing to publish)
    if (tid < nb) piv[c0 + tid] = sm.pv[tid];
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
      sm.seen = K > 0 ? load_acquire(flags + (K - 1) * nt + K + 1) : 0;
    }
    __syncthreads();
    if (K == 0) {
      load_h(Sp, H, n, 1, 0);
    } else {
      load_tile(Sp, L, n, K + 1, K);
    }
    have_a = sm.seen != 0;
    if (have_a) load_tile_async(sm.tiles[(K + 1) & 1], L, n, K + 1, K + 1);
    __syncthreads();
    column_steps<false>(Sp, D, sm.pv, sm.pr, sm.cs, kT, n - c0 - kT);
    store_tile(Sp, L, n, K + 1, K);
    zero_mirror(L, n, K + 1, K);
    publish(flags + (K + 1) * nt + K);
  }
}

// Job k (k = 0, 1, ...) of one instance, in this order for C = 0, 1, ...:
// the tiles (I, C), I >= C + 2, which apply their updates, wait for
// diagonal tile C and solve themselves; then tile (C + 2, C + 1) with
// panels 0 .. C applied (for the walker's solve at K = C + 1, flag at the
// upper position (C + 1, C + 2)); then tile (C + 2, C + 2) likewise (for
// its factor at K = C + 2, flag at (C, C + 2)).  Each job waits only for
// jobs earlier in this order or for walker steps whose own inputs come
// earlier still.
template <typename T>
__device__ __forceinline__ void job(Smem<T>& sm, const T* H, T* L, int* flags,
                                   const T* piv, int n, int nt, int k) {
  Tile<T>& A = sm.tiles[0];
  Tile<T>& Si = sm.tiles[1];
  Tile<T>& Sc = sm.tiles[2];
  const int tid = threadIdx.x;
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
      sm.pv[tid] = root;
      sm.pr[tid] = rcp_of(root);
    }
    __syncthreads();
    column_steps<false>(A, Sc, sm.pv, sm.pr, sm.cs, kT, n - r0);
    store_tile(A, L, n, I, C);
    publish(flags + I * nt + C);
  }
}

// The block's loop: take a ticket, map it to (instance, its ticket), walk
// or do the job, take the next, until the batch's tickets are gone.
// H, L: (batch, n, n); group: the instances a deal spans (launch()).
template <typename T>
__device__ __forceinline__ void run(const T* __restrict__ H, T* __restrict__ L,
                                    int* __restrict__ scratch, int batch, int n,
                                    int group) {
  __shared__ Smem<T> sm;
  __shared__ int ticket;
  const int nt = tiles_of(n);
  const int per = tickets_of(nt);
  const long long total = static_cast<long long>(batch) * per;
  // (no scratch: one tile of one instance, which publishes nothing)
  T* roots = scratch ? reinterpret_cast<T*>(scratch + roots_offset(batch, nt))
                     : nullptr;
  if (threadIdx.x == 0) ticket = scratch ? atomicAdd(scratch, 1) : 0;
  __syncthreads();
  while (ticket < total) {
    const int g = ticket / (group * per);      // the deal's group
    const int r = ticket - g * group * per;
    const int size = min(group, batch - g * group);
    const int k = r / size;                    // the instance's own ticket
    const int inst = g * group + (r - k * size);
    const size_t at = static_cast<size_t>(inst) * n * n;
    int* flags = scratch ? scratch + 2 + static_cast<size_t>(inst) * nt * nt
                         : nullptr;
    T* piv = roots ? roots + static_cast<size_t>(inst) * n : nullptr;
    if (k == 0) {
      walk(sm, H + at, L + at, flags, piv, n, nt);
    } else {
      job(sm, H + at, L + at, flags, piv, n, nt, k - 1);
    }
    __syncthreads();  // all are done with the tiles and have read the ticket
    if (threadIdx.x == 0) ticket = scratch ? atomicAdd(scratch, 1) : INT_MAX;
    __syncthreads();
  }
}

// Launch `kernel` (a source's wrapper of run<T>) on a batch: the ticket
// counter and the flags zeroed on the stream (cudaMemsetAsync: a stream
// operation, which a CUDA graph captures), then a grid of the blocks that
// fit the card at once (more would only wait for a ticket; fewer when the
// batch has fewer tickets), counted once per process and device in grid[].
template <typename T>
int launch(void (*kernel)(const T*, T*, int*, int, int, int), int (&grid)[kMaxDevices],
           const T* H, T* L, int* scratch, int batch, int n, cudaStream_t s) {
  if (batch <= 0 || n <= 0) return 0;         // nothing to factor
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int nt = tiles_of(n);
  const int ints = scratch_ints(batch, n);
  if (ints < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ints > 0) {  // the ticket and the flags start at zero in every call
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(scratch, 0, roots_offset(batch, nt) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tickets = static_cast<long long>(batch) * tickets_of(nt);
  const int blocks = tickets < grid[dev] ? static_cast<int>(tickets) : grid[dev];
  const int share = grid[dev] / kGroupShare > 0 ? grid[dev] / kGroupShare : 1;
  const int group = batch < share ? batch : share;
  kernel<<<blocks, kThreads, 0, s>>>(H, L, ints > 0 ? scratch : nullptr, batch,
                                     n, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chol_tiles
