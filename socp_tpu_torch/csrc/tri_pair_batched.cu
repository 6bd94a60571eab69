// tri_pair_batched.cu -- batched (L L')^-1 B in f64 or f32, any order, in
// one launch: forward substitution on L, then backward substitution on L'
// read from the same L; one warp per instance and rhs column (up to n =
// 32, one warp per instance or several, all their columns), and above
// kBlockPanelsFrom a block for each instance and up to 4 columns
// (csrc/tri_pair_panels.cuh).
//
// tri_pair_batched_f64 replaces
// socp_tpu/ops/pallas_chol.py:_tri_pair_batch_kernel (entry point
// tri_pair_solve_batched), the instance-tiled dd32 pair solve of the TPU's
// batched lockstep path, which takes any order in one pallas_call; it
// computes the same function in f64.
// tri_pair_batched_f32 replaces pallas_chol.py:_f32_tri_kernel (entry point
// tri_solve_f32, a one-instance f32 kernel that jax.vmap batches): the same
// forward-then-backward pair solve in f32, the back-solve of the solver's
// mixed-precision mode (factor_dtype="float32") on the batched path.  Both
// TPU kernels took L' as a second operand so that both passes read rows
// along the lane axis; here that operand is gone.
//
// What bounds it on this card.  Per instance it must read the lower
// triangle of L and n k of rhs and write n k, and does 2 n^2 k flops: at
// n = 102, k = 1 in f64 that is 43 KB and 21 kFLOP, a half flop a byte, so
// the least time is the bytes' time (0.053 ms for B = 4096).  Each
// instance's own time is a chain of 2 n dependent steps (an IEEE division,
// a broadcast, a multiply-subtract) and about 20 block copies, each waited
// for in turn, so the time is each warp's latency, divided by the warps in
// flight: taking the rows beyond the panels away entirely does not move
// it, taking the divisions away saves about a tenth (PERF.md).
//
// What the design does about it.  A warp carries one instance's chain (one
// rhs column; k columns take k warps), and a block is 4 independent warps:
// no block barrier anywhere, and about 18 KB of shared memory a warp in f64
// (9 KB in f32), so 12 (f64) or 24 (f32) instances are resident on an SM.
// The passes walk 32 x 32 blocks of L's lower triangle, each copied in
// with cp.async, coalesced, kStages - 1 blocks ahead of the one in use (a
// third stage costs more in resident warps than it saves):
//   forward    for panel P (rows 32 P ..), its diagonal block: lane l holds
//              row l's x, and each step's quotient x_j / L_jj is divided on
//              every lane at once (div_rn.cuh, the pivot's reciprocal taken
//              once; lanes other than row j's divide 1) and broadcast by
//              __shfl_sync; then each block below it: lane l takes the
//              panel's 32 quotients, in step order, into row l of the block
//              (read from the block's row l, padded against bank conflicts);
//   backward   the same from the bottom panel up, each block read by its
//              columns (row j of L is column j of L').
// The rhs lives in the warp's shared memory, one entry a row, touched only
// by its own lane (row i by lane i mod 32).  L is read once a pass; the
// second read mostly hits L2.
//
// The small-order schedule (n <= 32: config 4's blocks at n = 10, k = 8
// and 1, config 5's H at n = 21 and its 1 x 1 Schur complement, k = 1),
// chosen by n in launch().  Above, a warp an instance and column reserves
// the panels' shared memory whatever n is (about 17 KB in f64 even at
// n = 1), which holds 12 warps on an SM, and at k = 8 copies L in 8 times.
// Here a warp copies the lower triangles of G instances in once (flat,
// coalesced cp.async into a packed buffer: row i at i (i + 1) / 2, sized by
// n and G) and solves all their k columns: a column takes n lanes, lane
// u n + i on row i of column unit u, U = 32 / n units at once, G = max(1,
// U / k) instances a warp (32 at n = 1, k = 1), the warp's G k units in
// passes of U.  The columns of a pass run their chains side by side in one
// instruction stream.  Each step divides on every lane with its own
// diagonal entry's reciprocal (taken once; lanes not on step j's row divide
// 1), broadcasts row j's quotient within its column by __shfl_sync, and
// applies it with one shared-memory read of L: the forward pass reads L by
// rows, the backward by columns, both free of bank conflicts for a warp of
// one instance (packed_copy.cuh).  At config 5's (65,536, 21, 1) the copy
// of L alone takes about a third of the kernel's time and the divisions a
// quarter; the rest is the chain's 2 n steps, with 11 of 32 lanes idle at
// n = 21 (PERF.md, kernel_variants.py).
//
// Above kBlockPanelsFrom (config 2's width, n = 500, in a batch).  A warp
// an instance runs a chain of 2 n steps and copies in and works through
// n^2 / 1024 blocks of L one after another, and at B = 64 keeps 16 SMs
// busy.  There the design of tri_pair_single (tri_pair_panels.cuh) takes
// over with a batch index: a block for each instance and up to 4 rhs
// columns, its chain warp running each 32-row panel's steps while row
// threads apply the panel to the rows beyond it, one barrier a panel.  So
// a batch solves bit for bit as B calls of tri_pair_single.  PERF.md has
// both schedules' times at (64, 200) and (64, 500).  The only order it
// refuses is one whose rhs column does not fit shared memory
// (tri_pair_single_max_n).
//
// Agreement with the plain version (ops/chol.py).  Every x_i sees the plain
// loops' operations in their order: forward x_i -= L[i][j] * (x_j / L_jj)
// for j = 0, 1, ..., i - 1, then x_i / L_ii; backward x_i -= L[j][i] *
// (x_j / L_jj) for j = n - 1, ..., i + 1, then x_i / L_ii.  mul_rn /
// sub_rn (chol_column.cuh) are never contracted into an FMA and div_rn is
// x / p bit for bit, so the kernel agrees with the plain version bit for bit
// in either type.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "chol_column.cuh"
#include "div_rn.cuh"
#include "packed_copy.cuh"
#include "tri_pair_panels.cuh"

namespace {

constexpr int kP = 32;          // panel and block width: one warp
constexpr int kLd = kP + 1;     // a block row in shared memory, padded
constexpr int kWarps = 4;       // instances (rhs columns) a block
constexpr int kStages = 2;      // blocks of L in flight a warp
constexpr int kBlockPanelsFrom = 257;  // the first n of a block an instance
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;    // a block's dynamic shared memory

// A warp's shared memory, in entries: kStages blocks, the panel's
// quotients, the rhs column (n rounded up to the panel width).
__host__ __device__ constexpr int warp_entries(int n) {
  return kStages * kP * kLd + kP + (n + kP - 1) / kP * kP;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kP)
tri_pair_batched_kernel(const T* __restrict__ L, const T* __restrict__ B,
                        T* __restrict__ X, int batch, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kP - 1);
  const int w = threadIdx.x / kP;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (unit >= static_cast<long long>(batch) * k) return;  // a whole warp
  const int inst = static_cast<int>(unit / k);
  const int c = static_cast<int>(unit - static_cast<long long>(inst) * k);
  L += static_cast<size_t>(inst) * n * n;
  B += static_cast<size_t>(inst) * n * k + c;
  X += static_cast<size_t>(inst) * n * k + c;

  T* mine = reinterpret_cast<T*>(smem_raw) + w * warp_entries(n);
  T (*blk)[kP][kLd] = reinterpret_cast<T (*)[kP][kLd]>(mine);
  T* qs = mine + kStages * kP * kLd;  // the panel's quotients, by row
  T* xs = qs + kP;               // the rhs column
  for (int i = lane; i < n; i += kP) xs[i] = B[static_cast<size_t>(i) * k];

  // Block (R0, C0) of L's lower triangle into blk[buf], row rr by lane t
  // at column C0 + t; the entries outside it are never read.
  auto load = [&](int buf, int r0, int c0) {
    const int col = c0 + lane;
    for (int rr = 0; rr < kP; ++rr) {
      const int row = r0 + rr;
      if (row < n && col <= row) {
        __pipeline_memcpy_async(&blk[buf][rr][lane],
                                L + static_cast<size_t>(row) * n + col,
                                sizeof(T));
      }
    }
    __pipeline_commit();
  };

  // The jobs: forward, panel P = 0 .. np - 1, block rows r = P .. np - 1
  // (block (32 r, 32 P)); backward, P = np - 1 .. 0, block columns
  // r = P .. 0 (block (32 P, 32 r)).  The job kStages - 1 ahead is loaded
  // while one is worked on.
  const int np = (n + kP - 1) / kP;
  struct Job {
    bool fwd;
    int P, r;
  };
  auto next = [&](Job& j) {  // false after the last job
    if (j.fwd) {
      if (j.r + 1 < np) { ++j.r; return true; }
      if (j.P + 1 < np) { j.r = ++j.P; return true; }
      j = {false, np - 1, np - 1};
      return true;
    }
    if (j.r > 0) { --j.r; return true; }
    if (j.P > 0) { j.r = --j.P; return true; }
    return false;
  };
  auto load_job = [&](int buf, const Job& j) {
    load(buf, kP * (j.fwd ? j.r : j.P), kP * (j.fwd ? j.P : j.r));
  };
  Job job = {true, 0, 0}, ahead = job;
  bool more = true;  // `ahead` is a job
  for (int b = 0; b + 1 < kStages; ++b) {
    if (more) {
      load_job(b, ahead);
      more = next(ahead);
    } else {
      __pipeline_commit();
    }
  }
  for (int buf = 0, fill = kStages - 1;;) {
    if (more) {
      load_job(fill, ahead);
      more = next(ahead);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(kStages - 1);  // this job's block has landed
    __syncwarp();                        // (every lane's copies)
    const T (*S)[kLd] = blk[buf];
    const bool fwd = job.fwd;
    const int P = job.P, r = job.r;
    const int a = kP * P;                  // the panel's first row
    const int nb = min(kP, n - a);         // and its rows
    if (r == P) {
      // the diagonal block: the chain, lane l on row a + l
      const bool own = lane < nb;
      const T piv = own ? S[lane][lane] : T(1);
      const T rp = rcp_of(piv);
      T x = own ? xs[a + lane] : T(0);
      for (int t = 0; t < nb; ++t) {
        const int src = fwd ? t : nb - 1 - t;   // step t's row
        const T d = fwd ? S[lane][src] : S[src][lane];
        T q = div_rn(lane == src ? x : T(1), piv, rp);
        q = __shfl_sync(kFull, q, src);
        if (fwd ? lane > src : lane < src) x = sub_rn(x, mul_rn(d, q));
      }
      const T z = div_rn(own ? x : T(1), piv, rp);
      if (own) {
        qs[lane] = z;
        if (fwd) {
          xs[a + lane] = z;
        } else {
          X[static_cast<size_t>(a + lane) * k] = z;
        }
      }
    } else {
      // rows beyond the panel take its quotients in step order: forward
      // row 32 r + l, L[32 r + l][a + t], t ascending; backward row
      // 32 r + l, L[a + t][32 r + l], t descending
      const int i = kP * r + lane;
      if (i < n) {
        T x = xs[i];
        if (fwd) {
          for (int t = 0; t < kP; ++t) x = sub_rn(x, mul_rn(S[lane][t], qs[t]));
        } else {
          for (int t = nb - 1; t >= 0; --t) {
            x = sub_rn(x, mul_rn(S[t][lane], qs[t]));
          }
        }
        xs[i] = x;
      }
    }
    __syncwarp();  // the block and the quotients are read before reuse
    if (!next(job)) break;
    buf = buf + 1 == kStages ? 0 : buf + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
}

// ---- the small-order schedule: n <= kSmallMaxN, all k columns of G
// instances a warp

constexpr int kSmallMaxN = 32;
constexpr int kSmallWarps = 4;       // independent warps a block

// The instances a warp takes at order n with k columns.
__host__ __device__ constexpr int small_instances(int n, int k) {
  return n <= 0 || k <= 0 || k >= kP / n ? 1 : kP / n / k;
}

template <typename T>
__global__ void __launch_bounds__(kSmallWarps * kP)
tri_pair_small_kernel(const T* __restrict__ L, const T* __restrict__ B,
                      T* __restrict__ X, int batch, int n, int k, int per_warp,
                      unsigned long long magic) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ln = threadIdx.x & (kP - 1);
  const int w = threadIdx.x / kP;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kSmallWarps + w) * per_warp;
  if (first >= batch) return;                 // a whole warp
  const int count =
      static_cast<int>(min(static_cast<long long>(per_warp), batch - first));
  const int tri = n * (n + 1) / 2;
  T* low = reinterpret_cast<T*>(smem_raw) + w * per_warp * tri;
  L += static_cast<size_t>(first) * n * n;
  B += static_cast<size_t>(first) * n * k;
  X += static_cast<size_t>(first) * n * k;

  copy_lower(low, L, count, n, magic, ln);     // packed_copy.cuh
  __pipeline_wait_prior(0);
  __syncwarp();                               // (every lane's copies)

  const int u = ln / n, i = ln - u * n;       // column unit, row
  const int per_pass = kP / n, units = count * k;
  for (int base = 0; base < units; base += per_pass) {
    const int unit = base + u;
    const bool live = u < per_pass && unit < units;
    const int g = live ? unit / k : 0;        // instance in the warp
    const int c = live ? unit - g * k : 0;    // its column
    const T* Lg = low + g * tri;
    const T* Li = Lg + i * (i + 1) / 2;       // row i
    const size_t at = (static_cast<size_t>(g) * n + i) * k + c;
    const T piv = live ? Li[i] : T(1);
    const T rp = rcp_of(piv);
    T x = live ? B[at] : T(0);
    const int src = u * n;                    // the unit's first lane
    // (the step loops unrolled by 2: by 4, the f64 instance spills around
    // the division's slow-path call)
    // forward: x_i -= L[i][j] (x_j / L_jj), j ascending; x_j / L_jj
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      T q = div_rn(live && i == j ? x : T(1), piv, rp);
      q = __shfl_sync(kFull, q, src + j);
      if (i > j) {
        x = sub_rn(x, mul_rn(Li[j], q));
      } else if (i == j) {
        x = q;
      }
    }
    // backward: x_i -= L[j][i] (x_j / L_jj), j descending; x_j / L_jj
#pragma unroll 2
    for (int j = n - 1; j >= 0; --j) {
      T q = div_rn(live && i == j ? x : T(1), piv, rp);
      q = __shfl_sync(kFull, q, src + j);
      if (i < j) {
        x = sub_rn(x, mul_rn(Lg[j * (j + 1) / 2 + i], q));
      } else if (i == j) {
        x = q;
      }
    }
    if (live) X[at] = x;
  }
}

template <typename T>
int launch_small(const T* L, const T* B, T* X, int batch, int n, int k,
                 cudaStream_t s) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;   // nothing to solve
  const int per_warp = small_instances(n, k);
  const long long warps = (static_cast<long long>(batch) + per_warp - 1) / per_warp;
  const long long blocks = (warps + kSmallWarps - 1) / kSmallWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      static_cast<size_t>(kSmallWarps) * per_warp * (n * (n + 1) / 2) * sizeof(T);
  tri_pair_small_kernel<T><<<static_cast<unsigned>(blocks), kSmallWarps * kP,
                             bytes, s>>>(L, B, X, batch, n, k, per_warp,
                                         magic_of(n));
  return static_cast<int>(cudaGetLastError());
}

// ---- above kBlockPanelsFrom: a block for each instance and up to 4
// columns (tri_pair_panels.cuh)

template <typename T, int W>
__global__ void __launch_bounds__(pair_panels::threads_of(W))
tri_pair_batched_rows_kernel(const T* __restrict__ L, const T* __restrict__ B,
                             T* __restrict__ X, int n, int k) {
  pair_panels::run<T, W>(L, B, X, n, k);
}

template <typename T>
int launch(const T* L, const T* B, T* X, int batch, int n, int k,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmallMaxN) return launch_small(L, B, X, batch, n, k, s);
  if (n >= kBlockPanelsFrom) {
    static bool set[2][pair_panels::kMaxDevices] = {};
    return pair_panels::launch<T>(
        tri_pair_batched_rows_kernel<T, 1>,
        tri_pair_batched_rows_kernel<T, pair_panels::kCols>, set, L, B, X,
        batch, n, k, s);
  }
  const size_t bytes = kWarps * warp_entries(n) * sizeof(T);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once per process and device: the largest allocation
  static bool attribute_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(tri_pair_batched_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  const long long units = static_cast<long long>(batch) * k;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;                  // nothing to solve
  tri_pair_batched_kernel<T><<<static_cast<unsigned>(blocks), kWarps * kP,
                               bytes, s>>>(L, B, X, batch, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest n the kernels take for entries of `itemsize` bytes: above
// kBlockPanelsFrom one rhs column of n entries must fit the shared memory
// the panels leave (tri_pair_single_max_n's limit).
extern "C" int tri_pair_batched_max_n(int itemsize) {
  return pair_panels::max_n(itemsize);
}

// L: (batch, n, n) lower factor; B, X: (batch, n, k); all row-major on the
// device.  Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue when n is above tri_pair_batched_max_n.
extern "C" int tri_pair_batched_f64(const double* L, const double* B,
                                    double* X, int batch, int n, int k,
                                    void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}

extern "C" int tri_pair_batched_f32(const float* L, const float* B, float* X,
                                    int batch, int n, int k, void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}

// The schedule launch() takes at order n with k columns (both dtypes): the
// instances a warp holds in the small-order schedule (1 ... 32), -1 for a
// warp an instance and column over 32 x 32 blocks, -2 for a block an
// instance and up to 4 columns.
extern "C" int tri_pair_batched_schedule(int n, int k) {
  if (n <= kSmallMaxN) return small_instances(n, k);
  return n >= kBlockPanelsFrom ? -2 : -1;
}
