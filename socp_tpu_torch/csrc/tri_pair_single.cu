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
// What the design does about it.  Panels of kP = 32 rows, one warp wide,
// top down for the forward pass (bottom up, j descending, for the
// backward).  Panel p, between two barriers:
//   chain warp   (one a rhs column, up to 4 side by side) holds the
//                panel's x, lane l on row l.  It first applies the last
//                panel's 32 quotients to its own rows (the lookahead, from
//                segments of L it read during the last panel), then runs the
//                panel's 32 steps: every lane divides with div_rn
//                (div_rn.cuh: IEEE division, each lane's pivot's reciprocal
//                taken once a panel, off the chain; lanes other than row
//                j's divide 1, so no division sits in a divergent branch),
//                __shfl_sync broadcasts row j's q_j = x_j / L_jj, the lanes
//                below subtract their entry of the panel's diagonal block
//                (in shared memory, copied in during the last panel) times
//                q_j.  No barrier and no load lies on the chain.
//   row threads  apply the last panel's quotients to every row beyond this
//                panel, j ascending, each row's 32 entries of L (256
//                contiguous bytes in f64 forward; L[j][i] for the panel's
//                j backward, neighbouring threads on neighbouring entries)
//                read while the row before is worked on, and copy the next
//                panel's diagonal block in with cp.async.
// One barrier a panel: ceil(n / 32) a pass instead of the 2 n of a design
// with a barrier a step.  L is read from device memory (L2 holds it: 2 MB
// in f64 at n = 500); shared memory holds the pass's rhs columns, the two
// diagonal blocks and two panels' quotients.
//
// Agreement with the plain version (ops/chol.py).  Every x_i sees the plain
// loops' operations in their order: forward x_i -= L[i][j] * (x_j / L_jj)
// for j = 0, 1, ..., i - 1, then x_i / L_ii; backward x_i -= L[j][i] *
// (x_j / L_jj) for j = n - 1, ..., i + 1, then x_i / L_ii.  Panels only
// change which thread applies which j, mul_rn / sub_rn (chol_column.cuh)
// are never contracted into an FMA and div_rn is x / p bit for bit, so the
// kernel agrees with the plain version bit for bit in either type.
// Right-hand sides are taken kCols columns a pass; more columns run as
// further passes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "chol_column.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kP = 32;          // panel width: one warp
constexpr int kCols = 4;        // rhs columns a pass when k > 1
// row threads: beside one chain warp, or beside kCols (256 threads a block)
constexpr int row_threads(int W) { return W > 1 ? 256 - W * 32 : 224; }
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Static shared memory (bytes, f64): two diagonal blocks and their pivots,
// two panels' quotients.  What is left of the 227 KB holds the rhs columns.
constexpr size_t kSmemStatic =
    (2 * kP * (kP + 1) + 2 * kP + 2 * kP * kCols) * 8;
constexpr size_t kSmemDynamic = 232448 - kSmemStatic;

// W: rhs columns a pass (1 for k = 1, kCols otherwise).  Warp c < W runs
// the chain of the pass's column c; thread 32 W + r is row thread r.
template <typename T, int W>
__global__ void __launch_bounds__(W * kP + row_threads(W))
tri_pair_single_kernel(const T* __restrict__ L, const T* __restrict__ B,
                       T* __restrict__ X, int n, int k) {
  // D[b][l][t]: the entry the panel's row l subtracts at step t, pv[b][l]:
  // row l's pivot (b: this panel's block or the next one's); qs[b][t][c]:
  // step t's quotient x_j / L_jj for rhs column c (b: this panel's or the
  // last one's)
  __shared__ T D[2][kP][kP + 1];
  __shared__ T pv[2][kP];
  __shared__ T qs[2][kP][W];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // n x W, the pass's columns
  const int tid = threadIdx.x;
  const int lane = tid & (kP - 1);
  const int cw = tid / kP;                 // a chain warp's rhs column
  const bool on_chain = tid < W * kP;
  const int rt = tid - W * kP;             // row thread (>= 0 off the chains)
  const int nrt = blockDim.x - W * kP;     // row threads (>= 32)

  // Row thread l < 32 copies the diagonal block of the panel with rows
  // [a, a + nb) into D[b] (cp.async: it lands while the thread works on;
  // __pipeline_wait_prior(0) before the next barrier): forward, row a + l
  // subtracts L[a + l][a + t] at step t; backward, step t is row
  // j = a + nb - 1 - t and row a + l subtracts L[j][a + l].
  auto load_block = [&](bool forward, int b, int a, int nb, int l) {
    const int r = a + l;
    const bool own = l < nb;
    for (int t = 0; t < kP; ++t) {
      const int j = a + nb - 1 - t;
      const T* e = nullptr;
      if (forward && own && t < l) e = L + static_cast<size_t>(r) * n + a + t;
      if (!forward && own && t < nb && j > r) e = L + static_cast<size_t>(j) * n + r;
      if (e) {
        __pipeline_memcpy_async(&D[b][l][t], e, sizeof(T));
      } else {
        D[b][l][t] = T(0);
      }
    }
    if (own) {
      __pipeline_memcpy_async(&pv[b][l], L + static_cast<size_t>(r) * n + r,
                              sizeof(T));
    } else {
      pv[b][l] = T(1);
    }
    __pipeline_commit();
  };

  // The 32 entries row i subtracts with a panel's quotients, step t:
  // forward the panel starts at j, L[i][j + t]; backward it ends at j,
  // L[j - 1 - t][i].
  auto segment = [&](bool forward, int i, int j, T (&v)[kP]) {
    if (forward) {
      const T* row = L + static_cast<size_t>(i) * n + j;
#pragma unroll
      for (int t = 0; t < kP; ++t) v[t] = row[t];
    } else {
#pragma unroll
      for (int t = 0; t < kP; ++t) v[t] = L[static_cast<size_t>(j - 1 - t) * n + i];
    }
  };

  // x -= v[t] q_t for t = 0 .. 31, column c of the quotients in qs[b].
  // The quotients are read afresh for every row (volatile): kept in
  // registers across a row thread's rows, 32 of them beside its two
  // segments spilled the k = 1 instance in f64.
  auto apply = [&](const T (&v)[kP], int b, int c, T x) {
    const volatile T* q = &qs[b][0][c];
#pragma unroll
    for (int t = 0; t < kP; ++t) x = sub_rn(x, mul_rn(v[t], q[t * W]));
    return x;
  };

  // One substitution pass over panels of 32 rows, top down (forward) or
  // bottom up (backward).  Panel p, between two barriers:
  //   chain warps  finish the panel's rows with the last panel's quotients
  //                (the lookahead, from segments read during that panel),
  //                then run the panel's 32 steps: for each step, the lane
  //                of row j divides, __shfl_sync broadcasts q = x_j / L_jj,
  //                the lanes it updates subtract D[l][t] q;
  //   row threads  apply the last panel's quotients to the rows beyond this
  //                one, each row's segment read while the row before is
  //                worked on, and read the next panel's diagonal block.
  // So one barrier a panel, and only the chain warps' work lies on it.
  auto pass = [&](bool forward, int w) {
    const int panels = (n + kP - 1) / kP;
    // a segment read during one panel for the next (one array, two roles):
    // the chain warps' lookahead, the row threads' first row
    T pre[kP];
    for (int p = 0; p < panels; ++p) {
      // this panel's rows [a, a + nb); the rows beyond it: forward
      // [a + nb, n), backward [0, a)
      const int a = forward ? p * kP : max(0, n - (p + 1) * kP);
      const int nb = forward ? min(kP, n - a) : n - p * kP - a;
      const int b = p & 1;
      const int an = forward ? a + kP : max(0, a - kP);  // the next panel
      if (on_chain) {
        if (cw < w) {
          const bool own = lane < nb;
          T x = own ? xs[(a + lane) * W + cw] : T(0);
          if (p > 0 && own) x = apply(pre, b ^ 1, cw, x);
          // the next panel's rows, segments of this panel's steps
          if (forward ? an + lane < n : an + lane < a) {
            segment(forward, an + lane, forward ? a : a + nb, pre);
          }
          const T piv = pv[b][lane];
          const T rpiv = rcp_of(piv);  // div_rn.cuh: off the chain
          for (int t = 0; t < nb; ++t) {  // rolled: the chain's code is small
            const int src = forward ? t : nb - 1 - t;
            const T d = D[b][lane][t];
            // every lane divides (the others 1 by their pivot), so no
            // division sits in a branch; lane src's quotient goes to all
            T q = div_rn(lane == src ? x : T(1), piv, rpiv);
            q = __shfl_sync(kFull, q, src);
            if (forward ? lane > src : lane < src) x = sub_rn(x, mul_rn(d, q));
          }
          if (own) {
            xs[(a + lane) * W + cw] = x;
            qs[b][forward ? lane : nb - 1 - lane][cw] = div_rn(x, piv, rpiv);
          }
        }
      } else {
        if (rt < kP && p + 1 < panels) {
          load_block(forward, b ^ 1, an, forward ? min(kP, n - an) : a - an, rt);
        }
        // the last panel's quotients, to the rows beyond this panel (the
        // first row's segment came in during the last panel)
        const int lo = forward ? a + kP : 0;
        const int hi = forward ? n : a;
        const int jp = forward ? a - kP : a + nb + kP;  // the last panel
        if (p > 0) {
          T vn[kP];
          for (int i = lo + rt; i < hi; i += nrt) {
            if (i + nrt < hi) segment(forward, i + nrt, jp, vn);
            for (int c = 0; c < w; ++c) {
              xs[i * W + c] = apply(pre, b ^ 1, c, xs[i * W + c]);
            }
#pragma unroll
            for (int t = 0; t < kP; ++t) pre[t] = vn[t];
          }
        }
        // the next apply's first row: beyond the next panel, this panel's
        // steps
        const int lo_next = forward ? an + kP : 0;
        const int hi_next = forward ? n : an;
        if (lo_next + rt < hi_next) {
          segment(forward, lo_next + rt, forward ? a : a + nb, pre);
        }
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    }
  };

  for (int c0 = 0; c0 < k; c0 += W) {
    const int w = min(W, k - c0);
    __syncthreads();  // the previous pass is done with xs
    for (int e = tid; e < n * W; e += blockDim.x) {
      const int i = e / W;
      const int c = e - i * W;
      xs[e] = c < w ? B[static_cast<size_t>(i) * k + c0 + c] : T(0);
    }
    if (!on_chain && rt < kP) load_block(true, 0, 0, min(kP, n), rt);
    __pipeline_wait_prior(0);
    __syncthreads();
    pass(true, w);   // L y = b
    for (int e = tid; e < n * W; e += blockDim.x) {
      const int i = e / W;
      xs[e] = xs[e] / L[static_cast<size_t>(i) * n + i];
    }
    const int a0 = max(0, n - kP);
    if (!on_chain && rt < kP) load_block(false, 0, a0, n - a0, rt);
    __pipeline_wait_prior(0);
    __syncthreads();
    pass(false, w);  // L' x = y
    for (int e = tid; e < n * W; e += blockDim.x) {
      const int i = e / W;
      const int c = e - i * W;
      if (c < w) {
        X[static_cast<size_t>(i) * k + c0 + c] =
            xs[e] / L[static_cast<size_t>(i) * n + i];
      }
    }
  }
}

template <typename T, int W>
int launch_w(const T* L, const T* B, T* X, int n, int k, cudaStream_t s) {
  if (static_cast<size_t>(n) * W * sizeof(T) > kSmemDynamic) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the attribute once per process and device: the largest allocation
  static bool attribute_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(tri_pair_single_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemDynamic));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  // the chain warps, then a thread per row below the first panel
  int threads = n > kP ? (n - 1) / kP * kP : kP;
  if (threads > row_threads(W)) threads = row_threads(W);
  tri_pair_single_kernel<T, W><<<1, W * kP + threads, n * W * sizeof(T), s>>>(
      L, B, X, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* L, const T* B, T* X, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // k = 1 (every pair solve but config 1's H^-1 A') takes the instance
  // with one chain warp; k > 1 runs up to 4 chains side by side, one warp
  // a column, unless 4 columns do not fit shared memory (n above 6656 in
  // f64): then one column a pass.
  if (k == 1 || static_cast<size_t>(n) * kCols * sizeof(T) > kSmemDynamic) {
    return launch_w<T, 1>(L, B, X, n, k, s);
  }
  return launch_w<T, kCols>(L, B, X, n, k, s);
}

}  // namespace

// The largest n the kernels take for entries of `itemsize` bytes: one rhs
// column of n entries must fit the shared memory the panels leave.
extern "C" int tri_pair_single_max_n(int itemsize) {
  return static_cast<int>(kSmemDynamic / itemsize);
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
