// tri_pair_batched.cu -- batched (L L')^-1 B in f64 or f32: forward
// substitution on L, then backward substitution on L' read from the same L,
// one warp per instance and rhs column.
//
// tri_pair_batched_f64 replaces
// socp_tpu/ops/pallas_chol.py:_tri_pair_batch_kernel (entry point
// tri_pair_solve_batched), the instance-tiled dd32 pair solve of the TPU's
// batched lockstep path; it computes the same function in f64.
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

namespace {

constexpr int kP = 32;          // panel and block width: one warp
constexpr int kLd = kP + 1;     // a block row in shared memory, padded
constexpr int kWarps = 4;       // instances (rhs columns) a block
constexpr int kStages = 2;      // blocks of L in flight a warp
constexpr int kMaxN = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

template <typename T>
int launch(const T* L, const T* B, T* X, int batch, int n, int k,
           void* stream) {
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once per process and device: the largest allocation
  static bool attribute_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(
        tri_pair_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kWarps * warp_entries(kMaxN) * sizeof(T)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  const long long units = static_cast<long long>(batch) * k;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tri_pair_batched_kernel<T><<<static_cast<unsigned>(blocks), kWarps * kP,
                               kWarps * warp_entries(n) * sizeof(T),
                               static_cast<cudaStream_t>(stream)>>>(
      L, B, X, batch, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: (batch, n, n) lower factor; B, X: (batch, n, k); all row-major on the
// device.  Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue when n is above 256.
extern "C" int tri_pair_batched_f64(const double* L, const double* B,
                                    double* X, int batch, int n, int k,
                                    void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}

extern "C" int tri_pair_batched_f32(const float* L, const float* B, float* X,
                                    int batch, int n, int k, void* stream) {
  return launch(L, B, X, batch, n, k, stream);
}
