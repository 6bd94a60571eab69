// probes.cu -- the ports of the Mosaic toolchain probes, in f32.
//
// The reference's scripts/pallas_probe.py and scripts/pallas_probe2.py
// probe what the TPU's Pallas lowering can compile: each is a tiny kernel
// on no solver path.  These are their counterparts for this card, each an
// entry point of its own (ops/probes.py wraps them):
//
//   probe_eft    replaces scripts/pallas_probe.py:_eft_kernel (P2): Knuth's
//                two-sum and Dekker's two-prod (split 4097) on f32 arrays,
//                four outputs s, e, p, q with s + e == a + b and
//                p + q == a * b exactly.  Every operation is __fadd_rn /
//                __fsub_rn / __fmul_rn, which nvcc can neither contract into
//                an FMA nor reassociate: that is what the probe checks.
//   probe_read   replaces scripts/pallas_probe2.py:_read_kernel (P3): the
//                sum of the rows of a (rows, cols) matrix, one row a step,
//                in row order (thread c adds column c's entries in order).
//   probe_write  replaces pallas_probe2.py:_write_kernel (P4): the rows in
//                reverse order, one row written a step.
//   probe_fwd    replaces pallas_probe2.py:_fwd_kernel (P5): forward
//                substitution L x = b reading rows of LT (columns of L),
//                in the plain version's axpy order: step j,
//                x_j = b_j / L_jj, then b_i -= L[i][j] x_j for i > j
//                (a multiply, then a subtract), and each row divided once
//                by its diagonal at the end; n up to 512, any k.
//   probe_empty  no TPU kernel: an empty launch, the floor under every
//                probe's time.
//
// P1 (pallas_probe.py:_chol_kernel, an f32 Cholesky of a (128, 128) matrix)
// has no kernel here: it is the same function as chol_single_f32 at
// n = 128 (chol_single.cu).
//
// What bounds them on this card.  Each is a few KB of device memory (the
// largest, P5 at n = 128, reads 64 KB of LT): one launch's latency, a few
// microseconds, is far above the bytes' time over 3.35 TB/s and the flops'
// over 67 TFLOP/s FP32 (non-tensor; H100 SXM data sheet); probe_empty
// measures that floor.  P5 is a chain of n - 1 dependent steps: its time is
// the chain's latency.  Its first design ran one block of 256 threads with
// a block barrier and a global load of row j in every step, and every
// thread repeating the division (about 0.43 us a step).  This one
// (fwd_kernel below) runs a warp a column with x in registers: a step is
// a broadcast, a division whose divisor's part was taken before, and one
// row's multiply-subtract, with no barrier and no load on the chain; the
// rows below the current 32 take their subtractions after them; LT comes
// ahead of the chain through shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "div_rn.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void eft_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, float* __restrict__ s,
                           float* __restrict__ e, float* __restrict__ p,
                           float* __restrict__ q, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float ai = a[i];
  const float bi = b[i];
  // Knuth two-sum
  const float si = __fadd_rn(ai, bi);
  const float bb = __fsub_rn(si, ai);
  s[i] = si;
  e[i] = __fadd_rn(__fsub_rn(ai, __fsub_rn(si, bb)), __fsub_rn(bi, bb));
  // Dekker two-prod, split 4097 = 2^12 + 1
  const float split = 4097.0f;
  const float pi = __fmul_rn(ai, bi);
  const float ta = __fmul_rn(split, ai);
  const float ua = __fsub_rn(ta, ai);
  const float ah = __fsub_rn(ta, ua);
  const float al = __fsub_rn(ai, ah);
  const float tb = __fmul_rn(split, bi);
  const float ub = __fsub_rn(tb, bi);
  const float bh = __fsub_rn(tb, ub);
  const float bl = __fsub_rn(bi, bh);
  // ((ah bh - p) + ah bl + al bh) + al bl, left to right
  float err = __fsub_rn(__fmul_rn(ah, bh), pi);
  err = __fadd_rn(err, __fmul_rn(ah, bl));
  err = __fadd_rn(err, __fmul_rn(al, bh));
  err = __fadd_rn(err, __fmul_rn(al, bl));
  p[i] = pi;
  q[i] = err;
}

__global__ void read_kernel(const float* __restrict__ M,
                            float* __restrict__ out, int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
  for (int j = 0; j < rows; ++j) {
    acc = __fadd_rn(acc, M[static_cast<size_t>(j) * cols + c]);
  }
  out[c] = acc;
}

__global__ void write_kernel(const float* __restrict__ M,
                             float* __restrict__ out, int rows, int cols) {
  const size_t total = static_cast<size_t>(rows) * cols;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t j = e / cols;
    const size_t c = e - j * cols;
    out[(rows - 1 - j) * cols + c] = M[e];
  }
}

// The largest n (32 lanes x kFwdSlots register slots) and the rhs columns
// (warps) a block runs.
constexpr int kFwdSlots = 16;
constexpr int kFwdMaxN = 32 * kFwdSlots;
constexpr int kFwdCols = 8;
constexpr int kFwdMinWarps = 4;
constexpr int kMaxDevices = 64;

// fwd_kernel's shared memory in floats: two panels of 32 rows of LT (row
// stride n), a row and 32 floats that the read-ahead of a panel's last
// step may touch (their values unused), then 32 floats a warp for its
// block's quotients.
__host__ __device__ constexpr int fwd_panel_floats(int n) {
  return 2 * 32 * n + n + 32;
}
__host__ __device__ constexpr int fwd_smem_floats(int n) {
  return fwd_panel_floats(n) + 32 * kFwdCols;
}

// Asynchronous copies global -> shared (cp.async) to a 32-bit shared
// address, taken once: a generic pointer would make the compiler find the
// shared window again at every copy.
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [j0, j0 + rows) of LT, whole and contiguous, into the panel at
// shared address `panel` (row stride n), by every thread of the block, one
// flat loop and one commit group: 16-byte copies where n is a multiple of
// 4 and LT 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void fwd_panel_copy(unsigned panel,
                                               const float* __restrict__ LT,
                                               int j0, int rows, int n,
                                               bool vec4) {
  const float* src = LT + static_cast<size_t>(j0) * n;
  const int total = rows * n;
  if (vec4) {
    for (int c = 4 * threadIdx.x; c < total; c += 4 * blockDim.x) {
      cp_async16(panel + 4u * c, src + c);
    }
  } else {
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      cp_async4(panel + 4u * c, src + c);
    }
  }
  cp_async_commit();
}

// The forward substitution of one warp's column, a block of 32 rows at a
// time (block p: rows 32 p .. 32 p + 31, slot p).  Lane l holds rows l,
// l + 32, ... of x in registers (slot r: row 32 r + l; the slot loop is
// unrolled, so every index is compile-time).  Block p's steps: at step t
// (j = 32 p + t) lane t holds x_j, __shfl_sync broadcasts it, every lane
// divides it by L_jj (the block's pivots and their reciprocals are taken
// before its steps, a lane each, and broadcast), and the lanes below t in
// the block subtract L[j][i] x_j, multiply then subtract, with L[j][i]
// read one step ahead.  The chain from one step to the next is the
// broadcast, the division and row j + 1's multiply-subtract: no barrier,
// no load and no other row's work.  The step's quotient is row j of the
// result (the plain version's final division gives the same bits: x_j is
// not changed after step j) and goes to the warp's 32 floats of shared
// memory.  After the block, each row below it takes the block's 32
// subtractions in step order, the same operations in the same order as
// the plain version's, only later.  The block's last step may be row
// n - 1, which only divides.  LT comes through shared memory in 32-row
// panels, double buffered: the next panel is copied (cp.async) while the
// block's steps run, and the block of threads meets at one barrier a
// panel.
//
// The division: kSafe = false takes the fast path of div_rn (div_rn.cuh;
// the same roundings, and for a zero numerator a zero of x / p's sign),
// for a positive pivot; a numerator other than zero or a pivot outside
// div_rn's range (magnitude outside [2^-60, 2^60), a subnormal, an
// infinity, a NaN), or a pivot that is not positive, marks the pass as
// bad, and the kernel then runs the whole substitution again with kSafe =
// true, IEEE x / p.  So the result is x / p's, bit for bit, for every
// input, and no branch sits on the chain.  Returns whether the pass was
// bad.
template <int R, bool kSafe>
__device__ __forceinline__ bool fwd_run(const float* __restrict__ LT,
                                        const float* __restrict__ b,
                                        float* __restrict__ x, int n, int k,
                                        bool vec4, float* panels) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = col < k;
  float* xq = panels + fwd_panel_floats(n) + 32 * warp;
  const int nb = (n + 31) / 32;
  const unsigned panels_s =
      static_cast<unsigned>(__cvta_generic_to_shared(panels));
  fwd_panel_copy(panels_s, LT, 0, min(32, n), n, vec4);
  float xr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    xr[r] = active && i < n ? b[static_cast<size_t>(i) * k + col] : 0.0f;
  }
  bool bad = false;
#pragma unroll
  for (int p = 0; p < R; ++p) {
    if (p < nb) {
      if (p + 1 < nb) {
        const int j1 = 32 * (p + 1);
        fwd_panel_copy(panels_s + 4u * ((p + 1) & 1) * 32 * n, LT, j1,
                       min(32, n - j1), n, vec4);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                   // panel p has landed
      // row[t * n + c]: LT[32 p + t][c + lane]
      const float* row = panels + (p & 1) * 32 * n + lane;
      const int rows = min(32, n - 32 * p);
      // lane t < rows: step t's pivot and its reciprocal
      const float piv = lane < rows ? row[lane * n + 32 * p] : 1.0f;
      const float prcp = rcp_of(piv);
      if constexpr (!kSafe) bad |= !(piv > 0.0f && div_rn_moderate(piv));
      float lcur = row[32 * p];          // L[j][32 p + lane], step 0's
#pragma unroll 4
      for (int t = 0; t < rows; ++t) {
        const float lnext = row[(t + 1) * n + 32 * p];
        const float ljj = __shfl_sync(0xffffffffu, piv, t);
        const float rcp = __shfl_sync(0xffffffffu, prcp, t);
        const float v = __shfl_sync(0xffffffffu, xr[p], t);
        float q;
        if constexpr (kSafe) {
          q = v / ljj;
        } else {
          // div_rn's q0 + r (x - p q0) as q0 - r (p q0 - x): the same bits
          // (a negated residual, rounded alike), and a zero numerator
          // keeps its sign through it where the pivot is positive
          const float q0 = __fmul_rn(v, rcp);
          const float nrem = __fmaf_rn(ljj, q0, -v);
          q = __fmaf_rn(-rcp, nrem, q0);
          bad |= !(v == 0.0f || div_rn_moderate(v));
        }
        if (lane > t) xr[p] = __fsub_rn(xr[p], __fmul_rn(lcur, q));
        if (lane == 0) xq[t] = q;
        lcur = lnext;
      }
      __syncwarp();
      if (active && lane < rows) {
        x[static_cast<size_t>(32 * p + lane) * k + col] = xq[lane];
      }
#pragma unroll
      for (int r = p + 1; r < R; ++r) {
        if (32 * r + lane < n) {
          float acc = xr[r];
#pragma unroll 8
          for (int t = 0; t < rows; ++t) {
            acc = __fsub_rn(acc, __fmul_rn(row[t * n + 32 * r], xq[t]));
          }
          xr[r] = acc;
        }
      }
      __syncthreads();                   // panel p and xq read
    }
  }
  return bad;
}

template <int R>
__global__ void __launch_bounds__(32 * kFwdCols)
fwd_kernel(const float* __restrict__ LT, const float* __restrict__ b,
           float* __restrict__ x, int n, int k, bool vec4) {
  extern __shared__ __align__(16) float panels[];
  const bool bad = fwd_run<R, false>(LT, b, x, n, k, vec4, panels);
  if (__syncthreads_or(bad)) fwd_run<R, true>(LT, b, x, n, k, vec4, panels);
}

template <int R>
int launch_fwd(const float* LT, const float* b, float* x, int n, int k,
               cudaStream_t s) {
  // the attribute once per process and device: the largest allocation
  static bool attribute_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(
        fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem_floats(32 * R) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[dev] = true;
  }
  // at least kFwdMinWarps warps a block, so that enough threads issue the
  // panel copies; a warp past the last column runs on zeros
  const int warps = k < kFwdMinWarps ? kFwdMinWarps
                                     : (k < kFwdCols ? k : kFwdCols);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(LT) % 16 == 0;
  fwd_kernel<R><<<(k + warps - 1) / warps, 32 * warps,
                  fwd_smem_floats(n) * sizeof(float), s>>>(LT, b, x, n, k,
                                                           vec4);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

int blocks_for(size_t count) {
  const size_t b = (count + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1024 ? (b < 1 ? 1 : b) : 1024);
}

}  // namespace

// a, b, s, e, p, q: `count` f32 each on the device.  Every entry point
// returns the CUDA error code of its launch (0 on success).
extern "C" int probe_eft(const float* a, const float* b, float* s, float* e,
                         float* p, float* q, int count, void* stream) {
  eft_kernel<<<blocks_for(count), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(a, b, s, e, p, q, count);
  return static_cast<int>(cudaGetLastError());
}

// M: (rows, cols) row-major; out: cols entries.
extern "C" int probe_read(const float* M, float* out, int rows, int cols,
                          void* stream) {
  read_kernel<<<blocks_for(cols), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(M, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// M, out: (rows, cols) row-major.
extern "C" int probe_write(const float* M, float* out, int rows, int cols,
                           void* stream) {
  write_kernel<<<blocks_for(static_cast<size_t>(rows) * cols), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(M, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// LT: (n, n), the transpose of a lower factor; b, x: (n, k); row-major.
// cudaErrorInvalidValue for n outside 1 .. kFwdMaxN (512) or k < 1.
extern "C" int probe_fwd(const float* LT, const float* b, float* x, int n,
                         int k, void* stream) {
  if (n < 1 || n > kFwdMaxN || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32) return launch_fwd<1>(LT, b, x, n, k, s);
  if (n <= 64) return launch_fwd<2>(LT, b, x, n, k, s);
  if (n <= 128) return launch_fwd<4>(LT, b, x, n, k, s);
  if (n <= 256) return launch_fwd<8>(LT, b, x, n, k, s);
  return launch_fwd<kFwdSlots>(LT, b, x, n, k, s);
}

// The floor of a launch on this card: one block of one thread that does
// nothing (chip_smoke.py times it beside the probes).
extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
