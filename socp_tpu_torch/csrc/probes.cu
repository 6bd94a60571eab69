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
//                x_j = b_j / L_jj, then b_i -= L[i][j] x_j for i > j.
//
// P1 (pallas_probe.py:_chol_kernel, an f32 Cholesky of a (128, 128) matrix)
// has no kernel here: it is the same function as chol_single_f32 at
// n = 128 (chol_single.cu).
//
// What bounds them on this card.  Each is a few KB of device memory (the
// largest, P5 at n = 128, reads 64 KB of LT): one launch's latency, a few
// microseconds, is far above the bytes' time over 3.35 TB/s and the flops'
// over 67 TFLOP/s FP32 (non-tensor; H100 SXM data sheet).  P5 is a chain of
// n dependent steps, each ending in a block barrier.

#include <cuda_runtime.h>

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

// One block; xs (n x k, shared) is the running residual.  Step j reads row j
// of LT.  No thread writes row j of xs while another reads it: every thread
// computes x_j = xs[j] / L_jj itself, and row j is divided once, after the
// loop, as the reference's step j writes it.
__global__ void fwd_kernel(const float* __restrict__ LT,
                           const float* __restrict__ b, float* __restrict__ x,
                           int n, int k) {
  extern __shared__ float xs[];
  const int nk = n * k;
  for (int e = threadIdx.x; e < nk; e += blockDim.x) xs[e] = b[e];
  __syncthreads();
  for (int j = 0; j < n - 1; ++j) {
    const float ljj = LT[static_cast<size_t>(j) * n + j];
    const float* row = LT + static_cast<size_t>(j) * n;
    for (int e = (j + 1) * k + threadIdx.x; e < nk; e += blockDim.x) {
      const int i = e / k;
      const int c = e - i * k;
      xs[e] = __fsub_rn(xs[e], __fmul_rn(row[i], xs[j * k + c] / ljj));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nk; e += blockDim.x) {
    const int i = e / k;
    x[e] = xs[e] / LT[static_cast<size_t>(i) * n + i];
  }
}

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
// cudaErrorInvalidValue when b does not fit one block's shared memory.
extern "C" int probe_fwd(const float* LT, const float* b, float* x, int n,
                         int k, void* stream) {
  const size_t smem = static_cast<size_t>(n) * k * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  fwd_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      LT, b, x, n, k);
  return static_cast<int>(cudaGetLastError());
}
