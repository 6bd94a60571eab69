// packed_copy.cuh -- the small-order schedules' copy of a warp's instances
// (chol_batched.cu and tri_pair_batched.cu, n <= 32) into shared memory.
//
// A warp's count instances are count n^2 contiguous words of a (B, n, n)
// batch; copy_lower takes them word by word across the warp (every access
// coalesced) with cp.async and keeps each instance's lower triangle,
// packed: instance g's row r at g tri + r (r + 1) / 2, tri = n (n + 1) / 2.
// A lane reading its own row there, or a column's entries, touches
// distinct banks: the triangular numbers are distinct mod 32.  The flat
// index is split into (instance, row, column) by two multiply-highs with
// magic_of(n), no integer division.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// idx / n for 0 <= idx < 2^16 and 1 <= n <= 32, given magic = ceil(2^32 /
// n) (the error idx (magic n - 2^32) / (n 2^32) stays below 1 / n).
__host__ __device__ constexpr unsigned long long magic_of(int n) {
  return ((1ull << 32) + n - 1) / n;
}
__device__ __forceinline__ int div_small(int idx, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(idx) * magic) >> 32);
}

// Flat word idx of a warp's instances: its instance, row and column.
__device__ __forceinline__ void split_flat(int idx, int n,
                                           unsigned long long magic, int& gi,
                                           int& r, int& c) {
  const int rf = div_small(idx, magic);       // row of the stacked rows
  gi = div_small(rf, magic);
  r = rf - gi * n;
  c = idx - rf * n;
}

// The count instances at src into low, their lower triangles packed; the
// copies are committed, not waited for.
template <typename T>
__device__ __forceinline__ void copy_lower(T* low, const T* __restrict__ src,
                                           int count, int n,
                                           unsigned long long magic, int lane) {
  const int tri = n * (n + 1) / 2;
  for (int idx = lane; idx < count * n * n; idx += 32) {
    int gi, r, c;
    split_flat(idx, n, magic, gi, r, c);
    if (c <= r) {
      __pipeline_memcpy_async(&low[gi * tri + r * (r + 1) / 2 + c], src + idx,
                              sizeof(T));
    }
  }
  __pipeline_commit();
}
