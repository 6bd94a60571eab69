// chol_column.cuh -- the correctly rounded scalar operations the kernels
// share (f64 and f32).
//
// mul_rn / sub_rn (__dmul_rn / __dsub_rn, __fmul_rn / __fsub_rn) are never
// contracted into an FMA, so a multiply-subtract written with them rounds
// twice, as the plain PyTorch versions (ops/chol.py) round it.  sqrt_rn and
// IEEE `/` are correctly rounded in both types: the build has no
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sqrt_rn(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return sqrtf(a); }
