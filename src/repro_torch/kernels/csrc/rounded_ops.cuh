// Multiply and add rounded one at a time, so the compiler cannot fuse them
// into one multiply-add: the kernels then round each product before summing
// it, as the reference's "elementwise multiply, then sum over K" does.
#pragma once

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
