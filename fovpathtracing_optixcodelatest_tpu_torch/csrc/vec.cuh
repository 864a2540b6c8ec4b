// The float32 vector arithmetic the shading and frame kernels share,
// written as PyTorch evaluates it (csrc/shade.cu, csrc/frame.cu): one IEEE
// float32 operation for each PyTorch op, in its order (the libraries are
// built with --fmad=false).
#pragma once

#include <cmath>

// a Python float constant as PyTorch converts a scalar operand: the double
// rounded to float32
#define F(x) static_cast<float>(x)

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

// ops/sampling.py dot: summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// torch.clamp(x, min=lo), torch.clamp(x, max=hi), torch.clamp(x, lo, hi):
// NaN passes through
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

}  // namespace
