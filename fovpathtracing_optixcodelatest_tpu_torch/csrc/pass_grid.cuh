// The per-pass pixel grid that ray generation and the film share
// (render/raygen.py pass_launch_dims, pass_offset, pass_pixels and the
// ring of generate_pass_rays; render/renderer.py pass_backplate): launch
// pixel (lx, ly) of a pass is frame pixel (lx * factor + ox, ly * factor +
// oy); it is in the pass's ring when its distance to the gaze lies in
// [r_inner, r_outer]; its ray of sample slot s has the id frame_pixel *
// RNG_STRIDE + s, with launch pixels off the frame in a band of ids above
// the frame's; a point (px, py) of the frame is seen along the camera-basis
// direction normalize(ndc_x * u + ndc_y * v + w). Every expression repeats
// the plain code's PyTorch ops in their order; a tensor divided by a Python
// number is multiplied by the number's float32 reciprocal, as PyTorch does
// on the card.
#pragma once

#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kMaxPasses = 8;   // ops/frame.py MAX_PASSES
constexpr int kRngStride = 64;  // raygen.RNG_STRIDE
constexpr int kOffBand = 512;   // raygen.OFF_BAND

// one pass's launch grid, as ops/frame.py packs it
struct PassGrid {
  int factor, spp;
  int lw, lh;  // launch dims (pass_launch_dims)
  int ox, oy;  // frame offset of the grid (pass_offset; may be negative)
  float r_inner, r_outer;  // ring radii in float32, as torch compares them
};

// frame pixel (x, y) in the pass's ring around the gaze (gx, gy)
__device__ __forceinline__ bool in_ring(const PassGrid& p, int x, int y,
                                        int gx, int gy) {
  const float dx = (float)x - (float)gx;
  const float dy = (float)y - (float)gy;
  const float r = sqrtf(dx * dx + dy * dy);
  return r >= p.r_inner && r <= p.r_outer;
}

// the id of slot `slot`'s ray through frame pixel (x, y) of a w x h frame
__device__ __forceinline__ int64_t pixel_ray_id(int x, int y, int w, int h,
                                                int slot) {
  const bool in_frame = x >= 0 && x < w && y >= 0 && y < h;
  const int64_t cx = x < -kOffBand ? -kOffBand
                     : x > w + kOffBand - 1 ? w + kOffBand - 1 : x;
  const int64_t cy = y < -kOffBand ? -kOffBand
                     : y > h + kOffBand - 1 ? h + kOffBand - 1 : y;
  const int64_t virt_w = w + 2 * kOffBand;
  const int64_t pix = in_frame ? (int64_t)y * w + x
                               : (int64_t)w * h + (cy + kOffBand) * virt_w +
                                     (cx + kOffBand);
  return pix * kRngStride + slot;
}

// the normalized direction through frame point (px, py) of a w x h frame
// for the camera basis (u, v, w3), each (3,) on the device:
// ndc = 2 * p / size - 1, then ops/sampling.py normalize
__device__ __forceinline__ V3 camera_dir(const float* u, const float* v,
                                         const float* w3, float px,
                                         float py, int w, int h) {
  const float ndc_x = (px * 2.0f) * (1.0f / (float)w) - 1.0f;
  const float ndc_y = (py * 2.0f) * (1.0f / (float)h) - 1.0f;
  const V3 d = {(ndc_x * u[0] + ndc_y * v[0]) + w3[0],
                (ndc_x * u[1] + ndc_y * v[1]) + w3[1],
                (ndc_x * u[2] + ndc_y * v[2]) + w3[2]};
  return d * (1.0f / sqrtf(clamp_lo(dot(d, d), F(1e-20))));
}

}  // namespace
