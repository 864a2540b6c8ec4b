// The frame's per-pixel work around the bounce loop in two kernels, both on
// the per-pass pixel grid of pass_grid.cuh.
//
// Replaces: render/renderer.py plain_frame_rays (raygen.generate_pass_rays
// for every pass and the torch.cat merge) and plain_composite_passes
// (slot sums, pass_backplate, film.shade_to_accum_color and
// film.composite_pass for every pass) followed by film.finalize
// (ops/tonemap.py postprocess), which stay as the kernels' plain versions.
//
// - raygen_kernel, one thread a ray of the merged wavefront: the ray's pass
//   from its index against the passes' first rays, its launch pixel and
//   slot, the ring test, the ray id, the `random` sampler's jitter (the
//   counter hash's streams 0 and 1 under the jitter key; none without
//   antialiasing) and the camera-basis direction. It writes the merged
//   origin, direction, active and ray_ids, and each pass's ring mask (the
//   slot-0 ray of a launch pixel).
// - film_kernel, one thread a pixel of the padded canvas inside the passes'
//   regions and the crop: the passes in schedule order (inner passes
//   overwrite the ring overlap), each covering the pixel with its launch
//   pixel's block: that launch pixel's slot sums, its backplate (the pixel
//   centre's direction, dir_to_uv, the nearest probe texel), its colour,
//   then the progressive lerp or the overwrite against the value so far.
//   It writes the canvas and, inside the crop, the tone-mapped uint8 pixel
//   (exposure, Reinhard, sRGB, quantize).
//
// The arguments are __grid_constant__: the pass table is indexed at run time
// and read in place, not copied to each thread's local memory.
//
// Same arithmetic as the plain versions, bit for bit (see pass_grid.cuh and
// vec.cuh): the library is built with --fmad=false; a slot sum is
// Tensor.sum(1) on a (P, k, 3) float32 tensor as ATen's reduction runs it on
// the card (the channel is the fastest output dimension, so one thread
// reduces one output over its k slots with four accumulators, slot j into
// accumulator j % 4, then ((a0 + a1) + a2) + a3: Reduce.cuh
// thread_reduce_impl with vt0 = 4); torch.pow with a Python exponent is
// powf of the float32 exponent.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "pass_grid.cuh"
#include "rng.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32, kTileH = 8;  // film_kernel's block
constexpr float kPi = F(3.141592653589793);
constexpr float kTwoPi = F(6.283185307179586);

}  // namespace

// The C interface's arguments; ops/frame.py packs the same fields in the
// same order (ctypes.Structure): pointers first, then 32-bit fields, then
// the pass table.
struct RaygenArgs {
  const float* eye;   // (3,) the camera
  const float* u;     // (3,)
  const float* v;     // (3,)
  const float* w;     // (3,)
  float* origin;      // (n, 3) the merged wavefront, out
  float* direction;   // (n, 3)
  bool* active;       // (n,)
  int64_t* ray_ids;   // (n,)
  bool* ring;         // each pass's (lh, lw) ring mask, one after another
  int n, width, height, gaze_x, gaze_y, antialias, num_passes;
  unsigned key0, key1;            // the jitter key's words
  int ray_base[kMaxPasses];       // each pass's first ray
  int ring_base[kMaxPasses];      // each pass's first ring entry
  PassGrid passes[kMaxPasses];
};

// one pass of the film: its slot values and its composite
struct FilmPass {
  const float* radiance;  // (lw * lh, spp, 3) the pass's slot values
  const float* alpha;     // (lw * lh, spp, 3)
  int blend;    // accumulate, not redraw, subframe > 0: lerp, else overwrite
  float lerp;   // float32(1) / float32(subframe + 1)
  PassGrid grid;
};

struct FilmArgs {
  float* canvas;        // (canvas_h, canvas_w, 3), updated in place
  uint8_t* frame;       // (height, width, 3), out
  const float* u;       // (3,) the camera basis
  const float* v;
  const float* w;
  const float* probe;   // (probe_h, probe_w, 3)
  int canvas_w, canvas_h, pad, width, height, gaze_x, gaze_y;
  int probe_w, probe_h;
  int box_x0, box_y0, box_x1, box_y1;  // the canvas pixels launched
  int exposure_on, tonemap_on;
  float exposure_scale;  // float32(2 ** exposure_stops)
  float inv_white;       // float32(1) / float32(white)
  int num_passes;
  FilmPass passes[kMaxPasses];
};

namespace {

__global__ void __launch_bounds__(kThreads)
    raygen_kernel(const __grid_constant__ RaygenArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  int i = 0;
  while (i + 1 < a.num_passes && r >= a.ray_base[i + 1]) ++i;
  const PassGrid& p = a.passes[i];
  const int local = r - a.ray_base[i];
  const int pix = local / p.spp;
  const int slot = local - pix * p.spp;
  const int ly = pix / p.lw;
  const int lx = pix - ly * p.lw;
  const int x = lx * p.factor + p.ox;
  const int y = ly * p.factor + p.oy;
  const bool ring = in_ring(p, x, y, a.gaze_x, a.gaze_y);
  if (slot == 0) a.ring[a.ring_base[i] + pix] = ring;

  const int64_t id = pixel_ray_id(x, y, a.width, a.height, slot);
  float jx = 0.0f, jy = 0.0f;
  if (a.antialias) {  // samplers.aa_jitter, "random": ray_uniforms(key, id, 2)
    const uint32_t base = ray_hash(id, a.key0, a.key1);
    jx = ray_uniform(base, 0);
    jy = ray_uniform(base, 1);
  }
  const V3 d = camera_dir(a.u, a.v, a.w, (float)x + jx, (float)y + jy,
                          a.width, a.height);
  a.origin[3 * (int64_t)r] = a.eye[0];
  a.origin[3 * (int64_t)r + 1] = a.eye[1];
  a.origin[3 * (int64_t)r + 2] = a.eye[2];
  a.direction[3 * (int64_t)r] = d.x;
  a.direction[3 * (int64_t)r + 1] = d.y;
  a.direction[3 * (int64_t)r + 2] = d.z;
  a.active[r] = ring;
  a.ray_ids[r] = id;
}

__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

// Tensor.sum(1) of one launch pixel's (k, 3) slot values on the card
__device__ __forceinline__ V3 slot_sum(const float* s, int k) {
  V3 a0 = {0.0f, 0.0f, 0.0f}, a1 = a0, a2 = a0, a3 = a0;
  int j = 0;
  for (; j + 3 < k; j += 4) {
    a0 = a0 + load3(s + 3 * j);
    a1 = a1 + load3(s + 3 * (j + 1));
    a2 = a2 + load3(s + 3 * (j + 2));
    a3 = a3 + load3(s + 3 * (j + 3));
  }
  if (j < k) a0 = a0 + load3(s + 3 * j);
  if (j + 1 < k) a1 = a1 + load3(s + 3 * (j + 1));
  if (j + 2 < k) a2 = a2 + load3(s + 3 * (j + 2));
  return ((a0 + a1) + a2) + a3;
}

// pass_backplate at frame pixel (x, y): the pixel centre's direction,
// probe_sampling.dir_to_uv, probe_eval's nearest texel
__device__ __forceinline__ V3 backplate(const FilmArgs& a, int x, int y) {
  const V3 d = camera_dir(a.u, a.v, a.w, (float)x + 0.5f, (float)y + 0.5f,
                          a.width, a.height);
  const float theta = acosf(clamp2(d.y, -1.0f, 1.0f));
  const float phi = (d.x == 0.0f && d.z == 0.0f) ? 0.0f : atan2f(d.z, d.x);
  const float u = (phi + kPi) * (1.0f / kTwoPi);
  const float v = theta * (1.0f / kPi);
  int64_t px = (int64_t)(u * (float)a.probe_w);
  int64_t py = (int64_t)(v * (float)a.probe_h);
  px = px < 0 ? 0 : px > a.probe_w - 1 ? a.probe_w - 1 : px;
  py = py < 0 ? 0 : py > a.probe_h - 1 ? a.probe_h - 1 : py;
  return load3(a.probe + 3 * (py * a.probe_w + px));
}

// tonemap.make_color of one channel: sRGB of the clamped value, quantized
__device__ __forceinline__ uint8_t to_u8(float c) {
  const float t = clamp2(clamp2(c, 0.0f, 1.0f), 0.0f, 1.0f);
  const float powed = powf(clamp_lo(t, F(1e-10)), F(1.0 / 2.4));
  const float s = t < F(0.0031308) ? t * F(12.92)
                                   : powed * F(1.055) - F(0.055);
  const int64_t q = (int64_t)(clamp2(s, 0.0f, 1.0f) * 256.0f);
  return (uint8_t)(q > 255 ? 255 : q);
}

__global__ void __launch_bounds__(kTileW * kTileH)
    film_kernel(const __grid_constant__ FilmArgs a) {
  const int x = a.box_x0 + blockIdx.x * kTileW + threadIdx.x;
  const int y = a.box_y0 + blockIdx.y * kTileH + threadIdx.y;
  if (x >= a.box_x1 || y >= a.box_y1) return;
  float* out = a.canvas + 3 * ((int64_t)y * a.canvas_w + x);
  V3 val = load3(out);
  bool wrote = false;
  for (int i = 0; i < a.num_passes; ++i) {
    const FilmPass& fp = a.passes[i];
    const PassGrid& p = fp.grid;
    const int rx = x - (a.pad + p.ox), ry = y - (a.pad + p.oy);
    if (rx < 0 || ry < 0 || rx >= p.lw * p.factor || ry >= p.lh * p.factor)
      continue;
    const int lx = rx / p.factor, ly = ry / p.factor;
    const int fx = lx * p.factor + p.ox, fy = ly * p.factor + p.oy;
    if (!in_ring(p, fx, fy, a.gaze_x, a.gaze_y)) continue;
    const int64_t slots = 3 * ((int64_t)ly * p.lw + lx) * p.spp;
    const V3 rad = slot_sum(fp.radiance + slots, p.spp);
    const V3 alpha = slot_sum(fp.alpha + slots, p.spp);
    const V3 bp = backplate(a, fx, fy);
    // film.shade_to_accum_color: (backplate * spp * (1 - alpha_sum / spp)
    // + rad_sum) / spp
    const float spp = (float)p.spp, inv = 1.0f / spp;
    const V3 c = {((bp.x * spp) * (1.0f - alpha.x * inv) + rad.x) * inv,
                  ((bp.y * spp) * (1.0f - alpha.y * inv) + rad.y) * inv,
                  ((bp.z * spp) * (1.0f - alpha.z * inv) + rad.z) * inv};
    // film.composite_pass: prev + (new - prev) * a, or new
    val = fp.blend ? V3{val.x + (c.x - val.x) * fp.lerp,
                        val.y + (c.y - val.y) * fp.lerp,
                        val.z + (c.z - val.z) * fp.lerp}
                   : c;
    wrote = true;
  }
  if (wrote) {
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
  }
  const int cx = x - a.pad, cy = y - a.pad;
  if (cx < 0 || cy < 0 || cx >= a.width || cy >= a.height) return;
  // film.finalize: tonemap.postprocess of the cropped canvas
  V3 c = val;
  if (a.exposure_on) c = c * a.exposure_scale;
  if (a.tonemap_on) {  // reinhard: c / (1 + lum(c) / white)
    const float lum = (c.x * F(0.2126) + c.y * F(0.7152)) + c.z * F(0.0722);
    const float den = lum * a.inv_white + 1.0f;
    c = {c.x / den, c.y / den, c.z / den};
  }
  uint8_t* px = a.frame + 3 * ((int64_t)cy * a.width + cx);
  px[0] = to_u8(c.x);
  px[1] = to_u8(c.y);
  px[2] = to_u8(c.z);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Launch raygen_kernel over a->n rays on `stream`; returns
// cudaGetLastError.
extern "C" int fov_raygen(const RaygenArgs* a, cudaStream_t stream) {
  if (a->n < 0 || a->num_passes < 1 || a->num_passes > kMaxPasses)
    return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  raygen_kernel<<<blocks_for(a->n), kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launch film_kernel over the canvas box of `a` on `stream`.
extern "C" int fov_film(const FilmArgs* a, cudaStream_t stream) {
  if (a->num_passes < 1 || a->num_passes > kMaxPasses ||
      a->box_x0 < 0 || a->box_y0 < 0 || a->box_x1 > a->canvas_w ||
      a->box_y1 > a->canvas_h)
    return (int)cudaErrorInvalidValue;
  const int bw = a->box_x1 - a->box_x0, bh = a->box_y1 - a->box_y0;
  if (bw <= 0 || bh <= 0) return 0;
  const dim3 grid((bw + kTileW - 1) / kTileW, (bh + kTileH - 1) / kTileH);
  film_kernel<<<grid, dim3(kTileW, kTileH), 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Registers, local memory per thread, resident blocks per SM and the
// threads a block of kernel `which` (raygen 0, film 1).
extern "C" int fov_frame_info(int which, int* regs, int* local_bytes,
                              int* blocks_per_sm, int* threads) {
  const void* fn = which == 0   ? (const void*)raygen_kernel
                   : which == 1 ? (const void*)film_kernel
                                : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int block = which == 0 ? kThreads : kTileW * kTileH;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = block;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            block, 0);
}

// The argument structs' sizes in this build, for ops/frame.py's ctypes
// layouts to be held to.
extern "C" int fov_frame_sizes(int* raygen_args, int* film_args) {
  *raygen_args = (int)sizeof(RaygenArgs);
  *film_args = (int)sizeof(FilmArgs);
  return 0;
}
