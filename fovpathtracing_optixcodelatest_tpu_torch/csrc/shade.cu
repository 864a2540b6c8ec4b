// The shading of one bounce of the path tracer in two kernels: everything
// between K1's closest hits and the state arrays' update.
//
// Replaces: the plain-PyTorch body of render/integrator.py bounce() and the
// scatter of its results in trace_paths (the plain bounce stays there, as
// these kernels' plain version). One thread a live lane, each kernel one
// launch a bounce:
//
// - shade_kernel (after K1 and the catcher pass-through): the hit's
//   tri_pack row (normal, uvs, texture id, material columns), on a
//   two-level table the world normal, face_forward, the bilinear-wrap
//   texture sample, the lane's 8 uniforms (the lowbias32 counter hash),
//   the probe's alias sample, the NEE bsdf_pdf / bsdf_eval with the MIS
//   weight, basis_from_vector and bsdf_sample, the BSDF at the sampled
//   direction, and the occlusion query mask (with the catcher rule). It
//   writes K2's inputs (p, wi, query) and a record of what resolve needs.
// - resolve_kernel (after K2): the NEE contribution, the primary hit's
//   emission, the catcher's alpha, the throughput, eta and direction
//   updates and the alive flag, scattered in place into the full-size
//   state arrays at the lane's index; the bounce's occlusion queries and
//   its lanes are added to `traces` on the device.
//
// Over a wavefront's lane list (render/integrator.py trace_paths on the
// card) both kernels take the list's length from the device (`count`,
// written by csrc/lanes.cu's compaction) and their grids are sized for the
// list's capacity n, the record's row stride; lanes past the count return.
//
// Same arithmetic: every expression is written in the order of
// ops/bsdf.py, ops/sampling.py, ops/probe_sampling.py, ops/rng.py and
// models/texture.py, one IEEE float32 operation for each PyTorch op (the
// library is built with --fmad=false, IEEE division and square root), with
// the same clamps (NaN passes through torch.clamp, as here) and the same
// selections. Where PyTorch computes every branch and selects with a mask,
// a thread computes the selected branch only, which gives the same value.
// A Python float constant is the double rounded to float32, as PyTorch
// converts a scalar operand (F below); a tensor divided by a Python number
// is multiplied by the scalar's float32 reciprocal, as PyTorch does on the
// card. A lane whose ray missed skips the shading: the plain bounce
// computes it and then masks every use of it.
//
// The record (SoA, kRec rows of n floats) holds, per lane: light_val (3),
// the sampled direction (3), thr_scale (3), out_eta, the emitted radiance
// (3, zero weight off primary hits), the flags (int bits), and at depth 0
// the normal (3) and albedo (3).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "rng.cuh"
#include "vec.cuh"

namespace {

constexpr double kPiD = 3.141592653589793;
constexpr float kPi = F(kPiD);
constexpr float kTwoPi = F(6.283185307179586);
constexpr float kInvPi = F(1.0 / kPiD);
constexpr float kInv2Pi = F(0.5 / kPiD);
constexpr float kTwoPiPi = F(2.0 * kPiD * kPiD);
constexpr int kThreads = 256;

// record rows
constexpr int kLight = 0, kDir = 3, kThr = 6, kEta = 9, kEmit = 10,
              kFlags = 13, kNormal = 14, kAlbedo = 17, kRec = 20;
// flag bits
constexpr int kHit = 1, kSampleOk = 2, kCatcher = 4, kTransmitted = 8;

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// local_to_world(d, u, v, n)
__device__ __forceinline__ V3 to_world(V3 d, V3 u, V3 v, V3 n) {
  return {(u.x * d.x + v.x * d.y) + n.x * d.z,
          (u.y * d.x + v.y * d.y) + n.y * d.z,
          (u.z * d.x + v.z * d.y) + n.z * d.z};
}

__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float length2 = dot(v, v);
  const float inv =
      length2 > F(1e-20) ? 1.0f / sqrtf(clamp_lo(length2, F(1e-20))) : 0.0f;
  return v * inv;
}

__device__ __forceinline__ float schlick_fresnel(float u) {
  const float m = clamp2(1.0f - u, 0.0f, 1.0f);
  const float m2 = m * m;
  return m2 * m2 * m;
}

__device__ __forceinline__ float fresnel_dielectric(float v_dot_n,
                                                    float eta_i,
                                                    float eta_t) {
  const float r = eta_i / eta_t;
  const float sin2_t = r * r * (1.0f - v_dot_n * v_dot_n);
  const float l_dot_n =
      sqrtf(clamp_lo(1.0f - clamp_hi(sin2_t, 1.0f), 0.0f));
  const float eta = eta_t / eta_i;
  const float denom1 = v_dot_n + eta * l_dot_n;
  const float denom2 = l_dot_n + eta * v_dot_n;
  const float r1 = (v_dot_n - eta * l_dot_n) /
                   (fabsf(denom1) < F(1e-12) ? F(1e-12) : denom1);
  const float r2 = (l_dot_n - eta * v_dot_n) /
                   (fabsf(denom2) < F(1e-12) ? F(1e-12) : denom2);
  const float f = 0.5f * (r1 * r1 + r2 * r2);
  return sin2_t > 1.0f ? 1.0f : f;
}

__device__ __forceinline__ float gtr1(float n_dot_h, float a) {
  if (a >= 1.0f) return kInvPi;
  const float a2 = a * a;
  const float t = (a2 - 1.0f) * n_dot_h * n_dot_h + 1.0f;
  const float safe_log = logf(clamp2(a2, F(1e-8), F(0.999999)));
  return (a2 - 1.0f) / (kPi * safe_log * (t == 0.0f ? F(1e-8) : t));
}

__device__ __forceinline__ float gtr2(float n_dot_h, float a) {
  const float a2 = a * a;
  const float t = (a2 - 1.0f) * n_dot_h * n_dot_h + 1.0f;
  return a2 / (kPi * clamp_lo(t * t, F(1e-12)));
}

__device__ __forceinline__ float smith_ggx(float n_dot_v, float alpha_g) {
  const float a = alpha_g * alpha_g;
  const float b = n_dot_v * n_dot_v;
  return 1.0f /
         clamp_lo(n_dot_v + sqrtf(clamp_lo(a + b - a * b, 0.0f)), F(1e-8));
}

// the material columns of a tri_pack row (models/material.py)
struct Mat {
  V3 color, emission;
  float eta, metallic, subsurface, specular, roughness, specular_tint,
      clearcoat, clearcoat_gloss, transmission;
  int flags;
};

__device__ __forceinline__ float bsdf_pdf(const Mat& m, float eta_i,
                                          float eta_o, V3 n, V3 view,
                                          V3 light) {
  const float n_dot_l = dot(light, n);
  float brdf_p, bsdf_p;
  if (n_dot_l <= 0.0f) {
    brdf_p = kInv2Pi * m.subsurface * 0.5f;
    bsdf_p = 0.0f;
  } else {
    const float f = fresnel_dielectric(dot(n, view), eta_i, eta_o);
    const float a = clamp_lo(m.roughness, F(0.001));
    const V3 half = safe_normalize(light + view);
    const float cos_theta_half = fabsf(dot(half, n));
    const float pdf_half = gtr2(cos_theta_half, a) * cos_theta_half;
    const float pdf_spec =
        0.25f * pdf_half / clamp_lo(dot(light, half), F(1e-6));
    const float pdf_diff = fabsf(n_dot_l) * kInvPi * (1.0f - m.subsurface);
    bsdf_p = pdf_spec * f;
    brdf_p = 0.5f * (pdf_diff + pdf_spec);
  }
  return brdf_p + m.transmission * (bsdf_p - brdf_p);
}

__device__ __forceinline__ V3 bsdf_eval(const Mat& m, V3 albedo,
                                        float eta_i, float eta_o, V3 n,
                                        V3 view, V3 light) {
  const float n_dot_l = dot(light, n);
  const float n_dot_v = dot(n, view);
  const V3 h = safe_normalize(light + view);
  const float n_dot_h = dot(n, h);
  const float l_dot_h = dot(light, h);

  const V3 cdlin = albedo;
  const float cdlum =
      F(0.3) * cdlin.x + F(0.6) * cdlin.y + F(0.1) * cdlin.z;
  V3 ctint = {1.0f, 1.0f, 1.0f};
  if (cdlum > 0.0f) {
    const float c = clamp_lo(cdlum, F(1e-8));
    ctint = {cdlin.x / c, cdlin.y / c, cdlin.z / c};
  }
  const float s08 = m.specular * F(0.08);
  const V3 dielec = {s08 * (m.specular_tint * (ctint.x - 1.0f) + 1.0f),
                     s08 * (m.specular_tint * (ctint.y - 1.0f) + 1.0f),
                     s08 * (m.specular_tint * (ctint.z - 1.0f) + 1.0f)};
  const V3 cspec0 = {dielec.x + m.metallic * (cdlin.x - dielec.x),
                     dielec.y + m.metallic * (cdlin.y - dielec.y),
                     dielec.z + m.metallic * (cdlin.z - dielec.z)};

  const bool below = n_dot_l <= 0.0f;
  const float a = clamp_lo(m.roughness, F(0.001));
  float gs = 0.0f, ds = 0.0f;
  if (!below) {
    ds = gtr2(n_dot_h, a);
    gs = smith_ggx(n_dot_v, a) * smith_ggx(n_dot_l, a);
  }

  // transmission side
  V3 bsdf_side = {0.0f, 0.0f, 0.0f};
  if (m.transmission > 0.0f) {
    if (below) {
      const float f_v = fresnel_dielectric(n_dot_v, eta_i, eta_o);
      const float b = m.transmission * (1.0f - f_v) /
                      clamp_lo(fabsf(n_dot_l), F(1e-6)) *
                      (1.0f - m.metallic);
      bsdf_side = {b, b, b};
    } else {
      const float fh_dielec = fresnel_dielectric(l_dot_h, eta_i, eta_o);
      const float g = gs * ds;
      bsdf_side = {g * (cspec0.x + fh_dielec * (1.0f - cspec0.x)),
                   g * (cspec0.y + fh_dielec * (1.0f - cspec0.y)),
                   g * (cspec0.z + fh_dielec * (1.0f - cspec0.z))};
    }
  }

  // reflection side
  V3 brdf_side = {0.0f, 0.0f, 0.0f};
  if (m.transmission < 1.0f) {
    const float fv = schlick_fresnel(n_dot_v);
    if (below) {
      if (m.subsurface > 0.0f) {
        const float fl_abs = schlick_fresnel(fabsf(n_dot_l));
        const float fd_ss = (1.0f - 0.5f * fl_abs) * (1.0f - 0.5f * fv);
        const float k =
            (m.subsurface * fd_ss * (1.0f - m.metallic)) * kInvPi;
        brdf_side = {k * sqrtf(clamp_lo(m.color.x, 0.0f)),
                     k * sqrtf(clamp_lo(m.color.y, 0.0f)),
                     k * sqrtf(clamp_lo(m.color.z, 0.0f))};
      }
    } else {
      const float fh = schlick_fresnel(l_dot_h);
      const float fl = schlick_fresnel(n_dot_l);
      const float fd90 = 2.0f * l_dot_h * l_dot_h * m.roughness + 0.5f;
      const float fd =
          (fl * (fd90 - 1.0f) + 1.0f) * (fv * (fd90 - 1.0f) + 1.0f);
      const float dr =
          gtr1(n_dot_h, m.clearcoat_gloss * F(0.001 - 0.1) + F(0.1));
      const float fc = fh * F(1.0 - 0.04) + F(0.04);
      const float gr = smith_ggx(n_dot_l, 0.25f) * smith_ggx(n_dot_v, 0.25f);
      const float kd =
          fd * kInvPi * (1.0f - m.metallic) * (1.0f - m.subsurface);
      const float g = gs * ds;
      const float cc = m.clearcoat * gr * fc * dr;
      brdf_side = {
          (kd * cdlin.x + g * (cspec0.x + fh * (1.0f - cspec0.x))) + cc,
          (kd * cdlin.y + g * (cspec0.y + fh * (1.0f - cspec0.y))) + cc,
          (kd * cdlin.z + g * (cspec0.z + fh * (1.0f - cspec0.z))) + cc};
    }
  }
  return {brdf_side.x + m.transmission * (bsdf_side.x - brdf_side.x),
          brdf_side.y + m.transmission * (bsdf_side.y - brdf_side.y),
          brdf_side.z + m.transmission * (bsdf_side.z - brdf_side.z)};
}

// bsdf_sample with the uniforms [branch_t, branch_f, branch_half,
// branch_ss, r1, r2] -> (light, pdf)
__device__ __forceinline__ void bsdf_sample(const Mat& m, float eta_i,
                                            float eta_o, V3 u, V3 v, V3 n,
                                            V3 view, float u_t, float u_f,
                                            float u_half, float u_ss,
                                            float r1, float r2, V3& light,
                                            float& pdf) {
  const float f = fresnel_dielectric(dot(n, view), eta_i, eta_o);
  const bool trans_branch = u_t < m.transmission;
  const bool spec_in_trans = u_f < f;
  const bool diffuse_half = u_half < 0.5f;
  const bool ss_pick = u_ss < m.subsurface;
  bool spec;
  if (trans_branch) {
    spec = spec_in_trans;
  } else {
    spec = !diffuse_half;
  }
  if (spec) {
    // _sample_ggx_half, then reflect(view, half)
    const float a = clamp_lo(m.roughness, F(0.001));
    const float phi = r1 * kTwoPi;
    const float cos_th = sqrtf(
        clamp2((1.0f - r2) / ((a * a - 1.0f) * r2 + 1.0f), 0.0f, 1.0f));
    const float sin_th = sqrtf(clamp_lo(1.0f - cos_th * cos_th, 0.0f));
    V3 half = to_world({sin_th * cosf(phi), sin_th * sinf(phi), cos_th}, u,
                       v, n);
    if (dot(half, view) <= 0.0f) half = neg(half);
    const float k = 2.0f * dot(view, half);
    light = {k * half.x - view.x, k * half.y - view.y, k * half.z - view.z};
  } else if (trans_branch) {
    // refract(view, n, eta_i / eta_o)
    const float eta = eta_i / eta_o;
    const float cos_i = dot(n, view);
    const float sin2_i = clamp_lo(1.0f - cos_i * cos_i, 0.0f);
    const float sin2_t = eta * eta * sin2_i;
    const float cos_t = sqrtf(clamp_lo(1.0f - sin2_t, 0.0f));
    const float s = eta * cos_i - cos_t;
    light = {eta * -view.x + s * n.x, eta * -view.y + s * n.y,
             eta * -view.z + s * n.z};
    pdf = sin2_t < 1.0f ? (1.0f - f) * m.transmission : 0.0f;
    return;
  } else if (ss_pick) {
    // uniform_sample_hemisphere, below the surface
    const float w = sqrtf(clamp_lo(1.0f - r1 * r1, 0.0f));
    const float phi = r2 * kTwoPi;
    const V3 d = {cosf(phi) * w, sinf(phi) * w, r1};
    light = {(u.x * d.x + v.x * d.y) - n.x * d.z,
             (u.y * d.x + v.y * d.y) - n.y * d.z,
             (u.z * d.x + v.z * d.y) - n.z * d.z};
  } else {
    // cosine_sample_hemisphere
    const float r = sqrtf(r1);
    const float theta = r2 * kTwoPi;
    const float s0 = r * cosf(theta), s1 = r * sinf(theta);
    const float z = sqrtf(clamp_lo(1.0f - s0 * s0 - s1 * s1, 0.0f));
    light = to_world({s0, s1, z}, u, v, n);
  }
  pdf = bsdf_pdf(m, eta_i, eta_o, n, view, light);
}

// torch.remainder on int64: the sign of the divisor
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

}  // namespace

// The C interface's arguments; ops/shade.py packs the same fields in the
// same order (ctypes.Structure). Pointers first, then 32-bit fields.
struct ShadeArgs {
  const int64_t* idx;       // (n,) lanes' indices into the state arrays
  const float* o;           // (n, 3) the lanes' origins (after pass-through)
  const float* d;           // (n, 3)
  const float* t;           // (n,) K1's answer
  const float* hu;
  const float* hv;
  const int32_t* tri;
  const bool* hit;
  const int32_t* inst;      // (n,) on a two-level table, else null
  const float* eta;         // (N,) state
  const int64_t* ray_ids;   // (N,)
  const float* tri_pack;    // (T, tri_cols)
  const float* table;       // BVH rows (the instance rows' inverse transforms)
  const float* tex_data;    // (K, tex_h, tex_w, 3), or null
  const int64_t* tex_sizes; // (K, 2) width, height
  const float* probe_rows;  // (H*W, 13), or null
  const float* alias_prob;  // (H*W,) where probe_rows is null
  const int64_t* alias_idx;
  const float* pdf_flat;
  const float* probe_data;  // (H, W, 3)
  float* p_out;             // (n, 3) K2's origins
  float* wi_out;            // (n, 3) K2's directions
  bool* query;              // (n,) K2's mask
  float* rec;               // (kRec, n)
  const int32_t* count;     // () the lanes to shade, at most n; null: n
  int n, rec_rows, tri_cols, table_cols, inst_base;
  int tex_count, tex_h, tex_w, probe_w, probe_h;
  unsigned key0, key1;
  int primary, has_textures, has_catcher, instanced, catcher_bit;
  int col_tex, col_color, col_emission, col_eta, col_metallic,
      col_subsurface, col_specular, col_roughness, col_specular_tint,
      col_clearcoat, col_clearcoat_gloss, col_transmission, col_flags;
};

struct ResolveArgs {
  const int64_t* idx;  // (n,)
  const float* rec;    // (kRec, n)
  const float* p;      // (n, 3)
  const bool* occ;     // (n,) K2's answer
  const bool* query;   // (n,)
  float* o;            // (N, 3) state, updated in place
  float* d;
  float* throughput;
  float* eta;          // (N,)
  float* radiance;     // (N, 3)
  float* alpha;
  float* normal;
  float* albedo;
  bool* alive;         // (n,) out
  long long* traces;   // () int64, added to
  const int32_t* count;  // () the lanes to resolve, at most n; null: n
  int n, rec_rows, primary, has_catcher;
};

namespace {

__global__ void __launch_bounds__(kThreads, 2)
    shade_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lane_count(a.n, a.count)) return;
  const int n = a.n;  // the record's row stride
  float* rec = a.rec;
  const int64_t j = a.idx[i];
  const V3 o = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
  const V3 d = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
  const bool hit = a.hit[i];

  // the lane's 8 uniforms (ops/rng.py ray_uniform_cols): stream s of the
  // counter hash keyed by the bounce key's two words and the ray id
  const uint32_t base = ray_hash(a.ray_ids[j], a.key0, a.key1);
  const auto uniform = [base](uint32_t s) { return ray_uniform(base, s); };

  // probe_sample(probe, uniform(0), uniform(1))
  V3 wi, sky_col;
  float sky_pdf;
  {
    const int w = a.probe_w, h = a.probe_h;
    const int64_t k = (int64_t)w * h;
    int64_t cand = (int64_t)(uniform(0) * (float)k);
    cand = cand < k - 1 ? cand : k - 1;
    float u, v, pdf;
    if (a.probe_rows != nullptr) {
      const float* g = a.probe_rows + cand * 13;
      const bool accept = uniform(1) < g[0];
      const int c = accept ? 1 : 7;
      u = g[c];
      v = g[c + 1];
      pdf = g[c + 2];
      sky_col = {g[c + 3], g[c + 4], g[c + 5]};
    } else {
      const bool accept = uniform(1) < a.alias_prob[cand];
      const int64_t lin = accept ? cand : a.alias_idx[cand];
      const int64_t row = lin / w;
      const int64_t col = lin - row * w;
      const float* c = a.probe_data + 3 * lin;
      sky_col = {c[0], c[1], c[2]};
      pdf = a.pdf_flat[lin];
      u = (float)col * (1.0f / (float)w);
      v = (float)row * (1.0f / (float)h);
    }
    const float theta = v * kPi;
    const float sin_theta = sinf(theta);
    sky_pdf = sin_theta == 0.0f
                  ? 0.0f
                  : pdf * (float)w * (float)h / (kTwoPiPi * sin_theta);
    const float phi = u * kTwoPi;
    wi = {-sin_theta * cosf(phi), cosf(theta), -sin_theta * sinf(phi)};
  }
  a.wi_out[3 * i] = wi.x;
  a.wi_out[3 * i + 1] = wi.y;
  a.wi_out[3 * i + 2] = wi.z;

  if (!hit) {
    a.p_out[3 * i] = o.x;
    a.p_out[3 * i + 1] = o.y;
    a.p_out[3 * i + 2] = o.z;
    a.query[i] = false;
    rec[kFlags * n + i] = __int_as_float(0);
    return;
  }

  const float t = a.t[i];
  const V3 p = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  a.p_out[3 * i] = p.x;
  a.p_out[3 * i + 1] = p.y;
  a.p_out[3 * i + 2] = p.z;

  const int tri = a.tri[i] > 0 ? a.tri[i] : 0;
  const float* row = a.tri_pack + (int64_t)tri * a.tri_cols;
  V3 ng = {row[0], row[1], row[2]};
  if (a.instanced) {
    // _world_normal: A^T n over the instance row's inverse transform
    const int inst = a.inst[i] > 0 ? a.inst[i] : 0;
    const float* am =
        a.table + ((int64_t)a.inst_base + inst) * a.table_cols + 1;
    const V3 w = {(am[0] * ng.x + am[3] * ng.y) + am[6] * ng.z,
                  (am[1] * ng.x + am[4] * ng.y) + am[7] * ng.z,
                  (am[2] * ng.x + am[5] * ng.y) + am[8] * ng.z};
    // torch.linalg.vector_norm's reduction over 3 entries on the card:
    // two threads, the first summing entries 0 and 2
    const float len =
        clamp_lo(sqrtf((w.x * w.x + w.z * w.z) + w.y * w.y), F(1e-20));
    ng = {w.x / len, w.y / len, w.z / len};
  }
  const V3 view = neg(d);
  const V3 nrm = dot(ng, view) < 0.0f ? neg(ng) : ng;

  Mat m;
  m.color = {row[a.col_color], row[a.col_color + 1], row[a.col_color + 2]};
  m.emission = {row[a.col_emission], row[a.col_emission + 1],
                row[a.col_emission + 2]};
  m.eta = row[a.col_eta];
  m.metallic = row[a.col_metallic];
  m.subsurface = row[a.col_subsurface];
  m.specular = row[a.col_specular];
  m.roughness = row[a.col_roughness];
  m.specular_tint = row[a.col_specular_tint];
  m.clearcoat = row[a.col_clearcoat];
  m.clearcoat_gloss = row[a.col_clearcoat_gloss];
  m.transmission = row[a.col_transmission];
  m.flags = __float_as_int(row[a.col_flags]);

  V3 albedo = m.color;
  if (a.has_textures) {
    const int tex_id = __float_as_int(row[a.col_tex]);
    if (tex_id >= 0) {
      // hit_uv, then sample_bilinear_wrap
      const float bu = a.hu[i], bv = a.hv[i];
      const float wa = 1.0f - bu - bv;
      const float uu = (wa * row[3] + bu * row[5]) + bv * row[7];
      const float vv = (wa * row[4] + bu * row[6]) + bv * row[8];
      const int64_t id = tex_id < a.tex_count - 1 ? tex_id : a.tex_count - 1;
      const int64_t tw = a.tex_sizes[2 * id], th = a.tex_sizes[2 * id + 1];
      const float x = uu * (float)tw - 0.5f;
      const float y = vv * (float)th - 0.5f;
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      const int64_t x0i = (int64_t)x0, y0i = (int64_t)y0;
      const int64_t xa = floor_mod(x0i, tw);
      const int64_t xb = floor_mod((int64_t)((uint64_t)x0i + 1), tw);
      const int64_t ya = floor_mod(y0i, th);
      const int64_t yb = floor_mod((int64_t)((uint64_t)y0i + 1), th);
      const int64_t base = id * a.tex_h;
      const float* c00 = a.tex_data + ((base + ya) * a.tex_w + xa) * 3;
      const float* c10 = a.tex_data + ((base + ya) * a.tex_w + xb) * 3;
      const float* c01 = a.tex_data + ((base + yb) * a.tex_w + xa) * 3;
      const float* c11 = a.tex_data + ((base + yb) * a.tex_w + xb) * 3;
      const auto lerp = [fx, fy, c00, c10, c01, c11](int c) {
        const float top = c00[c] * (1.0f - fx) + c10[c] * fx;
        const float bot = c01[c] * (1.0f - fx) + c11[c] * fx;
        return top * (1.0f - fy) + bot * fy;
      };
      albedo = {lerp(0), lerp(1), lerp(2)};
    }
  }
  const float eta_in = a.eta[j];
  const float out_eta = eta_in == 1.0f ? m.eta : 1.0f;

  // probe NEE with MIS
  const float nee_pdf = bsdf_pdf(m, eta_in, out_eta, nrm, view, wi);
  const float denom = 0.5f * nee_pdf + 0.5f * sky_pdf;
  const float weight =
      denom > 0.0f ? 0.5f * sky_pdf / clamp_lo(denom, F(1e-20)) : 0.0f;
  V3 light_val = {0.0f, 0.0f, 0.0f};
  bool any_light = false;
  if (nee_pdf > 0.0f && weight > 0.0f && sky_pdf > 0.0f) {
    const V3 nee_f = bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, wi);
    const float c = fabsf(dot(wi, nrm));
    const float s = clamp_lo(sky_pdf, F(1e-20));
    light_val = {weight * sky_col.x * nee_f.x * c / s,
                 weight * sky_col.y * nee_f.y * c / s,
                 weight * sky_col.z * nee_f.z * c / s};
    // light_val.amax(dim=1) > 0: a NaN entry makes the maximum NaN
    any_light = !(isnan(light_val.x) || isnan(light_val.y) ||
                  isnan(light_val.z)) &&
                fmaxf(fmaxf(light_val.x, light_val.y), light_val.z) > 0.0f;
  }

  // basis_from_vector(nrm)
  V3 uf;
  if (fabsf(nrm.x) > fabsf(nrm.y)) {
    const float inv =
        1.0f / sqrtf(clamp_lo(nrm.x * nrm.x + nrm.z * nrm.z, F(1e-20)));
    uf = {-nrm.z * inv, 0.0f, nrm.x * inv};
  } else {
    const float inv =
        1.0f / sqrtf(clamp_lo(nrm.y * nrm.y + nrm.z * nrm.z, F(1e-20)));
    uf = {0.0f, nrm.z * inv, -nrm.y * inv};
  }
  const V3 vf = cross(nrm, uf);
  V3 l_dir;
  float pdf;
  bsdf_sample(m, eta_in, out_eta, uf, vf, nrm, view, uniform(2), uniform(3),
              uniform(4), uniform(5), uniform(6), uniform(7), l_dir, pdf);
  const bool sample_ok = pdf > 0.0f;
  const bool is_catcher =
      a.has_catcher && (m.flags & a.catcher_bit) != 0;
  a.query[i] = any_light && (sample_ok || is_catcher);

  const V3 f_b = bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, l_dir);
  const float c = fabsf(dot(nrm, l_dir));
  const float s = clamp_lo(pdf, F(1e-20));
  const float e = a.primary ? 1.0f : 0.0f;
  const int flags = kHit | (sample_ok ? kSampleOk : 0) |
                    (is_catcher ? kCatcher : 0) |
                    (dot(l_dir, nrm) <= 0.0f ? kTransmitted : 0);
  const auto put = [rec, n, i](int row, V3 v) {
    rec[row * n + i] = v.x;
    rec[(row + 1) * n + i] = v.y;
    rec[(row + 2) * n + i] = v.z;
  };
  put(kLight, light_val);
  put(kDir, l_dir);
  put(kThr, {f_b.x * c / s, f_b.y * c / s, f_b.z * c / s});
  rec[kEta * n + i] = out_eta;
  put(kEmit, {e * m.emission.x, e * m.emission.y, e * m.emission.z});
  rec[kFlags * n + i] = __int_as_float(flags);
  if (a.primary) {
    put(kNormal, nrm);
    put(kAlbedo, albedo);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    resolve_kernel(const ResolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lanes = lane_count(a.n, a.count);
  const bool q = i < lanes && a.query[i];
  // the bounce's occlusion queries, and its lanes once, into traces
  const unsigned queries = __popc(__ballot_sync(0xFFFFFFFFu, q));
  if ((threadIdx.x & 31) == 0) {
    unsigned long long add = queries;
    if (i == 0) add += (unsigned long long)lanes;
    if (add) atomicAdd((unsigned long long*)a.traces, add);
  }
  if (i >= lanes) return;
  const int n = a.n;  // the record's row stride
  const float* rec = a.rec;
  const int64_t j = a.idx[i];
  const int flags = __float_as_int(rec[kFlags * n + i]);
  const bool hit = flags & kHit;
  const bool cont = hit && (flags & kSampleOk);
  const bool catcher = flags & kCatcher;
  const bool occ = a.occ[i];
  float* thr = a.throughput + 3 * j;
  float* rad = a.radiance + 3 * j;
  float* alpha = a.alpha + 3 * j;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t = thr[c];
    float light = 0.0f;
    if (hit) light = rec[(kLight + c) * n + i];
    float contrib = 0.0f;
    if (cont) {
      const float nee = occ ? 0.0f : light;
      const float emitted = rec[(kEmit + c) * n + i];
      contrib = (a.has_catcher ? (catcher ? 0.0f : t * nee) : t * nee) +
                emitted;
    }
    rad[c] = rad[c] + contrib;
    if (a.has_catcher) {
      const float add = hit && catcher ? t * (occ ? light : 0.0f) : 0.0f;
      const float kept = alpha[c] + add;
      alpha[c] = hit && !catcher ? 1.0f : kept;
    } else if (hit) {
      alpha[c] = 1.0f;
    }
    if (cont) thr[c] = t * rec[(kThr + c) * n + i];
    a.o[3 * j + c] = a.p[3 * i + c];
    if (hit) a.d[3 * j + c] = rec[(kDir + c) * n + i];
    if (a.primary) {
      a.normal[3 * j + c] = hit ? rec[(kNormal + c) * n + i] : 0.0f;
      a.albedo[3 * j + c] = hit ? rec[(kAlbedo + c) * n + i] : 0.0f;
    }
  }
  if (hit && (flags & kTransmitted)) a.eta[j] = rec[kEta * n + i];
  a.alive[i] = cont;
}

const void* kernel_of(int which) {
  return which == 0 ? (const void*)shade_kernel
                    : which == 1 ? (const void*)resolve_kernel : nullptr;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Launch shade_kernel over a->n lanes on `stream`; returns cudaGetLastError.
extern "C" int fov_shade(const ShadeArgs* a, cudaStream_t stream) {
  if (a->rec_rows != kRec || a->n < 0) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  shade_kernel<<<blocks_for(a->n), kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launch resolve_kernel over a->n lanes on `stream`.
extern "C" int fov_resolve(const ResolveArgs* a, cudaStream_t stream) {
  if (a->rec_rows != kRec || a->n < 0) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  resolve_kernel<<<blocks_for(a->n), kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Registers, local memory per thread, resident blocks per SM at kThreads
// threads and the threads a block of kernel `which` (shade 0, resolve 1).
extern "C" int fov_shade_info(int which, int* regs, int* local_bytes,
                              int* blocks_per_sm, int* threads) {
  const void* fn = kernel_of(which);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            kThreads, 0);
}
