// Möller-Trumbore ray/triangle test shared by the traversal kernels.
//
// The expression order is the JAX package's (ops/traverse8.py _leaf_hits and
// ops/pallas_traverse.py _occlusion_kernel): each cross-product term and each
// three-term sum is evaluated left to right with one rounding per operation.
// The kernels are built with --fmad=false, so nothing is contracted to FMA
// and t/u/v come out bit-identical to the plain PyTorch versions, which
// apply the same operations one tensor op at a time.
#pragma once

#define FOV_INF __int_as_float(0x7f800000)

struct TriHit {
  bool hit;
  float t, u, v;
};

// tri = [v0 (3), e1 (3), e2 (3)]; cull keeps only det > 1e-9 (back faces
// culled), otherwise |det| > 1e-9.
__device__ __forceinline__ TriHit tri_test(const float* tri, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float tmin, float tmax,
                                           bool cull) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = cull ? (det > 1e-9f) : (fabsf(det) > 1e-9f);
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  TriHit r;
  r.u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  r.v = (dx * qx + dy * qy + dz * qz) * inv_det;
  r.t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  r.hit = det_ok && r.u >= 0.0f && r.v >= 0.0f && r.u + r.v <= 1.0f &&
          r.t >= tmin && r.t <= tmax;
  return r;
}

// The traversals' safe inverse direction: |d| < 1e-12 becomes +-1e-12.
__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / s;
}

// Slab test of one box against the ray; returns tn and whether
// tn <= tf, tf >= tmin and tn <= tlimit.
__device__ __forceinline__ bool slab(const float lo[3], const float hi[3],
                                     const float o[3], const float inv[3],
                                     float tmin, float tlimit, float* tn_out) {
  float tn = -FOV_INF, tf = FOV_INF;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv[a];
    const float t1 = (hi[a] - o[a]) * inv[a];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  *tn_out = tn;
  return tn <= tf && tf >= tmin && tn <= tlimit;
}
