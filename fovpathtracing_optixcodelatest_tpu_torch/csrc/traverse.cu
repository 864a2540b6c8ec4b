// Closest-hit (K1) and occlusion (K2) traversal of the packed wide BVH, one
// thread per ray.
//
// Replaces: the XLA while_loop traversals of the JAX package,
// ops/traverse8.py closest_hit (:795, reached from the fused bounce through
// closest_hit_staged :715; node expand _expand :201, leaf test _leaf_hits
// :234) and occluded (:1367). Same result contract: closest hit returns
// t/tri_id/u/v (miss: t = inf, tri_id = -1, u = v = 0); occlusion culls back
// faces (det > 1e-9), accepts tmin <= t <= tmax and stops at the first hit;
// inactive rays report a miss.
//
// Table layout (ops/bvh8.py): W = max(4A, 10L) float32 columns per row.
// Node rows hold child c's axis-a bounds as a conservative bf16 pair in one
// uint32 at col 3c + a (lo = u & 0xFFFF0000, hi = u << 16) and the child's
// entry code (row << 2) | kind at col 3A + c (kind 0 node, 1 leaf, 0 =
// empty). Leaf rows hold L triangles [v0, e1, e2] and, at col 9L + k, the
// original triangle id of slot k.
//
// Visit order (K1) is the JAX package's: a stack entry is the packed key
// (mono(tn) & himask) | code, children are pushed sorted by descending key
// so the nearest pops first, and a popped entry whose key exceeds
// mono(min(t, tmax)) | lowmask is stale and skipped. With the same order the
// first-found triangle among equal-t hits is the same one, so tri_id agrees
// with the reference even on shared edges.
//
// What bounds it on this card: table rows fetched per ray. A node row is
// 4A * 4 = 256 bytes and a leaf row 10L * 4 = 240 bytes (A16/L6); the bench
// scene's whole table (about 1.5k rows, 376 KB) stays resident in the 50 MB
// L2, so the fetches are L2 hits and HBM traffic is the ray inputs and
// outputs. The least time chip_smoke.py reports is the larger of those
// bytes at the HBM rate and the float32 slab and triangle tests of the rows
// the rays visit (counted by the plain version) at the non-tensor peak; the
// latency of each ray's chain of dependent L2 row fetches is what the
// first design actually waits on.
//
// First design: one thread per ray with a private stack in local memory
// (at most MAX_STACK entries), no shared-memory staging and no ray sorting.
// The table rows are read through the read-only cache (__ldg). Divergent
// warps and the local-memory stack are the known costs; a later design can
// measure warp-cooperative node fetches or a short-stack in registers.
//
// Built with --fmad=false: with no FMA contraction the slab tests and the
// Möller-Trumbore arithmetic round exactly as the plain PyTorch versions
// do, so hit/tri_id and t/u/v match them bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "tri.cuh"

#define MAX_STACK 128

__device__ __forceinline__ uint32_t mono_u32(float x) {
  const uint32_t b = __float_as_uint(x);
  return x < 0.0f ? ~b : (b | 0x80000000u);
}

__global__ void closest_hit_kernel(
    const float* __restrict__ table, int width, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    long long n, float tmin, float tmax, int stack_depth, int arity,
    int leaf_size, unsigned int lowmask, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = FOV_INF, bu = 0.0f, bv = 0.0f;
  int best = -1;
  if (active[i]) {
    const float o[3] = {orig[3 * i], orig[3 * i + 1], orig[3 * i + 2]};
    const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    const uint32_t himask = ~lowmask;
    uint32_t stack[MAX_STACK];
    stack[0] = 0u;  // the root: code 0 = internal row 0
    int sp = 1;
    while (sp > 0) {
      const uint32_t e = stack[--sp];
      const float tlimit = fminf(t, tmax);
      if (e > (mono_u32(tlimit) | lowmask)) continue;  // stale
      const uint32_t code = e & lowmask;
      const float* r = table + (long long)(code >> 2) * width;
      if ((code & 3u) == 0u) {
        const int base = sp;
        for (int c = 0; c < arity; ++c) {
          const uint32_t cc = __float_as_uint(__ldg(r + 3 * arity + c));
          if (cc == 0u) continue;
          float lo[3], hi[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const uint32_t u = __float_as_uint(__ldg(r + 3 * c + a));
            lo[a] = __uint_as_float(u & 0xFFFF0000u);
            hi[a] = __uint_as_float(u << 16);
          }
          float tn;
          if (!slab(lo, hi, o, inv, tmin, tlimit, &tn)) continue;
          const uint32_t key = (mono_u32(tn) & himask) | cc;
          // keep stack[base..sp) sorted by descending key (nearest on top);
          // a full stack drops its smallest key, as the reference's push
          // drops the entries past its depth
          int j;
          if (sp < stack_depth) {
            j = sp++;
          } else if (sp > base && stack[sp - 1] < key) {
            j = sp - 1;
          } else {
            continue;
          }
          while (j > base && stack[j - 1] < key) {
            stack[j] = stack[j - 1];
            --j;
          }
          stack[j] = key;
        }
      } else {
        for (int k = 0; k < leaf_size; ++k) {
          float tri[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) tri[q] = __ldg(r + 9 * k + q);
          const TriHit h =
              tri_test(tri, o[0], o[1], o[2], d[0], d[1], d[2], tmin, tmax,
                       false);
          if (h.hit && h.t < t) {
            t = h.t;
            bu = h.u;
            bv = h.v;
            best = __float_as_int(__ldg(r + 9 * leaf_size + k));
          }
        }
      }
    }
  }
  t_out[i] = t;
  u_out[i] = bu;
  v_out[i] = bv;
  tri_out[i] = best;
}

__global__ void occluded_kernel(
    const float* __restrict__ table, int width, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    long long n, float tmin, float tmax, int stack_depth, int arity,
    int leaf_size, bool* __restrict__ occ_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = false;
  if (active[i]) {
    const float o[3] = {orig[3 * i], orig[3 * i + 1], orig[3 * i + 2]};
    const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    uint32_t stack[MAX_STACK];
    stack[0] = 0u;
    int sp = 1;
    while (sp > 0 && !occ) {
      const uint32_t code = stack[--sp];
      const float* r = table + (long long)(code >> 2) * width;
      if ((code & 3u) == 0u) {
        // children pushed in slot order; the order cannot change an
        // any-hit answer
        for (int c = 0; c < arity; ++c) {
          const uint32_t cc = __float_as_uint(__ldg(r + 3 * arity + c));
          if (cc == 0u) continue;
          float lo[3], hi[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const uint32_t u = __float_as_uint(__ldg(r + 3 * c + a));
            lo[a] = __uint_as_float(u & 0xFFFF0000u);
            hi[a] = __uint_as_float(u << 16);
          }
          float tn;
          if (slab(lo, hi, o, inv, tmin, tmax, &tn) && sp < stack_depth)
            stack[sp++] = cc;
        }
      } else {
        for (int k = 0; k < leaf_size && !occ; ++k) {
          float tri[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) tri[q] = __ldg(r + 9 * k + q);
          occ = tri_test(tri, o[0], o[1], o[2], d[0], d[1], d[2], tmin, tmax,
                         true)
                    .hit;
        }
      }
    }
  }
  occ_out[i] = occ;
}

static inline unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

extern "C" int fov_closest_hit(const float* table, int width,
                               const float* orig, const float* dir,
                               const unsigned char* active, long long n,
                               float tmin, float tmax, int stack_depth,
                               int arity, int leaf_size, unsigned int lowmask,
                               float* t_out, int* tri_out, float* u_out,
                               float* v_out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    closest_hit_kernel<<<blocks_for(n, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        table, width, orig, dir, active, n, tmin, tmax, stack_depth, arity,
        leaf_size, lowmask, t_out, tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int fov_occluded(const float* table, int width, const float* orig,
                            const float* dir, const unsigned char* active,
                            long long n, float tmin, float tmax,
                            int stack_depth, int arity, int leaf_size,
                            bool* occ_out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    occluded_kernel<<<blocks_for(n, threads), threads, 0,
                      (cudaStream_t)stream>>>(table, width, orig, dir, active,
                                              n, tmin, tmax, stack_depth,
                                              arity, leaf_size, occ_out);
  }
  return (int)cudaGetLastError();
}
