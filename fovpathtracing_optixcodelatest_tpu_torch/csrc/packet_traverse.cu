// Occlusion traversal of the legacy 8-wide float32 BVH (K3), one thread per
// ray.
//
// Replaces: the JAX package's one Pallas kernel, ops/pallas_traverse.py
// _occlusion_kernel (:53) reached through occluded_packets (:143,
// pallas_call at :180). Same function: any-hit occlusion with back faces
// culled (det > 1e-9), tmin <= t <= tmax, the walk stops at the first hit,
// inactive rays report false.
//
// Table layout (ops/bvh8.py pack_wide_legacy8): node rows hold 8 children x
// [lo3, hi3] float32 (cols 0:48) then 8 x [a, kind] int32 (cols 48:64); kind
// 0 internal (a = node row), 1 leaf (a = leaf row), -1 empty. Leaf rows hold
// 4 triangles x [v0, e1, e2]. Stack entries are a node row, or -(row + 1)
// for a leaf.
//
// The TPU shape does not carry over. Mosaic has no per-lane gather, so the
// Pallas kernel walks one scalar stack per 1024-ray packet and descends into
// any child that any pending ray hits (union traversal). Hopper gathers per
// thread, so this first design gives every ray its own stack and visits only
// the boxes that ray hits; the per-ray answer is the same. Whether a warp- or
// CTA-shared packet stack ever pays is left to a later measurement against
// K2 (csrc/traverse.cu).
//
// What bounds it on this card: table rows fetched per ray, 256 bytes each.
// The bench scene's legacy table (about 2.4k rows, 620 KB) stays resident in
// L2, so HBM moves only the rays and the answers. chip_smoke.py reports as
// the least time the larger of those bytes at the HBM rate and the float32
// slab and triangle tests of the visited rows at the non-tensor peak. The
// latency of each ray's chain of dependent L2 row fetches is what this
// design actually waits on.
//
// Built with --fmad=false so the slab and Möller-Trumbore arithmetic round
// exactly as the plain PyTorch version's one-op-at-a-time tensors do.
#include <cstdint>
#include <cuda_runtime.h>

#include "tri.cuh"

#define MAX_STACK 128

__global__ void occluded_packets_kernel(
    const float* __restrict__ table, int width, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    long long n, float tmin, float tmax, int stack_depth, int leaf_size,
    bool* __restrict__ occ_out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = false;
  if (active[i]) {
    const float o[3] = {orig[3 * i], orig[3 * i + 1], orig[3 * i + 2]};
    const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
    const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};
    int stack[MAX_STACK];
    stack[0] = 0;
    int sp = 1;
    while (sp > 0 && !occ) {
      const int e = stack[--sp];
      if (e < 0) {
        const float* r = table + (long long)(-e - 1) * width;
        for (int k = 0; k < leaf_size && !occ; ++k) {
          float tri[9];
#pragma unroll
          for (int q = 0; q < 9; ++q) tri[q] = __ldg(r + 9 * k + q);
          occ = tri_test(tri, o[0], o[1], o[2], d[0], d[1], d[2], tmin, tmax,
                         true)
                    .hit;
        }
      } else {
        const float* r = table + (long long)e * width;
        for (int c = 0; c < 8; ++c) {
          const int a_val = __float_as_int(__ldg(r + 48 + 2 * c));
          const int kind = __float_as_int(__ldg(r + 49 + 2 * c));
          if (kind < 0) continue;
          float lo[3], hi[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            lo[a] = __ldg(r + 6 * c + a);
            hi[a] = __ldg(r + 6 * c + 3 + a);
          }
          float tn;
          if (slab(lo, hi, o, inv, tmin, tmax, &tn) && sp < stack_depth)
            stack[sp++] = kind > 0 ? -(a_val + 1) : a_val;
        }
      }
    }
  }
  occ_out[i] = occ;
}

extern "C" int fov_occluded_packets(const float* table, int width,
                                    const float* orig, const float* dir,
                                    const unsigned char* active, long long n,
                                    float tmin, float tmax, int stack_depth,
                                    int leaf_size, bool* occ_out,
                                    void* stream) {
  if (n > 0) {
    const int threads = 128;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    occluded_packets_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, width, orig, dir, active, n, tmin, tmax, stack_depth,
        leaf_size, occ_out);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local memory per thread (the stack and any spills)
// and resident blocks per SM of K3 at its launch shape.
extern "C" int fov_packet_info(int* regs, int* local_bytes,
                               int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, occluded_packets_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, occluded_packets_kernel, 128, 0);
}
