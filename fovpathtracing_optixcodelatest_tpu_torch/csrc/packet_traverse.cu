// Occlusion traversal of the legacy 8-wide float32 BVH (K3) as a masked
// warp-packet walk: 32 queried rays share one stack and each fetched row.
//
// Replaces: the JAX package's one Pallas kernel, ops/pallas_traverse.py
// _occlusion_kernel (:53) reached through occluded_packets (:143,
// pallas_call at :180). Same function: any-hit occlusion with back faces
// culled (det > 1e-9), tmin <= t <= tmax, the walk stops at the first hit,
// inactive rays report false. The answer is the per-ray one of
// traverse8.occluded, the contract the Pallas kernel states for itself: the
// Pallas kernel's packets descend into every child that any pending ray
// hits and test each pending ray against every triangle they reach, so a
// ray that misses a leaf's box by rounding can still be found occluded
// there (five of the bench frame's 499,085 shadow queries, ROADMAP.md §3).
// Here each stack entry carries a lane mask, so a lane is tested only where
// its own walk goes, whatever rays share its packet.
//
// Table layout (ops/bvh8.py pack_wide_legacy8): node rows hold 8 children x
// [lo3, hi3] float32 (cols 0:48) then 8 x [a, kind] int32 (cols 48:64); kind
// 0 internal (a = node row), 1 leaf (a = leaf row), -1 empty. Leaf rows hold
// 4 triangles x [v0, e1, e2]. The kernel is compiled for this layout only
// (64 columns, leaf size 4); the wrapper refuses any other.
//
// The walk. A warp takes lanes from a global counter 32 at a time
// (persistent.cuh: inactive lanes are answered false and never walked),
// fills a packet with 32 queried rays and walks it to its end before it
// takes the next. The packet's stack holds (entry, lane mask) pairs, its top
// in shared memory; an entry is a node row, or -(row + 1) for a leaf row. On a
// pop the entry's mask is cut to the lanes still pending; an entry left with
// none is dropped before its row is fetched. Lanes 0-15 read the row as
// sixteen 16-byte loads into the warp's 256 bytes of shared memory, and
// every lane reads it from there: one fetch per packet step. A step with
// few lanes in its mask spreads its tests over the warp: at a node the k
// lanes of the mask need k x 8 (ray, child) slab tests, run 32 at a time,
// each lane taking its ray's origin and inverse direction by shuffle (on
// the bench frame k is about 9 at a node: 3 rounds instead of every lane
// testing 8 children); above 16 lanes each tests its own ray's 8 children,
// which takes fewer rounds than the spread. Then one __ballot_sync per
// child, in slot order, gives the lanes that push it. At a leaf the k x 4
// (ray, triangle) tests run likewise (k is about 3: one round instead of 4
// tests), and the hits leave the pending set. Every
// *_sync sees the whole warp and control flow stays warp-uniform: a test is
// run or not per lane, and the mask applies to the results. A lane's
// entries form its own per-ray stack in order, so each lane visits exactly
// the rows of the per-ray walk in the same order, and the same arithmetic
// on the same floats gives an answer bit-exact with occluded_packets_plain
// and with K2.
//
// Stack depth. The plain version drops a ray's push when its own stack holds
// stack_depth entries. K3 reproduces that exactly rather than refusing the
// depth: each lane counts its own entries and leaves its bit out of a push
// when the count is full. The packet's stack then holds at most 32 x
// stack_depth entries (every entry carries at least one lane, and a lane is
// on at most stack_depth entries), and that is its capacity, so it cannot
// fill at any depth the wrapper takes. A DFS that pushes at most 8 children
// per node also holds at most 7 x height + 1 entries, whatever the masks
// (36 on the bench frame's table, of height 5): the first kTop (128, so
// every tree of height up to 18) live in shared memory, and the rest of the
// capacity in a global buffer the wrapper allocates, which only a taller
// tree reaches. Sizing the shared stack at 32 x stack_depth instead held 5
// blocks per SM where the registers allow 8, and measured 13% slower.
//
// What bounds it on this card: the chain of dependent steps of a packet
// (pop, row fetch, barrier, tests, ballots, pushes). The bench scene's
// legacy table (2,428 rows, 620 KB) stays in L2, so HBM moves only the rays
// and the answers; chip_smoke.py reports as the least time the larger of
// those bytes at the HBM rate and the float32 slab and triangle tests the
// rays need at the non-tensor peak. Sharing a row fetch among the packet's
// lanes fetches 6.5 times fewer rows than the per-ray walk, but the bench
// rays need about 436k packet steps, a step uses few of the 32 lanes (about
// 8 at a node, 3 at a leaf), and a per-ray walk of the same rays (K2) runs
// fewer dependent warp steps: PERF.md has the measurements.
//
// Built with --fmad=false so the slab and Möller-Trumbore arithmetic round
// exactly as the plain PyTorch version's one-op-at-a-time tensors do.
#include <cstdint>
#include <cuda_runtime.h>

#include "persistent.cuh"
#include "tri.cuh"

namespace {

constexpr int kChildren = 8, kLeaf = 4;  // ops/bvh8.py legacy width, LEAF_SIZE8
constexpr int kRowVecs = 16;             // a 64-column row as uint4s
constexpr int kWarps = 4;                // a packet is a warp's 32 lanes
constexpr int kThreads = 32 * kWarps;
// stack entries of a packet kept in shared memory: every tree of height up
// to 18 (7 x 18 + 1 entries) stays within them
constexpr int kTop = 128;

// dynamic shared memory of a block: each packet's row, queue, lane of each
// rank and the top of its stack
constexpr size_t kSharedBytes =
    kWarps * (sizeof(uint4) * kRowVecs + sizeof(int) * kQueue +
              sizeof(int) * 32 + sizeof(uint2) * kTop);

// stack entries of a packet beyond kTop, in global memory: with 32 x
// stack_depth entries in all the stack cannot fill
__host__ __device__ constexpr int spill_entries(int depth) {
  return 32 * depth > kTop ? 32 * depth - kTop : 0;
}

// A packet's stack of (entry, lane mask) pairs: entries below kTop in shared
// memory, the rest in the packet's own part of a global buffer.
struct PacketStack {
  uint2* top;
  uint2* spill;
  __device__ __forceinline__ uint2 get(int j) const {
    return j < kTop ? top[j] : spill[j - kTop];
  }
  __device__ __forceinline__ void put(int j, uint2 e) const {
    if (j < kTop)
      top[j] = e;
    else
      spill[j - kTop] = e;
  }
};

// Row r of the table, read once for the whole packet: lanes 0-15 load one
// uint4 each into the warp's shared-memory row.
__device__ __forceinline__ const float* stage_row(
    const uint4* __restrict__ table, int r, uint4* row, int lane) {
  if (lane < kRowVecs) row[lane] = __ldg(table + (size_t)r * kRowVecs + lane);
  __syncwarp();
  return reinterpret_cast<const float*>(row);
}

// whether the ray (o, inv) hits child c's box in node row rf
__device__ __forceinline__ bool child_hit(const float* rf, int c,
                                          const float o[3], const float inv[3],
                                          float tmin, float tmax) {
  float lo[3], hi[3], tn;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = rf[6 * c + a];
    hi[a] = rf[6 * c + 3 + a];
  }
  return slab(lo, hi, o, inv, tmin, tmax, &tn);
}

__global__ void __launch_bounds__(kThreads) occluded_packets_kernel(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, float tmin, float tmax, int depth, bool* __restrict__ occ_out,
    uint2* __restrict__ spill, int* __restrict__ counter) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned me = 1u << lane, below = me - 1u;
  uint4* row = smem + warp * kRowVecs;
  int* queues = reinterpret_cast<int*>(smem + kWarps * kRowVecs);
  int* queue = queues + warp * kQueue;
  int* ranks = queues + kWarps * kQueue;
  int* lane_of = ranks + warp * 32;  // the lane of the r-th lane of a mask
  const PacketStack stk{
      reinterpret_cast<uint2*>(ranks + kWarps * 32) + warp * kTop,
      spill + (size_t)(blockIdx.x * kWarps + warp) * spill_entries(depth)};
  int head = 0, queued = 0;
  bool drained = false;
  int packets = 0, node_rows = 0, leaf_rows = 0;
  while (true) {
    fill_queue(active, n, nullptr, counter, queue, head, queued, drained, 32,
               [&](int i) { occ_out[i] = false; });
    __syncwarp();
    if (queued == 0) break;
    const int take = min(32, queued);
    const int mine = lane < take ? queue[(head + lane) & (kQueue - 1)] : -1;
    head += take;
    queued -= take;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f}, inv[3];
    if (mine >= 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o[a] = orig[3ll * mine + a];
        d[a] = dir[3ll * mine + a];
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) inv[a] = safe_inv(d[a]);

    unsigned pending = __ballot_sync(kFull, mine >= 0);
    int count = mine >= 0;  // entries on this lane's own stack: the root
    bool occ = false;
    if (lane == 0) stk.put(0, make_uint2(0u, pending));  // the root, row 0
    int sp = 1;
    ++packets;
    while (sp > 0) {
      __syncwarp();  // the last push is visible, the row is read
      const uint2 e = stk.get(--sp);
      if (e.y & me) --count;
      const unsigned m = e.y & pending;
      if (m == 0u) continue;  // every lane it was pushed for is done
      const int code = (int)e.x;
      const bool leaf = code < 0;
      const bool in = (m & me) != 0u;
      const int k = __popc(m), rank = __popc(m & below);
      if (in) lane_of[rank] = lane;
      const float* rf =
          stage_row(table, leaf ? -code - 1 : code, row, lane);
      const int* ri = reinterpret_cast<const int*>(rf);
      if (!leaf) {
        ++node_rows;
        unsigned hits = 0u;  // the children this lane's ray hits, by slot
        if (k > 16) {
          // most lanes pending: each tests its own ray against the 8
          // children
#pragma unroll
          for (int c = 0; c < kChildren; ++c)
            if (ri[49 + 2 * c] >= 0 && child_hit(rf, c, o, inv, tmin, tmax))
              hits |= 1u << c;
        } else {
          // few: the k x 8 (ray, child) tests run 32 at a time, test p
          // (child p % 8 of the ray of rank p / 8) on lane p % 32
          for (int base = 0; base < 8 * k; base += 32) {
            const int p = base + lane, r = p >> 3, c = p & 7;
            const int src = r < k ? lane_of[r] : lane;
            float ro[3], rinv[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              ro[a] = __shfl_sync(kFull, o[a], src);
              rinv[a] = __shfl_sync(kFull, inv[a], src);
            }
            const bool hit = r < k && ri[49 + 2 * c] >= 0 &&
                             child_hit(rf, c, ro, rinv, tmin, tmax);
            const unsigned bits = __ballot_sync(kFull, hit);
            if (8 * rank - base < 32 && 8 * rank >= base)
              hits = (bits >> (8 * rank - base)) & 0xFFu;
          }
        }
        // pushes in slot order, each lane's bit only while its own stack
        // has room
#pragma unroll
        for (int c = 0; c < kChildren; ++c) {
          const int kind = ri[49 + 2 * c];
          if (kind < 0) continue;  // empty slot
          const bool push = in && ((hits >> c) & 1u) && count < depth;
          const unsigned b = __ballot_sync(kFull, push);
          count += push;
          if (b != 0u) {
            if (lane == 0) {
              const int a_val = ri[48 + 2 * c];
              stk.put(sp, make_uint2(
                              (unsigned)(kind > 0 ? -(a_val + 1) : a_val), b));
            }
            ++sp;
          }
        }
      } else {
        ++leaf_rows;
        // the k x 4 (ray, triangle) tests, 32 at a time: test p is
        // triangle p % 4 against the ray of rank p / 4
        bool hit = false;  // whether this lane's ray hits a triangle
        for (int base = 0; base < kLeaf * k; base += 32) {
          const int p = base + lane, r = p / kLeaf, t = p % kLeaf;
          const int src = r < k ? lane_of[r] : lane;
          float ro[3], rd[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            ro[a] = __shfl_sync(kFull, o[a], src);
            rd[a] = __shfl_sync(kFull, d[a], src);
          }
          const bool h = r < k && tri_test(rf + 9 * t, ro[0], ro[1], ro[2],
                                           rd[0], rd[1], rd[2], tmin, tmax,
                                           true)
                                      .hit;
          const unsigned bits = __ballot_sync(kFull, h);
          if (kLeaf * rank - base < 32 && kLeaf * rank >= base)
            hit = ((bits >> (kLeaf * rank - base)) & 0xFu) != 0u;
        }
        const bool found = hit && in;
        occ |= found;
        pending &= ~__ballot_sync(kFull, found);
        if (pending == 0u) break;
      }
    }
    if (mine >= 0) occ_out[mine] = occ;
  }
  if (lane == 0 && packets > 0) {
    atomicAdd(counter + 1, packets);
    atomicAdd(counter + 2, node_rows);
    atomicAdd(counter + 3, leaf_rows);
  }
}

GridCache grid_cache;

// the launch grid of n lanes: the device filled with resident blocks, or
// fewer where n needs fewer
cudaError_t launch_blocks(int n, int* blocks) {
  int per_sm = 0, full = 0;
  const cudaError_t err = grid_cache.get((const void*)occluded_packets_kernel,
                                         kThreads, kSharedBytes, &per_sm,
                                         &full);
  const int needed = (n + kThreads - 1) / kThreads;
  *blocks = full < needed ? full : needed;
  return err;
}

}  // namespace

// The uint2 entries of the global stack buffer a launch over n lanes at
// stack_depth needs (0 where the shared-memory stack suffices).
extern "C" int fov_packet_spill(int stack_depth, int n, long long* entries) {
  int blocks = 0;
  const cudaError_t err = launch_blocks(n > 0 ? n : 1, &blocks);
  *entries = (long long)blocks * kWarps * spill_entries(stack_depth);
  return (int)err;
}

// K3's launch
struct PacketArgs {
  const float* table;
  const float* orig;            // (n, 3)
  const float* dir;             // (n, 3)
  const unsigned char* active;  // (n,)
  bool* occ_out;                // (n,)
  void* spill;  // fov_packet_spill(stack_depth, n) uint2 entries of scratch
  // 4 zeroed int32. counter[0] hands out the lanes; K3 adds the packets it
  // walked and the node and leaf rows it fetched to counter[1..3].
  int* counter;
  int n;
  float tmin;
  float tmax;
  int stack_depth;
};

extern "C" int fov_occluded_packets(const PacketArgs* a, cudaStream_t stream) {
  if (a->n > 0) {
    int blocks = 0;
    const cudaError_t err = launch_blocks(a->n, &blocks);
    if (err != cudaSuccess) return (int)err;
    occluded_packets_kernel<<<blocks, kThreads, kSharedBytes, stream>>>(
        reinterpret_cast<const uint4*>(a->table), a->orig, a->dir, a->active,
        a->n, a->tmin, a->tmax, a->stack_depth, a->occ_out,
        reinterpret_cast<uint2*>(a->spill), a->counter);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local memory per thread (spills and any stack
// frame), resident blocks per SM and dynamic shared memory per block of K3.
extern "C" int fov_packet_info(int* regs, int* local_bytes,
                               int* blocks_per_sm, int* shared) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, occluded_packets_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared = (int)kSharedBytes;
  int blocks = 0;
  return (int)grid_cache.get((const void*)occluded_packets_kernel, kThreads,
                             kSharedBytes, blocks_per_sm, &blocks);
}
