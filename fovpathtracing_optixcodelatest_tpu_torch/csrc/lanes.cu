// A wavefront's live lanes on the card: the stable compaction of a bounce's
// lane list by its alive mask, in one pass, so the host never reads a lane
// count back.
//
// Replaces: the host's narrowing in render/integrator.py trace_paths
// (torch.nonzero on ray generation's mask, idx[alive] after each bounce)
// and the next bounce's gathers st.o[idx], st.d[idx] on the kernel path;
// each of those waited for the device. It replaces no kernel of the JAX
// package, whose bounce loop masks every lane of a fixed-size batch. The
// plain version is ops/lanes.py compact_plain.
//
// compact_kernel: a block a tile of kTile positions of the current list,
// kItems rounds of kThreads positions (round j, thread t: position
// j * kThreads + t of the tile, so the loads are coalesced). A position is
// kept where it lies below the list's count and its mask is set. Each
// round's warp ballot gives a kept position its rank among the warp's, one
// warp scans the (round, warp) totals in position order, and the tile's
// total goes into the single-pass scan across tiles: the decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016). A block takes its tile from a ticket
// counter, so every tile before its own belongs to a block that is
// running or done: the look-back never waits on a block not yet
// scheduled. It publishes its total (kAggregate), reads its predecessors'
// words 32 at a time, nearest first, summing back to the nearest
// inclusive prefix (kPrefix), then publishes its own inclusive prefix. A
// kept position's rank in the list is its tile's exclusive prefix plus its
// rank in the tile, so the lanes keep their order: idx[alive]'s. It
// writes the lane, the lane's origin and direction from the state arrays
// (the next bounce's rays), and the last live tile writes the count and
// adds it into the per-depth lane counts. Tiles past the count exit.
//
// Bound: memory. A position below the count reads its mask byte (1 B); a
// kept lane reads its list entry (8 B; ray generation's list is the
// identity, read as none), writes the next list's and reads and writes its
// rays (8 + 24 + 24 B); a tile's status word is 4 B.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
// a tile's status word: its state in the top two bits, a lane count below
constexpr unsigned kAggregate = 1u << 30, kPrefix = 2u << 30;
constexpr unsigned kValue = kAggregate - 1u;
constexpr int kMaxLanes = (int)kValue;  // counts fit in the 30 low bits

__device__ __forceinline__ unsigned state_of(unsigned word) {
  return word >> 30;
}

// Publish tile `tile`'s kept-lane total `total` in `status`, and return
// the kept lanes of every tile before it; then publish its inclusive
// prefix. Called by the 32 lanes of one warp.
__device__ __forceinline__ unsigned look_back(volatile unsigned* status,
                                              int tile, unsigned total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) status[0] = kPrefix | total;
    return 0u;
  }
  if (lane == 0) status[tile] = kAggregate | total;
  unsigned before = 0u;
  for (int nearest = tile - 1;; nearest -= 32) {
    const int j = nearest - lane;  // lane 0 the nearest predecessor
    unsigned word = kPrefix;  // before the first tile: a prefix of none
    if (j >= 0) word = status[j];
    while (__any_sync(kFull, state_of(word) == 0u))
      if (state_of(word) == 0u) word = status[j];
    const unsigned prefixes =
        __ballot_sync(kFull, state_of(word) == (kPrefix >> 30));
    // sum back to the nearest inclusive prefix, that one included
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned v = lane <= stop ? (word & kValue) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    before += v;
    if (prefixes) break;
  }
  if (lane == 0) status[tile] = kPrefix | (before + total);
  return before;
}

}  // namespace

// The C interface's arguments; ops/lanes.py packs the same fields in the
// same order (ctypes.Structure): pointers first, then 32-bit fields.
struct CompactArgs {
  const bool* mask;        // (n,) over the current list's positions
  const int64_t* idx_in;   // (n,) the current list; null: the identity
  const int32_t* count_in; // () its length; null: n
  const float* o;          // (N, 3) the state's origins
  const float* d;          // (N, 3) the state's directions
  int64_t* idx_out;        // (n,) the next list
  int32_t* count_out;      // () its length
  float* o_out;            // (n, 3) its rays
  float* d_out;
  int64_t* lanes;          // () the depth's lane count, added to
  unsigned* tiles;         // (1 + tiles,) zeroed: the ticket, each status
  int n, tile;
};

namespace {

__global__ void __launch_bounds__(kThreads)
    compact_kernel(const CompactArgs a) {
  __shared__ int tile_s;
  __shared__ unsigned totals[kItems * kWarps];  // (round, warp), in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(a.tiles, 1u);
  __syncthreads();
  const int tile = tile_s;
  const int count = a.count_in == nullptr ? a.n : min(*a.count_in, a.n);
  const int live = count > 0 ? (count - 1) / kTile + 1 : 1;
  if (tile >= live) return;  // the whole block: tile is uniform

  const int first = tile * kTile + (int)threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  bool keep[kItems];
  unsigned rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = first + r * kThreads;
    keep[r] = p < count && a.mask[p];
    const unsigned ballot = __ballot_sync(kFull, keep[r]);
    rank[r] = __popc(ballot & below);
    if (lane == 0) totals[r * kWarps + warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the (round, warp) totals: kItems * kWarps == 32
    const unsigned v = totals[lane];
    unsigned incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    const unsigned total = __shfl_sync(kFull, incl, 31);
    const unsigned before = look_back(a.tiles + 1, tile, total);
    totals[lane] = before + incl - v;
    if (lane == 0 && tile == live - 1) {
      *a.count_out = (int32_t)(before + total);
      atomicAdd((unsigned long long*)a.lanes,
                (unsigned long long)(before + total));
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!keep[r]) continue;
    const int p = first + r * kThreads;
    const int64_t k = (int64_t)totals[r * kWarps + warp] + rank[r];
    const int64_t j = a.idx_in == nullptr ? (int64_t)p : a.idx_in[p];
    a.idx_out[k] = j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.o_out[3 * k + c] = a.o[3 * j + c];
      a.d_out[3 * k + c] = a.d[3 * j + c];
    }
  }
}

}  // namespace

// Launch compact_kernel over the a->n positions of the current list on
// `stream`: one block a tile, at least one (an empty list still writes its
// count). Returns cudaGetLastError; cudaErrorInvalidValue where a->tile is
// not this build's tile or n does not fit a status word.
extern "C" int fov_compact(const CompactArgs* a, cudaStream_t stream) {
  if (a->tile != kTile || a->n < 0 || a->n > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const int blocks = a->n > 0 ? (a->n - 1) / kTile + 1 : 1;
  compact_kernel<<<blocks, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Registers, local memory per thread, resident blocks per SM and the
// threads a block of compact_kernel (`which` 0).
extern "C" int fov_lanes_info(int which, int* regs, int* local_bytes,
                              int* blocks_per_sm, int* threads) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)compact_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                            kThreads, 0);
}
