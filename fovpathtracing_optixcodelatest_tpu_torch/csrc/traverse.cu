// Closest-hit (K1) and occlusion (K2) traversal of the packed wide BVH:
// persistent warps that fetch their rays from a global counter.
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
// original triangle id of slot k. K1, K2 and the non-culling K2 are
// compiled for the three layouts the port builds: A16/L6 (W = 64, 256-byte
// rows), the default, and the JAX package's wide A32/L12 (W = 128, 512 B)
// and A32/L24 (W = 240, 960 B); the two-level kernels too. The wrappers
// refuse any other layout. A16/L6 and A32/L24 walk one ray a thread, the
// single-level A32/L12 kernels one ray a group of lanes (below). A row
// order is no layout: the JAX package's DFS and treelet tables (rows of
// the same tree permuted, synthetic group rows whose empty slots hold the
// box (+inf, -inf) and code 0, which every walk skips by its code) walk
// unchanged, with ties between equal keys following their row ids.
//
// Visit order (K1) is the JAX package's: a stack entry is the packed key
// (mono(tn) & himask) | code, children are pushed sorted by descending key
// so the nearest pops first, and a popped entry whose key exceeds
// mono(min(t, tmax)) | lowmask is stale and skipped. With the same order the
// first-found triangle among equal-t hits is the same one, so tri_id agrees
// with the reference even on shared edges. K2 pushes its hit children in
// slot order. A full stack keeps the rule of the plain versions: K1 keeps the
// largest keys of a node's hit children that fit and drops the rest, K2
// pushes no more children.
//
// What bounds it on this card: the chain of dependent row fetches of each
// ray. The bench scene's whole table (about 1.5k rows, 376 KB) stays in the
// 50 MB L2, so HBM moves only the rays and the answers; the least time
// chip_smoke.py reports is the larger of those bytes at the HBM rate and the
// float32 slab and triangle tests of the rows the rays visit at the
// non-tensor peak. The design works on the latency and on idle lanes:
//
// - Compile-time shape, whole-row loads. ARITY and LEAF are template
//   parameters, so every loop over children, axes and triangles unrolls. A
//   row is read as 16-byte __ldg's (a leaf as the 14 that cover its 54
//   triangle words) and costs one round of latency: K2 issues them all
//   before any test; K1 prefetches the row's two 128-byte lines into L1 and
//   then reads it a group of children or half a leaf at a time from there,
//   which holds 69 registers instead of 96 and keeps 7 blocks per SM
//   resident instead of 5. A leaf's triangle ids are read only for a hit
//   (K1). A node's children are tested in groups of four whose codes share
//   one uint4; a group with no child is skipped (most nodes of the bench
//   scene have two children), the rest run without branches.
// - Persistent warps with dynamic ray fetch (Aila and Laine, "Understanding
//   the Efficiency of Ray Traversal on GPUs", HPG 2009). The grid is the
//   SMs times the resident blocks. A warp takes lanes from a global counter
//   in chunks of 32, writes the miss answer of the inactive ones (coalesced)
//   and compacts the active ones with __ballot_sync/__popc into a per-warp
//   queue in shared memory, so an inactive lane never takes a thread. A lane
//   whose ray is done takes the next queued ray once kK2RefillIdle (16)
//   lanes of its warp are idle in K2, whose rays end early and unevenly
//   (kIK2RefillIdle, 8, in the two-level K2; kWideK2RefillIdle, 4, in every
//   K2's lockstep loop at the wide layouts), and kK1RefillIdle (32, the
//   whole warp) in K1 and its two-level variant, which lose their
//   coherence and 20-35% of their speed when part of a warp refills (at 16
//   or 8 idle lanes; 18% at 16 in the A32/L24 lockstep K1). A launch over
//   a wavefront's lane list takes its length from the device (the
//   `count` argument: csrc/lanes.cu's compaction writes it) and hands out
//   lanes up to it; its grid is sized for the list's capacity n.
// - K1 computes its children's keys in registers and sorts them there with
//   a bitonic network (over 4, 8 or 16 keys, as far as the node's children
//   reach) before pushing the hits.
// - Each thread's stack lives in shared memory, stack_depth entries (the
//   table's exact worst case, ops/bvh8.py lifo_stack_bound), strided by 32
//   so a warp's pushes and pops hit 32 banks. A fixed 128-entry stack in
//   local memory timed the same within noise; shared memory is kept because
//   it is sized from the argument.
//
// The constants below were chosen by timing each alternative build on every
// main-path shape against the kept one (PERF.md has the numbers).
//
// A32/L24 runs the same walks with these differences, which keep every
// instantiation exact against its plain version:
//
// - Staged reads everywhere. A row is 60 uint4, more than registers hold:
//   the prefetch covers the lines of the row's used part (four for a node,
//   seven for a leaf, and the line of its last word: 960-byte rows do not
//   start on a line), then a node's codes are read a group of four at a
//   time (one uint4, a group with no child skipped on it), three box
//   uint4s a used group, or seven uint4s a third of a leaf.
// - No sorting network (kRankPush): K1 inserts each hit key into the
//   node's stack window as the slab tests find it (insert_desc, about
//   cnt^2 / 2 compares), which leaves the stack a descending sort would,
//   the full-stack rule included; the two-level K1 below does the same.
// - Lockstep steps (kLockstep): K1, K2 and the non-culling K2 run in the
//   group walks' persistent loop (walk_group_rays) with one lane a group.
//   Each lane pops its next entry (K1 skipping stale ones), and only the
//   lanes whose rows are of the kind more of the warp's lanes hold, node
//   or leaf, visit them; the others keep their rows for a later step. A
//   wide node step (up to 32 slab tests) and leaf step (24 triangle
//   tests) are both long, and a warp that holds both kinds pays for both
//   in a step; in lockstep it pays for one. K1's t does not change while a
//   lane holds its row, so each lane visits the rows of walk_rays in
//   their order.
// - The stack in local memory: kMaxStack entries a thread, interleaved by
//   the hardware so a warp's pushes at one depth share lines as the
//   strided shared stack's do; it costs no shared memory, and the
//   registers alone set the resident blocks: 9 for K1 (56 registers, 14 B
//   spilled), 8 for K2 (63 registers).
//
// Timed on the 388,812-triangle frame's lanes (box_city_fast(180); PERF.md has
// every design's time), against the walk these replace (a 32-key bitonic
// network in K1, whole code rows, walk_rays; 3.50 ms K1, 0.92 ms K2, at 80 /
// 96 registers and 6 / 5 blocks an SM, on an H100 at 700 W): the kept K1 takes
// 2.42 ms, 31% less (rank insertion alone 23%; lockstep 2% more; 8, then 9
// blocks an SM, 3% and 4% more), the kept K2 0.68 ms, 26% less (lockstep with
// the code reads 25%; 8 blocks an SM and no leaf exit 1% more). Not kept:
// skipping a leaf's thirds from the first whose first slot is padding (id -1),
// in every form tried (the next third's id read with each third's loads, or
// with the third itself, its line prefetched or not, or the leaf's used thirds
// read once): K1 6-11% slower, K2 0-4%. A leaf row holds 19.2 of its 24 slots,
// but a warp's leaf step lasts as long as its fullest lane's leaf, and half of
// the table's leaves use seven or eight of their eight thirds (87% six or
// more); the skip's branches cost more than the tests it saves. Nor kept:
// refilling K1 at 16 idle lanes (18% slower), K2 at 2, 8 or 16 (the same to 2%
// slower), the leaf exit in the single-level K2 (1% slower), and 10 blocks an
// SM (both spilled, 5-8% slower than 8).
//
// A32/L12 walks each ray with a group of G lanes instead (group-per-ray
// walks, below). What bounds one thread's wide step is its serial work
// (32 slab tests in eight groups, a 32-key sort, 12 triangle tests) and,
// on the deep tables these layouts serve (a 10M-triangle A32/L12 table is
// 686 MB, 14 times the L2), the chain of dependent row fetches from HBM.
// The group walk spreads a step over its lanes and fetches each row in
// one coalesced pass:
//
// - Lane j of the group owns children C j .. C j + C - 1 (C = 32 / G),
//   whose boxes and codes are contiguous words of the row, and triangles
//   j, j + G, ... of a leaf. The group copies the row into the ray's
//   shared-memory buffer with cp.async, every G-th uint4 a lane, so each
//   pass reads contiguous bytes; a leaf's 9-word triangles, which straddle
//   16-byte chunks, are then read word by word from shared memory (the
//   rays' buffers are offset 8 banks apart).
// - No sorting network. K1 compacts the node's hit keys in slot order into
//   the ray's shared scratch (ballot prefix counts), and each key goes to
//   stk[sp + rank], its rank the number of hit keys above it (distinct):
//   the stack a descending sort leaves; a full stack keeps the largest
//   keys, rank < depth - sp. K2 pushes its hits in slot order at their
//   ballot prefix positions, the first depth - sp of them.
// - A leaf's closest hit is a (t, slot) min-reduction across the group
//   (lowest slot among equal t: the triangle the serial t < best loop
//   keeps), u, v and the id from the same slot; K2's is an any-hit ballot.
// - Lockstep steps. The groups of a warp pop, start their rows' copies and
//   wait for them together, then visit only the rows of the kind (node or
//   leaf) more of them hold, so the warp runs one of the two paths a step;
//   the others keep their rows (K1 10% faster on the 10M frame than
//   visiting every row each step). The persistent loop hands queued rays
//   to idle groups (walk_rays' counter and queue, a group taking a lane's
//   place).
// - G and the stack's home (GroupDesign), chosen by timing G = 4, 8, 16
//   (and 2) with the stack in shared and in global memory on the 10M
//   frame's lanes: rays in flight set the time there. K1 takes G = 4 with
//   its stack in a global buffer the wrapper allocates (64 registers, 8
//   blocks an SM: 256 rays; a shared stack of depth 164 leaves 5 blocks),
//   K2 G = 8 with a shared stack (48 registers, 10 blocks). On that frame
//   K1 takes 14% less time than the one-thread walk, K2 7% less; on tables
//   that fit in the L2 (388,812 triangles) the group walks take about 2x
//   the one-thread walks' time, which is why A32/L24, timed there, keeps
//   its one-thread walk (PERF.md has every alternative's time).
//
// K2 without back-face culling (traverse8.py occluded(cull_backface=False)
// :1376, its leaf test :247; the 04 raycast's shadow ray): the occlusion
// walk has a compile-time CULL flag, and occluded_nocull_kernel is its
// CULL = false instantiation for single-level tables of each layout, in
// which a triangle occludes where |det| > 1e-9;
// occluded_nocull_instanced_kernel is the same instantiation of the
// two-level K2 (traverse8.py :1487-1580 passes cull_backface to its leaf
// test too), the 04 raycast of a render-time-instanced scene. The culling
// kernels compile as without the flag.
//
// Two-level tables (ops/tlas.py; the instance steps of traverse8.py
// _ch_step :523-632 and of the occlusion loop :1487-1580):
// closest_hit_instanced_kernel and occluded_instanced_kernel are the
// one-thread walks with INSTANCED set, compiled at each layout (the
// single-level kernels compile as without the flag). At A32/L12 and
// A32/L24 they take the wide one-thread walks' form: the row read staged,
// the stack in local memory (kMaxStack entries). Their K1 has no sorting
// network (kRankPush): most of its node steps use a child past slot 15
// (a TLAS row holds one instance a slot; a wide BLAS root has tens of
// leaves), where the 32-key network of the single-level walk runs 240
// compare-exchanges and holds the 32 keys live (95 registers, 5 blocks
// an SM). It reads a node's codes a group of four at a time and inserts
// each hit key into the node's stack window as the slab tests find it
// (insert_desc: about cnt^2 / 2 compares, cnt usually 1-4), which leaves
// the stack a descending sort would, the full-stack rule included: 75
// registers, 6 blocks an SM, no spill. Timed against the network on the
// 1,000-instance field's primary lanes (in the L2) and on a (32, 12) table
// 2.4 times the L2 (PERF.md): 31% less time at A32/L24, 17% and 28% less
// at A32/L12; issuing the BLAS root row's reads before the instance
// transform gained nothing (and spilled where the root's codes were read
// with it), refilling at 16 idle lanes cost 8-33%, and an A32/L12 group
// walk (the single-level K1's below, with the instance state in each lane
// of the group) took 3.3 times as long on the field and 27% longer on the
// larger table.
// Rows [inst_base, blas_base) are instance rows [root code, A (3x3
// row-major), b (3)]. Popping an instance code (kind 2, the instance id in
// the row bits) reads its 13 words as four 16-byte loads, sets the lane's
// object-space ray x_obj = A x + b (direction A d left unnormalised, so t
// stays in world units; its safe inverse) and its current instance, and
// tests the BLAS root's row, node or leaf, in the same step. The plain
// versions push the root (K1 with the instance entry's key bits) and pop
// it next: the pop freed the slot the push takes, and the root's key
// cannot be stale, since t has not changed since the entry passed the
// stale test; so the rows visited, and their order, are the same. A node
// row below blas_base is a TLAS row, tested in world space (and the lane
// leaves its instance); BLAS nodes and leaves are tested in object space.
// Each sum is evaluated left to right as ops/traverse.py inv_transform
// writes it, so the object rays, and with them t/u/v, match the plain
// versions bit for bit. K1 also writes the hit's instance (-1 on a miss).
// A lane carries the world ray, the object ray, cur and the best hit's
// instance in registers and resets them when it takes a new ray. More
// resident warps do not speed K1 up: keeping the world ray in shared
// memory (one ray a lane in registers, 71 registers and 7 blocks/SM) timed
// 1-2% slower than this walk (80 registers, 6 blocks/SM). The two-level K2
// reads its rows staged, as K1 does: at A16/L6 96 registers without the
// spill that whole-row reads cost it, and 10% faster; and its idle lanes
// refill at 8 (5% faster than at 16).
// At A32/L12 and A32/L24 the two-level K2 (kLockstep) steps in lockstep
// as the single-level A32/L24 walks do: it runs in the group walks'
// persistent loop (walk_group_rays) with one lane a group, so each lane
// pops its next entry (entering an instance there), and only the lanes
// whose rows are of the kind more of the warp's lanes hold, node or leaf,
// visit them; the others keep their rows for a later step, and idle lanes
// take new rays once 4 are idle.
// Its node step (32 slab tests in eight groups) and leaf step (12 or 24
// triangle tests) are both long, and a warp whose lanes hold both kinds
// pays for both in a step; in lockstep it pays for one. It also reads a
// node's codes a group of four at a time, as K1 does (75 registers, 6
// blocks an SM, no spill, where reading them with the row held 96 and
// spilled 8-16 B at 5 blocks an SM), and leaves a leaf at the first third
// of its triangles that occludes. Timed against the walk it replaces (the
// one-thread step of walk_rays, a node's codes read with its row) on the
// 1,000-instance field's shadow lanes (in the L2) and on a (32, 12) table
// 2.4 times the L2 (PERF.md), the kept walk takes 15% less time at
// A32/L12, 25% less at A32/L24 and 12% less on the larger table; lockstep
// alone 10-17% less than the same walk without it, the code reads alone,
// with their registers, 1-5%; without the leaf exit it timed within 1%
// (80 registers). Not kept, each slower on some shape: 7 blocks an SM,
// refilling at 1, 2 or 8 idle lanes, prefetching a row's lines when it is
// popped, and an A32/L12 group walk (the single-level A32/L12 K2's, 8
// lanes a ray, each entering the instance: 2.6 times as long on the
// field, 34% longer on the larger table). PERF.md has the times of every
// alternative.
//
// Built with --fmad=false: with no FMA contraction the slab tests and the
// Möller-Trumbore arithmetic round exactly as the plain PyTorch versions
// do, so hit/tri_id and t/u/v match them bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "persistent.cuh"
#include "tri.cuh"

namespace {

constexpr int kArity = 16, kLeaf = 6;  // ops/bvh8.py ARITY, LEAF_SIZE
// entries of a local-memory stack: ops/traverse.py MAX_STACK
constexpr int kMaxStack = 256;
constexpr uint32_t kKindInst = 2u;     // ops/bvh8.py KIND_INST
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// lanes of a warp that must be idle before they take new rays: K1 and its
// two-level variant, K2 and its non-culling instantiation, the two-level K2,
// and every K2 at the wide layouts (in its lockstep loop)
constexpr int kK1RefillIdle = 32, kK2RefillIdle = 16, kIK2RefillIdle = 8,
              kWideK2RefillIdle = 4;
// resident blocks per SM asked of the register allocator by every kernel
// (4 gives K2 109 registers, 6 spills)
constexpr int kMinBlocks = 5;
// whether a walk prefetches a row's two lines into L1 and then reads it a
// group of children or half a leaf at a time (fewer registers: K1 and the
// two-level K2), or reads it all at once (K2, which gains nothing from
// staging)
constexpr bool kK1StagedRow = true, kK2StagedRow = false, kIK2StagedRow = true;
// resident blocks per SM asked by the two-level K1 and K2 at the wide
// layouts (6: 80 registers; with their stacks in local memory both take
// 75 and neither spills)
constexpr int kInstWideMinBlocks = 6;
// resident blocks per SM asked by the single-level K1 and K2 at A32/L24
// (K1 9: 56 registers and 14 B spilled, 4% faster than 8 at 63 registers
// and none; K2 8: 63 registers; 10 spilled hundreds of bytes and was
// slower)
constexpr int kWideK1MinBlocks = 9, kWideK2MinBlocks = 8;

template <int ARITY, int LEAF>
struct Layout {
  static_assert(ARITY % 4 == 0 && LEAF % 3 == 0,
                "children are read in fours and leaves in threes");
  static constexpr int kWidth = 4 * ARITY > 10 * LEAF ? 4 * ARITY : 10 * LEAF;
  static constexpr int kVecs = kWidth / 4;             // uint4 per row
  static constexpr int kLeafVecs = (9 * LEAF + 3) / 4;  // uint4 of triangles
  static_assert(kWidth % 4 == 0, "a row must be whole uint4s");
  // 128-byte lines of a node's boxes and codes, of a leaf's triangles
  static constexpr int kNodeLines = (16 * ARITY + 127) / 128;
  static constexpr int kLeafLines = (36 * LEAF + 127) / 128;
  // a row of more uint4s than the (16, 6) row's 16: the wide layouts
  static constexpr bool kWide = kVecs > 16;
  // K2 reads whole rows only where they fit in registers
  static constexpr bool kK2Staged = kK2StagedRow || kWide;
  // the wide layouts keep the stack in local memory
  static constexpr bool kLocalStack = kWide;
};

__device__ __forceinline__ uint32_t mono_u32(float x) {
  const uint32_t b = __float_as_uint(x);
  return x < 0.0f ? ~b : (b | 0x80000000u);
}

// word w of a row held as uint4s (w is a constant after unrolling)
__device__ __forceinline__ uint32_t word(const uint4* q, int w) {
  const uint4 v = q[w >> 2];
  const int c = w & 3;
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Read the row of entry code: all of a node row, the triangle words of a
// leaf row; every load is issued before the caller tests anything.
template <int ARITY, int LEAF>
__device__ __forceinline__ void load_row(const uint4* __restrict__ table,
                                         uint32_t code,
                                         uint4 (&q)[Layout<ARITY, LEAF>::kVecs]) {
  using L = Layout<ARITY, LEAF>;
  const uint4* r = table + (size_t)(code >> 2) * L::kVecs;
  const bool node = (code & 3u) == 0u;
#pragma unroll
  for (int j = 0; j < L::kVecs; ++j)
    if (j < L::kLeafVecs || node) q[j] = __ldg(r + j);
}

// q[lo..hi] = row r's uint4s lo..hi (constant bounds after unrolling)
__device__ __forceinline__ void load_vecs(const uint4* __restrict__ r,
                                          uint4* q, int lo, int hi) {
#pragma unroll
  for (int j = lo; j <= hi; ++j) q[j] = __ldg(r + j);
}

// Prefetch into L1 the 128-byte lines of the row of entry code that its
// walk reads: a node's boxes and codes, a leaf's triangles.
template <int ARITY, int LEAF>
__device__ __forceinline__ const uint4* prefetch_row(
    const uint4* __restrict__ table, uint32_t code) {
  using L = Layout<ARITY, LEAF>;
  const uint4* r = table + (size_t)(code >> 2) * L::kVecs;
  const bool node = (code & 3u) == 0u;
  constexpr int kLines =
      L::kNodeLines > L::kLeafLines ? L::kNodeLines : L::kLeafLines;
#pragma unroll
  for (int j = 0; j < kLines; ++j)
    if (j < (node ? L::kNodeLines : L::kLeafLines))
      asm volatile("prefetch.global.L1 [%0];" ::"l"(r + 8 * j));
  if constexpr (L::kVecs % 8 != 0) {  // a row that starts inside a line
    const char* last = reinterpret_cast<const char*>(r) - 1 +
                       (node ? 16 * ARITY : 36 * LEAF);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(last));
  }
  return r;
}

// Start reading the row of entry code: all of it at once, or (staged) a
// prefetch of its lines and, for a node, its child codes.
template <int ARITY, int LEAF, bool STAGED>
__device__ __forceinline__ const uint4* begin_row(
    const uint4* __restrict__ table, uint32_t code,
    uint4 (&q)[Layout<ARITY, LEAF>::kVecs]) {
  using L = Layout<ARITY, LEAF>;
  const uint4* r = table + (size_t)(code >> 2) * L::kVecs;
  if (!STAGED) {
    load_row<ARITY, LEAF>(table, code, q);
    return r;
  }
  prefetch_row<ARITY, LEAF>(table, code);
  if ((code & 3u) == 0u)
    load_vecs(r, q, 3 * ARITY / 4, ARITY - 1);  // the child codes
  return r;
}

// (staged) the box words of group g of four children, before its tests
template <bool STAGED>
__device__ __forceinline__ void group_boxes(const uint4* __restrict__ r,
                                            uint4* q, int g) {
  if (STAGED) load_vecs(r, q, 3 * g, 3 * g + 2);
}

// (staged) the words 27h .. 27h + 26 of leaf triangles 3h .. 3h + 2, before
// their tests
template <bool STAGED>
__device__ __forceinline__ void leaf_half(const uint4* __restrict__ r,
                                          uint4* q, int h) {
  if (STAGED) load_vecs(r, q, 27 * h / 4, (27 * h + 26) / 4);
}

// child c's box from a node row
template <int ARITY>
__device__ __forceinline__ void child_box(const uint4* q, int c, float lo[3],
                                          float hi[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const uint32_t u = word(q, 3 * c + a);
    lo[a] = __uint_as_float(u & 0xFFFF0000u);
    hi[a] = __uint_as_float(u << 16);
  }
}

__device__ __forceinline__ void triangle(const uint4* q, int k, float tri[9]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) tri[j] = __uint_as_float(word(q, 9 * k + j));
}

// Bitonic sort of k[0..N) (N a power of two) into descending order, in
// registers: every loop has a constant trip count and unrolls.
template <int N>
__device__ __forceinline__ void sort_desc(uint32_t* k) {
  constexpr int kLog = N == 32 ? 5 : N == 16 ? 4 : N == 8 ? 3 : N == 4 ? 2
                       : N == 2 ? 1 : 0;
  static_assert(N == 1 << kLog, "N must be a power of two up to 32");
#pragma unroll
  for (int p = 1; p <= kLog; ++p) {
#pragma unroll
    for (int s = kLog - 1; s >= 0; --s) {
      if (s < p) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int j = i ^ (1 << s);
          if (j > i) {
            const uint32_t a = k[i], b = k[j];
            const bool desc = (i & (1 << p)) == 0;
            k[i] = desc ? max(a, b) : min(a, b);
            k[j] = desc ? min(a, b) : max(a, b);
          }
        }
      }
    }
  }
}

// whether any of children 4g..4g+3 of a node row exists: their four codes
// are one uint4
template <int ARITY>
__device__ __forceinline__ bool group_used(const uint4* q, int g) {
  const uint4 c = q[3 * ARITY / 4 + g];
  return (c.x | c.y | c.z | c.w) != 0u;
}

// One thread's stack: in shared memory, entry j at base[32 j] (the warps'
// stacks of depth entries follow their queues), or in local memory, in
// the kernel's Storage array. The array stays out of the walk's struct,
// whose fields would otherwise follow it into local memory.
template <bool LOCAL>
struct Stack {
  struct Storage {};
  uint32_t* base;
  __device__ __forceinline__ void init(uint32_t* smem, int depth, Storage&) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    base = smem + kWarps * kQueue + warp * 32 * depth + lane;
  }
  __device__ __forceinline__ uint32_t& operator[](int j) {
    return base[j * 32];
  }
};

template <>
struct Stack<true> {
  struct Storage {
    uint32_t e[kMaxStack];
  };
  uint32_t* base;
  __device__ __forceinline__ void init(uint32_t*, int, Storage& s) {
    base = s.e;
  }
  __device__ __forceinline__ uint32_t& operator[](int j) { return base[j]; }
};

// dynamic shared memory of a block: the warps' queues, then their stacks
// where these lie in shared memory
template <bool LOCAL>
__host__ __device__ constexpr size_t shared_bytes(int depth) {
  return sizeof(int) * kWarps * kQueue +
         (LOCAL ? 0 : sizeof(uint32_t) * kWarps * 32 * (size_t)depth);
}

// Push the nonzero keys among k[0..N) (cnt of them, distinct) in descending
// order, so the nearest ends on top; a full stack keeps the largest keys
// that fit.
template <int N, class Stk>
__device__ __forceinline__ void push_sorted(uint32_t* k, int cnt, int depth,
                                            Stk& stk, int& sp) {
  if (cnt > 1) {
    sort_desc<N>(k);
  } else if (cnt == 1) {
#pragma unroll
    for (int c = 1; c < N; ++c) k[0] |= k[c];  // the one hit
  }
  const int push = min(cnt, depth - sp);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < push) stk[sp + j] = k[j];
  sp += push;
}

// push_sorted over the fewest keys (N, N / 2, ... down to 4) that cover the
// ``groups`` groups of four up to the last used one: the keys past them
// are 0
template <int N, class Stk>
__device__ __forceinline__ void push_used(uint32_t* k, int cnt, int groups,
                                          int depth, Stk& stk, int& sp) {
  if constexpr (N > 4) {
    if (groups > N / 8) {
      push_sorted<N>(k, cnt, depth, stk, sp);
      return;
    }
    push_used<N / 2>(k, cnt, groups, depth, stk, sp);
  } else {
    push_sorted<4>(k, cnt, depth, stk, sp);
  }
}

// Place hit key k in the node's window stk[sp .. sp + n), which holds the
// largest of the node's hit keys so far in descending order (the nearest
// on top) and at most room = depth - sp of them: an insertion from the top
// (keys are distinct, as their codes are), so the window ends as a
// descending sort of all the node's hit keys would leave it, the largest
// room of them where they do not all fit.
template <class Stk>
__device__ __forceinline__ void insert_desc(Stk& stk, int sp, int room,
                                            int& n, uint32_t k) {
  int j = n;
  if (n == room) {  // full: k takes the smallest's place if it is larger
    if (room == 0 || k < stk[sp + room - 1]) return;
    j = room - 1;
  } else {
    ++n;
  }
  for (; j > 0; --j) {
    const uint32_t below = stk[sp + j - 1];
    if (below > k) break;
    stk[sp + j] = below;
  }
  stk[sp + j] = k;
}

struct Ray {
  float o[3], d[3], inv[3];
  __device__ __forceinline__ void load(const float* __restrict__ orig,
                                       const float* __restrict__ dir, int i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = orig[3ll * i + a];
      d[a] = dir[3ll * i + a];
      inv[a] = safe_inv(d[a]);
    }
  }
};

// The two-level walk's per-lane state: nothing on a single-level walk.
template <bool INSTANCED>
struct Instancing {};

template <>
struct Instancing<true> {
  int inst_base, blas_base;
  float o[3], d[3], inv[3];  // the object-space ray of instance cur
  int cur;                   // the lane's instance, -1 in world space

  __device__ __forceinline__ void reset(const Ray& ray) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = ray.o[a];
      d[a] = ray.d[a];
      inv[a] = ray.inv[a];
    }
    cur = -1;
  }

  // Enter the instance of code (kind 2): its row's BLAS root code, and
  // the object-space ray from the row's A and b.
  template <int VECS>
  __device__ __forceinline__ uint32_t enter(const uint4* __restrict__ table,
                                            uint32_t code, const Ray& ray) {
    const uint4* r = table + (size_t)(inst_base + (int)(code >> 2)) * VECS;
    uint4 q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = __ldg(r + j);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float r0 = __uint_as_float(word(q, 1 + 3 * a));
      const float r1 = __uint_as_float(word(q, 2 + 3 * a));
      const float r2 = __uint_as_float(word(q, 3 + 3 * a));
      o[a] = r0 * ray.o[0] + r1 * ray.o[1] + r2 * ray.o[2] +
             __uint_as_float(word(q, 10 + a));
      d[a] = r0 * ray.d[0] + r1 * ray.d[1] + r2 * ray.d[2];
      inv[a] = safe_inv(d[a]);
    }
    cur = (int)(code >> 2);
    return q[0].x;
  }

  // The ray a node row's children are tested with: world space on a TLAS
  // row (the lane leaves its instance), object space on a BLAS row.
  __device__ __forceinline__ void node_ray(uint32_t code, const Ray& ray,
                                           float no[3], float ninv[3]) {
    const bool world = (int)(code >> 2) < blas_base;
    if (world) cur = -1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      no[a] = world ? ray.o[a] : o[a];
      ninv[a] = world ? ray.inv[a] : inv[a];
    }
  }
};

// The ray of a node row's slab tests (no) and of a leaf row's triangle
// tests (lo, ld): the world ray, or on a two-level walk the space's.
template <bool INSTANCED>
__device__ __forceinline__ void node_ray(Instancing<INSTANCED>& in,
                                         uint32_t code, const Ray& ray,
                                         float no[3], float ninv[3]) {
  if constexpr (INSTANCED) {
    in.node_ray(code, ray, no, ninv);
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      no[a] = ray.o[a];
      ninv[a] = ray.inv[a];
    }
  }
}

template <bool INSTANCED>
__device__ __forceinline__ void leaf_ray(const Instancing<INSTANCED>& in,
                                         const Ray& ray, float lo[3],
                                         float ld[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if constexpr (INSTANCED) {
      lo[a] = in.o[a];
      ld[a] = in.d[a];
    } else {
      lo[a] = ray.o[a];
      ld[a] = ray.d[a];
    }
  }
}

template <int ARITY, int LEAF, bool INSTANCED = false, bool CULL = true,
          bool STAGED = Layout<ARITY, LEAF>::kK2Staged>
struct OccludedWalk {
  using L = Layout<ARITY, LEAF>;
  // the one-thread walks at the wide layouts step in lockstep (pop, then
  // visit: walk_group_rays) and read a node's codes a group of four at a
  // time
  static constexpr bool kLockstep = L::kWide;
  // (kLockstep) the two-level ones leave a leaf at the first third that
  // occludes (the single-level one, 1% faster without, tests it all)
  static constexpr bool kLeafExit = kLockstep && INSTANCED;
  const uint4* __restrict__ table;
  const float* __restrict__ orig;
  const float* __restrict__ dir;
  bool* __restrict__ out;
  float tmin, tmax;
  int depth;
  Stack<L::kLocalStack> stk;
  Ray ray;
  int sp;
  bool occ;
  Instancing<INSTANCED> in;

  __device__ __forceinline__ void miss(int i) const { out[i] = false; }

  __device__ __forceinline__ void begin(int i) {
    ray.load(orig, dir, i);
    stk[0] = 0u;  // the root: code 0 = internal row 0
    sp = 1;
    occ = false;
    if constexpr (INSTANCED) in.reset(ray);
  }

  // The next row to visit: an instance entry's BLAS root, which it tests
  // in the same step.
  __device__ __forceinline__ uint32_t next() {
    uint32_t code = stk[--sp];
    if constexpr (INSTANCED) {
      if ((code & 3u) == kKindInst)
        code = in.template enter<L::kVecs>(table, code, ray);
    }
    return code;
  }

  // One pop; true when the ray is done.
  __device__ __forceinline__ bool step() { return visit(next()); }

  // (kLockstep) the steps of walk_group_rays, a lane a group: pop
  // (there is an entry: a ray is done when its stack empties), then visit
  __device__ __forceinline__ bool pop(uint32_t& code) {
    code = next();
    return true;
  }
  __device__ __forceinline__ void issue(uint32_t) const {}

  // Visit the row of code; true when the ray is done.
  __device__ __forceinline__ bool visit(uint32_t code) {
    uint4 q[L::kVecs];
    // (kLockstep) the row's lines only: its codes are read a group of four
    // at a time below
    const uint4* r = kLockstep
                         ? prefetch_row<ARITY, LEAF>(table, code)
                         : begin_row<ARITY, LEAF, STAGED>(table, code, q);
    if ((code & 3u) == 0u) {
      float o[3], inv[3];
      node_ray<INSTANCED>(in, code, ray, o, inv);
      // children in groups of four; a group with no child is skipped
#pragma unroll
      for (int g = 0; g < ARITY / 4; ++g) {
        uint4 cg{};  // (kLockstep) the group's four codes
        if constexpr (kLockstep) {
          cg = __ldg(r + 3 * ARITY / 4 + g);
          if ((cg.x | cg.y | cg.z | cg.w) == 0u) continue;
        } else if (!group_used<ARITY>(q, g)) {
          continue;
        }
        group_boxes<STAGED>(r, q, g);
#pragma unroll
        for (int c = 4 * g; c < 4 * g + 4; ++c) {
          const uint32_t cc =
              kLockstep ? word(&cg, c - 4 * g) : word(q, 3 * ARITY + c);
          float lo[3], hi[3], tn;
          child_box<ARITY>(q, c, lo, hi);
          const bool hit = slab(lo, hi, o, inv, tmin, tmax, &tn);
          if (cc != 0u && hit && sp < depth) stk[sp++] = cc;
        }
      }
    } else {
      float lo[3], ld[3];
      leaf_ray<INSTANCED>(in, ray, lo, ld);
#pragma unroll
      for (int k = 0; k < LEAF; ++k) {
        if (k % 3 == 0) {
          // (kLeafExit) no further third once one occludes: the answer is
          // the same bool
          if (kLeafExit && occ) break;
          leaf_half<STAGED>(r, q, k / 3);
        }
        float tri[9];
        triangle(q, k, tri);
        occ |= tri_test(tri, lo[0], lo[1], lo[2], ld[0], ld[1], ld[2], tmin,
                        tmax, CULL)
                   .hit;
      }
    }
    return occ || sp == 0;
  }

  __device__ __forceinline__ void end(int i) const { out[i] = occ; }
};

template <int ARITY, int LEAF, bool INSTANCED = false>
struct ClosestWalk {
  using L = Layout<ARITY, LEAF>;
  // the walks at the wide layouts place each hit key by rank
  static constexpr bool kRankPush = L::kWide;
  // the single-level one steps in lockstep (pop, then visit:
  // walk_group_rays)
  static constexpr bool kLockstep = L::kWide && !INSTANCED;
  const uint4* __restrict__ table;
  const float* __restrict__ orig;
  const float* __restrict__ dir;
  float* __restrict__ t_out;
  int* __restrict__ tri_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  float tmin, tmax;
  int depth;
  uint32_t lowmask;
  Stack<L::kLocalStack> stk;
  Ray ray;
  int sp, best;
  float t, u, v;
  Instancing<INSTANCED> in;
  int* __restrict__ inst_out;  // (instanced) the hit's instance
  int best_inst;

  __device__ __forceinline__ void miss(int i) const {
    t_out[i] = FOV_INF;
    tri_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    if constexpr (INSTANCED) inst_out[i] = -1;
  }

  __device__ __forceinline__ void begin(int i) {
    ray.load(orig, dir, i);
    stk[0] = 0u;
    sp = 1;
    best = -1;
    t = FOV_INF;
    u = v = 0.0f;
    if constexpr (INSTANCED) {
      in.reset(ray);
      best_inst = -1;
    }
  }

  // One pop; true when the ray is done.
  __device__ __forceinline__ bool step() {
    const float tlimit = fminf(t, tmax);
    const uint32_t fresh = mono_u32(tlimit) | lowmask;
    uint32_t e = stk[--sp];
    while (e > fresh) {  // stale: its box starts beyond the closest hit
      if (sp == 0) return true;
      e = stk[--sp];
    }
    uint32_t code = e & lowmask;
    // an instance entry tests its BLAS root in the same step: keyed
    // (e & ~lowmask) | root, the root would pop next and not be stale
    if constexpr (INSTANCED) {
      if ((code & 3u) == kKindInst)
        code = in.template enter<L::kVecs>(table, code, ray);
    }
    return visit_row(code, tlimit);
  }

  // (kLockstep) the steps of walk_group_rays, a lane a group: pop the next
  // entry that is not stale, false when none is left (the ray is done);
  // then visit its row. t does not change while a lane holds its row, so
  // the visit tests it against the tlimit of the pop.
  __device__ __forceinline__ bool pop(uint32_t& code) {
    const uint32_t fresh = mono_u32(fminf(t, tmax)) | lowmask;
    uint32_t e;
    do {
      if (sp == 0) return false;
      e = stk[--sp];
    } while (e > fresh);
    code = e & lowmask;
    return true;
  }
  __device__ __forceinline__ void issue(uint32_t) const {}
  __device__ __forceinline__ bool visit(uint32_t code) {
    return visit_row(code, fminf(t, tmax));
  }

  // Test the row of code against tlimit = min(t, tmax); true when the ray
  // is done.
  __device__ __forceinline__ bool visit_row(uint32_t code, float tlimit) {
    uint4 q[L::kVecs];
    // (kRankPush) the row's lines only: its codes are read a group of four
    // at a time below
    const uint4* r =
        kRankPush ? prefetch_row<ARITY, LEAF>(table, code)
                  : begin_row<ARITY, LEAF, kK1StagedRow>(table, code, q);
    if ((code & 3u) == 0u) {
      float o[3], inv[3];
      node_ray<INSTANCED>(in, code, ray, o, inv);
      const uint32_t himask = ~lowmask;
      if constexpr (kRankPush) {
        // each hit key inserted into the node's window as it is found: no
        // key array, no sorting network
        const int room = depth - sp;
        int cnt = 0;
#pragma unroll
        for (int g = 0; g < ARITY / 4; ++g) {
          const uint4 cg = __ldg(r + 3 * ARITY / 4 + g);  // its four codes
          if ((cg.x | cg.y | cg.z | cg.w) == 0u) continue;
          group_boxes<kK1StagedRow>(r, q, g);
          uint32_t k4[4];
          unsigned hits = 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t cc = c == 0 ? cg.x : c == 1 ? cg.y
                                : c == 2 ? cg.z : cg.w;
            float lo[3], hi[3], tn;
            child_box<ARITY>(q, 4 * g + c, lo, hi);
            const bool hit =
                slab(lo, hi, o, inv, tmin, tlimit, &tn) && cc != 0u;
            k4[c] = (mono_u32(tn) & himask) | cc;
            hits |= (unsigned)hit << c;
          }
          while (hits != 0u) {
            const int c = __ffs(hits) - 1;
            hits &= hits - 1u;
            const uint32_t k = c == 0 ? k4[0] : c == 1 ? k4[1]
                               : c == 2 ? k4[2] : k4[3];
            insert_desc(stk, sp, room, cnt, k);
          }
        }
        sp += cnt;
      } else {
        uint32_t key[ARITY];  // a hit child's key, 0 for a miss or empty
        int cnt = 0;
        int groups = 1;  // the groups up to the last one that has a child
        // children in groups of four; a group with no child is skipped
#pragma unroll
        for (int g = 0; g < ARITY / 4; ++g) {
          const bool used = group_used<ARITY>(q, g);
          if (used) groups = g + 1;
#pragma unroll
          for (int c = 4 * g; c < 4 * g + 4; ++c) key[c] = 0u;
          if (!used) continue;
          group_boxes<kK1StagedRow>(r, q, g);
#pragma unroll
          for (int c = 4 * g; c < 4 * g + 4; ++c) {
            const uint32_t cc = word(q, 3 * ARITY + c);
            float lo[3], hi[3], tn;
            child_box<ARITY>(q, c, lo, hi);
            const bool hit =
                slab(lo, hi, o, inv, tmin, tlimit, &tn) && cc != 0u;
            key[c] = hit ? (mono_u32(tn) & himask) | cc : 0u;
            cnt += hit;
          }
        }
        push_used<ARITY>(key, cnt, groups, depth, stk, sp);
      }
    } else {
      const int* ids = reinterpret_cast<const int*>(r) + 9 * LEAF;
      float lo[3], ld[3];
      leaf_ray<INSTANCED>(in, ray, lo, ld);
#pragma unroll
      for (int k = 0; k < LEAF; ++k) {
        if (k % 3 == 0) leaf_half<kK1StagedRow>(r, q, k / 3);
        float tri[9];
        triangle(q, k, tri);
        const TriHit h = tri_test(tri, lo[0], lo[1], lo[2], ld[0], ld[1],
                                  ld[2], tmin, tmax, false);
        if (h.hit && h.t < t) {
          t = h.t;
          u = h.u;
          v = h.v;
          best = __ldg(ids + k);
          if constexpr (INSTANCED) best_inst = in.cur;
        }
      }
    }
    return sp == 0;
  }

  __device__ __forceinline__ void end(int i) const {
    t_out[i] = t;
    tri_out[i] = best;
    u_out[i] = u;
    v_out[i] = v;
    if constexpr (INSTANCED) inst_out[i] = best_inst;
  }
};

// The persistent loop of one warp. Every branch that decides whether the
// warp goes on is taken on values that all 32 lanes hold alike (ballots and
// a broadcast), so the *_sync calls always see the full warp.
template <int REFILL_IDLE, class Walk>
__device__ __forceinline__ void walk_rays(Walk& w,
                                          const unsigned char* __restrict__ active,
                                          int n, const int* __restrict__ count,
                                          int* __restrict__ counter,
                                          int* __restrict__ queue) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int mine = -1;  // this lane's ray, -1 = idle
  int head = 0, queued = 0;  // the warp's queue window [head, head + queued)
  bool drained = false;      // the counter has passed n
  while (true) {
    // fetch chunks of 32 lanes until every idle lane has a ray waiting
    const unsigned idle = __ballot_sync(kFull, mine < 0);
    const int want = __popc(idle);
    fill_queue(active, n, count, counter, queue, head, queued, drained, want,
               [&](int i) { w.miss(i); });
    __syncwarp();
    if (mine < 0) {
      const int r = __popc(idle & below);
      if (r < queued) {
        mine = queue[(head + r) & (kQueue - 1)];
        w.begin(mine);
      }
    }
    const int took = min(want, queued);
    head += took;
    queued -= took;
    __syncwarp();
    if (__ballot_sync(kFull, mine >= 0) == 0) return;
    // walk until enough lanes are idle to refill (to the end once no ray
    // is left to fetch)
    const int limit = drained && queued == 0 ? 32 : REFILL_IDLE;
    while (true) {
      if (mine >= 0 && w.step()) {
        w.end(mine);
        mine = -1;
      }
      if (__popc(__ballot_sync(kFull, mine < 0)) >= limit) break;
    }
  }
}

// groups of a warp that must be idle before they take new rays: one (K1
// waiting for all its groups was 4% faster on the 10M frame's primary
// lanes but 2% slower over the frame's four launches, whose bounce rays
// end unevenly; K2 17% slower)
constexpr int kGroupRefillIdle = 1;

// the lowest lane of every group of g lanes of a warp
__host__ __device__ constexpr unsigned group_leaders(int g) {
  unsigned m = 0u;
  for (int l = 0; l < 32; l += g) m |= 1u << l;
  return m;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The persistent loop of one warp whose groups of G lanes each walk a ray:
// walk_rays with a group, not a lane, taking each queued ray, once
// REFILL_IDLE groups are idle (G = 1: the one-thread walks' lockstep steps
// at the wide layouts, a lane a ray). A group's lanes hold its ray
// (mine) alike; every branch that decides whether the warp goes on is
// taken on values all 32 lanes hold alike. The groups of a
// warp step in lockstep: each pops its next entry and starts its row's
// copy, the warp waits once for all of them, then the groups whose rows
// are of the kind more groups hold (node or leaf) visit them; the others
// keep their rows for a later step.
template <int G, class Walk, int REFILL_IDLE = kGroupRefillIdle>
__device__ __forceinline__ void walk_group_rays(
    Walk& w, const unsigned char* __restrict__ active, int n,
    const int* __restrict__ count, int* __restrict__ counter,
    int* __restrict__ queue) {
  constexpr int kGroups = 32 / G;
  constexpr unsigned kLeaders = group_leaders(G);
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << (lane & ~(G - 1))) - 1u;  // earlier groups
  int mine = -1;  // this group's ray, -1 = idle
  int head = 0, queued = 0;  // the warp's queue window [head, head + queued)
  bool drained = false;      // the counter has passed n
  uint32_t code = 0u;        // the group's entry popped and copied
  bool held = false;         // ... and not visited yet
  while (true) {
    // fetch chunks of 32 lanes until every idle group has a ray waiting
    const unsigned idle = __ballot_sync(kFull, mine < 0) & kLeaders;
    const int want = __popc(idle);
    fill_queue(active, n, count, counter, queue, head, queued, drained, want,
               [&](int i) { w.miss(i); });
    __syncwarp();
    if (mine < 0) {
      const int r = __popc(idle & before);
      if (r < queued) {
        mine = queue[(head + r) & (kQueue - 1)];
        w.begin(mine);
      }
    }
    const int took = min(want, queued);
    head += took;
    queued -= took;
    __syncwarp();
    if (__ballot_sync(kFull, mine >= 0) == 0) return;
    // walk until enough groups are idle to refill (to the end once no ray
    // is left to fetch)
    const int limit = drained && queued == 0 ? kGroups : REFILL_IDLE;
    while (true) {
      __syncwarp();  // the last visits' pushes and buffer reads are done
      if (mine >= 0 && !held) {
        if (w.pop(code)) {
          w.issue(code);
          held = true;
        } else {
          w.end(mine);
          mine = -1;
        }
      }
      cp_async_wait_all();
      __syncwarp();
      // visit one kind of row a step, the kind more groups hold, so the
      // warp runs one of the node and leaf paths (the others keep theirs)
      const bool node = (code & 3u) == 0u;
      const int nodes = __popc(__ballot_sync(kFull, held && node) & kLeaders);
      const int leaves =
          __popc(__ballot_sync(kFull, held && !node) & kLeaders);
      if (held && node == (nodes >= leaves)) {
        held = false;
        if (w.visit(code)) {
          w.end(mine);
          mine = -1;
        }
      }
      if (__popc(__ballot_sync(kFull, mine < 0) & kLeaders) >= limit) break;
    }
  }
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kWideK1MinBlocks : kMinBlocks))
    closest_hit_kernel(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    unsigned int lowmask,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ counter) {
  extern __shared__ uint32_t smem[];
  ClosestWalk<ARITY, LEAF> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.t_out = t_out;
  w.tri_out = tri_out;
  w.u_out = u_out;
  w.v_out = v_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  w.lowmask = lowmask;
  typename decltype(w.stk)::Storage stack;
  w.stk.init(smem, depth, stack);
  int* queue = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * kQueue;
  if constexpr (decltype(w)::kLockstep)  // lockstep steps, a lane a ray
    walk_group_rays<1, decltype(w), kK1RefillIdle>(w, active, n, count,
                                                   counter, queue);
  else
    walk_rays<kK1RefillIdle>(w, active, n, count, counter, queue);
}

// The single-level K2 of both kernels below.
template <int ARITY, int LEAF, bool CULL>
__device__ __forceinline__ void occluded_walk(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    bool* __restrict__ occ_out,
    int* __restrict__ counter) {
  extern __shared__ uint32_t smem[];
  OccludedWalk<ARITY, LEAF, false, CULL> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.out = occ_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  typename decltype(w.stk)::Storage stack;
  w.stk.init(smem, depth, stack);
  int* queue = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * kQueue;
  if constexpr (decltype(w)::kLockstep)  // lockstep steps, a lane a ray
    walk_group_rays<1, decltype(w), kWideK2RefillIdle>(w, active, n,
                                                       count, counter, queue);
  else
    walk_rays<kK2RefillIdle>(w, active, n, count, counter, queue);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kWideK2MinBlocks : kMinBlocks))
    occluded_kernel(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    bool* __restrict__ occ_out,
    int* __restrict__ counter) {
  occluded_walk<ARITY, LEAF, true>(table, orig, dir, active, n, count, tmin,
                                   tmax, depth, occ_out, counter);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kWideK2MinBlocks : kMinBlocks))
    occluded_nocull_kernel(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    bool* __restrict__ occ_out,
    int* __restrict__ counter) {
  occluded_walk<ARITY, LEAF, false>(table, orig, dir, active, n, count, tmin,
                                    tmax, depth, occ_out, counter);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kInstWideMinBlocks : kMinBlocks))
    closest_hit_instanced_kernel(
        const uint4* __restrict__ table, const float* __restrict__ orig,
        const float* __restrict__ dir,
        const unsigned char* __restrict__ active, int n,
        const int* __restrict__ count, float tmin, float tmax, int depth,
        unsigned int lowmask,
        float* __restrict__ t_out, int* __restrict__ tri_out,
        float* __restrict__ u_out, float* __restrict__ v_out,
        int* __restrict__ counter, int inst_base, int blas_base,
        int* __restrict__ inst_out) {
  extern __shared__ uint32_t smem[];
  ClosestWalk<ARITY, LEAF, true> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.t_out = t_out;
  w.tri_out = tri_out;
  w.u_out = u_out;
  w.v_out = v_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  w.lowmask = lowmask;
  typename decltype(w.stk)::Storage stack;
  w.stk.init(smem, depth, stack);
  w.in.inst_base = inst_base;
  w.in.blas_base = blas_base;
  w.inst_out = inst_out;
  walk_rays<kK1RefillIdle>(
      w, active, n, count, counter,
      reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * kQueue);
}

// ---------------------------------------------------------------------------
// The (32, 12) layout's walks: a group of G lanes per ray
// ---------------------------------------------------------------------------

// The group walks' design, K1 (CLOSEST) and K2: G, the lanes of a ray, and
// where its stack lies, chosen by timing G = 4, 8, 16 and both homes on the
// 10M-triangle frame's lanes (PERF.md). K1: G = 4, the stack in global
// memory (the wrapper's buffer), which leaves shared memory to 8 blocks an
// SM, 256 rays (a shared stack of depth 164 leaves 5); K2: G = 8, the
// stack in shared memory.
template <bool CLOSEST>
struct GroupDesign {
  static constexpr int kLanes = CLOSEST ? 4 : 8;
  static constexpr bool kGlobalStack = CLOSEST;
};
// resident blocks per SM asked of the register allocator by the group
// walks (8: 64 registers)
constexpr int kGroupMinBlocks = 8;

template <int ARITY, int LEAF, int G>
struct Grouped {
  static_assert(32 % G == 0, "a group is lanes of one warp");
  static_assert(ARITY % (4 * G) == 0 && LEAF % 2 == 0,
                "a lane owns children in fours (whole uint4s of box words "
                "and codes); a leaf row is whole uint4s");
  static constexpr int kChildren = ARITY / G;       // a lane's children
  static constexpr int kTris = (LEAF + G - 1) / G;  // a lane's triangles
  static constexpr int kRays = kThreads / G;        // a block's rays
  // the uint4s a step copies: a node row (boxes, codes), a leaf row's
  // triangles and ids
  static constexpr int kNodeVecs = ARITY;
  static constexpr int kLeafVecs = 10 * LEAF / 4;
  static constexpr int kCopies =
      ((kNodeVecs > kLeafVecs ? kNodeVecs : kLeafVecs) + G - 1) / G;
  // a ray's row buffer in words, padded to 8 mod 32 so the four rays of a
  // warp (at G = 8) read their triangles' words from 32 distinct banks
  static constexpr int kRowWords =
      4 * (kNodeVecs > kLeafVecs ? kNodeVecs : kLeafVecs);
  static constexpr int kBufWords = kRowWords + (40 - kRowWords % 32) % 32;
};

// dynamic shared memory of a group walk's block: the warps' queues, then
// each ray's row buffer, then (K1) each ray's ARITY-entry key scratch (its
// hit keys, compacted), then (a shared stack) each ray's stack of depth
// entries
template <int ARITY, int LEAF, bool CLOSEST>
__host__ __device__ constexpr size_t group_shared_bytes(int depth) {
  using D = GroupDesign<CLOSEST>;
  using P = Grouped<ARITY, LEAF, D::kLanes>;
  return sizeof(int) * kWarps * kQueue +
         sizeof(uint32_t) * P::kRays *
             (P::kBufWords + (CLOSEST ? ARITY : 0) +
              (D::kGlobalStack ? 0 : (size_t)depth));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

// n words of shared memory from s (16-byte aligned) into w
template <int N>
__device__ __forceinline__ void shared_words(const uint32_t* s,
                                             uint32_t (&w)[N]) {
  static_assert(N % 4 == 0, "whole uint4s");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(s)[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

// A ray walked by the G lanes of a group: the state every lane holds alike
// (the ray, the stack pointer), the ray's row buffer (and K1's key scratch)
// in shared memory, its stack, and the steps both walks share.
template <int ARITY, int LEAF, bool CLOSEST>
struct GroupRay {
  using D = GroupDesign<CLOSEST>;
  static constexpr int G = D::kLanes;
  using P = Grouped<ARITY, LEAF, G>;
  const uint4* __restrict__ table;
  const float* __restrict__ orig;
  const float* __restrict__ dir;
  float tmin, tmax;
  int depth;
  unsigned gmask;  // the group's lanes
  int jl;          // this lane's index in the group
  uint32_t* buf;   // the ray's row buffer
  uint32_t* keys;  // the ray's key scratch (K1)
  uint32_t* stk;   // the ray's stack
  Ray ray;
  int sp;

  // smem: the block's dynamic shared memory; gstack: the global stack
  // buffer, kRays * depth entries a block (a global stack only)
  __device__ __forceinline__ void init(uint32_t* smem, uint32_t* gstack) {
    constexpr int kKeys = CLOSEST ? ARITY : 0;
    const int lane = threadIdx.x & 31;
    jl = lane & (G - 1);
    gmask = G == 32 ? kFull : ((1u << (G & 31)) - 1u) << (lane & ~(G - 1));
    const int slot = threadIdx.x / G;
    uint32_t* base = smem + kWarps * kQueue;
    buf = base + slot * P::kBufWords;
    keys = base + P::kRays * P::kBufWords + slot * kKeys;
    if constexpr (D::kGlobalStack)
      stk = gstack + ((size_t)blockIdx.x * P::kRays + slot) * depth;
    else
      stk = base + P::kRays * (P::kBufWords + kKeys) + slot * depth;
  }

  __device__ __forceinline__ void start(int i) {
    ray.load(orig, dir, i);
    if (jl == 0) stk[0] = 0u;  // the root: code 0 = internal row 0
    sp = 1;
  }

  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(gmask, p) & gmask;
  }

  // The hit children's positions in slot order (a lane's children follow
  // the lanes before it): pos[i] for this lane's hit child i, and cnt,
  // the node's hit children.
  __device__ __forceinline__ void slot_order(const bool (&hit)[P::kChildren],
                                             int (&pos)[P::kChildren],
                                             int& cnt) const {
    const unsigned before = (1u << (threadIdx.x & 31)) - 1u;
    int below = 0;
    cnt = 0;
#pragma unroll
    for (int i = 0; i < P::kChildren; ++i) {
      const unsigned b = ballot(hit[i]);
      cnt += __popc(b);
      below += __popc(b & before);
    }
#pragma unroll
    for (int i = 0; i < P::kChildren; ++i) {
      pos[i] = below;
      below += hit[i];
    }
  }

  // Start copying the row of entry code into the ray's buffer: the
  // group's lanes take every G-th uint4, so each pass reads contiguous
  // bytes. The warp waits for every group's copies at once.
  __device__ __forceinline__ void issue(uint32_t code) const {
    const uint4* r = table + (size_t)(code >> 2) * Layout<ARITY, LEAF>::kVecs;
    const int vecs = (code & 3u) == 0u ? P::kNodeVecs : P::kLeafVecs;
    uint4* dst = reinterpret_cast<uint4*>(buf);
#pragma unroll
    for (int m = 0; m < P::kCopies; ++m) {
      const int q = jl + G * m;
      if (q < vecs) cp_async16(dst + q, r + q);
    }
  }

  // Slab-test this lane's children kChildren jl .. kChildren (jl + 1) - 1
  // of the node row in the buffer: hit (a non-empty child whose box the
  // ray enters before tlimit), its entry code and tn.
  __device__ __forceinline__ void children(float tlimit,
                                           bool (&hit)[P::kChildren],
                                           uint32_t (&code)[P::kChildren],
                                           float (&tn)[P::kChildren]) const {
    constexpr int C = P::kChildren;
    uint32_t box[3 * C];
    shared_words<3 * C>(buf + 3 * C * jl, box);
    shared_words<C>(buf + 3 * ARITY + C * jl, code);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = __uint_as_float(box[3 * i + a] & 0xFFFF0000u);
        hi[a] = __uint_as_float(box[3 * i + a] << 16);
      }
      hit[i] = slab(lo, hi, ray.o, ray.inv, tmin, tlimit, &tn[i]) &&
               code[i] != 0u;
    }
  }

  // triangle k of the leaf row in the buffer
  __device__ __forceinline__ void triangle(int k, float tri[9]) const {
#pragma unroll
    for (int j = 0; j < 9; ++j) tri[j] = __uint_as_float(buf[9 * k + j]);
  }
};

template <int ARITY, int LEAF, bool CULL>
struct OccludedGroupWalk : GroupRay<ARITY, LEAF, false> {
  using B = GroupRay<ARITY, LEAF, false>;
  using P = typename B::P;
  bool* __restrict__ out;
  bool occ;

  __device__ __forceinline__ void miss(int i) const { out[i] = false; }

  __device__ __forceinline__ void begin(int i) {
    B::start(i);
    occ = false;
  }

  // The next entry to visit (there is one: a ray is done when its stack
  // empties).
  __device__ __forceinline__ bool pop(uint32_t& code) {
    code = B::stk[--B::sp];
    return true;
  }

  // Visit the row of code, in the buffer; true when the ray is done. Hit
  // children are pushed in slot order (a lane's children follow the lanes
  // before it), the first depth - sp of them where they do not all fit.
  __device__ __forceinline__ bool visit(uint32_t code) {
    if ((code & 3u) == 0u) {
      constexpr int C = P::kChildren;
      bool hit[C];
      uint32_t cc[C];
      float tn[C];
      B::children(B::tmax, hit, cc, tn);
      int pos[C], cnt;
      B::slot_order(hit, pos, cnt);
      const int room = B::depth - B::sp;
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (hit[i] && pos[i] < room) B::stk[B::sp + pos[i]] = cc[i];
      B::sp += min(cnt, room);
    } else {
      bool any = false;
#pragma unroll
      for (int m = 0; m < P::kTris; ++m) {
        const int k = B::jl + B::G * m;
        if (k < LEAF) {
          float tri[9];
          B::triangle(k, tri);
          any |= tri_test(tri, B::ray.o[0], B::ray.o[1], B::ray.o[2],
                          B::ray.d[0], B::ray.d[1], B::ray.d[2], B::tmin,
                          B::tmax, CULL)
                     .hit;
        }
      }
      occ = B::ballot(any) != 0u;
    }
    return occ || B::sp == 0;
  }

  __device__ __forceinline__ void end(int i) const {
    if (B::jl == 0) out[i] = occ;
  }
};

template <int ARITY, int LEAF>
struct ClosestGroupWalk : GroupRay<ARITY, LEAF, true> {
  using B = GroupRay<ARITY, LEAF, true>;
  using P = typename B::P;
  float* __restrict__ t_out;
  int* __restrict__ tri_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  uint32_t lowmask;
  int best;
  float t, u, v;

  __device__ __forceinline__ void miss(int i) const {
    t_out[i] = FOV_INF;
    tri_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
  }

  __device__ __forceinline__ void begin(int i) {
    B::start(i);
    best = -1;
    t = FOV_INF;
    u = v = 0.0f;
  }

  // The next entry to visit, skipping stale ones (their boxes start
  // beyond the closest hit); false when none is left: the ray is done.
  __device__ __forceinline__ bool pop(uint32_t& code) {
    const uint32_t fresh = mono_u32(fminf(t, B::tmax)) | lowmask;
    uint32_t e;
    do {
      if (B::sp == 0) return false;
      e = B::stk[--B::sp];
    } while (e > fresh);
    code = e & lowmask;
    return true;
  }

  // Visit the row of code, in the buffer; true when the ray is done. A
  // node's hit keys go to stk[sp + rank], rank = the hit keys above the key
  // (distinct, as their codes are): the stack a descending sort leaves,
  // nearest on top; a full stack keeps the largest keys, rank < depth - sp.
  // A leaf's closest hit is the (t, slot) minimum over the group: the
  // lowest slot among equal t, as the serial t < best loop keeps.
  __device__ __forceinline__ bool visit(uint32_t code) {
    const float tlimit = fminf(t, B::tmax);
    if ((code & 3u) == 0u) {
      constexpr int C = P::kChildren;
      bool hit[C];
      uint32_t key[C];
      float tn[C];
      B::children(tlimit, hit, key, tn);
      const uint32_t himask = ~lowmask;
      int pos[C], cnt;
      B::slot_order(hit, pos, cnt);
      // the hit keys, compacted into the ray's scratch; lane l then ranks
      // keys l, l + G, ...
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (hit[i]) B::keys[pos[i]] = (mono_u32(tn[i]) & himask) | key[i];
      __syncwarp(B::gmask);
      const int push = min(cnt, B::depth - B::sp);
      for (int q = B::jl; q < cnt; q += B::G) {
        const uint32_t k = B::keys[q];
        int rank = 0;
        for (int x = 0; x < cnt; ++x) rank += B::keys[x] > k;
        if (rank < push) B::stk[B::sp + rank] = k;
      }
      B::sp += push;
    } else {
      float bt = FOV_INF, bu = 0.0f, bv = 0.0f;
      int bk = LEAF;
#pragma unroll
      for (int m = 0; m < P::kTris; ++m) {
        const int k = B::jl + B::G * m;
        if (k < LEAF) {
          float tri[9];
          B::triangle(k, tri);
          const TriHit h =
              tri_test(tri, B::ray.o[0], B::ray.o[1], B::ray.o[2],
                       B::ray.d[0], B::ray.d[1], B::ray.d[2], B::tmin,
                       B::tmax, false);
          if (h.hit && h.t < bt) {
            bt = h.t;
            bu = h.u;
            bv = h.v;
            bk = k;
          }
        }
      }
#pragma unroll
      for (int off = B::G / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(B::gmask, bt, off);
        const float ou = __shfl_xor_sync(B::gmask, bu, off);
        const float ov = __shfl_xor_sync(B::gmask, bv, off);
        const int ok = __shfl_xor_sync(B::gmask, bk, off);
        if (ot < bt || (ot == bt && ok < bk)) {
          bt = ot;
          bu = ou;
          bv = ov;
          bk = ok;
        }
      }
      if (bt < t) {
        t = bt;
        u = bu;
        v = bv;
        best = static_cast<int>(B::buf[9 * LEAF + bk]);
      }
    }
    return B::sp == 0;
  }

  __device__ __forceinline__ void end(int i) const {
    if (B::jl == 0) {
      t_out[i] = t;
      tri_out[i] = best;
      u_out[i] = u;
      v_out[i] = v;
    }
  }
};

// The two-level K2 of both kernels below: at the wide layouts in the group
// walks' lockstep loop with one lane a group (below their loop,
// walk_group_rays).
template <int ARITY, int LEAF, bool CULL>
__device__ __forceinline__ void occluded_instanced_walk(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    bool* __restrict__ occ_out,
    int* __restrict__ counter, int inst_base, int blas_base) {
  extern __shared__ uint32_t smem[];
  OccludedWalk<ARITY, LEAF, true, CULL, kIK2StagedRow> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.out = occ_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  typename decltype(w.stk)::Storage stack;
  w.stk.init(smem, depth, stack);
  w.in.inst_base = inst_base;
  w.in.blas_base = blas_base;
  int* queue = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * kQueue;
  if constexpr (Layout<ARITY, LEAF>::kWide)  // lockstep steps, a lane a ray
    walk_group_rays<1, decltype(w), kWideK2RefillIdle>(w, active, n,
                                                       count, counter, queue);
  else
    walk_rays<kIK2RefillIdle>(w, active, n, count, counter, queue);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kInstWideMinBlocks : kMinBlocks))
    occluded_instanced_kernel(
        const uint4* __restrict__ table, const float* __restrict__ orig,
        const float* __restrict__ dir,
        const unsigned char* __restrict__ active, int n,
        const int* __restrict__ count, float tmin, float tmax, int depth,
        bool* __restrict__ occ_out,
        int* __restrict__ counter, int inst_base, int blas_base) {
  occluded_instanced_walk<ARITY, LEAF, true>(table, orig, dir, active, n,
                                             count, tmin, tmax, depth, occ_out,
                                             counter, inst_base, blas_base);
}

// The two-level K2 without back-face culling (the 04 raycast of an
// instanced scene): a triangle occludes where |det| > 1e-9.
template <int ARITY, int LEAF>
__global__ void __launch_bounds__(
    kThreads, (Layout<ARITY, LEAF>::kWide ? kInstWideMinBlocks : kMinBlocks))
    occluded_nocull_instanced_kernel(
        const uint4* __restrict__ table, const float* __restrict__ orig,
        const float* __restrict__ dir,
        const unsigned char* __restrict__ active, int n,
        const int* __restrict__ count, float tmin, float tmax, int depth,
        bool* __restrict__ occ_out,
        int* __restrict__ counter, int inst_base, int blas_base) {
  occluded_instanced_walk<ARITY, LEAF, false>(table, orig, dir, active, n,
                                              count, tmin, tmax, depth, occ_out,
                                              counter, inst_base, blas_base);
}

// stack: the global stack buffer, kRays * depth entries a block
template <int ARITY, int LEAF>
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    closest_hit_group_kernel(
        const uint4* __restrict__ table, const float* __restrict__ orig,
        const float* __restrict__ dir,
        const unsigned char* __restrict__ active, int n,
        const int* __restrict__ count, float tmin, float tmax, int depth,
        unsigned int lowmask,
        float* __restrict__ t_out, int* __restrict__ tri_out,
        float* __restrict__ u_out, float* __restrict__ v_out,
        int* __restrict__ counter, uint32_t* __restrict__ stack) {
  extern __shared__ __align__(16) uint32_t group_smem[];
  ClosestGroupWalk<ARITY, LEAF> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.t_out = t_out;
  w.tri_out = tri_out;
  w.u_out = u_out;
  w.v_out = v_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  w.lowmask = lowmask;
  w.init(group_smem, stack);
  walk_group_rays<decltype(w)::G>(
      w, active, n, count, counter,
      reinterpret_cast<int*>(group_smem) + (threadIdx.x >> 5) * kQueue);
}

// The group walks' K2 of both kernels below.
template <int ARITY, int LEAF, bool CULL>
__device__ __forceinline__ void occluded_group_walk(
    const uint4* __restrict__ table, const float* __restrict__ orig,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    int n, const int* __restrict__ count, float tmin, float tmax, int depth,
    bool* __restrict__ occ_out,
    int* __restrict__ counter) {
  extern __shared__ __align__(16) uint32_t group_smem[];
  OccludedGroupWalk<ARITY, LEAF, CULL> w;
  w.table = table;
  w.orig = orig;
  w.dir = dir;
  w.out = occ_out;
  w.tmin = tmin;
  w.tmax = tmax;
  w.depth = depth;
  w.init(group_smem, nullptr);
  walk_group_rays<decltype(w)::G>(
      w, active, n, count, counter,
      reinterpret_cast<int*>(group_smem) + (threadIdx.x >> 5) * kQueue);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    occluded_group_kernel(const uint4* __restrict__ table,
                          const float* __restrict__ orig,
                          const float* __restrict__ dir,
                          const unsigned char* __restrict__ active, int n,
                          const int* __restrict__ count,
                          float tmin, float tmax, int depth,
                          bool* __restrict__ occ_out,
                          int* __restrict__ counter) {
  occluded_group_walk<ARITY, LEAF, true>(table, orig, dir, active, n, count,
                                         tmin, tmax, depth, occ_out, counter);
}

template <int ARITY, int LEAF>
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    occluded_nocull_group_kernel(const uint4* __restrict__ table,
                                 const float* __restrict__ orig,
                                 const float* __restrict__ dir,
                                 const unsigned char* __restrict__ active,
                                 int n, const int* __restrict__ count,
                                 float tmin, float tmax, int depth,
                                 bool* __restrict__ occ_out,
                                 int* __restrict__ counter) {
  occluded_group_walk<ARITY, LEAF, false>(table, orig, dir, active, n,
                                          count, tmin, tmax, depth, occ_out,
                                          counter);
}

// K1 (which = 0), K2 (1), their instanced variants (2, 3), the
// non-culling K2 (4) and its instanced variant (5), at each layout
constexpr int kKernels = 6;
constexpr int kLayouts = 3;

template <int ARITY, int LEAF>
struct LayoutTag {
  static constexpr int kArity = ARITY, kLeaf = LEAF;
};

// Layout 0 (16, 6), 1 (32, 12), 2 (32, 24); -1 for one not compiled.
int layout_of(int arity, int leaf) {
  if (arity == kArity && leaf == kLeaf) return 0;
  if (arity == 32 && leaf == 12) return 1;
  if (arity == 32 && leaf == 24) return 2;
  return -1;
}

// f(LayoutTag<ARITY, LEAF>{}) for a layout_of index
template <class F>
auto with_layout(int layout, F f) {
  switch (layout) {
    case 1:
      return f(LayoutTag<32, 12>{});
    case 2:
      return f(LayoutTag<32, 24>{});
    default:
      return f(LayoutTag<kArity, kLeaf>{});
  }
}

// the single-level kernels at (32, 12) walk a ray with a group of lanes;
// every other kernel and layout with a lane
template <int A, int L>
constexpr bool kGrouped = A == 32 && L == 12;
constexpr bool grouped_kernel(int which) {
  return which != 2 && which != 3 && which != 5;
}

// K2 (CULL) or the non-culling K2 at a layout
template <int A, int L, bool CULL>
auto occluded_kernel_at() {
  if constexpr (kGrouped<A, L> && CULL)
    return occluded_group_kernel<A, L>;
  else if constexpr (kGrouped<A, L>)
    return occluded_nocull_group_kernel<A, L>;
  else if constexpr (CULL)
    return occluded_kernel<A, L>;
  else
    return occluded_nocull_kernel<A, L>;
}

// kernel ``which`` at a layout, nullptr where it is not compiled
const void* kernel_of(int which, int layout) {
  return with_layout(layout, [which](auto tag) -> const void* {
    constexpr int A = decltype(tag)::kArity, L = decltype(tag)::kLeaf;
    switch (which) {
      case 0:
        if constexpr (kGrouped<A, L>)
          return (const void*)closest_hit_group_kernel<A, L>;
        else
          return (const void*)closest_hit_kernel<A, L>;
      case 1:
        return (const void*)occluded_kernel_at<A, L, true>();
      case 2:
        return (const void*)closest_hit_instanced_kernel<A, L>;
      case 3:
        return (const void*)occluded_instanced_kernel<A, L>;
      case 4:
        return (const void*)occluded_kernel_at<A, L, false>();
      case 5:
        return (const void*)occluded_nocull_instanced_kernel<A, L>;
    }
    return nullptr;
  });
}

// dynamic shared memory of a block of kernel ``which`` at a layout and a
// stack depth
size_t shared_of(int which, int layout, int depth) {
  return with_layout(layout, [which, depth](auto tag) {
    constexpr int A = decltype(tag)::kArity, L = decltype(tag)::kLeaf;
    if constexpr (kGrouped<A, L>) {
      if (grouped_kernel(which))
        return which == 0 ? group_shared_bytes<A, L, true>(depth)
                          : group_shared_bytes<A, L, false>(depth);
    }
    return shared_bytes<Layout<A, L>::kLocalStack>(depth);
  });
}

// The design of kernel ``which`` at a layout: the lanes that walk one ray,
// and where its stack lies (0 shared memory, 1 global memory, 2 local
// memory).
void design_of(int which, int layout, int* lanes, int* stack_home) {
  with_layout(layout, [=](auto tag) {
    constexpr int A = decltype(tag)::kArity, L = decltype(tag)::kLeaf;
    if (kGrouped<A, L> && grouped_kernel(which)) {
      const bool closest = which == 0;
      *lanes = closest ? GroupDesign<true>::kLanes
                       : GroupDesign<false>::kLanes;
      *stack_home = (closest ? GroupDesign<true>::kGlobalStack
                             : GroupDesign<false>::kGlobalStack)
                        ? 1
                        : 0;
    } else {
      *lanes = 1;
      *stack_home = Layout<A, L>::kLocalStack ? 2 : 0;
    }
    return 0;
  });
}

// Resident blocks per SM of kernel ``which`` at a layout and a
// shared-memory size on the current device, and the grid that fills it.
cudaError_t grid_of(int which, int layout, size_t smem, int* per_sm,
                    int* blocks) {
  static GridCache cache[kKernels * kLayouts];
  const void* fn = which >= 0 && which < kKernels && layout >= 0
                       ? kernel_of(which, layout)
                       : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cache[which * kLayouts + layout].get(fn, kThreads, smem, per_sm,
                                              blocks);
}

int launch_grid(int which, int layout, int n, int depth, size_t* smem,
                int* blocks) {
  if (depth < 1 || depth > kMaxStack) return (int)cudaErrorInvalidValue;
  *smem = shared_of(which, layout, depth);
  int per_sm = 0, full = 0;
  const cudaError_t err = grid_of(which, layout, *smem, &per_sm, &full);
  if (err != cudaSuccess) return (int)err;
  const int needed = (n + kThreads - 1) / kThreads;
  *blocks = full < needed ? full : needed;
  return 0;
}

// entries of the global stack buffer kernel ``which`` takes for n lanes at
// a layout and a stack depth (0 where its stacks lie elsewhere)
int global_stack_entries(int which, int layout, int n, int depth,
                         long long* entries) {
  int lanes = 1, home = 0;
  design_of(which, layout, &lanes, &home);
  *entries = 0;
  if (home != 1 || n <= 0) return 0;
  size_t smem = 0;
  int blocks = 0;
  const int rc = launch_grid(which, layout, n, depth, &smem, &blocks);
  *entries = (long long)blocks * (kThreads / lanes) * depth;
  return rc;
}

}  // namespace

// A traversal launch: kernel ``which`` (K1 0, K2 1, instanced K1 2,
// instanced K2 3, non-culling K2 4, non-culling instanced K2 5) at the
// table's (arity, leaf). Each kernel reads the fields it takes and ignores
// the rest.
struct TraverseArgs {
  const float* table;
  const float* orig;            // (n, 3)
  const float* dir;             // (n, 3)
  const unsigned char* active;  // (n,)
  float* t_out;                 // (n,) K1's
  int* tri_out;
  float* u_out;
  float* v_out;
  int* inst_out;  // (n,) the instanced K1's
  bool* occ_out;  // (n,) K2's
  int* counter;   // 1 zeroed int32: hands out the lanes
  // the single-level K1's global stack: fov_traverse_stack entries (none,
  // a null pointer, at the layouts whose stacks lie in shared or local
  // memory)
  unsigned int* stack;
  // the lanes to walk, read on the device (a wavefront's live lanes, which
  // csrc/lanes.cu's compaction counted; at most n); null: all n
  const int* count;
  int which;
  int n;
  float tmin;
  float tmax;
  int stack_depth;
  unsigned int lowmask;  // K1's
  int inst_base;         // the instanced kernels'
  int blas_base;
  int arity;
  int leaf;
};

// Launches the instantiation of the table's layout; any other layout, or
// a ``which`` outside 0-5, returns cudaErrorInvalidValue.
extern "C" int fov_traverse(const TraverseArgs* a, cudaStream_t stream) {
  const int layout = layout_of(a->arity, a->leaf);
  if (layout < 0 || a->which < 0 || a->which >= kKernels)
    return (int)cudaErrorInvalidValue;
  if (a->n > 0) {
    size_t smem = 0;
    int blocks = 0;
    const int rc =
        launch_grid(a->which, layout, a->n, a->stack_depth, &smem, &blocks);
    if (rc != 0) return rc;
    with_layout(layout, [&](auto tag) {
      constexpr int A = decltype(tag)::kArity, L = decltype(tag)::kLeaf;
      const uint4* t = reinterpret_cast<const uint4*>(a->table);
      switch (a->which) {
        case 0:
          if constexpr (kGrouped<A, L>)
            closest_hit_group_kernel<A, L><<<blocks, kThreads, smem, stream>>>(
                t, a->orig, a->dir, a->active, a->n, a->count, a->tmin,
                a->tmax, a->stack_depth, a->lowmask, a->t_out, a->tri_out,
                a->u_out, a->v_out, a->counter, a->stack);
          else
            closest_hit_kernel<A, L><<<blocks, kThreads, smem, stream>>>(
                t, a->orig, a->dir, a->active, a->n, a->count, a->tmin,
                a->tmax, a->stack_depth, a->lowmask, a->t_out, a->tri_out,
                a->u_out, a->v_out, a->counter);
          break;
        case 2:
          closest_hit_instanced_kernel<A, L>
              <<<blocks, kThreads, smem, stream>>>(
                  t, a->orig, a->dir, a->active, a->n, a->count, a->tmin,
                  a->tmax, a->stack_depth, a->lowmask, a->t_out, a->tri_out,
                  a->u_out, a->v_out, a->counter, a->inst_base, a->blas_base,
                  a->inst_out);
          break;
        case 3:
        case 5: {
          const auto kernel = a->which == 3
                                  ? occluded_instanced_kernel<A, L>
                                  : occluded_nocull_instanced_kernel<A, L>;
          kernel<<<blocks, kThreads, smem, stream>>>(
              t, a->orig, a->dir, a->active, a->n, a->count, a->tmin,
              a->tmax, a->stack_depth, a->occ_out, a->counter, a->inst_base,
              a->blas_base);
          break;
        }
        default: {  // K2 (1) or the non-culling K2 (4)
          const auto kernel = a->which == 1 ? occluded_kernel_at<A, L, true>()
                                            : occluded_kernel_at<A, L, false>();
          kernel<<<blocks, kThreads, smem, stream>>>(
              t, a->orig, a->dir, a->active, a->n, a->count, a->tmin,
              a->tmax, a->stack_depth, a->occ_out, a->counter);
        }
      }
      return 0;
    });
  }
  return (int)cudaGetLastError();
}

// The global stack buffer K1 (which 0) or K2 (1, 4) takes for n lanes at
// layout (arity, leaf) and stack_depth: *entries uint32 entries, 0 where
// the kernel keeps its stacks in shared or local memory.
extern "C" int fov_traverse_stack(int which, int arity, int leaf,
                                  int stack_depth, int n,
                                  long long* entries) {
  const int layout = layout_of(arity, leaf);
  if (which < 0 || which >= kKernels || layout < 0 ||
      kernel_of(which, layout) == nullptr)
    return (int)cudaErrorInvalidValue;
  return global_stack_entries(which, layout, n, stack_depth, entries);
}

// Registers per thread, local memory per thread (spills and any stack
// frame), resident blocks per SM and dynamic shared memory per block of
// kernel ``which`` (K1 0, K2 1, instanced K1 2, instanced K2 3, non-culling
// K2 4, non-culling instanced K2 5) at layout (arity, leaf) and
// stack_depth.
extern "C" int fov_traverse_info(int which, int arity, int leaf,
                                 int stack_depth, int* regs,
                                 int* local_bytes, int* blocks_per_sm,
                                 int* shared) {
  const int layout = layout_of(arity, leaf);
  if (which < 0 || which >= kKernels || layout < 0 ||
      kernel_of(which, layout) == nullptr || stack_depth < 1 ||
      stack_depth > kMaxStack)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel_of(which, layout));
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  const size_t smem = shared_of(which, layout, stack_depth);
  *shared = (int)smem;
  int blocks = 0;
  return (int)grid_of(which, layout, smem, blocks_per_sm, &blocks);
}

// The design of kernel ``which`` at layout (arity, leaf): the lanes that
// walk one ray (1, or G for the single-level kernels at (32, 12)), how its rows reach the walk (0:
// 16-byte __ldg's into registers; 1: cp.async into the ray's
// shared-memory buffer) and where its stacks lie (0 shared, 1 global, 2
// local memory).
extern "C" int fov_traverse_design(int which, int arity, int leaf,
                                   int* group_lanes, int* row_copy,
                                   int* stack_home) {
  const int layout = layout_of(arity, leaf);
  if (which < 0 || which >= kKernels || layout < 0 ||
      kernel_of(which, layout) == nullptr)
    return (int)cudaErrorInvalidValue;
  design_of(which, layout, group_lanes, stack_home);
  *row_copy = *group_lanes > 1 ? 1 : 0;
  return 0;
}
