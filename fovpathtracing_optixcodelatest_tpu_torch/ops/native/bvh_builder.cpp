// Native BVH builder: binned-SAH BVH2 -> wide collapse (the PyTorch port's
// own copy; kept byte-for-byte equal in logic to the JAX package's builder so
// both packages pack identical tables).
//
// The TPU framework's equivalent of the reference's GPU-side
// optixAccelBuild (SimplePathtracer.cpp:602-746) is a *host*-side build;
// numpy handles small scenes but San-Miguel-class inputs (~1e7 triangles,
// see the reference's benchmark tags) need native speed. This builder
// produces exactly the WideBVH layout consumed by ops/traverse8.py:
//   boxes (M, 8, 6) f32   child AABBs (empty slots inverted)
//   meta  (M, 8, 2) i32   [a, count]: count>0 leaf (a=tri_offset),
//                          count==0 internal (a=child node), count==-1 empty
//   tri_perm (S,) i32     leaf slot -> original triangle id
//
// Exposed through a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float sa() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB box;
  int64_t start = 0;  // range into order[]
  int64_t count = 0;  // 0 for internal
  int32_t left = -1, right = -1;
};

constexpr int kBins = 16;

struct Builder {
  const float* tris;  // T*9
  int64_t T;
  int leaf_size;
  std::vector<AABB> prim_box;
  std::vector<Vec3> centroid;
  std::vector<int64_t> order;
  std::vector<Node> nodes;

  void prim_setup() {
    prim_box.resize(T);
    centroid.resize(T);
    order.resize(T);
    for (int64_t i = 0; i < T; ++i) {
      const float* p = tris + i * 9;
      Vec3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
      AABB bb;
      bb.grow(a);
      bb.grow(b);
      bb.grow(c);
      prim_box[i] = bb;
      centroid[i] = {(bb.lo.x + bb.hi.x) * 0.5f, (bb.lo.y + bb.hi.y) * 0.5f,
                     (bb.lo.z + bb.hi.z) * 0.5f};
      order[i] = i;
    }
  }

  int32_t make_node(int64_t start, int64_t count) {
    Node n;
    for (int64_t i = start; i < start + count; ++i)
      n.box.grow(prim_box[order[i]]);
    n.start = start;
    n.count = count;
    nodes.push_back(n);
    return (int32_t)nodes.size() - 1;
  }

  void build() {
    prim_setup();
    nodes.reserve((size_t)(2.0 * T / std::max(1, leaf_size / 2) + 16));
    std::vector<int32_t> stack;
    stack.push_back(make_node(0, T));
    std::vector<int64_t> tmp;
    while (!stack.empty()) {
      int32_t ni = stack.back();
      stack.pop_back();
      // nodes may reallocate; use index access
      int64_t start = nodes[ni].start, count = nodes[ni].count;
      if (count <= leaf_size) continue;

      // centroid bounds + widest axis
      AABB cb;
      for (int64_t i = start; i < start + count; ++i) cb.grow(centroid[order[i]]);
      float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
      int axis = 0;
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;
      int64_t mid = 0;

      if (ext[axis] > 1e-12f) {
        // binned SAH
        float cmin = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
        float scale = kBins * (1.0f - 1e-6f) / ext[axis];
        AABB bin_box[kBins];
        int64_t bin_n[kBins] = {0};
        for (int64_t i = start; i < start + count; ++i) {
          int64_t id = order[i];
          float c = axis == 0 ? centroid[id].x
                              : (axis == 1 ? centroid[id].y : centroid[id].z);
          int b = (int)((c - cmin) * scale);
          b = std::min(std::max(b, 0), kBins - 1);
          bin_box[b].grow(prim_box[id]);
          bin_n[b]++;
        }
        AABB lbox[kBins - 1], rbox[kBins - 1];
        int64_t lcnt[kBins - 1], rcnt[kBins - 1];
        {
          AABB acc;
          int64_t n = 0;
          for (int b = 0; b < kBins - 1; ++b) {
            acc.grow(bin_box[b]);
            n += bin_n[b];
            lbox[b] = acc;
            lcnt[b] = n;
          }
          acc = AABB();
          n = 0;
          for (int b = kBins - 2; b >= 0; --b) {
            acc.grow(bin_box[b + 1]);
            n += bin_n[b + 1];
            rbox[b] = acc;
            rcnt[b] = n;
          }
        }
        float best_cost = FLT_MAX;
        int best = -1;
        for (int b = 0; b < kBins - 1; ++b) {
          if (lcnt[b] == 0 || rcnt[b] == 0) continue;
          float cost = lbox[b].sa() * lcnt[b] + rbox[b].sa() * rcnt[b];
          if (cost < best_cost) {
            best_cost = cost;
            best = b;
          }
        }
        if (best >= 0) {
          // partition
          tmp.assign(order.begin() + start, order.begin() + start + count);
          int64_t l = start, r = start + count;
          for (int64_t k = 0; k < count; ++k) {
            int64_t id = tmp[k];
            float c = axis == 0 ? centroid[id].x
                                : (axis == 1 ? centroid[id].y : centroid[id].z);
            int b = (int)((c - cmin) * scale);
            b = std::min(std::max(b, 0), kBins - 1);
            if (b <= best)
              order[l++] = id;
            else
              order[--r] = id;
          }
          // restore right-half order (we filled it reversed)
          std::reverse(order.begin() + r, order.begin() + start + count);
          mid = l - start;
          if (mid == 0 || mid == count) mid = 0;
        }
      }
      if (mid == 0) {
        // median split by centroid
        mid = count / 2;
        std::nth_element(
            order.begin() + start, order.begin() + start + mid,
            order.begin() + start + count, [&](int64_t a, int64_t b) {
              float ca = axis == 0 ? centroid[a].x
                                   : (axis == 1 ? centroid[a].y : centroid[a].z);
              float cb2 = axis == 0 ? centroid[b].x
                                    : (axis == 1 ? centroid[b].y : centroid[b].z);
              return ca < cb2;
            });
      }
      int32_t li = make_node(start, mid);
      int32_t ri = make_node(start + mid, count - mid);
      nodes[ni].left = li;
      nodes[ni].right = ri;
      nodes[ni].count = 0;
      stack.push_back(li);
      stack.push_back(ri);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees outputs with fovtix_free().
// ``arity`` is the wide-node branching factor (8 or 16 in practice).
int fovtix_build_bvhw(const float* tris, int64_t T, int leaf_size, int arity,
                      float** out_boxes, int32_t** out_meta,
                      int64_t* out_num_nodes, int32_t** out_tri_perm,
                      int64_t* out_num_slots) {
  if (T <= 0 || leaf_size < 1 || leaf_size > 15) return 1;
  if (arity < 2 || arity > 64) return 1;
  const int kWidth = arity;
  Builder b;
  b.tris = tris;
  b.T = T;
  b.leaf_size = leaf_size;
  b.build();
  const auto& nodes = b.nodes;

  // Collapse to ``arity``-wide with leaf MERGING: sibling BVH2 leaves inside
  // one wide node are bin-packed (first-fit decreasing) into shared leaf
  // slots of up to leaf_size triangles, so leaf rows in the packed table run
  // full and freed slots let the expansion absorb more internal nodes.
  // (The naive collapse averaged 6/16 fill and half-empty leaf rows.)
  struct SlotRec {
    int32_t internal_b2 = -1;          // >=0: internal child (BVH2 id)
    std::vector<int32_t> leaves;       // else: merged BVH2 leaf ids
  };
  std::vector<std::vector<SlotRec>> wide;
  std::vector<int32_t> wide_of(nodes.size(), -1);
  std::vector<int32_t> queue;

  auto slots_needed = [&](const std::vector<int32_t>& g) {
    std::vector<int64_t> leaf_counts;
    int internals = 0;
    for (int32_t c : g) {
      if (nodes[c].count == 0)
        internals++;
      else
        leaf_counts.push_back(nodes[c].count);
    }
    std::sort(leaf_counts.rbegin(), leaf_counts.rend());
    std::vector<int64_t> bins;
    for (int64_t lc : leaf_counts) {
      bool placed = false;
      for (auto& bn : bins)
        if (bn + lc <= leaf_size) {
          bn += lc;
          placed = true;
          break;
        }
      if (!placed) bins.push_back(lc);
    }
    return internals + (int)bins.size();
  };

  auto make_wide = [&](int32_t b2) {
    const Node& n = nodes[b2];
    std::vector<int32_t> group;
    if (n.count == 0) {
      group = {n.left, n.right};
    } else {
      group = {b2};
    }
    while (true) {
      int best = -1;
      float best_sa = -1.f;
      for (int i = 0; i < (int)group.size(); ++i) {
        const Node& c = nodes[group[i]];
        if (c.count == 0 && c.box.sa() > best_sa) {
          best = i;
          best_sa = c.box.sa();
        }
      }
      if (best < 0) break;
      std::vector<int32_t> trial = group;
      const Node& c = nodes[trial[best]];
      trial[best] = c.left;
      trial.insert(trial.begin() + best + 1, c.right);
      if (slots_needed(trial) > kWidth) break;
      group.swap(trial);
    }
    // bin-pack the leaf children (first-fit decreasing)
    std::vector<SlotRec> slots;
    std::vector<int32_t> leaf_ids;
    for (int32_t c : group) {
      if (nodes[c].count == 0) {
        SlotRec s;
        s.internal_b2 = c;
        slots.push_back(std::move(s));
      } else {
        leaf_ids.push_back(c);
      }
    }
    std::sort(leaf_ids.begin(), leaf_ids.end(), [&](int32_t a2, int32_t b3) {
      return nodes[a2].count > nodes[b3].count;
    });
    std::vector<int64_t> bin_fill;
    std::vector<int> bin_slot;
    for (int32_t lid : leaf_ids) {
      int64_t lc = nodes[lid].count;
      int found = -1;
      for (size_t k = 0; k < bin_fill.size(); ++k)
        if (bin_fill[k] + lc <= leaf_size) {
          found = (int)k;
          break;
        }
      if (found < 0) {
        bin_fill.push_back(lc);
        bin_slot.push_back((int)slots.size());
        SlotRec s;
        s.leaves.push_back(lid);
        slots.push_back(std::move(s));
      } else {
        bin_fill[found] += lc;
        slots[bin_slot[found]].leaves.push_back(lid);
      }
    }
    wide.push_back(std::move(slots));
    wide_of[b2] = (int32_t)wide.size() - 1;
    return wide_of[b2];
  };

  queue.push_back(make_wide(0));
  while (!queue.empty()) {
    int32_t w = queue.back();
    queue.pop_back();
    for (const SlotRec& s : wide[w]) {
      if (s.internal_b2 >= 0 && wide_of[s.internal_b2] < 0) {
        queue.push_back(make_wide(s.internal_b2));
      }
    }
  }

  int64_t m = (int64_t)wide.size();
  int64_t slots_total = 0;
  for (const auto& g : wide)
    for (const SlotRec& s : g)
      for (int32_t lid : s.leaves) slots_total += nodes[lid].count;
  if (slots_total == 0) slots_total = 1;

  float* boxes = (float*)std::malloc(sizeof(float) * m * kWidth * 6);
  int32_t* meta = (int32_t*)std::malloc(sizeof(int32_t) * m * kWidth * 2);
  int32_t* perm = (int32_t*)std::malloc(sizeof(int32_t) * slots_total);
  if (!boxes || !meta || !perm) {
    std::free(boxes);
    std::free(meta);
    std::free(perm);
    return 2;
  }
  for (int64_t i = 0; i < slots_total; ++i) perm[i] = -1;

  int64_t cursor = 0;
  for (int64_t w = 0; w < m; ++w) {
    for (int s = 0; s < kWidth; ++s) {
      float* bx = boxes + (w * kWidth + s) * 6;
      int32_t* mt = meta + (w * kWidth + s) * 2;
      if (s >= (int)wide[w].size()) {
        bx[0] = bx[1] = bx[2] = FLT_MAX;
        bx[3] = bx[4] = bx[5] = -FLT_MAX;
        mt[0] = 0;
        mt[1] = -1;
        continue;
      }
      const SlotRec& sr = wide[w][s];
      if (sr.internal_b2 >= 0) {
        const Node& c = nodes[sr.internal_b2];
        bx[0] = c.box.lo.x;
        bx[1] = c.box.lo.y;
        bx[2] = c.box.lo.z;
        bx[3] = c.box.hi.x;
        bx[4] = c.box.hi.y;
        bx[5] = c.box.hi.z;
        mt[0] = wide_of[sr.internal_b2];
        mt[1] = 0;
      } else {
        AABB ub;
        int64_t cnt = 0;
        int64_t at = cursor;
        for (int32_t lid : sr.leaves) {
          const Node& c = nodes[lid];
          ub.grow(c.box);
          for (int64_t k = 0; k < c.count; ++k)
            perm[at++] = (int32_t)b.order[c.start + k];
          cnt += c.count;
        }
        bx[0] = ub.lo.x;
        bx[1] = ub.lo.y;
        bx[2] = ub.lo.z;
        bx[3] = ub.hi.x;
        bx[4] = ub.hi.y;
        bx[5] = ub.hi.z;
        mt[0] = (int32_t)cursor;
        mt[1] = (int32_t)cnt;
        cursor = at;
      }
    }
  }

  *out_boxes = boxes;
  *out_meta = meta;
  *out_num_nodes = m;
  *out_tri_perm = perm;
  *out_num_slots = slots_total;
  return 0;
}

int fovtix_build_bvh8(const float* tris, int64_t T, int leaf_size,
                      float** out_boxes, int32_t** out_meta,
                      int64_t* out_num_nodes, int32_t** out_tri_perm,
                      int64_t* out_num_slots) {
  return fovtix_build_bvhw(tris, T, leaf_size, 8, out_boxes, out_meta,
                           out_num_nodes, out_tri_perm, out_num_slots);
}

void fovtix_free(void* p) { std::free(p); }
}
