// The lanes a launch over a lane list of capacity n walks: n, or where
// `count` is given the list's length as the device holds it (a
// wavefront's live lanes, written by csrc/lanes.cu's compaction), never
// more than n. Shared by the traversal kernels (persistent.cuh, which
// reads it at each lane fetch) and the shading kernels (shade.cu), whose
// grids are sized for n. The load is volatile so that the compiler keeps
// it where it is written and no register holds the result through a
// persistent walk's loop.
#pragma once

namespace {

__device__ __forceinline__ int lane_count(int n, const int* count) {
  return count == nullptr ? n : min(n, *(const volatile int*)count);
}

}  // namespace
