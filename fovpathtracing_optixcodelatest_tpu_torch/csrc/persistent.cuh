// Persistent warps that take their lanes from a global counter: the lane
// fetch and the launch grid shared by the traversal kernels (K1, K2 in
// traverse.cu, K3 in packet_traverse.cu).
//
// A warp takes 32 lanes at a time from a zeroed int32 counter, writes the
// answer of the inactive ones and compacts the active ones with
// __ballot_sync/__popc into its queue in shared memory, so no thread ever
// walks an inactive lane and the host never synchronises. The lanes handed
// out stop at n, or at a count read on the device (lanes.cuh).
// The grid is the SMs times the resident blocks, from the occupancy API.
#pragma once

#include <cstddef>
#include <mutex>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kQueue = 64;       // a warp's ray queue; holds at most 63
constexpr int kMaxDevices = 64;  // devices the launch-grid cache tells apart

// Take chunks of 32 lanes from *counter until the warp's `queue` holds at
// least `want` rays past `head` or the lanes run out (`drained`): the first
// n, or lane_count(n, count). Called by the 32 lanes of a warp alike;
// miss(i) answers each inactive lane i. `queued` and `drained` stay uniform
// across the warp. The limit is read here, a call at a time, so no
// register holds it through the walk (n and count are kernel arguments).
template <class Miss>
__device__ __forceinline__ void fill_queue(
    const unsigned char* __restrict__ active, int n,
    const int* __restrict__ count, int* __restrict__ counter,
    int* __restrict__ queue, int head, int& queued, bool& drained, int want,
    Miss miss) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  n = lane_count(n, count);
  while (queued < want && !drained) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n) {
      drained = true;
      break;
    }
    const int i = base + lane;
    const bool act = i < n && active[i];
    if (i < n && !act) miss(i);
    const unsigned m = __ballot_sync(kFull, act);
    if (act) queue[(head + queued + __popc(m & below)) & (kQueue - 1)] = i;
    queued += __popc(m);
  }
}

// Resident blocks per SM of one kernel at a shared-memory size on the
// current device, and the grid that fills the device with them; computed
// once per device and size (the shared-memory attribute is set per device).
class GridCache {
 public:
  cudaError_t get(const void* fn, int threads, size_t smem, int* per_sm,
                  int* blocks) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    Entry& e = cache_[dev];
    if (e.per_sm == 0 || e.smem != smem) {
      int sms = 0, fit = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fn, threads,
                                                            smem);
      if (err != cudaSuccess) return err;
      if (fit < 1) return cudaErrorInvalidConfiguration;
      e = Entry{smem, fit, sms * fit};
    }
    *per_sm = e.per_sm;
    *blocks = e.blocks;
    return cudaSuccess;
  }

 private:
  struct Entry {
    size_t smem;
    int per_sm, blocks;
  };
  std::mutex mu_;
  Entry cache_[kMaxDevices] = {};
};

}  // namespace
