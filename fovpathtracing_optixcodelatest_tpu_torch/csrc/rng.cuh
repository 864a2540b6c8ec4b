// The per-ray counter hash of ops/rng.py ray_uniform_cols, shared by the
// bounce's shading (csrc/shade.cu) and ray generation (csrc/frame.cu): two
// rounds of the lowbias32 mix keyed by the key's two words and the ray id's
// low 32 bits, then one more mix per stream.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the hash of ray `id` under the key words (key0, key1)
__device__ __forceinline__ uint32_t ray_hash(int64_t id, unsigned key0,
                                             unsigned key1) {
  const uint32_t low = (uint32_t)((uint64_t)id & 0xFFFFFFFFull);
  return mix(mix(low ^ key0) ^ key1);
}

// stream s's uniform in [0, 1) of the ray whose hash is `base`
__device__ __forceinline__ float ray_uniform(uint32_t base, uint32_t s) {
  return (float)(mix(base + 0x9E3779B9u * (s + 1)) >> 8) *
         static_cast<float>(1.0 / (1 << 24));
}

}  // namespace
