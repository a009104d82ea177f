// Dropout masks of the training kernels: a counter-based hash keyed by
// (seed, unit, sample, mask-id, element index), `sample` the index in the
// global batch (the kernel's sample base plus the local index), bit for
// bit the one of
// gator_tpu_torch/nn/dropout_masks.py (murmur3's 32-bit finalizer). Keep
// when (bits >> 8) < thr, with thr = round((1 - rate) * 2^24), and scale
// the kept value by 1 / (1 - rate); rate 0 gives thr = 2^24 (keep all) and
// scale 1, so a zero rate needs no branch.
#pragma once

#include <stdint.h>

namespace gator {

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// mask-id layout (as nn/dropout_masks.py and the TPU kernels)
constexpr int M_ATTN0 = 0;  // + head
constexpr int M_PROJ = 8, M_DP1 = 9, M_MLP1 = 10, M_MLP2 = 11, M_DP2 = 12;
constexpr int M_SELF0 = 16;  // + head
constexpr int M_OUT = 24;

__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                                        int unit, int sample,
                                                        int mid) {
  uint32_t k = fmix32(seed ^ 0x9E3779B9u);
  k = fmix32(k ^ ((uint32_t)unit * 0x85EBCA77u + 0x165667B1u));
  return fmix32(k ^ ((uint32_t)sample * 32u + (uint32_t)mid));
}

struct Drop {
  uint32_t thr;  // keep when (bits >> 8) < thr
  float scale;   // 1 / (1 - rate)
};

// the scaled keep value (0 or 1/(1-rate)) of element `idx` of a stream
__device__ __forceinline__ float drop(uint32_t key, uint32_t idx, Drop d) {
  const uint32_t b = fmix32(key ^ (idx * 0x9E3779B9u));
  return (b >> 8) < d.thr ? d.scale : 0.0f;
}

}  // namespace gator
