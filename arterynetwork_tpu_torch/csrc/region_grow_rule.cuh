// The per-voxel rule of one variational region-growing iteration, shared
// by the full-grid sweep (region_grow_sweep.cu, K2) and the frontier-tile
// sweep (region_grow_frontier.cu, K5).
//
// A voxel flips when its 3x3x3 neighbourhood (itself included) holds both
// a segmented and an unsegmented voxel of the volume, and its segmentation
// differs from the decision bit of its intensity bin: bit b of the packed
// words is (diff[b] >= 0), diff = innerProbNorm - outerProbNorm
// (arterynetwork_tpu/ops/region_grow.py:187-209).  Voxels outside the
// volume are neither segmented nor unsegmented.
#pragma once

#include <cstdint>

namespace rg {

// Neighbourhood codes: OR-ing them over the 27 voxels gives kMixed exactly
// when the neighbourhood is mixed.
constexpr uint32_t kOutside = 0u;
constexpr uint32_t kSeg = 1u;
constexpr uint32_t kUnseg = 2u;
constexpr uint32_t kMixed = kSeg | kUnseg;

__device__ __forceinline__ uint32_t code(uint8_t seg) {
  return seg ? kSeg : kUnseg;
}

__device__ __forceinline__ uint32_t decision_bit(const uint32_t* words,
                                                 uint32_t bin) {
  return (words[bin >> 5] >> (bin & 31u)) & 1u;
}

// True when the voxel flips: boundary (mixed neighbourhood) and seg != bit.
__device__ __forceinline__ bool flips(uint32_t neighbourhood, uint32_t seg,
                                      uint32_t bit) {
  return neighbourhood == kMixed && seg != bit;
}

}  // namespace rg
