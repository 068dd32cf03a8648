// The per-voxel rule of one variational region-growing iteration, on bit
// masks, shared by the full-grid sweep (region_grow_sweep.cu, K2) and the
// frontier-tile sweep (region_grow_frontier.cu, K5).
//
// A voxel flips when its 3x3x3 neighbourhood (itself included) holds both
// a segmented and an unsegmented voxel of the volume, and its segmentation
// differs from the decision bit of its intensity bin: bit b of the packed
// words is (diff[b] >= 0), diff = innerProbNorm - outerProbNorm
// (arterynetwork_tpu/ops/region_grow.py:187-209).  Voxels outside the
// volume's valid region are neither segmented nor unsegmented.
//
// So the rule is an OR over a 3x3x3 box of two 1-bit masks, S (segmented)
// and U (unsegmented and valid), packed 32 voxels of a row to a word (bit
// i of word k is x = 32 k + i):
//
//   B = dil(S) & dil(U) & (S | U)        the boundary: only these voxels
//   flip = B & (S != decision bit)       read their bin
//
// where dil ORs a word with its x-neighbours (shifts, with carries from
// the words beside it), then over the rows y-1..y+1 and planes z-1..z+1.
#pragma once

#include <cstdint>

namespace rg {

// A word ORed with its x-neighbours; `left` and `right` are the words
// beside it in the row (0 past the row's ends).
__device__ __forceinline__ uint32_t xdil(uint32_t left, uint32_t w,
                                         uint32_t right) {
  return w | (w << 1) | (w >> 1) | (left >> 31) | (right << 31);
}

// The x-dilated word k ORed over rows row0, row0 + 1, row0 + 2 of `w`
// (row-major, nw words a row).
__device__ __forceinline__ uint32_t dil_rows(const uint32_t* w, int row0,
                                             int k, int nw) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t* r = w + (row0 + i) * nw;
    d |= xdil(k > 0 ? r[k - 1] : 0u, r[k], k + 1 < nw ? r[k + 1] : 0u);
  }
  return d;
}

__device__ __forceinline__ uint32_t decision_bit(const uint32_t* words,
                                                 uint32_t bin) {
  return (words[bin >> 5] >> (bin & 31u)) & 1u;
}

}  // namespace rg
