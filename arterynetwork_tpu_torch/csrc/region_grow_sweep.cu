// One full-grid region-growing sweep, for Hopper (sm_90a).
//
// Replaces the TPU kernel _sweep_kernel of the JAX package's
// ops/region_grow_fused.py (launched by fused_sweep), and through the
// wrappers fused_sweep_banded and fused_sweep_banded_dma also its banded
// variants _banded_kernel and _banded_dma_kernel, which exist only because
// a whole slice did not fit the TPU's VMEM.  Per voxel of the (Z, Y, X)
// region, with the 27-neighbour rule of region_grow_rule.cuh:
//
//   out[v] = seg[v] ^ flip[v]                (Jacobi: out is a new buffer)
//   dh[0][bin] += #flips of unsegmented voxels (newly segmented)
//   dh[1][bin] += #flips of segmented voxels   (newly unsegmented)
//
// seg, bins and out share one layout: element (z, y, x) at z*sZ + y*sY + x,
// so a padded buffer is swept over its valid region in place of a copy.
//
// What bounds it on this card: per voxel it moves 3 bytes from device
// memory (seg and bin read, seg written; ~130 MB at 512x512x170, ~40 us at
// 3.35 TB/s) and makes 27 byte reads of seg, which neighbouring threads
// share through L1.  The load instructions, not HBM, are expected to bound
// it.  The design is the simple one: one thread per voxel, x fastest so a
// warp reads contiguous rows, each block walking a 32x8 column of 16
// z-slices so the three planes it reads stay in L1; the decision words sit
// in shared memory; flips (only on the region's boundary) go to a private
// shared-memory int histogram per block, flushed by global atomics only
// when the block flipped anything.

#include <cstdint>

#include <cuda_runtime.h>

#include "region_grow_rule.cuh"

namespace {

constexpr int kBX = 32, kBY = 8, kZChunk = 16;

__global__ void __launch_bounds__(kBX * kBY)
region_grow_sweep_kernel(const uint8_t* __restrict__ seg,
                         const uint8_t* __restrict__ bins,
                         uint8_t* __restrict__ out,
                         const int32_t* __restrict__ words_in, int Z, int Y,
                         int X, long long sZ, long long sY,
                         int32_t* __restrict__ dh) {
  __shared__ int h[2][256];
  __shared__ uint32_t words[8];
  const int t = threadIdx.y * kBX + threadIdx.x;
  for (int i = t; i < 512; i += kBX * kBY) (&h[0][0])[i] = 0;
  if (t < 8) words[t] = (uint32_t)words_in[t];
  __syncthreads();

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZChunk;
  const int z1 = min(z0 + kZChunk, Z);
  int flipped = 0;
  if (x < X && y < Y) {
    const bool xl = x > 0, xh = x + 1 < X, yl = y > 0, yh = y + 1 < Y;
    for (int z = z0; z < z1; ++z) {
      uint32_t nb = rg::kOutside;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int zz = z + dz;
        if (zz < 0 || zz >= Z) continue;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          if ((dy < 0 && !yl) || (dy > 0 && !yh)) continue;
          const uint8_t* row = seg + zz * sZ + (y + dy) * sY + x;
          if (xl) nb |= rg::code(row[-1]);
          nb |= rg::code(row[0]);
          if (xh) nb |= rg::code(row[1]);
        }
      }
      const long long v = z * sZ + y * sY + x;
      const uint32_t c = seg[v] ? 1u : 0u;
      const uint32_t b = bins[v];
      const bool f = rg::flips(nb, c, rg::decision_bit(words, b));
      out[v] = (uint8_t)(c ^ (uint32_t)f);
      if (f) {
        atomicAdd(&h[c][b], 1);
        flipped = 1;
      }
    }
  }
  if (__syncthreads_or(flipped)) {
    for (int i = t; i < 512; i += kBX * kBY)
      if ((&h[0][0])[i]) atomicAdd(&dh[i], (&h[0][0])[i]);
  }
}

}  // namespace

// seg, bins, out: uint8 with element (z, y, x) at z*sZ + y*sY + x for the
// region Z x Y x X; words: int32[8] decision bits on the device; dh:
// int32[2][256], zeroed by the caller.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int region_grow_sweep(const void* seg, const void* bins,
                                 void* out, const void* words, int Z, int Y,
                                 int X, long long sZ, long long sY, void* dh,
                                 void* stream) {
  if (Z <= 0 || Y <= 0 || X <= 0) return 0;
  const dim3 block(kBX, kBY);
  const dim3 grid((X + kBX - 1) / kBX, (Y + kBY - 1) / kBY,
                  (Z + kZChunk - 1) / kZChunk);
  region_grow_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(seg), static_cast<const uint8_t*>(bins),
      static_cast<uint8_t*>(out), static_cast<const int32_t*>(words), Z, Y,
      X, sZ, sY, static_cast<int32_t*>(dh));
  return (int)cudaGetLastError();
}
