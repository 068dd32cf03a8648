// One frontier-tile (block-sparse) region-growing iteration, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _frontier_kernel of the JAX package's
// ops/region_grow_frontier.py.  The volume (Z, Y, X) is cut into
// (TZ, TY, full-X) tiles, tile id = tz * nty + ty.  The first `*nact`
// entries of `ids` name the active tiles; each is swept with the
// 27-neighbour rule of region_grow_rule.cuh, in place in `seg`:
//
//   seg[v] ^= flip[v]                 for v in the active tiles' interiors
//   dhist[bin] += +1 / -1             per voxel newly segmented / unsegmented
//   flags[slot] = (#flips in the tile, tile holds a boundary voxel)
//
// Jacobi semantics across tiles: a first kernel snapshots every active
// tile's halo'd box (TZ+2, TY+2, X+2) into `snap`, coded as the rule's
// neighbourhood codes (outside / segmented / unsegmented); the second
// kernel, queued after it on the same stream, reads only the snapshots, so
// no tile ever sees a neighbour's write of the same iteration.  The TPU
// kernel does the same in two phases of one sequential grid.
//
// What bounds it on this card: an active tile of 8x16x170 voxels moves
// ~60 KB (box snapshot written and read, bins read, flips written) and its
// 27 reads per voxel hit L1; a typical front activates tens to a few
// hundred tiles, so one iteration is a few MB, and the two launches'
// fixed cost is expected to dominate.  The design: one block per `nb`
// active tiles (nact read on the device, so the host never waits), the
// decision words in shared memory, a private shared-memory histogram per
// block flushed by global atomics, and only flipped voxels written back.

#include <cstdint>

#include <cuda_runtime.h>

#include "region_grow_rule.cuh"

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int Z, Y, X, TZ, TY, nty;
  __device__ int BY() const { return TY + 2; }
  __device__ int BX() const { return X + 2; }
  __device__ long long box() const {
    return (long long)(TZ + 2) * (TY + 2) * (X + 2);
  }
};

__global__ void __launch_bounds__(kThreads)
frontier_snapshot_kernel(const uint8_t* __restrict__ seg,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ nact, Geometry g,
                         uint8_t* __restrict__ snap) {
  const int slot = blockIdx.x;
  if (slot >= *nact) return;
  const int tid = ids[slot];
  const int z0 = (tid / g.nty) * g.TZ - 1, y0 = (tid % g.nty) * g.TY - 1;
  const int BY = g.BY(), BX = g.BX();
  uint8_t* dst = snap + slot * g.box();
  for (long long i = threadIdx.x; i < g.box(); i += blockDim.x) {
    const int bx = (int)(i % BX);
    const long long r = i / BX;
    const int z = z0 + (int)(r / BY), y = y0 + (int)(r % BY), x = bx - 1;
    uint8_t c = (uint8_t)rg::kOutside;
    if (z >= 0 && z < g.Z && y >= 0 && y < g.Y && x >= 0 && x < g.X)
      c = (uint8_t)rg::code(seg[((long long)z * g.Y + y) * g.X + x]);
    dst[i] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
frontier_sweep_kernel(uint8_t* __restrict__ seg,
                      const uint8_t* __restrict__ bins,
                      const int32_t* __restrict__ ids,
                      const int32_t* __restrict__ nact,
                      const int32_t* __restrict__ words_in, int n_words,
                      Geometry g, int nb,
                      const uint8_t* __restrict__ snap,
                      int32_t* __restrict__ dhist,
                      int32_t* __restrict__ flags) {
  __shared__ int h[256];
  __shared__ uint32_t words[8];
  __shared__ int tile_flips, tile_bnd;
  const int n_act = *nact;
  const int first = blockIdx.x * nb;
  if (first >= n_act) return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  if ((int)threadIdx.x < n_words)
    words[threadIdx.x] = (uint32_t)words_in[threadIdx.x];
  int touched = 0;

  const int BY = g.BY(), BX = g.BX();
  const long long sBZ = (long long)BY * BX;
  for (int slot = first; slot < min(first + nb, n_act); ++slot) {
    if (threadIdx.x == 0) tile_flips = tile_bnd = 0;
    __syncthreads();
    const int tid = ids[slot];
    const int z0 = (tid / g.nty) * g.TZ, y0 = (tid % g.nty) * g.TY;
    const int nz = min(g.TZ, g.Z - z0), ny = min(g.TY, g.Y - y0);
    const uint8_t* box = snap + slot * g.box();
    const long long n = (long long)max(nz, 0) * max(ny, 0) * g.X;
    int my_flips = 0, my_bnd = 0;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const int x = (int)(i % g.X);
      const long long r = i / g.X;
      const int lz = (int)(r / ny), ly = (int)(r % ny);
      // box coordinates of the voxel: +1 for the halo
      const uint8_t* c0 = box + (lz + 1) * sBZ + (ly + 1) * BX + (x + 1);
      uint32_t nbh = 0;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const uint8_t* row = c0 + dz * sBZ + dy * BX;
          nbh |= (uint32_t)row[-1] | (uint32_t)row[0] | (uint32_t)row[1];
        }
      const uint32_t c = (*c0 == rg::kSeg) ? 1u : 0u;
      const long long v = ((long long)(z0 + lz) * g.Y + (y0 + ly)) * g.X + x;
      const uint32_t b = bins[v];
      my_bnd |= nbh == rg::kMixed;
      if (rg::flips(nbh, c, rg::decision_bit(words, b))) {
        seg[v] = (uint8_t)(c ^ 1u);
        atomicAdd(&h[b], c ? -1 : 1);
        ++my_flips;
      }
    }
    if (my_flips) atomicAdd(&tile_flips, my_flips);
    if (my_bnd) atomicOr(&tile_bnd, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      flags[2 * slot] = tile_flips;
      flags[2 * slot + 1] = tile_bnd;
    }
    touched |= tile_flips;
    __syncthreads();
  }
  if (touched)
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      if (h[i]) atomicAdd(&dhist[i], h[i]);
}

}  // namespace

// seg, bins: uint8 (Z, Y, X) contiguous; ids: int32[k_pad] tile ids, the
// first *nact (a device int32) valid; words: int32[n_words] decision bits;
// snap: uint8[k_pad][(TZ+2)(TY+2)(X+2)] scratch; dhist: int32[256] and
// flags: int32[k_pad][2], zeroed by the caller.  Launches the snapshot and
// the sweep kernels on `stream` and returns cudaGetLastError().
extern "C" int region_grow_frontier(void* seg, const void* bins,
                                    const void* ids, const void* nact,
                                    const void* words, int n_words, int Z,
                                    int Y, int X, int TZ, int TY, int k_pad,
                                    int nb, void* snap, void* dhist,
                                    void* flags, void* stream) {
  if (k_pad <= 0) return 0;
  const Geometry g{Z, Y, X, TZ, TY, (Y + TY - 1) / TY};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* na = static_cast<const int32_t*>(nact);
  frontier_snapshot_kernel<<<k_pad, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(seg), id, na, g,
      static_cast<uint8_t*>(snap));
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  frontier_sweep_kernel<<<(k_pad + nb - 1) / nb, kThreads, 0, s>>>(
      static_cast<uint8_t*>(seg), static_cast<const uint8_t*>(bins), id, na,
      static_cast<const int32_t*>(words), n_words, g, nb,
      static_cast<const uint8_t*>(snap), static_cast<int32_t*>(dhist),
      static_cast<int32_t*>(flags));
  return (int)cudaGetLastError();
}
