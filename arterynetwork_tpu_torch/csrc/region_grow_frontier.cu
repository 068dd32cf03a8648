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
// tile's halo'd box ((TZ+2) planes of (TY+2) rows) as the rule's S and U
// bit words; the second kernel, queued after it on the same stream, reads
// only the snapshots, so no tile ever sees a neighbour's write of the same
// iteration.  The TPU kernel does the same in two phases of one
// sequential grid.
//
// What bounds it on this card: an active tile of 8x16x170 voxels needs
// ~50 KB (its halo box read, its bytes written, bins at its boundary), so
// the few to few hundred tiles of a front are latency, not bytes: the
// time is the two launches' fixed cost plus the longest dependent chain
// of one block.  The design shortens that chain and spreads it:
//
// - Each tile is spread over many blocks: the snapshot kernel gives one
//   block to each (slot, box plane), the sweep kernel one to each (slot,
//   tile plane).  A snapshot block loads its rows with one byte load per
//   voxel and a ballot, a row's words in flight together, so a plane of
//   18 rows x 6 words is three round trips to memory.
// - Indices are 32-bit and come from the grid's own coordinates: no
//   per-element division.
// - The sweep block dilates the snapshot's words by shifts and ORs, as K2
//   does, reads bins only at boundary bits and writes only flipped bytes.
// - Its flips and boundary flag are summed in shared memory and added to
//   the slot's flags with one global atomic per block; the signed dhist is
//   a shared histogram flushed only when the block flipped something.
// - Blocks take slots with a stride, and a block whose slot is past
//   `*nact` exits at once; nact is read on the device, so the host never
//   waits.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "region_grow_rule.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSlotBlocks = 128;  // blocks along the slots

// The state of one voxel for the ballot: 0 outside the valid region,
// 1 unsegmented, 2 segmented; `p` is read only when `ok`.
__device__ __forceinline__ uint32_t voxel_state(const uint8_t* p, bool ok) {
  return ok ? (*p ? 2u : 1u) : 0u;
}

// Row words are walked kChunk at a time in unrolled loops, so that each
// word's offset is an immediate.
constexpr int kChunk = 8;

// Loads `nrows` rows of one plane (rows y0.., words 0..nw-1) as S and U
// words, word k of row r at S[r * nw + k] and U[r * nw + k].  Lane i of a
// warp reads the seg byte of x = 32 k + i, a coalesced row segment, and
// two ballots pack the warp's answers into the words.  Warp `warp` of
// `nwarps` takes rows warp, warp + nwarps, ..., and the words of a row
// kChunk at a time, their loads in flight together.  `plane` points at
// the plane's (y = 0, x = 0) byte, rows sY bytes apart, or is null for a
// plane outside the volume (all words 0).  Call with the whole warp.
__device__ __forceinline__ void load_rows(const uint8_t* plane, int sY,
                                          int y0, int nrows, int Y, int X,
                                          int nw, int warp, int nwarps,
                                          int lane, uint32_t* S,
                                          uint32_t* U) {
  for (int r = warp; r < nrows; r += nwarps) {
    const int y = y0 + r;
    const bool row = plane && y >= 0 && y < Y;
    const uint8_t* p = plane + (row ? y * sY : 0) + lane;
    for (int k0 = 0; k0 < nw; k0 += kChunk) {
      uint32_t st[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        st[j] = voxel_state(p + 32 * (k0 + j),
                            row && (k0 + j) * 32 + lane < X);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < nw) {                           // warp-uniform
          const uint32_t s = __ballot_sync(0xffffffffu, st[j] == 2u);
          const uint32_t u = __ballot_sync(0xffffffffu, st[j] == 1u);
          if (lane == 0) {
            S[r * nw + k0 + j] = s;
            U[r * nw + k0 + j] = u;
          }
        }
      }
    }
  }
}

struct Tiles {
  int Z, Y, X, TZ, TY, nty, nw;
  __device__ int nraw() const { return (TY + 2) * nw; }  // words a plane
};

// snap: int32[k_pad][TZ+2][2][(TY+2) * nw], S then U words of each plane.
__global__ void __launch_bounds__(kThreads)
frontier_snapshot_kernel(const uint8_t* __restrict__ seg,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ nact, Tiles g,
                         uint32_t* __restrict__ snap) {
  const int n_act = *nact, bz = blockIdx.y, nraw = g.nraw();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int slot = blockIdx.x; slot < n_act; slot += gridDim.x) {
    const int tid = ids[slot], tz = tid / g.nty, ty = tid - tz * g.nty;
    const int z = tz * g.TZ - 1 + bz;
    const uint8_t* plane =
        (z >= 0 && z < g.Z) ? seg + (long long)z * g.Y * g.X : nullptr;
    uint32_t* dst = snap + ((long long)slot * (g.TZ + 2) + bz) * 2 * nraw;
    load_rows(plane, g.X, ty * g.TY - 1, g.TY + 2, g.Y, g.X, g.nw, warp,
              kWarps, lane, dst, dst + nraw);
  }
}

__global__ void __launch_bounds__(kThreads)
frontier_sweep_kernel(uint8_t* __restrict__ seg,
                      const uint8_t* __restrict__ bins,
                      const int32_t* __restrict__ ids,
                      const int32_t* __restrict__ nact,
                      const int32_t* __restrict__ words_in, int n_words,
                      Tiles g, int nb, const uint32_t* __restrict__ snap,
                      int32_t* __restrict__ dhist,
                      int32_t* __restrict__ flags) {
  extern __shared__ uint32_t sm[];   // planes lz..lz+2 of the box; bnd
  __shared__ int h[256];
  __shared__ uint32_t words[8];
  __shared__ int tile_flips;
  const int n_act = *nact;
  if ((int)blockIdx.x * nb >= n_act) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int lz = blockIdx.y, nw = g.nw, nraw = g.nraw(), nout = g.TY * nw;
  uint32_t* bnd = sm + 6 * nraw;
  for (int i = t; i < 256; i += kThreads) h[i] = 0;
  if (t < 8) words[t] = t < n_words ? (uint32_t)words_in[t] : 0u;
  if (t == 0) tile_flips = 0;
  int touched = 0;

  for (int first = blockIdx.x * nb; first < n_act;
       first += gridDim.x * nb) {
    for (int slot = first; slot < min(first + nb, n_act); ++slot) {
      const int tid = ids[slot], tz = tid / g.nty, ty = tid - tz * g.nty;
      const int z = tz * g.TZ + lz;
      if (z >= g.Z) continue;                          // block-uniform
      const uint32_t* box =
          snap + ((long long)slot * (g.TZ + 2) + lz) * 2 * nraw;
      for (int i = t; i < 6 * nraw; i += kThreads) sm[i] = box[i];
      __syncthreads();
      // plane q of the three (box planes lz + q) holds S at sm[2 q nraw]
      // and U at sm[(2 q + 1) nraw]; the tile's plane is q = 1
      int any = 0;
      for (int i = t; i < nout; i += kThreads) {
        const int r = i / nw, k = i - r * nw;
        uint32_t dS = 0, dU = 0;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dS |= rg::dil_rows(sm + 2 * q * nraw, r, k, nw);
          dU |= rg::dil_rows(sm + (2 * q + 1) * nraw, r, k, nw);
        }
        const int c = (r + 1) * nw + k;
        const uint32_t b = dS & dU & (sm[2 * nraw + c] | sm[3 * nraw + c]);
        bnd[i] = b;
        any |= b != 0;
      }
      __syncthreads();
      int flips = 0;
      const long long zoff = (long long)z * g.Y * g.X;
      const uint8_t* bp = bins + zoff;
      uint8_t* sp = seg + zoff;
      const uint32_t* cS = sm + 2 * nraw + nw;    // the tile plane's row 0
      for (int r = warp; r < g.TY && ty * g.TY + r < g.Y; r += kWarps) {
        const int y = ty * g.TY + r;
        for (int k0 = 0; k0 < nw; k0 += kChunk) {
          const int row = y * g.X + k0 * 32 + lane;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (k0 + j >= nw) break;                 // warp-uniform
            const int w = r * nw + k0 + j;
            if ((k0 + j) * 32 + lane >= g.X || !((bnd[w] >> lane) & 1u))
              continue;
            const uint32_t s = (cS[w] >> lane) & 1u;
            const int v = row + 32 * j;
            const uint32_t b = bp[v];
            if (s != rg::decision_bit(words, b)) {
              sp[v] = (uint8_t)(s ^ 1u);
              atomicAdd(&h[b], s ? -1 : 1);
              ++flips;
            }
          }
        }
      }
      flips = __reduce_add_sync(0xffffffffu, flips);
      if (lane == 0 && flips) atomicAdd(&tile_flips, flips);
      any = __syncthreads_or(any);
      if (t == 0) {
        if (tile_flips) atomicAdd(&flags[2 * slot], tile_flips);
        if (any) atomicOr(&flags[2 * slot + 1], 1);
        touched |= tile_flips;
        tile_flips = 0;
      }
    }
  }
  if (__syncthreads_or(touched))
    for (int i = t; i < 256; i += kThreads)
      if (h[i]) atomicAdd(&dhist[i], h[i]);
}

}  // namespace

// seg, bins: uint8 (Z, Y, X) contiguous; ids: int32[k_pad] tile ids, the
// first *nact (a device int32) valid; words: int32[n_words] decision bits;
// snap: int32[k_pad][TZ+2][2][(TY+2) * ceil(X/32)] scratch; dhist:
// int32[256] and flags: int32[k_pad][2], zeroed by the caller.  Launches
// the snapshot and the sweep kernels on `stream` and returns
// cudaGetLastError().
extern "C" int region_grow_frontier(void* seg, const void* bins,
                                    const void* ids, const void* nact,
                                    const void* words, int n_words, int Z,
                                    int Y, int X, int TZ, int TY, int k_pad,
                                    int nb, void* snap, void* dhist,
                                    void* flags, void* stream) {
  if (k_pad <= 0 || Z <= 0 || Y <= 0 || X <= 0) return 0;
  if ((long long)Y * X > INT_MAX) return (int)cudaErrorInvalidValue;
  const Tiles g{Z, Y, X, TZ, TY, (Y + TY - 1) / TY, (X + 31) / 32};
  const size_t smem =
      sizeof(uint32_t) * (size_t)(6 * (TY + 2) + TY) * g.nw;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        frontier_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* na = static_cast<const int32_t*>(nact);
  auto* sn = static_cast<uint32_t*>(snap);
  frontier_snapshot_kernel<<<dim3(std::min(k_pad, kMaxSlotBlocks), TZ + 2),
                             kThreads, 0, s>>>(
      static_cast<const uint8_t*>(seg), id, na, g, sn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int groups = std::min((k_pad + nb - 1) / nb, kMaxSlotBlocks);
  frontier_sweep_kernel<<<dim3(groups, TZ), kThreads, smem, s>>>(
      static_cast<uint8_t*>(seg), static_cast<const uint8_t*>(bins), id, na,
      static_cast<const int32_t*>(words), n_words, g, nb, sn,
      static_cast<int32_t*>(dhist), static_cast<int32_t*>(flags));
  return (int)cudaGetLastError();
}
