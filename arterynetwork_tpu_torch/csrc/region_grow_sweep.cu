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
// An interior window [z0, z1) x [y0, y1) x [x0, x1) of the region limits
// what is written and counted: the rule still reads every voxel of the
// region (the planes z0 - 1 and z1 and the rows y0 - 1 and y1 where they
// exist), but only window voxels may flip, and only window rows of window
// planes are written.  A sweep over a block padded with its neighbours'
// halo voxels so flips and counts only the voxels the block owns.
//
// What bounds it on this card: the bytes it must move are seg read and out
// written once (89 MB at 512x512x170, 27 us at 3.35 TB/s) and bins at the
// boundary voxels only.  Gathering the 27 neighbours byte by byte is bound
// by load instructions instead (27 per voxel; a warp's byte load fetches
// 32 bytes), and so is any design that spends a lane on each voxel: it
// issues a few instructions for every 32 voxels in each pass.  So the rule
// runs on bit masks, one thread per 32-voxel word, and bytes move only in
// 16-byte copies:
//
// - Each block owns a strip of RB whole rows (all ceil(X/32) words of
//   each, so no x halo) and a chunk of zc planes, and marches through the
//   chunk in z.  The strip's rows and the row beside it on each side are
//   one contiguous byte range of a plane, so whatever the row alignment
//   (a row of the path's volume is 170 bytes, 2-byte aligned) the range is
//   staged into shared memory by 16-byte cp.async copies of the aligned
//   chunks around it, double-buffered: plane p + 1 is in flight while
//   plane p is computed.  (TMA would need 16-byte aligned rows.)
// - A thread packs its word's 32 bytes from the stage with aligned 32-bit
//   loads, funnel shifts and a nonzero-byte test into an S and a U word.
//   Each word is dilated in x by shifts with its neighbours' carries, in y
//   by OR-ing three rows, and kept in a ring of the last three planes;
//   OR-ing the ring gives the 3x3x3 dilation, and B = dil(S) & dil(U) &
//   valid marks the boundary.
// - The same thread walks the set bits of B, reads bins[v] only there and
//   flips where the decision bit differs; flips go to a shared int
//   histogram per block, flushed by global atomics only when the block
//   flipped something.  It expands its new word to bytes in a zeroed
//   shared out-stage laid out like `out` (storing only nonzero words),
//   and the strip is copied out with 16-byte stores, bytes only where a
//   chunk straddles the strip's ends.
// - The host tiles the window (strips and z-runs, see kMaxRows below) and
//   sizes the grid to one wave of the blocks the card holds.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "region_grow_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 16384;   // cap on one staged strip

struct Sweep {
  int Z, Y, X, nw, RB, zc, sY, stage;  // a plane holds < 2^31 bytes
  long long sZ, last;                // last: one past the last valid byte
  int z0, z1, y0, y1, x0, x1;        // the window
};

// Dynamic shared memory: two input stages and the out-stage of `stage`
// bytes each, then raw S and U of 3 planes of (RB+2) rows and dilated S
// and U of 3 planes of RB rows.
size_t smem_bytes(int RB, int nw, int stage) {
  return 3 * (size_t)stage + 4 * (size_t)(6 * (RB + 2) * nw + 6 * RB * nw);
}

__device__ __forceinline__ uintptr_t at(const void* buf, const Sweep& g,
                                        int p, int y) {
  return reinterpret_cast<uintptr_t>(buf) + p * g.sZ + (long long)y * g.sY;
}

// Queues the copy of rows [r0, r1) of plane p of seg, from the 16-byte
// chunk that holds their first byte, into `stage`.  Chunks inside the
// valid bytes go by cp.async; the (at most two) that straddle the
// buffer's ends go byte by byte.
__device__ void stage_rows(const uint8_t* seg, const Sweep& g, int p, int r0,
                           int r1, uint8_t* stage, int t) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(seg);
  const uintptr_t a0 = at(seg, g, p, r0) & ~uintptr_t(15);
  const uintptr_t end = base + g.last;
  const int n = (int)((at(seg, g, p, r1 - 1) + g.X - a0 + 15) >> 4);
  for (int i = t; i < n; i += kThreads) {
    const uintptr_t a = a0 + 16 * (uintptr_t)i;
    if (a >= base && a + 16 <= end) {
      __pipeline_memcpy_async(stage + 16 * i,
                              reinterpret_cast<const void*>(a), 16);
    } else {
      for (int j = 0; j < 16; ++j)
        if (a + j >= base && a + j < end)
          stage[16 * i + j] = *reinterpret_cast<const uint8_t*>(a + j);
    }
  }
}

// Bits i of word k (x = 32 k + i) with x0 <= x < x1.
__device__ __forceinline__ uint32_t window_bits(int k, int x0, int x1) {
  const int lo = max(x0 - 32 * k, 0), hi = min(x1 - 32 * k, 32);
  if (hi <= lo) return 0u;
  return (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// Bit i of the result: byte i of the 32 at `p` is nonzero.  Reads the 9
// aligned words around them.
__device__ __forceinline__ uint32_t pack32(const uint8_t* p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  const uint32_t sh = 8u * (reinterpret_cast<uintptr_t>(p) & 3u);
  uint32_t bits = 0, lo = w[0];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t hi = w[j + 1];
    const uint32_t b = __funnelshift_r(lo, hi, sh);   // bytes 4j..4j+3
    const uint32_t nz = (((b & 0x7f7f7f7fu) + 0x7f7f7f7fu) | b) >> 7;
    bits |= (((nz & 0x01010101u) * 0x01020408u) >> 24) << (4 * j);
    lo = hi;
  }
  return bits;
}

// Writes bit i of `o` as byte i (0 or 1) of the n <= 32 bytes at `p` of a
// zeroed buffer: words wholly inside the n bytes are stored, words shared
// with a neighbour's bytes ORed in, zero words skipped.
__device__ __forceinline__ void unpack32(uint8_t* p, uint32_t o, int n) {
  uint32_t* w = reinterpret_cast<uint32_t*>(reinterpret_cast<uintptr_t>(p)
                                            & ~uintptr_t(3));
  const int sh = (int)(reinterpret_cast<uintptr_t>(p) & 3u);
  uint32_t prev = 0;
#pragma unroll
  for (int m = 0; m <= 8; ++m) {
    const uint32_t cur =
        m < 8 ? (((o >> (4 * m)) & 15u) * 0x00204081u) & 0x01010101u : 0u;
    const uint32_t v = __funnelshift_l(prev, cur, 8 * sh);
    prev = cur;
    if (!v) continue;
    if (4 * m - sh >= 0 && 4 * m - sh + 4 <= n)
      w[m] = v;
    else
      atomicOr(&w[m], v);
  }
}

__global__ void __launch_bounds__(kThreads)
region_grow_sweep_kernel(const uint8_t* __restrict__ seg,
                         const uint8_t* __restrict__ bins,
                         uint8_t* __restrict__ out,
                         const int32_t* __restrict__ words_in, Sweep g,
                         int32_t* __restrict__ dh) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int h[2][256];
  __shared__ uint32_t words[8];
  const int nw = g.nw, RB = g.RB;
  const int nraw = (RB + 2) * nw, nout = RB * nw;
  uint8_t* stage = smem;                 // [2][g.stage], plane p at p & 1
  uint8_t* ostage = smem + 2 * g.stage;  // [g.stage], laid out like out
  uint32_t* rawS = reinterpret_cast<uint32_t*>(smem + 3 * g.stage);
  uint32_t* rawU = rawS + 3 * nraw;      // [3][nraw], plane p at p % 3
  uint32_t* dilS = rawU + 3 * nraw;      // [3][nout], plane p at p % 3
  uint32_t* dilU = dilS + 3 * nout;

  const int t = threadIdx.x;
  for (int i = t; i < 512; i += kThreads) (&h[0][0])[i] = 0;
  for (int i = t; i < g.stage / 16; i += kThreads)
    reinterpret_cast<uint4*>(ostage)[i] = make_uint4(0, 0, 0, 0);
  if (t < 8) words[t] = (uint32_t)words_in[t];

  const int y0 = g.y0 + blockIdx.x * RB, ye = min(y0 + RB, g.y1);
  const int z0 = g.z0 + blockIdx.y * g.zc, z1 = min(z0 + g.zc, g.z1);
  // the staged rows: the strip and the row beside it on each side
  const int r0 = max(y0 - 1, 0), r1 = min(y0 + RB + 1, g.Y);
  // copies plane c's rows y0..ye-1 from the out-stage to out and zeroes
  // the out-stage behind them
  auto copy_out = [&](int c) {
    const uintptr_t lo = at(out, g, c, y0);
    const uintptr_t hi = at(out, g, c, ye - 1) + g.X;
    const uintptr_t a0 = lo & ~uintptr_t(15);
    const int n = (int)((hi - a0 + 15) >> 4);
    for (int i = t; i < n; i += kThreads) {
      const uintptr_t a = a0 + 16 * (uintptr_t)i;
      uint4* s = reinterpret_cast<uint4*>(ostage) + i;
      if (a >= lo && a + 16 <= hi) {
        *reinterpret_cast<uint4*>(a) = *s;
      } else {
        for (int j = 0; j < 16; ++j)
          if (a + j >= lo && a + j < hi)
            *reinterpret_cast<uint8_t*>(a + j) = ostage[16 * i + j];
      }
      *s = make_uint4(0, 0, 0, 0);
    }
  };

  if (z0 > 0)
    stage_rows(seg, g, z0 - 1, r0, r1, stage + ((z0 + 1) & 1) * g.stage, t);
  __pipeline_commit();
  int flipped = 0;
  // plane p is packed; once its dilation exists, plane p - 1 is swept into
  // the out-stage, which the next pass copies out
  for (int p = z0 - 1; p <= z1; ++p) {
    const int q = p + 1;             // queued now, packed next
    if (q <= z1 && q < g.Z)
      stage_rows(seg, g, q, r0, r1, stage + (q & 1) * g.stage, t);
    __pipeline_commit();
    __pipeline_wait_prior(1);        // plane p has landed
    __syncthreads();
    if (p - 2 >= z0) copy_out(p - 2);
    const int sp = (p + 3) % 3;
    const bool have = p >= 0 && p < g.Z;
    const uint8_t* st = stage + ((p + 2) & 1) * g.stage
                        + (have ? at(seg, g, p, r0) & 15 : 0);
    for (int i = t; i < nraw; i += kThreads) {
      const int r = i / nw, k = i - r * nw, y = y0 - 1 + r;
      uint32_t s = 0, u = 0;
      if (have && y >= 0 && y < g.Y) {
        const int n = min(32, g.X - 32 * k);
        const uint32_t valid = n == 32 ? ~0u : (1u << n) - 1u;
        s = pack32(st + (y - r0) * g.sY + 32 * k) & valid;
        u = ~s & valid;
      }
      rawS[sp * nraw + i] = s;
      rawU[sp * nraw + i] = u;
    }
    __syncthreads();
    // yx-dilate plane p into the ring; sweep plane c = p - 1
    const int sc = (p + 2) % 3, sb = (p + 1) % 3;   // planes p-1, p-2
    const int c = p - 1;
    uint8_t* ost = ostage + (p > z0 ? at(out, g, c, y0) & 15 : 0);
    for (int i = t; i < nout; i += kThreads) {
      const int r = i / nw, k = i - r * nw;
      const uint32_t dS = rg::dil_rows(rawS + sp * nraw, r, k, nw);
      const uint32_t dU = rg::dil_rows(rawU + sp * nraw, r, k, nw);
      if (p > z0 && y0 + r < ye) {
        const int ci = sc * nraw + (r + 1) * nw + k;
        const uint32_t s = rawS[ci];
        uint32_t b = (dilS[sb * nout + i] | dilS[sc * nout + i] | dS)
                     & (dilU[sb * nout + i] | dilU[sc * nout + i] | dU)
                     & (s | rawU[ci]) & window_bits(k, g.x0, g.x1);
        const int row = (y0 + r) * g.sY + 32 * k;
        const uint8_t* bp = bins + c * g.sZ + row;
        uint32_t f = 0;
        while (b) {                  // the boundary voxels of this word
          const int j = __ffs(b) - 1;
          b &= b - 1;
          const uint32_t bin = bp[j], sj = (s >> j) & 1u;
          if (sj != rg::decision_bit(words, bin)) {
            f |= 1u << j;
            atomicAdd(&h[sj][bin], 1);
          }
        }
        flipped |= f != 0;
        unpack32(ost + r * g.sY + 32 * k, s ^ f, min(32, g.X - 32 * k));
      }
      dilS[sp * nout + i] = dS;
      dilU[sp * nout + i] = dU;
    }
  }
  __syncthreads();
  copy_out(z1 - 1);
  if (__syncthreads_or(flipped)) {
    for (int i = t; i < 512; i += kThreads)
      if ((&h[0][0])[i]) atomicAdd(&dh[i], (&h[0][0])[i]);
  }
}

// The tiling of a sweep over a Zw x Yw window: strips of RB rows (RB + 2
// staged and packed) and z-runs of zc planes (zc + 2 packed and
// dilated).  The host takes the fewest strips of equal height (no short
// last strip) of at most two raw words per thread and kMaxRows rows, then
// as many z-runs per strip as fill one wave of the blocks the card holds.
// Measured on an H100 (k2_breakdown.py, every tiling of a grid): where a
// sweep is bound by HBM (880x880x640, 20 words a row) taller strips pay,
// fewer rows read twice (22 rows against 10: -7% on a 441x441x640 block's
// window, -9% on the whole grid); where it is bound by latency and
// occupancy (512x512x170 and its 258x258x170 blocks) they help until a
// strip costs a resident block per SM (64 rows: 0.0543 ms for the whole
// grid, 74 rows 0.0602).  A floor on the z-run (so that fewer blocks
// pack the two warm-up planes) was slower at every shape measured.
constexpr int kMaxRows = 64;

}  // namespace

// seg, bins, out: uint8 with element (z, y, x) at z*sZ + y*sY + x for the
// region Z x Y x X (a plane of fewer than 2^31 bytes); the window
// [z0, z1) x [y0, y1) x [x0, x1) lies in the region (the whole region
// for a full sweep); words: int32[8] decision bits on the device; dh:
// int32[2][256], added into.  Writes the window's rows of its planes,
// whole (where sY > X, with zeros in the padding between two of them),
// and nothing else of out.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched, or an empty window).
extern "C" int region_grow_sweep(const void* seg, const void* bins,
                                 void* out, const void* words, int Z, int Y,
                                 int X, long long sZ, long long sY, int z0,
                                 int z1, int y0, int y1, int x0, int x1,
                                 void* dh, void* stream) {
  if (Z <= 0 || Y <= 0 || X <= 0) return 0;
  if (z0 < 0 || z1 > Z || y0 < 0 || y1 > Y || x0 < 0 || x1 > X)
    return (int)cudaErrorInvalidValue;
  if (z1 <= z0 || y1 <= y0 || x1 <= x0) return 0;
  if ((long long)Y * sY > INT_MAX) return (int)cudaErrorInvalidValue;
  const int nw = (X + 31) / 32;
  const int Yw = y1 - y0, Zw = z1 - z0;
  // the fewest strips of at most `most` rows, of equal height
  const int most = std::max(1, std::min({Yw, 2 * kThreads / nw - 2,
                                         kMaxRows,
                                         kStageBytes / (int)sY - 2}));
  const int fewest = (Yw + most - 1) / most;
  const int RB = (Yw + fewest - 1) / fewest, strips = (Yw + RB - 1) / RB;
  // RB + 2 rows from the start of their first 16-byte chunk, and the
  // aligned words that pack32 reads past a row's last word
  const int stage = (int)(((RB + 1) * sY + 32 * nw + 64) / 16 * 16);
  const size_t smem = smem_bytes(RB, nw, stage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_grow_sweep_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();           // not left for the next launch's check
      return (int)e;
    }
  }
  // one wave: as many z-runs per strip as the card holds blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, region_grow_sweep_kernel, kThreads, smem);
  const int runs = std::max(1, per_sm * sms / strips);
  const int zc = (Zw + runs - 1) / runs;
  const Sweep g{Z, Y, X, nw, RB, zc, (int)sY, stage, sZ,
                (Z - 1) * sZ + (Y - 1) * sY + X, z0, z1, y0, y1, x0, x1};
  const dim3 grid(strips, (Zw + zc - 1) / zc);
  region_grow_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(seg), static_cast<const uint8_t*>(bins),
      static_cast<uint8_t*>(out), static_cast<const int32_t*>(words), g,
      static_cast<int32_t*>(dh));
  return (int)cudaGetLastError();
}
