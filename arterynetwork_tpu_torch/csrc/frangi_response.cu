// Frangi response with the scale max folded into the store, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _response_kernel of the JAX package's
// ops/vesselness_fused.py (launched by _pallas_response).  Per output
// voxel of the smoothed field `sm`, rows [z_lo, z_lo + zr):
//   * the six scale-normalised Hessian terms by central differences on a
//     19-point stencil (centre, 6 faces, 12 edges): x sigma^2 on second
//     derivatives, x sigma^2/4 on cross terms; y and x indices are clamped
//     (edge replication, as the reference stencils do at the volume faces)
//     and z comes from real rows (clamped only at the ends of `sm`);
//   * the closed-form eigenvalues of the symmetric 3x3 matrix in the
//     trigonometric form (acosf/cosf) — the TPU kernel solves the
//     triple-angle cubic by Newton only because Mosaic has no acos/cos;
//   * the sort by |lambda|, Frangi's alpha/beta/gamma=g tubularity and the
//     bright/dark sign gate;
//   * best[best_z0 + z, y, x] = fmaxf(best[...], v), in place.
//
// What bounds it on this card.  The bytes a launch must move (sm's rows
// read once, best read and written once: 50.8 MB at the path's shape,
// 0.0152 ms at 3.35 TB/s) are not the limit; instructions are.  The first
// design (one thread per voxel, 19 __ldg per voxel with clamps and 64-bit
// addresses, the arithmetic for every voxel) took 0.0854 ms per launch on
// an H100 80GB HBM3 at 700 W; a copy of it with the arithmetic removed
// took 0.0506 ms and one with the loads replaced by register values
// 0.0623 ms (k1_breakdown.py): both streams are large, and they overlap
// only in part.  This design cuts both, and takes 0.080 ms on the same
// card.  With its survivors' arithmetic replaced by a sum it still takes
// 0.060 ms, and without the gate 0.101 ms: the staged stencil, the terms
// and the list now set the pace, and the arithmetic the gate leaves adds
// ~0.020 ms.
//
// - Staging.  A block owns a 32 x 8 tile of output columns and a run of
//   zc planes, and marches through the run in z.  Each plane's halo'd
//   34 x 10 tile (y and x clamped at load time, so the stencil needs no
//   clamps; each thread's two source offsets are computed once) and the
//   tile's row of best are copied into shared rings by 4-byte cp.async
//   (rows of 170 floats are only 8-byte aligned, ragged ones 4-byte),
//   kAhead planes ahead of the one being computed.  A value of sm leaves
//   L2 about (zc + 2) / zc x 340 / 256 times instead of 19, the 19 reads
//   are shared-memory loads at fixed offsets, and indices are 32-bit
//   within a plane.
// - The exact sign gate.  After the sort by |lambda|, a kept voxel has
//   lambda2 and lambda3 of one sign, and |lambda1| <= |lambda2| puts the
//   eigenvalue sum on that sign by at least |lambda3|; the computed
//   e2 = 3 qm - e1 - e3 keeps that sum within a few ulps of |lambda3| of
//   3 qm, and the degenerate branch sets all three to qm.  So where
//   qm >= 0 (bright) or qm <= 0 (dark) the twin's response is exactly 0,
//   for finite terms and whatever the rounding; tests/
//   test_torch_vesselness_gate.py holds the twin and the JAX package's
//   function to it.  Such a voxel stores best = fmaxf(best, 0.0f), as
//   before, and skips the rest: about half the voxels of the path's slab
//   (45-55% per scale).
// - Compaction.  The other voxels append their six terms and their place
//   in the run to a per-block shared ring of survivors (warp ballot,
//   popcount prefix, one shared atomic per warp).  Once kThreads of them
//   wait, a step drains kThreads through the eigen-solve and the response
//   on every lane of the block: no lane idles on a gated voxel or past the
//   end of a row (the last tile of a 170-wide row has 22 such lanes).  A
//   step holds one barrier.  (Draining each plane's survivors at every
//   step, about half a block, took 0.0794 ms in another call: no
//   better.)  A drained
//   voxel's best is loaded from device memory at the start of its step,
//   a gated voxel's is staged with its row.
// - g, 2 g^2 + eps and the staging offsets are computed once per thread;
//   the host picks the run length so the grid holds two waves of blocks.
//
// The file is built with -fmad=false: every product and sum is rounded
// on its own, in the order of the plain PyTorch twin
// (ops/vesselness_fused.frangi_response_plain_), and a division by a
// constant is a multiply by its f32 reciprocal, as PyTorch's CUDA
// division by a Python scalar computes it.  The kernel then agrees with
// the twin on the card to the last bits, not to the FMA-contraction error.

#include <algorithm>
#include <climits>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32, kTY = 8, kThreads = kTX * kTY;
constexpr int kHX = kTX + 2, kHY = kTY + 2;    // the halo'd tile
constexpr int kPlane = kHX * kHY;              // <= 2 * kThreads
constexpr int kAhead = 3;                      // planes in flight
constexpr int kSlots = 3 + kAhead;             // z - 1, z, z + 1, ahead
constexpr int kTerms = 7;                      // 6 terms, the voxel
constexpr int kList = 3 * kThreads;            // survivors not yet drained

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The response of one voxel from its Hessian terms, in the twin's order.
__device__ __forceinline__ float response(float a11, float a22, float a33,
                                          float a12, float a13, float a23,
                                          float inv_two_a2, float inv_two_b2,
                                          float den, int bright) {
  // symmetric 3x3 eigenvalues, trigonometric closed form
  const float p1 = a12 * a12 + a13 * a13 + a23 * a23;
  const float qm = (a11 + a22 + a33) * (1.0f / 3.0f);
  const float b11 = a11 - qm, b22 = a22 - qm, b33 = a33 - qm;
  const float p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 * (1.0f / 6.0f), 1e-30f));
  const float inv_p = 1.0f / p;
  const float c11 = b11 * inv_p, c22 = b22 * inv_p, c33 = b33 * inv_p;
  const float c12 = a12 * inv_p, c13 = a13 * inv_p, c23 = a23 * inv_p;
  const float detb = c11 * (c22 * c33 - c23 * c23) -
                     c12 * (c12 * c33 - c23 * c13) +
                     c13 * (c12 * c23 - c22 * c13);
  const float r = fminf(fmaxf(detb * 0.5f, -1.0f), 1.0f);
  const float phi = acosf(r) * (1.0f / 3.0f);
  const float two_pi_3 = (float)2.0943951023931953;  // 2*pi/3
  float e1 = qm + 2.0f * p * cosf(phi);             // largest
  float e3 = qm + 2.0f * p * cosf(phi + two_pi_3);  // smallest
  float e2 = 3.0f * qm - e1 - e3;
  if (p2 < 1e-24f) e1 = e2 = e3 = qm;  // degenerate: all equal q

  // sort by |lambda|: 3-element compare-swap network
  float l1 = e3, l2 = e2, l3 = e1, t;
  if (fabsf(l1) > fabsf(l2)) { t = l1; l1 = l2; l2 = t; }
  if (fabsf(l2) > fabsf(l3)) { t = l2; l2 = l3; l3 = t; }
  if (fabsf(l1) > fabsf(l2)) { t = l1; l1 = l2; l2 = t; }

  const float eps = 1e-10f;
  const float ra = fabsf(l2) / (fabsf(l3) + eps);
  const float rb = fabsf(l1) / (sqrtf(fabsf(l2 * l3)) + eps);
  const float s = sqrtf(l1 * l1 + l2 * l2 + l3 * l3);
  const float v = (1.0f - expf(-(ra * ra) * inv_two_a2)) *
                  expf(-(rb * rb) * inv_two_b2) *
                  (1.0f - expf(-(s * s) / den));
  const bool keep = bright ? (l2 < 0.0f && l3 < 0.0f)
                           : (l2 > 0.0f && l3 > 0.0f);
  return keep ? v : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
frangi_response_max_kernel(const float* __restrict__ sm, int Zs, int Y,
                           int X, int z_lo, int zr, int zc,
                           float* __restrict__ best, int best_z0,
                           const float* __restrict__ g_ptr, float s2,
                           float q, float inv_two_a2, float inv_two_b2,
                           int bright) {
  __shared__ float ring[kSlots][kPlane];       // sm row r at r % kSlots
  __shared__ float best_in[kSlots][kThreads];  // best row k at k % kSlots
  __shared__ float list[kTerms][kList];        // a ring of survivors
  __shared__ int count[3];                     // step k's at k % 3
  const int t = threadIdx.x, lane = t & 31;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const bool inside = x0 + lane < X && y0 + (t >> 5) < Y;
  const int off = (y0 + (t >> 5)) * X + x0 + lane;   // in-plane offset
  const int cc = ((t >> 5) + 1) * kHX + lane + 1;    // centre in the tile
  const int zb = blockIdx.z * zc;              // first row of the run
  const int nz = min(zc, zr - zb);
  const size_t plane = (size_t)(Y * X);
  const float g = __ldg(g_ptr);
  const float den = 2.0f * (g * g) + 1e-10f;
  // this thread's two elements of every staged tile, y and x clamped
  const int e1 = t + kThreads;
  const int src0 = clampi(y0 - 1 + t / kHX, Y - 1) * X
                   + clampi(x0 - 1 + t % kHX, X - 1);
  const int src1 = e1 < kPlane ? clampi(y0 - 1 + e1 / kHX, Y - 1) * X
                                 + clampi(x0 - 1 + e1 % kHX, X - 1) : 0;
  if (t < 3) count[t] = 0;

  // Step j queues sm's row p0 + j (clamped into sm) and best's row j - 2
  // of the run, where they exist, as one cp.async group.
  const int p0 = z_lo + zb - 1;
  float* const best_run = best + (size_t)(best_z0 + zb) * plane;
  auto stage = [&](int j) {
    if (j < nz + 2) {
      const float* src = sm + (size_t)clampi(p0 + j, Zs - 1) * plane;
      float* dst = ring[j % kSlots];
      __pipeline_memcpy_async(dst + t, src + src0, sizeof(float));
      if (e1 < kPlane)
        __pipeline_memcpy_async(dst + e1, src + src1, sizeof(float));
    }
    if (j >= 2 && j - 2 < nz && inside)
      __pipeline_memcpy_async(&best_in[(j - 2) % kSlots][t],
                              best_run + (size_t)(j - 2) * plane + off,
                              sizeof(float));
    __pipeline_commit();
  };
  for (int j = 0; j < kSlots - 1; ++j) stage(j);

  // Step k computes the terms of row k and appends its survivors to the
  // list; once kThreads survivors wait (and in the two steps after the
  // last row, for the rest), the step also drains kThreads of them on
  // every lane.  One barrier a step.  head and tail count the survivors
  // drained and appended before the step; every thread keeps the same.
  int head = 0, tail = 0;
  for (int k = 0; k <= nz + 1; ++k) {
    __pipeline_wait_prior(kAhead - 1);         // groups <= k + 2 landed
    __syncthreads();
    // slot (k - 1) % kSlots of the ring was last read in step k - 1, and
    // best_in's slot (k + 3) % kSlots in step k - 3
    stage(k + kSlots - 1);
    if (k > 0) tail += count[(k - 1) % 3];
    if (t == 0) count[(k + 1) % 3] = 0;        // last read in step k - 1
    const int avail = tail - head;             // < 2 * kThreads
    const int d = avail >= kThreads || k >= nz ? min(avail, kThreads) : 0;
    // the drained voxel's best, loaded before its row's gated stores,
    // which never touch it
    int e = 0;
    float b = 0.0f;
    if (t < d) {
      e = __float_as_int(list[6][(head + t) % kList]);
      b = best_run[(size_t)(e >> 8) * plane
                   + (y0 + ((e & 255) >> 5)) * X + x0 + (e & 31)];
    }

    bool pass = false;
    float a11 = 0.0f, a22 = 0.0f, a33 = 0.0f, a12 = 0.0f, a13 = 0.0f,
          a23 = 0.0f;
    if (k < nz && inside) {
      const float* sn = ring[k % kSlots];          // z - 1
      const float* s0 = ring[(k + 1) % kSlots];    // z
      const float* sp = ring[(k + 2) % kSlots];    // z + 1
      const float c = s0[cc];
      // second derivatives: (f(+1) + f(-1)) - 2 f(0)
      a11 = ((sp[cc] + sn[cc]) - 2.0f * c) * s2;
      a22 = ((s0[cc + kHX] + s0[cc - kHX]) - 2.0f * c) * s2;
      a33 = ((s0[cc + 1] + s0[cc - 1]) - 2.0f * c) * s2;
      // cross terms: d/dy of dz, d/dz of dx, d/dy of dx
      a12 = ((sp[cc + kHX] - sn[cc + kHX]) -
             (sp[cc - kHX] - sn[cc - kHX])) * q;
      a13 = ((sp[cc + 1] - sp[cc - 1]) - (sn[cc + 1] - sn[cc - 1])) * q;
      a23 = ((s0[cc + kHX + 1] - s0[cc + kHX - 1]) -
             (s0[cc - kHX + 1] - s0[cc - kHX - 1])) * q;
      const float qm = (a11 + a22 + a33) * (1.0f / 3.0f);
      // the sign gate: the response is exactly 0 (head note); NaN passes
      pass = bright ? !(qm >= 0.0f) : !(qm <= 0.0f);
      if (!pass)
        best_run[(size_t)k * plane + off] =
            fmaxf(best_in[k % kSlots][t], 0.0f);
    }
    // append: the list holds < 2 * kThreads before and kThreads more
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (m) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&count[k % 3], __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (pass) {
        const int i = (tail + base + __popc(m & ((1u << lane) - 1u)))
                      % kList;
        list[0][i] = a11;
        list[1][i] = a22;
        list[2][i] = a33;
        list[3][i] = a12;
        list[4][i] = a13;
        list[5][i] = a23;
        list[6][i] = __int_as_float(k << 8 | t);
      }
    }

    if (t < d) {
      const int i = (head + t) % kList;
      const float v = response(list[0][i], list[1][i], list[2][i],
                               list[3][i], list[4][i], list[5][i],
                               inv_two_a2, inv_two_b2, den, bright);
      best_run[(size_t)(e >> 8) * plane + (y0 + ((e & 255) >> 5)) * X + x0
               + (e & 31)] = fmaxf(b, v);
    }
    head += d;
  }
}

// 6 blocks of 35 KB each fit an SM only with the largest carveout
cudaError_t set_carveout() {
  return cudaFuncSetAttribute(frangi_response_max_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int launch(const float* sm, int Zs, int Y, int X, int z_lo, int zr, int zc,
           float* best, int best_z0, const float* g, float s2, float q,
           float inv_two_a2, float inv_two_b2, int bright, void* stream) {
  const dim3 grid((X + kTX - 1) / kTX, (Y + kTY - 1) / kTY,
                  (zr + zc - 1) / zc);
  frangi_response_max_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sm, Zs, Y, X, z_lo, zr, zc, best, best_z0, g, s2, q, inv_two_a2,
      inv_two_b2, bright);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller has checked shapes, bounds and devices; a plane of sm holds
// fewer than 2^31 values.
extern "C" int frangi_response_max(const float* sm, int Zs, int Y, int X,
                                   int z_lo, int zr, float* best,
                                   int best_z0, const float* g, float s2,
                                   float q, float inv_two_a2,
                                   float inv_two_b2, int bright,
                                   void* stream) {
  if (zr <= 0) return 0;
  if ((long long)Y * X > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_carveout();
  if (e != cudaSuccess) return (int)e;
  // the longest run (fewest halo planes staged twice) that still gives
  // the grid two waves of the blocks the card holds, and at least 4
  // planes
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, frangi_response_max_kernel, kThreads, 0);
  const long long tiles = (long long)((X + kTX - 1) / kTX) *
                          ((Y + kTY - 1) / kTY);
  const long long runs = std::max(1LL, (2LL * sms * per_sm + tiles - 1)
                                           / tiles);
  const int zc = std::min(zr, std::max(4, (int)((zr + runs - 1) / runs)));
  return launch(sm, Zs, Y, X, z_lo, zr, zc, best, best_z0, g, s2, q,
                inv_two_a2, inv_two_b2, bright, stream);
}
