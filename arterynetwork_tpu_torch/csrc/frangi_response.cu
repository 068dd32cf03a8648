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
// What bounds it on this card: per voxel it moves ~12 bytes from device
// memory (one read of sm — the other 18 stencil reads hit L1/L2, since
// neighbouring threads share them — plus one read and one write of best)
// against ~200 flops including acosf, cosf, three expf and four sqrtf.
// That is ~17 flop/byte, near the card's FP32 balance point (67 TFLOP/s
// over 3.35 TB/s = 20), and each transcendental expands to tens of
// instructions, so the arithmetic, not HBM, is expected to bound it.  The
// design therefore spends nothing on data movement: no tiling through
// shared memory (the stencil's reuse is served by L1/L2), one thread per
// voxel with x fastest, so warps read and write contiguous 128-byte rows,
// and the scale max folded into the store instead of a second pass over
// the slab.  The scale weight g is read from a device pointer, so a chunk
// needs no host synchronisation.
//
// The file is built with -fmad=false: every product and sum is rounded
// on its own, in the order of the plain PyTorch twin
// (ops/vesselness_fused.frangi_response_plain_), and a division by a
// constant is a multiply by its f32 reciprocal, as PyTorch's CUDA
// division by a Python scalar computes it.  The kernel then agrees with
// the twin on the card to the last bits, not to the FMA-contraction error.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(256)
frangi_response_max_kernel(const float* __restrict__ sm, int Zs, int Y,
                           int X, int z_lo, float* __restrict__ best,
                           int best_z0, const float* __restrict__ g_ptr,
                           float s2, float q, float inv_two_a2,
                           float inv_two_b2,
                           int bright) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= X || y >= Y) return;
  const int zi = blockIdx.z;
  const int z = z_lo + zi;
  const long long plane = (long long)Y * X;
  const float* s0 = sm + (long long)z * plane;
  const float* sp = sm + (long long)clampi(z + 1, Zs - 1) * plane;
  const float* sn = sm + (long long)clampi(z - 1, Zs - 1) * plane;
  const int yp = clampi(y + 1, Y - 1) * X, yn = clampi(y - 1, Y - 1) * X;
  const int y0 = y * X;
  const int xp = clampi(x + 1, X - 1), xn = clampi(x - 1, X - 1);

  const float c = __ldg(s0 + y0 + x);
  // second derivatives: (f(+1) + f(-1)) - 2 f(0)
  const float a11 = ((__ldg(sp + y0 + x) + __ldg(sn + y0 + x)) - 2.0f * c) * s2;
  const float a22 = ((__ldg(s0 + yp + x) + __ldg(s0 + yn + x)) - 2.0f * c) * s2;
  const float a33 = ((__ldg(s0 + y0 + xp) + __ldg(s0 + y0 + xn)) - 2.0f * c) * s2;
  // cross terms: d/dy of dz, d/dz of dx, d/dy of dx
  const float a12 = ((__ldg(sp + yp + x) - __ldg(sn + yp + x)) -
                     (__ldg(sp + yn + x) - __ldg(sn + yn + x))) * q;
  const float a13 = ((__ldg(sp + y0 + xp) - __ldg(sp + y0 + xn)) -
                     (__ldg(sn + y0 + xp) - __ldg(sn + y0 + xn))) * q;
  const float a23 = ((__ldg(s0 + yp + xp) - __ldg(s0 + yp + xn)) -
                     (__ldg(s0 + yn + xp) - __ldg(s0 + yn + xn))) * q;

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
  const float g = __ldg(g_ptr);
  const float ra = fabsf(l2) / (fabsf(l3) + eps);
  const float rb = fabsf(l1) / (sqrtf(fabsf(l2 * l3)) + eps);
  const float s = sqrtf(l1 * l1 + l2 * l2 + l3 * l3);
  float v = (1.0f - expf(-(ra * ra) * inv_two_a2)) *
            expf(-(rb * rb) * inv_two_b2) *
            (1.0f - expf(-(s * s) / (2.0f * (g * g) + eps)));
  const bool keep = bright ? (l2 < 0.0f && l3 < 0.0f)
                           : (l2 > 0.0f && l3 > 0.0f);
  if (!keep) v = 0.0f;

  float* out = best + (long long)(best_z0 + zi) * plane + y0 + x;
  *out = fmaxf(*out, v);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller has checked shapes, bounds and devices.
extern "C" int frangi_response_max(const float* sm, int Zs, int Y, int X,
                                   int z_lo, int zr, float* best,
                                   int best_z0, const float* g, float s2,
                                   float q, float inv_two_a2,
                                   float inv_two_b2, int bright,
                                   void* stream) {
  if (zr <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((X + 31) / 32, (Y + 7) / 8, zr);
  frangi_response_max_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sm, Zs, Y, X, z_lo, best, best_z0, g, s2, q, inv_two_a2, inv_two_b2,
      bright);
  return (int)cudaGetLastError();
}
