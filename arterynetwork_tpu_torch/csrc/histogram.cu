// Masked 256-bin histograms of uint8 bin ids, for Hopper (sm_90a).
//
// Replaces the TPU kernels _hist1_kernel (masked_histogram1_pallas, one
// mask: K6b) and _hist2_kernel (masked_histograms_pallas, two masks: K6a)
// of the JAX package's ops/pallas_kernels.py.  One source, templated on
// the number of masks:
//
//   out[m][b] += #{ i : bins[i] == b and masks[m][i] != 0 }
//
// The TPU kernels factor each bin into two 16-wide one-hots and contract
// them on the matrix unit, accumulating in f32 (exact only below 2^24 per
// bin).  Here every count is an integer atomic: int32 in a block's shared
// histogram (the grid holds 8 blocks per SM, so a block counts fewer than
// 2^31 voxels while n < 2^41 on an H100), 64-bit in the global one, which
// a bin holding 2^31 voxels or more needs.  The wrapper casts to f32 once.
//
// What bounds it on this card: each voxel moves 1 + NM bytes, so a
// 512x512x170 volume is ~90-135 MB (~30-40 us at 3.35 TB/s), and each
// counted voxel costs one shared-memory atomic.  Real volumes put most
// voxels in a few background bins, so those atomics collide on one address
// and serialise; they, not HBM, are expected to bound the kernel.  The
// design: a grid-stride pass with 4 voxels per thread per step (one 32-bit
// load of bins and of each mask when the pointers allow it), a private
// shared-memory int histogram per block and mask, and one global atomic
// per non-zero bin when the block is done.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;

template <int NM>
__device__ __forceinline__ void count(int (*h)[kBins], uint32_t b,
                                      uint32_t m0, uint32_t m1) {
  if (m0) atomicAdd(&h[0][b], 1);
  if (NM == 2 && m1) atomicAdd(&h[1][b], 1);
}

template <int NM, bool VEC>
__global__ void __launch_bounds__(kThreads)
masked_hist_kernel(const uint8_t* __restrict__ bins,
                   const uint8_t* __restrict__ m0,
                   const uint8_t* __restrict__ m1, long long n,
                   int num_bins, unsigned long long* __restrict__ out) {
  __shared__ int h[NM][kBins];
  for (int i = threadIdx.x; i < NM * kBins; i += blockDim.x)
    (&h[0][0])[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    const uint32_t* b4 = reinterpret_cast<const uint32_t*>(bins);
    const uint32_t* a4 = reinterpret_cast<const uint32_t*>(m0);
    const uint32_t* c4 = reinterpret_cast<const uint32_t*>(m1);
    for (long long i = t0; i < n4; i += stride) {
      const uint32_t b = __ldg(b4 + i);
      const uint32_t a = __ldg(a4 + i);
      const uint32_t c = NM == 2 ? __ldg(c4 + i) : 0u;
      if ((a | c) == 0u) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        count<NM>(h, (b >> (8 * k)) & 0xffu, (a >> (8 * k)) & 0xffu,
                  (c >> (8 * k)) & 0xffu);
    }
    tail = n4 << 2;
  }
  for (long long i = tail + t0; i < n; i += stride)
    count<NM>(h, bins[i], m0[i], NM == 2 ? m1[i] : 0u);
  __syncthreads();

  for (int i = threadIdx.x; i < NM * num_bins; i += blockDim.x) {
    const int v = h[i / num_bins][i % num_bins];
    if (v) atomicAdd(&out[i], (unsigned long long)v);
  }
}

template <int NM>
int launch(const uint8_t* bins, const uint8_t* m0, const uint8_t* m1,
           long long n, int num_bins, unsigned long long* out, int n_sm,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(bins)
                     | reinterpret_cast<uintptr_t>(m0)
                     | reinterpret_cast<uintptr_t>(m1)) & 3u) == 0;
  // enough blocks to fill every SM several times over, and no more: each
  // block pays a 256-bin flush
  long long want = (n + 4LL * kThreads * 8 - 1) / (4LL * kThreads * 8);
  const int blocks = (int)(want < 1 ? 1 : (want > 8LL * n_sm ? 8LL * n_sm
                                                            : want));
  if (vec)
    masked_hist_kernel<NM, true><<<blocks, kThreads, 0, stream>>>(
        bins, m0, m1, n, num_bins, out);
  else
    masked_hist_kernel<NM, false><<<blocks, kThreads, 0, stream>>>(
        bins, m0, m1, n, num_bins, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out: int64[n_masks][num_bins], zeroed by the caller; masks may be equal.
// n_masks is 1 (m1 ignored) or 2; num_bins <= 256 and every bin id is
// below num_bins.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int masked_histograms_u8(const void* bins, const void* m0,
                                    const void* m1, long long n,
                                    int n_masks, int num_bins, void* out,
                                    int n_sm, void* stream) {
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* a = static_cast<const uint8_t*>(m0);
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_masks == 1) return launch<1>(b, a, a, n, num_bins, o, n_sm, s);
  return launch<2>(b, a, static_cast<const uint8_t*>(m1), n, num_bins, o,
                   n_sm, s);
}
