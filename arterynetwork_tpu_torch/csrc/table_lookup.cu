// Per-voxel table lookup, for Hopper (sm_90a).
//
// Replaces the TPU kernel _lookup_kernel of the JAX package's
// ops/pallas_kernels.py (launched by table_lookup_pallas), which computes
//
//   out[i] = table[bins[i]]
//
// over a flat volume.  The TPU kernel selects the entry with a one-hot
// compare-and-sum over (bins, 128) lanes because gathers are slow there;
// on this card a gather from shared memory is one instruction, so that
// workaround is not carried over.  One template gives two outputs:
//
//   values: out has the table's dtype (f32 or f64), out[i] = table[b];
//   sign:   out is 0/1 bytes (a bool tensor), out[i] = table[b] >= 0, so
//           NaN gives 0 and -0.0 gives 1, as the JAX package's packed sign
//           bits do.
//
// Bins are uint8 or int32.  An index outside [0, num_bins) is outside the
// contract; the kernel never reads outside the table and writes 0 there.
//
// What bounds it on this card: each voxel moves its bin (1 or 4 bytes) in
// and its entry (1, 4 or 8 bytes) out, e.g. 2 bytes per voxel for uint8
// bins in sign mode (~89 MB at 512x512x170, ~27 us at 3.35 TB/s), and does
// no arithmetic to speak of: HBM bounds it.  The design: each block stages
// the table (in sign mode the byte table table[b] >= 0) into shared
// memory when it fits in 48 KB, and reads it through the read-only cache
// when it does not; each thread takes 16 bins per step of a grid-stride
// loop, with 16-byte loads of the bins and 16-byte stores of the entries;
// a scalar loop takes the tail, and the whole volume when a pointer is not
// 16-byte aligned.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;

template <typename B>
__device__ __forceinline__ void load16(const B* p, uint32_t (&b)[16]);

template <>
__device__ __forceinline__ void load16(const uint8_t* p, uint32_t (&b)[16]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

template <>
__device__ __forceinline__ void load16(const int32_t* p, uint32_t (&b)[16]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 u = __ldg(q + k);
    b[4 * k] = (uint32_t)u.x;
    b[4 * k + 1] = (uint32_t)u.y;
    b[4 * k + 2] = (uint32_t)u.z;
    b[4 * k + 3] = (uint32_t)u.w;
  }
}

__device__ __forceinline__ void store16(uint8_t* p, const uint8_t (&v)[16]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)v[4 * k] | ((uint32_t)v[4 * k + 1] << 8) |
           ((uint32_t)v[4 * k + 2] << 16) | ((uint32_t)v[4 * k + 3] << 24);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(float* p, const float (&v)[16]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void store16(double* p, const double (&v)[16]) {
  double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = make_double2(v[2 * k], v[2 * k + 1]);
}

// E is what one voxel receives: a byte in sign mode, else the table's type.
template <typename T, bool SIGN>
using Entry = typename std::conditional<SIGN, uint8_t, T>::type;

template <typename T, bool SIGN>
__device__ __forceinline__ Entry<T, SIGN> entry(T v) {
  if constexpr (SIGN) return v >= T(0) ? 1 : 0;
  else return v;
}

template <typename B, typename T, bool SIGN, bool STAGED>
__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const B* __restrict__ bins, const T* __restrict__ table,
                    uint32_t num_bins, Entry<T, SIGN>* __restrict__ out,
                    long long n, bool vec) {
  using E = Entry<T, SIGN>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* tab = reinterpret_cast<E*>(smem);
  if constexpr (STAGED) {
    for (uint32_t i = threadIdx.x; i < num_bins; i += blockDim.x)
      tab[i] = entry<T, SIGN>(__ldg(table + i));
    __syncthreads();
  }
  auto fetch = [&](uint32_t b) -> E {
    if (b >= num_bins) return E(0);
    if constexpr (STAGED) return tab[b];
    else return entry<T, SIGN>(__ldg(table + b));
  };

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long groups = n >> 4;
    for (long long g = t0; g < groups; g += stride) {
      uint32_t b[16];
      load16(bins + 16 * g, b);
      E v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = fetch(b[j]);
      store16(out + 16 * g, v);
    }
    tail = groups << 4;
  }
  for (long long i = tail + t0; i < n; i += stride)
    out[i] = fetch((uint32_t)bins[i]);
}

template <typename B, typename T, bool SIGN>
int launch(const void* bins, const void* table, int num_bins, void* out,
           long long n, int n_sm, cudaStream_t stream) {
  if (n <= 0) return 0;
  using E = Entry<T, SIGN>;
  const bool vec = ((reinterpret_cast<uintptr_t>(bins) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long work = vec ? (n >> 4) + (n & 15) : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want > 8LL * n_sm ? 8LL * n_sm
                                                            : want));
  const size_t bytes = (size_t)num_bins * sizeof(E);
  const auto* b = static_cast<const B*>(bins);
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<E*>(out);
  if (bytes <= (size_t)kSharedBytes)
    table_lookup_kernel<B, T, SIGN, true>
        <<<blocks, kThreads, bytes, stream>>>(b, t, (uint32_t)num_bins, o, n,
                                              vec);
  else
    table_lookup_kernel<B, T, SIGN, false>
        <<<blocks, kThreads, 0, stream>>>(b, t, (uint32_t)num_bins, o, n,
                                          vec);
  return (int)cudaGetLastError();
}

template <typename B, typename T>
int by_mode(const void* bins, const void* table, int num_bins, void* out,
            int sign, long long n, int n_sm, cudaStream_t stream) {
  if (sign)
    return launch<B, T, true>(bins, table, num_bins, out, n, n_sm, stream);
  return launch<B, T, false>(bins, table, num_bins, out, n, n_sm, stream);
}

template <typename B>
int by_table(const void* bins, const void* table, int table_bytes,
             int num_bins, void* out, int sign, long long n, int n_sm,
             cudaStream_t stream) {
  if (table_bytes == 8)
    return by_mode<B, double>(bins, table, num_bins, out, sign, n, n_sm,
                              stream);
  return by_mode<B, float>(bins, table, num_bins, out, sign, n, n_sm,
                           stream);
}

}  // namespace

// bins: n uint8 (bin_bytes 1) or int32 (bin_bytes 4); table: num_bins
// float32 (table_bytes 4) or float64 (table_bytes 8); out: n entries of the
// table's type, or n 0/1 bytes when `sign` is non-zero.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int table_lookup(const void* bins, int bin_bytes,
                            const void* table, int table_bytes,
                            int num_bins, void* out, int sign, long long n,
                            int n_sm, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 4)
    return by_table<int32_t>(bins, table, table_bytes, num_bins, out, sign,
                             n, n_sm, s);
  return by_table<uint8_t>(bins, table, table_bytes, num_bins, out, sign, n,
                           n_sm, s);
}
