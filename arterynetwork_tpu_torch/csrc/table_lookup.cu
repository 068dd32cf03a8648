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
// and its entry (1, 4 or 8 bytes) out, e.g. 5 bytes per voxel for uint8
// bins and an f32 table (~223 MB at 512x512x170, ~67 us at 3.35 TB/s), and
// does no arithmetic to speak of: HBM bounds it, and the output is most of
// the bytes.  The design:
//
//   * each block stages the table (in sign mode the byte table
//     table[b] >= 0) into shared memory when it fits in 48 KB, and reads
//     it through the read-only cache when it does not;
//   * a thread's unit of work is a group of V consecutive voxels whose
//     entries fill one 16-byte store: V = 4 (f32), 2 (f64), 16 (sign).
//     Its V bins arrive in one load of V bytes (uint8) or 4V bytes
//     (int32).  Lane l of a warp takes group w + l, so every store
//     instruction of a warp writes one contiguous 512-byte run and every
//     load one contiguous run of its bins: no strided store, whose 32
//     lanes would each touch a different line;
//   * a thread takes kSteps[mode] groups per step of a grid-stride loop,
//     groups blockDim.x apart, and issues all their loads before its
//     first lookup, to keep bytes in flight;
//   * values are written with evict-first stores (the output is written
//     once and not read back by this kernel);
//   * the grid holds as many blocks as the card keeps resident at once
//     (from the occupancy of this kernel, table staging included);
//   * a scalar loop takes the last n % V voxels, and the whole volume
//     when bins or out is not 16-byte aligned.
//
// On an H100 (k7_breakdown.py) the values route runs at 77-85% of that
// bound on uint8 and int32 bins, skewed or uniform; an earlier design
// whose threads each stored 16 consecutive entries (32 lines per warp
// store) ran at 14-44% with the same registers and occupancy.  Staging
// a tile of entries in shared memory and draining it with one bulk
// asynchronous store (cp.async.bulk) measured within 5% of this design
// and was not kept: it would add a second path for uint8 bins only.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;
constexpr int kValueSteps = 4;   // groups per thread per step, values
constexpr int kSignSteps = 1;    // the same, sign mode

// E is what one voxel receives: a byte in sign mode, else the table's type.
template <typename T, bool SIGN>
using Entry = typename std::conditional<SIGN, uint8_t, T>::type;

template <typename T, bool SIGN>
__device__ __forceinline__ Entry<T, SIGN> entry(T v) {
  if constexpr (SIGN) return v >= T(0) ? 1 : 0;
  else return v;
}

// The V bins of one group, p aligned to V * sizeof(B) bytes.
template <typename B, int V>
__device__ __forceinline__ void load_bins(const B* p, uint32_t (&b)[V]) {
  constexpr int kBytes = V * (int)sizeof(B);
  uint32_t w[kBytes < 4 ? 1 : kBytes / 4];
  if constexpr (kBytes == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (kBytes == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(kBytes % 16 == 0, "a group's bins are 2, 4, 8 or 16k "
                  "bytes");
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 u = __ldg(q + k);
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    b[j] = sizeof(B) == 1 ? (w[j >> 2] >> (8 * (j & 3))) & 0xffu : w[j];
}

// One group's V entries as the four words of a 16-byte store.
template <typename E, int V>
__device__ __forceinline__ uint4 pack(const E (&v)[V]) {
  uint32_t w[4];
  if constexpr (sizeof(E) == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)v[4 * k] | ((uint32_t)v[4 * k + 1] << 8) |
             ((uint32_t)v[4 * k + 2] << 16) | ((uint32_t)v[4 * k + 3] << 24);
  } else if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned long long u = __double_as_longlong(v[k]);
      w[2 * k] = (uint32_t)u;
      w[2 * k + 1] = (uint32_t)(u >> 32);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename B, typename T, bool SIGN, bool STAGED>
__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const B* __restrict__ bins, const T* __restrict__ table,
                    uint32_t num_bins, Entry<T, SIGN>* __restrict__ out,
                    long long n, bool vec) {
  using E = Entry<T, SIGN>;
  constexpr int V = 16 / (int)sizeof(E);
  constexpr int U = SIGN ? kSignSteps : kValueSteps;
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

  long long tail = 0;
  if (vec) {
    const long long groups = n / V;
    const long long chunk = (long long)U * blockDim.x;
    for (long long g0 = (long long)blockIdx.x * chunk + threadIdx.x;
         g0 < groups; g0 += (long long)gridDim.x * chunk) {
      uint32_t b[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long g = g0 + (long long)u * blockDim.x;
        if (g < groups) load_bins<B, V>(bins + g * V, b[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long g = g0 + (long long)u * blockDim.x;
        if (g < groups) {
          E v[V];
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = fetch(b[u][j]);
          uint4* dst = reinterpret_cast<uint4*>(out + g * V);
          if constexpr (SIGN) *dst = pack<E, V>(v);
          else __stcs(dst, pack<E, V>(v));
        }
      }
    }
    tail = groups * V;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = tail + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = fetch((uint32_t)bins[i]);
}

template <typename B, typename T, bool SIGN, bool STAGED>
int launch_kernel(const B* bins, const T* table, int num_bins,
                  Entry<T, SIGN>* out, long long n, bool vec, int n_sm,
                  size_t smem, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(Entry<T, SIGN>);
  constexpr int U = SIGN ? kSignSteps : kValueSteps;
  auto* kernel = table_lookup_kernel<B, T, SIGN, STAGED>;
  // blocks resident per SM at this shared-memory size, asked once per size
  static size_t known_smem = ~(size_t)0;
  static int per_sm = 0;
  if (smem != known_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    known_smem = smem;
  }
  const long long work = vec ? (n / V + U - 1) / U + n % V : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long full = (long long)(per_sm < 1 ? 1 : per_sm) * n_sm;
  const int blocks = (int)(want < 1 ? 1 : (want > full ? full : want));
  kernel<<<blocks, kThreads, smem, stream>>>(bins, table, (uint32_t)num_bins,
                                             out, n, vec);
  return (int)cudaGetLastError();
}

template <typename B, typename T, bool SIGN>
int launch(const void* bins, const void* table, int num_bins, void* out,
           long long n, int n_sm, cudaStream_t stream) {
  if (n <= 0) return 0;
  using E = Entry<T, SIGN>;
  const bool vec = ((reinterpret_cast<uintptr_t>(bins) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const size_t bytes = (size_t)num_bins * sizeof(E);
  const auto* b = static_cast<const B*>(bins);
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<E*>(out);
  if (bytes <= (size_t)kSharedBytes)
    return launch_kernel<B, T, SIGN, true>(b, t, num_bins, o, n, vec, n_sm,
                                           bytes, stream);
  return launch_kernel<B, T, SIGN, false>(b, t, num_bins, o, n, vec, n_sm,
                                          0, stream);
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
