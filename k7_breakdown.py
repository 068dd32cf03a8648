#!/usr/bin/env python3
"""Where K7's time goes on one CUDA card, and which design it keeps.

    python3 k7_breakdown.py [--baseline OLD.cu] [--no-speck] [--json PATH]

K7 (csrc/table_lookup.cu, ``out[i] = table[bins[i]]`` as values or as
signs) on the region-growing path's inputs: the bins of bench.py's tube
phantom at 512x512x170 and at 880x880x640 (quantized to 256 bins as the
growers do), and uniform random bins at 512x512x170 (every bin equally
often, which the tube's skewed bins never give: bank conflicts).  Every
build below is held to the plain gather byte for byte on each case, then
timed.  Prints:

  * the card, and `nvidia-smi --query-gpu=name,power.limit`;
  * ptxas's registers, spills and stack frame for every instantiation of
    every build, and the resident blocks per SM that they allow;
  * device ms per launch of each build on each case: CUDA events around
    20 back-to-back launches into a preallocated output ("events"), and
    the torch.profiler time of chip_smoke.py's ``device_ms`` ("trace",
    None when every trace dropped events); for the port's wrapper, the
    CUDA-event time of one call (output allocation and checks included),
    and the same for ``table[bins.long()]`` (the library call);
  * each case's bound, bytes / 3.35 TB/s (each bin read once, each entry
    written once, the table read once).

The builds: "port" (the source as it is); variants made from it by one
substitution (VARIANTS below; a variant whose text is not in the source is
skipped); "staged_store", a probe in this file that stages each tile of
entries in shared memory and drains it with one bulk asynchronous store
(cp.async.bulk, double-buffered; f32/f64 values, uint8 bins, staged
tables only); and with ``--baseline``, an older K7 source with the same C
interface, e.g. the parent commit's:

    git show <commit>:arterynetwork_tpu_torch/csrc/table_lookup.cu \\
        > build/k7_baseline.cu
    python3 k7_breakdown.py --baseline build/k7_baseline.cu

Last, f32 values at n = 2^31 + 33 (port only; the plain gather's int64
index needs ~37 GB).  The whole record goes to ``--json`` (by default
build/k7_breakdown.json) and, as one JSON line, last to stdout.
Exits non-zero without a CUDA device or if any build disagrees with the
plain gather.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kernel_probe import build_all, demangle, events_ms, variants  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
RG_SHAPE = (512, 512, 170)
SPECK_SHAPE = (880, 880, 640)
N31 = 2 ** 31 + 33
REPS = 20

# name: (old, new, ...) substitutions into csrc/table_lookup.cu
VARIANTS = {
    "steps1": ("constexpr int kValueSteps = 4;",
               "constexpr int kValueSteps = 1;"),
    "steps2": ("constexpr int kValueSteps = 4;",
               "constexpr int kValueSteps = 2;"),
    "steps8": ("constexpr int kValueSteps = 4;",
               "constexpr int kValueSteps = 8;"),
    "plain_stores": ("else __stcs(dst, pack<E, V>(v));",
                     "else *dst = pack<E, V>(v);"),
    "grid_8_per_sm": (
        "const long long full = (long long)(per_sm < 1 ? 1 : per_sm) * n_sm;",
        "const long long full = 8LL * n_sm;"),
    "min_blocks_8": ("__global__ void __launch_bounds__(kThreads)",
                     "__global__ void __launch_bounds__(kThreads, 8)"),
    "sign_steps2": ("constexpr int kSignSteps = 1;",
                    "constexpr int kSignSteps = 2;"),
    "sign_stcs": ("if constexpr (SIGN) *dst = pack<E, V>(v);",
                  "if constexpr (SIGN) __stcs(dst, pack<E, V>(v));"),
}

STAGED_STORE_SRC = r"""
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;

template <typename T>
__device__ __forceinline__ uint4 pack(const T* v);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

template <>
__device__ __forceinline__ uint4 pack<double>(const double* v) {
  const unsigned long long a = __double_as_longlong(v[0]);
  const unsigned long long b = __double_as_longlong(v[1]);
  return make_uint4((uint32_t)a, (uint32_t)(a >> 32), (uint32_t)b,
                    (uint32_t)(b >> 32));
}

// Each block looks up a tile of kThreads * kSteps groups of V = 16 /
// sizeof(T) voxels into one of two shared-memory tiles (lane-contiguous
// 16-byte shared stores), then one thread drains the tile to global
// memory with cp.async.bulk while the block fills the other tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
staged_store_kernel(const uint8_t* __restrict__ bins,
                    const T* __restrict__ table, uint32_t num_bins,
                    T* __restrict__ out, long long n) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int kTile = kThreads * kSteps * V;
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  T* tab = buf + 2 * kTile;
  for (uint32_t i = threadIdx.x; i < num_bins; i += blockDim.x)
    tab[i] = __ldg(table + i);
  __syncthreads();
  const long long tiles = n / kTile;
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, ++it) {
    T* dst = buf + (it & 1) * kTile;
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();
    const uint8_t* src = bins + tile * kTile;
    uint32_t w[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int g = s * kThreads + threadIdx.x;
      if constexpr (V == 4)
        w[s] = __ldg(reinterpret_cast<const unsigned int*>(src + 4 * g));
      else
        w[s] = __ldg(reinterpret_cast<const unsigned short*>(src + 2 * g));
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int g = s * kThreads + threadIdx.x;
      T v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t b = (w[s] >> (8 * j)) & 0xffu;
        v[j] = b < num_bins ? tab[b] : T(0);
      }
      *reinterpret_cast<uint4*>(dst + g * V) = pack<T>(v);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"((unsigned long long)(out + tile * kTile)),
             "r"((uint32_t)__cvta_generic_to_shared(dst)),
             "r"((int)(kTile * sizeof(T))) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  for (long long i = tiles * kTile + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const uint32_t b = bins[i];
    out[i] = b < num_bins ? tab[b] : T(0);
  }
}

template <typename T>
int launch(const void* bins, const void* table, int num_bins, void* out,
           long long n, int n_sm, cudaStream_t stream) {
  constexpr int kTile = kThreads * kSteps * (16 / (int)sizeof(T));
  const size_t smem = (2 * kTile + num_bins) * sizeof(T);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, staged_store_kernel<T>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long want = n / kTile + 1;
  const long long full = (long long)(per_sm < 1 ? 1 : per_sm) * n_sm;
  staged_store_kernel<T><<<(int)(want > full ? full : want), kThreads, smem,
                           stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const T*>(table),
      (uint32_t)num_bins, static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int table_lookup(const void* bins, int bin_bytes,
                            const void* table, int table_bytes,
                            int num_bins, void* out, int sign, long long n,
                            int n_sm, void* stream) {
  if (sign || bin_bytes != 1 || num_bins > 256 ||
      ((reinterpret_cast<uintptr_t>(bins) |
        reinterpret_cast<uintptr_t>(out)) & 15u))
    return (int)cudaErrorNotSupported;
  auto s = static_cast<cudaStream_t>(stream);
  if (table_bytes == 8)
    return launch<double>(bins, table, num_bins, out, n, n_sm, s);
  return launch<float>(bins, table, num_bins, out, n, n_sm, s);
}
"""


def resident_blocks(ptxas, threads=256):
    """{kernel: blocks per SM that its registers allow (65,536 per SM,
    allocated per warp in units of 256; at most 2,048 threads)}."""
    out, name = {}, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs = int(m.group(1))
            per_warp = -(-regs * 32 // 256) * 256
            out[name] = min(2048 // threads,
                            65536 // (per_warp * (threads // 32)))
    return out


def run_case(name, bins, table, sign, libs, res, library=True):
    """Every build against the plain gather on one case, then timed."""
    import torch

    from chip_smoke import cuda_ms, device_ms
    from arterynetwork_tpu_torch.ops import cuda_build
    from arterynetwork_tpu_torch.ops import lookup_kernels as lk

    plain = lk.sign_lookup_plain if sign else lk.table_lookup_plain
    fn = lk.sign_lookup if sign else lk.table_lookup
    ref = plain(bins, table)
    out = torch.empty_like(ref)
    n = bins.numel()
    nbytes = n * (bins.element_size() + ref.element_size()) \
        + table.numel() * table.element_size()
    row = {"n": n, "bytes": nbytes,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "events": {},
           "trace": {}}
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for build, (lib, _) in libs.items():
        def launch(lib=lib):
            cuda_build.check(lib.table_lookup(
                bins.data_ptr(), bins.element_size(), table.data_ptr(),
                table.element_size(), table.numel(), out.data_ptr(),
                int(sign), n, n_sm, stream), build)

        out.view(torch.uint8).fill_(0xA5)
        try:
            launch()
        except RuntimeError as e:       # the probe takes values only
            print(f"  {name} / {build}: {e}", flush=True)
            continue
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.uint8), ref.view(torch.uint8)):
            raise SystemExit(f"k7_breakdown: {build} differs from the plain "
                             f"gather on {name}")
        row["events"][build] = events_ms(launch, n=REPS)
        row["trace"][build] = (None if n > 2 ** 31 else
                               device_ms(launch, own=True)[0])
    del out
    row["wrapper_call_ms"] = cuda_ms(lambda: fn(bins, table))
    if library:
        row["library_call_ms"] = cuda_ms(
            lambda: table[bins.long()] >= 0 if sign else table[bins.long()])
    del ref
    best = min(row["events"], key=row["events"].get)
    print(f"{name}: n {n}, bound {row['bound_ms']:.4f} ms; events ms "
          + ", ".join(f"{k} {v:.4f} ({row['bound_ms'] / v:.1%})"
                      for k, v in row["events"].items())
          + "; trace ms " + ", ".join(
              f"{k} {'dropped' if v is None else f'{v:.4f}'}"
              for k, v in row["trace"].items())
          + f"; wrapper call {row['wrapper_call_ms']:.4f}; library call "
          + (f"{row['library_call_ms']:.4f}" if library else "not timed")
          + f"; fastest {best}", flush=True)
    res["cases"][name] = row
    torch.cuda.empty_cache()


def tube_bins(shape, **kw):
    """The growers' uint8 bins of bench.py's tube phantom on the card."""
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import _bin_ids, _quantize
    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    vol, _ = tube_phantom(shape, **kw)
    data = torch.from_numpy(vol).cuda()
    del vol
    idx, _ = _quantize(data, 256)
    del data
    return _bin_ids(idx, 256).contiguous()


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older csrc/table_lookup.cu")
    ap.add_argument("--no-speck", action="store_true",
                    help="skip the 880x880x640 and 2^31 + 33 cases")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "k7_breakdown.json"),
                    help="where to write the whole record")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_breakdown: no CUDA device")
    from arterynetwork_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{smi}", flush=True)
    with open(os.path.join(cuda_build.CSRC, "table_lookup.cu")) as f:
        port = f.read()
    sources = {"port": port, **variants(port, VARIANTS),
               "staged_store": STAGED_STORE_SRC}
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    t0 = time.perf_counter()
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (lib, lines, _) in build_all(sources, "k7_probe").items():
        lib.table_lookup.restype = I
        lib.table_lookup.argtypes = [P, I, P, I, I, P, I, LL, I, P]
        libs[name] = (lib, demangle(lines))
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0,
           "ptxas": {k: v[1] for k, v in libs.items()},
           "resident_blocks": {k: resident_blocks(v[1])
                               for k, v in libs.items()},
           "cases": {}}
    for k, v in res["ptxas"].items():
        print(f"ptxas {k}: {'; '.join(v)}", flush=True)
        print(f"resident blocks per SM by registers, {k}: "
              f"{res['resident_blocks'][k]}", flush=True)

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    t32 = torch.randn(256, device="cuda", generator=g)
    t64 = t32.double()
    bins = tube_bins(RG_SHAPE)
    uniform = torch.randint(0, 256, RG_SHAPE, dtype=torch.uint8,
                            device="cuda", generator=g)
    run_case("f32 tube 512", bins, t32, False, libs, res)
    run_case("f64 tube 512", bins, t64, False, libs, res)
    run_case("f32 uniform 512", uniform, t32, False, libs, res)
    run_case("f64 uniform 512", uniform, t64, False, libs, res)
    run_case("f32 int32 tube 512", bins.int(), t32, False, libs, res)
    run_case("sign tube 512", bins, t32, True, libs, res)
    run_case("sign uniform 512", uniform, t32, True, libs, res)
    del bins, uniform
    if not args.no_speck:
        t1 = time.perf_counter()
        bins = tube_bins(SPECK_SHAPE, radius=3)
        print(f"Speck tube bins: {time.perf_counter() - t1:.1f} s",
              flush=True)
        run_case("f32 tube speck", bins, t32, False, libs, res)
        run_case("f64 tube speck", bins, t64, False, libs, res)
        run_case("sign tube speck", bins, t32, True, libs, res)
        del bins
        torch.cuda.empty_cache()
        rb = torch.randint(0, 256, (N31,), dtype=torch.uint8, device="cuda",
                           generator=g)
        run_case("f32 n=2^31+33", rb, t32, False,
                 {k: libs[k] for k in ("port", "baseline") if k in libs},
                 res, library=False)
        del rb
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
