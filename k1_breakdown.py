#!/usr/bin/env python3
"""Where K1's time goes on one CUDA card.

    python3 k1_breakdown.py

K1 (csrc/frangi_response.cu) at the main path's shape: pipeline_512's
chunk, a smoothed (68, 512, 170) slab of the 512x512x170 phantom with
rows [10, 58) responding, at each of the four scales.  Prints:

  * the card, and `nvidia-smi --query-gpu=name,power.limit`;
  * ptxas's registers, spills and stack frame for the port's K1 and for
    the three probe kernels below, and their SASS instruction counts
    (static, from cuobjdump where the toolkit has it);
  * device ms per launch (CUDA events around 100 launches after a
    warm-up; for the port's K1 also chip_smoke.py's torch.profiler
    time) of the port's K1 and of three probe kernels built from this
    file: "first", a copy of the first design (one thread per voxel, 19
    `__ldg` per voxel, no gate); "loads", the same 19 loads and the
    running max of their sum, no arithmetic; "arith", the same arithmetic
    on values made in registers from the voxel's index, no loads of `sm`;
    and two variants of the port's K1 made from its source (PORT_VARIANTS
    below: the survivors' arithmetic replaced by a sum, and no gate);
  * the share of voxels that K1's sign gate skips, per scale, bright and
    dark: qm = (a11 + a22 + a33) * (1/3) in f32 is >= 0 (bright) or <= 0
    (dark);
  * the port's K1 at sigma 1 for each run length (planes per block),
    through an entry that the "port_runs" variant adds to its source;

and one JSON line with all of it, last.  Exits non-zero without a CUDA
device.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kernel_probe import (build_all, events_ms, ptxas_lines,  # noqa: E402
                          variants)

PROBE_SRC = r"""
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// a value in [0, 1) from an index: stands in for a load of sm
__device__ __forceinline__ float hashf(unsigned i) {
  return __uint_as_float(((i * 2654435761u) >> 9) | 0x3f800000u) - 1.0f;
}

// V = 0: the first design; 1: its loads only; 2: its arithmetic only
template <int V>
__global__ void __launch_bounds__(256)
probe_kernel(const float* __restrict__ sm, int Zs, int Y, int X, int z_lo,
             float* __restrict__ best, int best_z0,
             const float* __restrict__ g_ptr, float s2, float q,
             float inv_two_a2, float inv_two_b2, int bright) {
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
  const unsigned h0 = 19u * (unsigned)((z * Y + y) * X + x);
#define LD(ptr, k) (V == 2 ? hashf(h0 + (k)) : __ldg(ptr))
  const float c = LD(s0 + y0 + x, 0);
  const float v1 = LD(sp + y0 + x, 1), v2 = LD(sn + y0 + x, 2);
  const float v3 = LD(s0 + yp + x, 3), v4 = LD(s0 + yn + x, 4);
  const float v5 = LD(s0 + y0 + xp, 5), v6 = LD(s0 + y0 + xn, 6);
  const float v7 = LD(sp + yp + x, 7), v8 = LD(sn + yp + x, 8);
  const float v9 = LD(sp + yn + x, 9), v10 = LD(sn + yn + x, 10);
  const float v11 = LD(sp + y0 + xp, 11), v12 = LD(sp + y0 + xn, 12);
  const float v13 = LD(sn + y0 + xp, 13), v14 = LD(sn + y0 + xn, 14);
  const float v15 = LD(s0 + yp + xp, 15), v16 = LD(s0 + yp + xn, 16);
  const float v17 = LD(s0 + yn + xp, 17), v18 = LD(s0 + yn + xn, 18);
#undef LD
  float* out = best + (long long)(best_z0 + zi) * plane + y0 + x;
  if (V == 1) {
    *out = fmaxf(*out, c + v1 + v2 + v3 + v4 + v5 + v6 + v7 + v8 + v9 +
                           v10 + v11 + v12 + v13 + v14 + v15 + v16 + v17 +
                           v18);
    return;
  }
  const float a11 = ((v1 + v2) - 2.0f * c) * s2;
  const float a22 = ((v3 + v4) - 2.0f * c) * s2;
  const float a33 = ((v5 + v6) - 2.0f * c) * s2;
  const float a12 = ((v7 - v8) - (v9 - v10)) * q;
  const float a13 = ((v11 - v12) - (v13 - v14)) * q;
  const float a23 = ((v15 - v16) - (v17 - v18)) * q;

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
  const float two_pi_3 = (float)2.0943951023931953;
  float e1 = qm + 2.0f * p * cosf(phi);
  float e3 = qm + 2.0f * p * cosf(phi + two_pi_3);
  float e2 = 3.0f * qm - e1 - e3;
  if (p2 < 1e-24f) e1 = e2 = e3 = qm;
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
  *out = fmaxf(*out, v);
}

}  // namespace

extern "C" int probe_launch(int variant, const float* sm, int Zs, int Y,
                            int X, int z_lo, int zr, float* best,
                            int best_z0, const float* g, float s2, float q,
                            float inv_two_a2, float inv_two_b2, int bright,
                            void* stream) {
  const dim3 block(32, 8), grid((X + 31) / 32, (Y + 7) / 8, zr);
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    probe_kernel<0><<<grid, block, 0, st>>>(sm, Zs, Y, X, z_lo, best,
        best_z0, g, s2, q, inv_two_a2, inv_two_b2, bright);
  else if (variant == 1)
    probe_kernel<1><<<grid, block, 0, st>>>(sm, Zs, Y, X, z_lo, best,
        best_z0, g, s2, q, inv_two_a2, inv_two_b2, bright);
  else
    probe_kernel<2><<<grid, block, 0, st>>>(sm, Zs, Y, X, z_lo, best,
        best_z0, g, s2, q, inv_two_a2, inv_two_b2, bright);
  return (int)cudaGetLastError();
}
"""

VARIANTS = ("first", "loads", "arith")


def sass_counts(so):
    """Static SASS instruction count per kernel of a library, or {}."""
    from arterynetwork_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=120).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            counts[name] += 1
    return counts


# Variants of the port's K1 for the same measurement, each made from its
# source by one substitution: "no_arith" drains the survivors through a
# sum of their terms instead of the eigen-solve and the response (its
# output is wrong; it times staging, the terms, the gate and the list),
# "no_gate" drains every voxel (its output is right: the gated voxels'
# response is 0), and "runs" adds an entry that takes the run length.  A
# variant whose text is not in the source is skipped.
PROBE_SUM = ("__device__ __forceinline__ float probe_sum(float a, float b, "
             "float c, float d, float e, float f, float, float, float, int) "
             "{ return ((a + b) + (c + d)) + (e + f); }\n")
RUNS_ENTRY = """
extern "C" int frangi_response_max_runs(
    const float* sm, int Zs, int Y, int X, int z_lo, int zr, int zc,
    float* best, int best_z0, const float* g, float s2, float q, float a2,
    float b2, int bright, void* stream) {
  const cudaError_t e = set_carveout();
  if (e != cudaSuccess) return (int)e;
  return launch(sm, Zs, Y, X, z_lo, zr, zc, best, best_z0, g, s2, q, a2,
                b2, bright, stream);
}
"""
PORT_VARIANTS = {
    "port_no_arith": ("namespace {\n", "namespace {\n" + PROBE_SUM,
                      "= response(", "= probe_sum("),
    "port_no_gate": ("pass = bright ? !(qm >= 0.0f) : !(qm <= 0.0f);",
                     "pass = true;"),
    "port_runs": ("int launch(", "int launch(", "set_carveout()",
                  "set_carveout()"),
}


def build():
    """(probe library, its ptxas lines, its .so path, {name: library} of
    the PORT_VARIANTS that apply to the port's source), every nvcc
    started together."""
    import ctypes

    from arterynetwork_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC, "frangi_response.cu")) as f:
        sources = variants(f.read(), PORT_VARIANTS)
    if "port_runs" in sources:
        sources["port_runs"] += RUNS_ENTRY
    libs = build_all({"k1_probe": PROBE_SRC, **sources}, "probe")
    if "k1_probe" not in libs:
        raise SystemExit("k1_breakdown: the probe did not build")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib, log, so = libs.pop("k1_probe")
    lib.probe_launch.restype = I
    lib.probe_launch.argtypes = [I, P, I, I, I, I, I, P, I, P, F, F, F, F, I,
                                 P]
    out = {}
    for name, (vlib, vlog, _) in libs.items():
        print(f"ptxas {name}: {'; '.join(vlog)}", flush=True)
        for fn, extra in (("frangi_response_max", []),
                          ("frangi_response_max_runs", [I])):
            if hasattr(vlib, fn):
                getattr(vlib, fn).restype = I
                getattr(vlib, fn).argtypes = [P, I, I, I, I, I, *extra, P, I,
                                              P, F, F, F, F, I, P]
        out[name] = vlib
    return lib, log, so, out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown: no CUDA device")
    from chip_smoke import device_ms
    from arterynetwork_tpu_torch.ops import cuda_build
    from arterynetwork_tpu_torch.ops.vesselness import (
        _frobenius_max, _hessian_from_smoothed, _smooth)
    from arterynetwork_tpu_torch.ops.vesselness_fused import \
        frangi_response_max_
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{smi}", flush=True)
    k1_log = cuda_build.build(("frangi_response",))["frangi_response"][1]
    lib, probe_log, probe_so, port_variants = build()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "ptxas": {"port_k1": ptxas_lines(k1_log), "probe": probe_log},
           "sass_instructions": {
               **sass_counts(os.path.join(cuda_build.BUILD_DIR,
                                          "frangi_response.so")),
               **sass_counts(probe_so)}}
    for k, v in res["ptxas"].items():
        print(f"ptxas {k}: {'; '.join(v)}", flush=True)
    print(f"SASS instructions (static): {res['sass_instructions']}",
          flush=True)

    phantom = vascular_tree_phantom((512, 512, 170), n_branches=400, seed=0)
    raw = phantom_raw_volume(phantom)
    dev = torch.device("cuda")
    halo, chunk = 10, 48
    slab = torch.from_numpy(np.ascontiguousarray(
        raw[200:200 + chunk + 2 * halo])).to(dev)
    third = torch.tensor(np.float32(1.0 / 3.0), device=dev)
    res["ms"], res["gated_share"] = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for sigma in (0.75, 1.0, 2.0, 3.0):
        sm = _smooth(slab, sigma)
        g = (_frobenius_max(sm, sigma, halo, chunk) * 0.5).reshape(())
        best = torch.zeros((chunk,) + tuple(sm.shape[1:]), device=dev)
        s2 = np.float32(sigma * sigma)
        args = (sm.data_ptr(), *sm.shape, halo, chunk, best.data_ptr(), 0,
                g.data_ptr(), float(s2), float(np.float32(0.25) * s2), 2.0,
                2.0, 1, stream)
        def port():
            frangi_response_max_(best, 0, sm, halo, chunk, sigma, g)

        row = {"port_k1": events_ms(port, n=100, warmup=10),
               "port_k1_profiler": device_ms(port, own=True)[0]}
        for i, name in enumerate(VARIANTS):
            def launch(i=i):
                cuda_build.check(lib.probe_launch(i, *args), "probe")
            row[name] = events_ms(launch, n=100, warmup=10)
        for name, vlib in port_variants.items():
            if name == "port_runs":
                continue
            def launch(fn=vlib.frangi_response_max):
                cuda_build.check(fn(*args), name)
            row[name] = events_ms(launch, n=100, warmup=10)
        res["ms"][sigma] = row
        hs = _hessian_from_smoothed(sm[halo - 1:halo + chunk + 1], sigma)
        qm = (((hs[0] + hs[1]) + hs[2]) * third)[1:-1]
        res["gated_share"][sigma] = {"bright": float((qm >= 0).float().mean()),
                                     "dark": float((qm <= 0).float().mean())}
        print(f"sigma {sigma}: device ms per launch "
              + ", ".join(f"{k} {v}" for k, v in row.items())
              + f"; gated share {res['gated_share'][sigma]}", flush=True)
    # the port's K1 at sigma 1 with each run length
    if "port_runs" in port_variants:
        runs = port_variants["port_runs"].frangi_response_max_runs
        sm = _smooth(slab, 1.0)
        g = (_frobenius_max(sm, 1.0, halo, chunk) * 0.5).reshape(())
        best = torch.zeros((chunk,) + tuple(sm.shape[1:]), device=dev)
        res["ms_by_run_length"] = {}
        for zc in (2, 4, 6, 8, 12, 16, 24, 48):
            def launch(zc=zc):
                cuda_build.check(runs(
                    sm.data_ptr(), *sm.shape, halo, chunk, zc,
                    best.data_ptr(), 0, g.data_ptr(), 1.0, 0.25, 2.0, 2.0, 1,
                    stream), "frangi_response_max_runs")
            res["ms_by_run_length"][zc] = events_ms(launch, n=100,
                                                    warmup=10)
        print(f"port K1 at sigma 1 by run length (planes: ms): "
              f"{res['ms_by_run_length']}", flush=True)
    torch.cuda.synchronize()
    res["ms_mean"] = {k: float(np.mean([r[k] for r in res["ms"].values()]))
                      for k in ("port_k1", "port_k1_profiler") + VARIANTS
                      + tuple(v for v in port_variants if v != "port_runs")
                      if None not in [r[k] for r in res["ms"].values()]}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
