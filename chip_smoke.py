#!/usr/bin/env python3
"""Smoke test of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

  1. device  — the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. builds  — the Frangi-response kernel (nvcc, sm_90a) and the native
               C++ library (g++), both from this checkout's sources;
  3. kernel  — K1 against its plain PyTorch twin on the card, at the main
               path's shapes (a smoothed (68, 512, 170) slab per scale),
               plus a dark and a ragged call; CUDA-event times;
  4. small   — the port's run_pipeline on a small phantom on the CPU (twin)
               and on the card (kernel): the outputs must agree;
  5. pipeline_512 — run_pipeline on the 512x512x170 400-branch phantom
               with bench.py's pipeline_512 configuration: one warm-up
               and three timed runs, 44 kernel launches per run, finite
               pressures and flows, mask recall >= 0.95.

Then one JSON line with the kernel's record and, last, the result line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero before
the result line; so does a machine without a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time

K1_TOL = 1e-5          # kernel vs twin, max |d| on responses in [0, 1]
RECALL_MIN = 0.95


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings,
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bench_config():
    """bench.py::bench_pipeline_512's configuration."""
    from arterynetwork_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq4"
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 6
    cfg.segmentation.min_component_size = 50
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = "float32"
    cfg.flow.linear_solver = "auto"
    return cfg


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return kind


def phase_builds():
    from arterynetwork_tpu_torch.ops import native, vesselness_fused

    secs, out = vesselness_fused.build_kernel()
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
    log("builds", f"frangi_response.cu (nvcc {' '.join(vesselness_fused.NVCC_FLAGS)}): "
        f"{secs:.2f} s; {'; '.join(regs)}")
    t0 = time.perf_counter()
    native._build()
    native.get_lib()
    log("builds", f"native/*.cpp (g++): {time.perf_counter() - t0:.2f} s")


def phase_kernel(raw):
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import (_frobenius_max,
                                                        _smooth)
    from arterynetwork_tpu_torch.ops.vesselness_fused import (
        frangi_response_max_, frangi_response_plain_)

    dev = torch.device("cuda")
    halo, chunk_z = 10, 48        # the pipeline_512 chunk geometry
    slab = torch.from_numpy(np.ascontiguousarray(
        raw[200:200 + chunk_z + 2 * halo])).to(dev)
    max_err, ms, plain_ms = 0.0, [], []

    def compare(sm, g, sigma, bright, z_lo, zr, label):
        ref = torch.zeros((zr,) + tuple(sm.shape[1:]), device=dev)
        out = torch.zeros_like(ref)
        frangi_response_plain_(ref, 0, sm, z_lo, zr, sigma, g,
                               bright=bright)
        frangi_response_max_(out, 0, sm, z_lo, zr, sigma, g, bright=bright)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        t_k = cuda_ms(lambda: frangi_response_max_(
            out, 0, sm, z_lo, zr, sigma, g, bright=bright))
        t_p = cuda_ms(lambda: frangi_response_plain_(
            ref, 0, sm, z_lo, zr, sigma, g, bright=bright))
        log("kernel", f"{label}: max|d| {err:.3e}, kernel {t_k:.4f} ms, "
            f"twin {t_p:.4f} ms, max response {float(ref.max()):.4f}")
        if not err <= K1_TOL:
            raise SystemExit(f"K1 disagrees with its twin: {err} > {K1_TOL}")
        return err, t_k, t_p

    for sigma in (0.75, 1.0, 2.0, 3.0):
        sm = _smooth(slab, sigma)
        g = (_frobenius_max(sm, sigma, halo, chunk_z) * 0.5).reshape(())
        err, t_k, t_p = compare(sm, g, sigma, True, halo, chunk_z,
                                f"sigma {sigma} bright {tuple(sm.shape)}")
        max_err = max(max_err, err)
        ms.append(t_k)
        plain_ms.append(t_p)
    sm = _smooth(slab, 2.0)
    g = (_frobenius_max(sm, 2.0, halo, chunk_z) * 0.5).reshape(())
    err, _, _ = compare(sm, g, 2.0, False, halo, chunk_z,
                        f"sigma 2.0 dark {tuple(sm.shape)}")
    max_err = max(max_err, err)
    rag = _smooth(slab[:40, :509, :167].contiguous(), 1.0)
    g = (_frobenius_max(rag, 1.0, 5, 30) * 0.5).reshape(())
    err, _, _ = compare(rag, g, 1.0, True, 5, 30,
                        f"sigma 1.0 ragged {tuple(rag.shape)}")
    max_err = max(max_err, err)
    return max_err, statistics.mean(ms), statistics.mean(plain_ms)


def phase_small():
    """The port on a small phantom: the CPU run (twin) is the reference
    for the card run (kernel)."""
    import numpy as np

    from arterynetwork_tpu_torch.pipeline import run_pipeline
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    ph = vascular_tree_phantom((48, 64, 64), n_branches=12, root_radius=3.0,
                               branch_length=(12, 25), seed=1)
    raw = phantom_raw_volume(ph)
    cfg = bench_config()
    ref = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    out = run_pipeline(raw_volume=raw, config=cfg, device="cuda")
    union = np.count_nonzero(ref["mask"] | out["mask"])
    diff = np.count_nonzero(ref["mask"] != out["mask"])
    msg = (f"mask voxels {int(out['mask'].sum())} (cpu {int(ref['mask'].sum())}),"
           f" {diff} differ; segments {len(out['segments'])} "
           f"(cpu {len(ref['segments'])})")
    if union == 0 or diff > 1e-3 * union:
        raise SystemExit(f"card and CPU masks disagree: {msg}")
    if diff == 0:
        same = ([list(map(tuple, s)) for s in out["segments"]]
                == [list(map(tuple, s)) for s in ref["segments"]])
        p, pr = out["solution"].pressure.cpu().numpy(), \
            ref["solution"].pressure.numpy()
        rel = float(np.max(np.abs(p - pr)) / np.max(np.abs(pr)))
        msg += f"; segments identical {same}; pressure rel diff {rel:.3e}"
        if not same or not rel <= 1e-5:
            raise SystemExit(f"card and CPU runs disagree: {msg}")
    log("small", msg)


def phase_pipeline(phantom, raw):
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness_fused import \
        frangi_response_max_
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    cfg = bench_config()
    totals, launches = [], []
    for i in range(4):            # run 0 is the warm-up
        frangi_response_max_.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, config=cfg, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        n = frangi_response_max_.launches
        launches.append(n)
        stages = ", ".join(f"{k} {v:.4f}" for k, v in
                           result["timings"].items())
        log("pipeline_512", f"run {i}{' (warm-up)' if i == 0 else ''}: "
            f"total {total:.4f} s; K1 launches {n}; stages (s): {stages}")
        if i:
            totals.append(total)
    sol = result["solution"]
    mask = result["mask"]
    recall = float(mask[phantom["mask"]].astype(bool).mean())
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    log("pipeline_512", f"median total {statistics.median(totals):.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in totals)}); mask voxels "
        f"{int(mask.sum())}; segments {len(result['segments'])}; flow edges "
        f"{result['network'].num_edges}; mask recall {recall:.4f}; "
        f"residual {float(sol.residual_norm):.3e} after {sol.iterations} "
        f"Newton iterations; pressures/flows finite {finite}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if any(n != 44 for n in launches):
        raise SystemExit(f"K1 launches per run {launches}, expected 44")
    if not finite:
        raise SystemExit("non-finite pressures or flows")
    if not recall >= RECALL_MIN:
        raise SystemExit(f"mask recall {recall} < {RECALL_MIN}")
    if sol.pressure.shape[0] != result["network"].num_nodes:
        raise SystemExit("pressure vector does not match the network")
    return launches[-1]


def main():
    import torch

    kind = phase_device()
    phase_builds()

    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    t0 = time.perf_counter()
    phantom = vascular_tree_phantom((512, 512, 170), n_branches=400, seed=0)
    raw = phantom_raw_volume(phantom)
    log("data", f"512x512x170 phantom, {phantom['n_branches']} branches, "
        f"{int(phantom['mask'].sum())} vessel voxels: "
        f"{time.perf_counter() - t0:.1f} s")

    max_err, ms, plain_ms = phase_kernel(raw)
    phase_small()
    launches = phase_pipeline(phantom, raw)

    print(json.dumps({"kernels": [{
        "name": "frangi_response",
        "route": "cuda",
        "source": "arterynetwork_tpu_torch/csrc/frangi_response.cu",
        "replaces": "arterynetwork_tpu/ops/vesselness_fused.py:159",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
