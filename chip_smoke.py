#!/usr/bin/env python3
"""Smoke test of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

  1. device  — the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. builds  — the five CUDA sources (nvcc, sm_90a, all started together:
               K1, K6, K2, K5, K7) and the native C++ library (g++), from
               this checkout's sources, with ptxas's register and spill
               lines;
  3. kernel  — K1 against its plain PyTorch twin on the card, at the main
               path's shapes (a smoothed (68, 512, 170) slab per scale),
               plus a dark and a ragged call; device and call times; then
               the hard cases within 1e-6: X in {1, 2, 33, 167, 170,
               513} x Y in {1, 3, 17}, one-plane volumes, best_z0 > 0,
               bowls the sign gate skips wholly or not at all; then
               frangi_response_fused (the functional form) on the slab,
               all rows and rows [10, 58), within 1e-5 of the twin, one
               K1 launch per call;
  4. small   — the port's run_pipeline on a small phantom on the CPU (twin)
               and on the card (kernel): the outputs must agree;
  5. pipeline_512 — run_pipeline on the 512x512x170 400-branch phantom
               with bench.py's pipeline_512 configuration: one warm-up
               and three timed runs, 44 kernel launches per run, finite
               pressures and flows, mask recall >= 0.95;
  6. sweep_cases — K2 (through fused_sweep_counts and the padded entries
               fused_sweep, fused_sweep_banded, fused_sweep_banded_dma;
               with interior windows of one plane, one row, one voxel,
               touching one face, x cuts, and each halo-padded block of
               a 2x2 mesh at 512x512x170) and K5 against their plain
               versions on hard inputs:
               Bernoulli(0.5) states with random decision words, all-
               and none-segmented volumes, ragged shapes, padded calls,
               a view not on a 16-byte boundary; K5 with ragged last
               tiles, nact < k_pad, nact = 0, nb 1 and 3.  Exact;
     f64_grow — region_grow "auto" on an f64 tube on the card takes the
               f64 full-grid path (no K2) and equals the CPU's; the
               voxels where the f32 fused grower differs are counted;
  7. region_grow_kernels — K6b, K6a, K2 (and the banded entries K3/K4
               run on it), K5 and K7 (values and sign modes) against their
               plain PyTorch versions on the card, at the region-grow
               path's shapes (bench.py's 512x512x170 tube phantom and its
               state after 20 iterations): equal outputs; device and call
               times of kernel, plain version and, where one PyTorch call
               computes the same function, that call; each kernel's bound;
               K5's fixed cost (no tile active);
  8. region_grow_512 — bench.py's bench_region_grow workload through
               region_grow "auto" (K2 + K6b), "xla" (K6b + K7) and
               region_grow_frontier (K5 + K6b), each also with the plain
               versions on the card: one (iterations, count) and one mask
               for all; then "xla" with an excluded slab (K6a + K7);
               one traced run each of "auto" and "frontier" for the
               device's idle share;
  9. value_map_512 — the reference's interface, region_grow_value_map,
               on the tube with the excluded slab as state 4: one warm-up
               and three timed runs (K6a + K7 per iteration, the value map
               rebuilt on the card), equal to the "xla" excluded grower;
 10. seeded_pipeline_512 — run_pipeline(raw_volume, seed_mask) on the
               pipeline_512 phantom, seeded with the 3x3x3 cube at the
               tree's root: one warm-up and three timed runs, finite
               pressures and flows, at least one segment.
     voxel_options_512 — pipeline_512 with a brain ellipsoid (semi-axes
               250, 250, 82), the tip extension (0.015, 3 steps, <= 4
               neighbours) and skeleton.backend "jax" (the device
               thinning): one warm-up and three timed runs (44 K1
               launches each), per-stage medians, centerline recall and
               precision of this run and of the native thinning on the
               same mask, peak device memory; then (a) the card's mask
               equals the CPU's, (b) the banded EDT equals the native
               exact EDT within its band and is clamped beyond, the exact
               EDT equals it on a 128x128x170 crop, (c) the LUT thinning
               equals the label-propagation thinning on the card (a ~2M
               voxel crop), (d) the full-size skeleton lies in the mask,
               has no deletable voxel left and as many 26-components, (e)
               the simple-point table built on the card equals the native
               predicate (2^20 sampled codes, and the native table on all
               2^26), (f) connected_components gives the native partition,
               (g) frangi_vesselness_chunked launches K1 once per slab and
               scale, within K1's bound of its twin and, on interior rows,
               of frangi_vesselness.
     graph_path_512 — pipeline_512 with flow.graph_path "nx" (the voxel
               graph, its BFS and reduction on the host): one warm-up and
               three timed runs (44 K1 launches each) with per-stage
               times and the f32 difference from the soa route, then one
               run with an artifact store, each write timed; gates (a)
               nx = soa at f64 on the card on the segments the nx
               reduction keeps (it collapses parallel arcs, as the
               reference's reduceGraph does; the others must be such
               arcs): nodes, edges by coordinates, radius and length,
               pressures within 1e-9, (b) every file
               of the JAX store's route written and read back equal to
               the run, (c) the CLI's `morpho --no-figures` on the store,
               (d) networkx, jax and matplotlib never imported, (e) K1 x
               44 per run.
     sharded_512 — parallel/pipeline_sharded.mini_pipeline_sharded on
               the pipeline_512 raw volume over a 2x2 mesh of cuda:0
               slots, at its defaults (sigmas 1, 2; 60 grow iterations;
               16 waves; T = 8): one warm-up and three timed runs with
               per-stage times; gates (a) the vesselness bit-equal to
               frangi_vesselness of the whole volume, (b) mask and
               skeleton equal to the single-device composition, (c) a
               segment, (d) the dp pressure rows equal to the
               unsharded batch's and two unsharded runs bit-equal (no
               global switch), (e) K2 4 times per sweep (its interior
               window) and K6b 8 times, (f) K6b on each padded block
               (int32, own-box and seed masks) equal to its plain
               version; halo bytes per iteration, a traced grow's idle
               share, peak device memory.
     dryrun_multichip — flagship.dryrun_multichip(4) and (8) on the card.
 11. flow_determinism — each solve run twice on the card gives the
               same bits: pipeline_512's f32 solve, the 16k tree's f32
               tree and CG solves, GBMTest5's T = 8 f64 batch (the flow
               sums run in a fixed order, flow/segment_sum.py);
     flow_solvers — bench.py::bench_flow_large's 16k-edge tree (depth
               13, 8,190 unknowns) solved f32 at tol 1e-9 with "auto" and
               the elimination plan (tree) and with "cg", f64 "cg" at the
               default tol 1e-14, and the flagship entry (depth 9, f32
               CG): ms per solve (median of 3 after a warm-up), Newton
               iterations, CG steps per linear solve, host reads per
               solve, max relative pressure error against the ground
               truth (<= 1e-6 f32, <= 1e-9 f64);
 12. longitudinal — GBMTest5 on the depth-13 tree, T = 8, f64, "auto"
               with the plan: the batched solve against T unbatched
               solves (same iterations, pressures within 1e-12), every
               residual < 1e-10 m^3/s, row 0 on the ground truth;
 13. studies — the study CLI's eight drivers at depth 10 (and gbm5 on
               the Darcy-Weisbach network): seconds per driver, finite
               outputs, the solver drivers equal to the port on the CPU
               within 1e-9, pickles written and read back.
 14. figures — the CLI's study gbm5 and gbm5b (depth 10, T = 4) and
               morpho with its 13 figures on graph_path_512's bundle, on
               the card: seconds and figure files with their sizes (each
               > 1000 bytes, none FAILED); pressure_velocity_arrays and
               _volumes of pipeline_512's solution.  Without matplotlib
               one line says how many figure calls did not run.
 Phases 11-14 launch none of the repository's kernels (checked).

A kernel's "ms" is its own kernels' device time per call from a
torch.profiler trace (the plain version's and the library call's: all
their device events), "call_ms" the CUDA-event time of one call, host
wrapper included; "bound_ms" the larger of the bytes this run's data
needs over 3.35 TB/s and the f32 operations over 67 TFLOP/s.  Each path
is driven with every launch count set to 0 just before it and read just
after.  Then the launches of each kernel on each path, one JSON
line with the kernels' records (times, bounds, library-call times) and,
last, the result line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero before
the result line; so does a machine without a CUDA device.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

K1_TOL = 1e-5          # kernel vs twin, max |d| on responses in [0, 1]
K1_EXACT = 1e-6        # the same on the hard cases (bit-identical: 0)
RECALL_MIN = 0.95
RG_SHAPE = (512, 512, 170)      # bench.py::bench_region_grow
RG_KW = {"max_segment_size": 10 ** 6, "iter_max": 300}
SLAB = 16                       # excluded rows (reference state 4)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores, same sheet
# K1's operations per output voxel, counted from csrc/frangi_response.cu
# (each division, square root and transcendental counted as one)
K1_OPS_PER_VOXEL = 125


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


def device_ms(fn, own=False, reps=10):
    """(device milliseconds per call of ``fn``, or None when the trace
    holds no device event; the events by name).  torch.profiler traces
    ``reps`` calls after two warm-up steps, each call synchronised; the
    trace may drop a few events, so each name counts its mean duration
    times its events per call, ceil(count / reps); the profiler's own
    buffer and step annotations do not count.  ``own`` keeps only this
    repository's kernels (csrc/*.cu, in an anonymous namespace), not the
    wrapper's fills and casts."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=reps),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA \
                and e.name != "Activity Buffer Request" \
                and not e.name.startswith("ProfilerStep") \
                and (not own or ("anonymous namespace)::" in e.name
                                 and "at::" not in e.name)):
            by_name.setdefault(e.name, []).append(e.device_time_total)
    us = sum(statistics.mean(d) * math.ceil(len(d) / reps)
             for d in by_name.values())
    return (us / 1e3 if us > 0 else None), [
        f"{len(d)} x {k[:50]}" for k, d in sorted(by_name.items())]


def _ms(t):
    return "not measured" if t is None else f"{t:.4f}"


def measure(fn, own=False):
    """(device ms or None, CUDA-event ms per call, device events by
    name)."""
    dev, names = device_ms(fn, own)
    return dev, cuda_ms(fn), names


def bound(nbytes, ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` through HBM and do ``ops`` f32 operations."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def timing(k, p, nbytes, ops=0, lib=None):
    """A kernel's record from ``measure`` results of the kernel, its plain
    version and the library call (or None): device ms (CUDA-event ms per
    call where the trace has no device time), the event ms per call, and
    the kernel's bound."""
    b_ms, by = bound(nbytes, ops)

    def ms(m):
        return None if m is None else (m[0] if m[0] is not None else m[1])

    return {"ms": ms(k), "call_ms": k[1], "plain_ms": ms(p),
            "plain_call_ms": p[1], "library_ms": ms(lib),
            "library_call_ms": lib and lib[1],
            "timed_by": "device" if k[0] is not None else "cuda events",
            "bound_ms": b_ms, "bound_us": 1e3 * b_ms, "bound_by": by}


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
    from arterynetwork_tpu_torch.ops import cuda_build, native

    log("builds", f"nvcc {' '.join(cuda_build.NVCC_FLAGS)}")
    for name, (secs, out) in cuda_build.build().items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln]
        log("builds", f"{name}.cu: done at {secs:.2f} s; {'; '.join(regs)}")
    t0 = time.perf_counter()
    native._build()
    native.get_lib()
    log("builds", f"native/*.cpp (g++): {time.perf_counter() - t0:.2f} s")


def k1_hard_cases(dev):
    """K1 against its twin on the shapes and inputs the path does not
    reach, as tests/test_torch_kernels.py's ``gpu`` tests: X in {1, 2, 33,
    167, 170, 513} x Y in {1, 3, 17}, one-plane volumes (zr = Zs = 1),
    best_z0 > 0, one row at the last plane, and paraboloid bowls that the
    sign gate skips wholly (+bowl bright, -bowl dark) or not at all.
    Exits if a call differs by more than K1_EXACT or touches rows of best
    outside its own; returns the largest max|d|."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import _smooth
    from arterynetwork_tpu_torch.ops.vesselness_fused import (
        frangi_response_max_, frangi_response_plain_)

    def noise(shape, sigma):
        rng = np.random.default_rng(0)
        vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
        zc, yc = shape[0] // 2, shape[1] // 2
        vol[zc - 1:zc + 2, yc - 1:yc + 2, 2:shape[2] - 2] += 1.0
        vol[2:shape[0] - 2, 1:4, shape[2] // 2:shape[2] // 2 + 3] += 0.7
        sm = _smooth(torch.from_numpy(vol).to(dev), sigma)
        return sm, (sm.abs().max() * 0.5).reshape(())

    def bowl(shape, sign):
        z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64)
                                for n in shape), indexing="ij")
        vol = ((z - shape[0] / 2) ** 2 + (y - shape[1] / 2) ** 2 / shape[1]
               + 0.5 * (x - shape[2] / 2) ** 2 / shape[2])
        return torch.from_numpy((sign * vol).astype(np.float32)).to(dev)

    shapes = [((36, 64, 96), 10, 16, 4), ((21, 37, 53), 0, 21, 0),
              ((30, 19, 170), 5, 20, 3), ((1, 17, 33), 0, 1, 0),
              ((1, 3, 170), 0, 1, 2), ((9, 17, 513), 8, 1, 5)]
    shapes += [((6, y, x), 1, 4, 2) for y in (1, 3, 17)
               for x in (1, 2, 33, 167, 170, 513)]
    calls = []
    for shape, z_lo, zr, b0 in shapes:
        for sigma in (0.75, 2.0):
            sm, g = noise(shape, sigma)
            for bright in (True, False):
                calls.append((f"{shape} rows {z_lo}+{zr} best_z0 {b0} sigma "
                              f"{sigma} bright {bright}", sm, z_lo, zr, b0,
                              sigma, g, bright))
    one = torch.ones((), device=dev)
    for sign in (1, -1):
        sm = bowl((20, 37, 170), sign)
        for bright in (True, False):
            calls.append((f"bowl {sign:+d} bright {bright}", sm, 1, 18, 3,
                          1.0, one, bright))
    worst, rng = 0.0, np.random.default_rng(1)
    for label, sm, z_lo, zr, b0, sigma, g, bright in calls:
        init = torch.from_numpy(rng.uniform(0, 0.05, (zr + b0 + 2,) + tuple(
            sm.shape[1:])).astype(np.float32)).to(dev)
        ref, out = init.clone(), init.clone()
        frangi_response_plain_(ref, b0, sm, z_lo, zr, sigma, g, bright=bright)
        frangi_response_max_(out, b0, sm, z_lo, zr, sigma, g, bright=bright)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        alone = (torch.equal(out[:b0], init[:b0])
                 and torch.equal(out[b0 + zr:], init[b0 + zr:]))
        worst = max(worst, err)
        if not (err <= K1_EXACT and alone):
            raise SystemExit(f"K1 disagrees with its twin on {label}: "
                             f"max|d| {err} (limit {K1_EXACT}); rows "
                             f"outside the call untouched {alone}")
    log("kernel", f"hard cases: {len(calls)} calls, max|d| {worst:.3e} "
        f"(limit {K1_EXACT}); rows outside each call untouched")
    return worst


def phase_kernel(raw):
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import (_frobenius_max,
                                                        _smooth)
    from arterynetwork_tpu_torch.ops.vesselness_fused import (
        frangi_response_fused, frangi_response_max_, frangi_response_plain_)

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
        m_k = measure(lambda: frangi_response_max_(
            out, 0, sm, z_lo, zr, sigma, g, bright=bright), own=True)
        m_p = measure(lambda: frangi_response_plain_(
            ref, 0, sm, z_lo, zr, sigma, g, bright=bright))
        log("kernel", f"{label}: max|d| {err:.3e}, kernel {_ms(m_k[0])} ms"
            f" on the device ({m_k[1]:.4f} ms per call), twin "
            f"{_ms(m_p[0])} ms ({m_p[1]:.4f} ms per call); max response "
            f"{float(ref.max()):.4f}")
        if not err <= K1_TOL:
            raise SystemExit(f"K1 disagrees with its twin: {err} > {K1_TOL}")
        return err, m_k, m_p

    for sigma in (0.75, 1.0, 2.0, 3.0):
        sm = _smooth(slab, sigma)
        g = (_frobenius_max(sm, sigma, halo, chunk_z) * 0.5).reshape(())
        err, m_k, m_p = compare(sm, g, sigma, True, halo, chunk_z,
                                f"sigma {sigma} bright {tuple(sm.shape)}")
        max_err = max(max_err, err)
        ms.append(m_k)
        plain_ms.append(m_p)
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
    max_err = max(max_err, k1_hard_cases(dev))
    # the functional form, frangi_response_fused (the JAX package's entry):
    # all rows of the slab and a window inside it, against the twin
    fused = []
    sm = _smooth(slab, 1.0)
    g = (_frobenius_max(sm, 1.0, halo, chunk_z) * 0.5).reshape(())
    frangi_response_max_.launches = 0
    for z_lo, z_hi in ((0, None), (halo, halo + chunk_z)):
        out = frangi_response_fused(sm, 1.0, g, z_lo=z_lo, z_hi=z_hi)
        fused.append((z_lo, z_hi, out))
    fused_launches = frangi_response_max_.launches
    for z_lo, z_hi, out in fused:
        zr = (z_hi or sm.shape[0]) - z_lo
        ref = torch.full_like(out, -float("inf"))
        frangi_response_plain_(ref, 0, sm, z_lo, zr, 1.0, g)
        err = float((out - ref).abs().max())
        log("kernel", f"frangi_response_fused rows [{z_lo}, "
            f"{z_lo + zr}) of {tuple(sm.shape)}: max|d| {err:.3e} from "
            f"the twin")
        if not (err <= K1_TOL and out.shape == (zr,) + tuple(sm.shape[1:])):
            raise SystemExit(f"frangi_response_fused disagrees with the "
                             f"twin: {err} > {K1_TOL}")
        max_err = max(max_err, err)
    if fused_launches != 2:
        raise SystemExit(f"frangi_response_fused: {fused_launches} K1 "
                         f"launches for 2 calls")
    # per launch at the main path's shape: the rows of sm it reads (one
    # beyond each end of the chunk), best read and written
    zs, plane = slab.shape[0], slab.shape[1] * slab.shape[2]
    rows = min(halo + chunk_z + 1, zs) - max(halo - 1, 0)
    def mean(ts):                  # over the four scales
        return tuple(None if None in c else statistics.mean(c)
                     for c in list(zip(*ts))[:2])

    rec = timing(mean(ms), mean(plain_ms), 4 * plane * (rows + 2 * chunk_z),
                 K1_OPS_PER_VOXEL * plane * chunk_z)
    log("kernel", f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}): "
        f"{rec['bound_ms'] / rec['ms']:.1%} of it")
    return {"max_abs_err": max_err, **rec}, fused_launches


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
    return launches[-1], result


def _ops(name):
    return importlib.import_module(f"arterynetwork_tpu_torch.ops.{name}")


def counted():
    """Every kernel wrapper, by kernel name; each holds its launch count."""
    return {
        "frangi_response": _ops("vesselness_fused").frangi_response_max_,
        "masked_histogram1": _ops("histogram_kernels").masked_histogram1,
        "masked_histograms2": _ops("histogram_kernels").masked_histograms2,
        "region_grow_sweep": _ops("region_grow_fused").fused_sweep_counts,
        "region_grow_frontier": _ops("region_grow_frontier").frontier_step,
        "table_lookup": _ops("lookup_kernels").table_lookup,
        "sign_lookup": _ops("lookup_kernels").sign_lookup,
    }


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counted().items()}


@contextlib.contextmanager
def plain_kernels():
    """Route the region growers to the kernels' plain versions for CUDA
    tensors too (the wrappers launch the kernels for every CUDA tensor),
    by swapping the names the growers call."""
    hist, hk = _ops("histogram"), _ops("histogram_kernels")
    fused, front = _ops("region_grow_fused"), _ops("region_grow_frontier")
    rg, lk = _ops("region_grow"), _ops("lookup_kernels")

    def plain1(bins, mask, num_bins=256):
        return hk.masked_histograms_plain(bins, mask.reshape(1, -1),
                                          num_bins)[0]

    swaps = [(hist, "masked_histogram1", plain1),
             (hist, "masked_histograms2", hk.masked_histograms_plain),
             (fused, "fused_sweep_counts", fused.fused_sweep_plain),
             (front, "frontier_step", front.frontier_step_plain),
             (rg, "sign_lookup", lk.sign_lookup_plain)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    try:
        for m, a, f in swaps:
            setattr(m, a, f)
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def _max_err(outs, refs):
    return max(float((a.double() - b.double()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(outs, refs))


def _frontier_bytes(ids, nact, shape, tile, n_bnd):
    """K5's traffic for these active tiles: each tile's seg halo box
    (clipped to the volume) read and its seg written, and the bins of the
    ``n_bnd`` boundary voxels (all in active tiles) read."""
    Z, Y, X = shape
    tz, ty = tile
    nty = -(-Y // ty)
    total = n_bnd
    for t in ids[:nact]:
        z0, y0 = (t // nty) * tz, (t % nty) * ty
        box = ((min(z0 + tz + 1, Z) - max(z0 - 1, 0))
               * (min(y0 + ty + 1, Y) - max(y0 - 1, 0)))
        total += X * (box + (min(z0 + tz, Z) - z0) * (min(y0 + ty, Y) - y0))
    return total


def phase_sweep_cases():
    """K2 (through all its entries) and K5 against their plain versions
    on the card, exactly, on inputs the path's state does not reach:
    Bernoulli(0.5) states with random decision words (almost every voxel
    on the boundary, many flips, every bin), all-segmented and
    all-unsegmented volumes, ragged shapes, padded ``valid_yx`` calls,
    and for K5 ragged last tiles, nact < k_pad, nact = 0 and nb 1 and
    3."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    fused, front = _ops("region_grow_fused"), _ops("region_grow_frontier")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)

    def state(shape, kind="half", n_words=8):
        bins = rng.integers(0, 32 * n_words, shape).astype(np.uint8)
        seg = {"half": lambda: rng.random(shape) < 0.5,
               "all": lambda: np.ones(shape, bool),
               "none": lambda: np.zeros(shape, bool)}[kind]()
        words = rng.integers(-2 ** 31, 2 ** 31, n_words).astype(np.int32)
        return (torch.from_numpy(seg.astype(np.uint8)).to(dev),
                torch.from_numpy(bins).to(dev), torch.from_numpy(words).to(dev))

    def same(label, out, ref):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise SystemExit(f"sweep_cases: {label} differs from the plain "
                             f"version (max|d| {_max_err(out, ref)})")

    flips, n = 0, 0
    sweeps = [(RG_SHAPE, k) for k in ("half", "all", "none")]
    sweeps += [((z, y, x), "half") for z in (1, 2, 17) for y in (1, 3, 17)
               for x in (1, 31, 33, 170, 513)]
    sweeps += [((17, 17, x), k) for x in (33, 513) for k in ("all", "none")]
    for shape, kind in sweeps:
        seg, bins, words = state(shape, kind)
        ref = fused.fused_sweep_plain(seg, bins, words)
        same(f"K2 {kind} {shape}", fused.fused_sweep_counts(seg, bins, words),
             ref)
        flips += int(ref[1].sum())
        n += 1
    # padded (Z, Yp, Xp) volumes with band 16 through the three entries
    for (z, y0, x0), (yp, xp) in (((17, 100, 170), (112, 256)),
                                  ((5, 17, 33), (32, 128)),
                                  ((3, 20, 1), (48, 128))):
        seg, bins, words = state((z, y0, x0))
        pad = (0, xp - x0, 0, yp - y0)
        seg_p, bins_p = F.pad(seg, pad), F.pad(bins, pad)
        s, dh = fused.fused_sweep_plain(seg_p, bins_p, words, (y0, x0))
        ref = (s, *fused._hist16(dh))
        for entry, kw in (("fused_sweep", {}),
                          ("fused_sweep_banded", {"band": 16}),
                          ("fused_sweep_banded_dma", {"band": 16})):
            same(f"{entry} {(z, yp, xp)} valid {(y0, x0)}",
                 getattr(fused, entry)(seg_p, bins_p, words, (y0, x0), **kw),
                 ref)
            n += 1
    # a view whose data does not start on a 16-byte boundary
    seg, bins, words = state((18, 17, 170))
    view = (seg[1:], bins[1:], words)
    same("K2 on an unaligned view", fused.fused_sweep_counts(*view),
         fused.fused_sweep_plain(*view))
    n += 1
    log("sweep_cases", f"K2: {n} calls equal to the plain version "
        f"({len(sweeps)} shapes, 9 padded entry calls, one unaligned view; "
        f"{flips} flips in the unpadded calls)")
    log("sweep_cases", f"K2 with an interior window: "
        f"{_window_cases(fused, state, same)} calls equal to the plain "
        f"version")

    tile, m, flips = (8, 16), 0, 0
    for shape, kind, n_words in (((20, 45, 170), "half", 8),
                                 ((17, 37, 513), "half", 8),
                                 ((9, 17, 33), "half", 2),
                                 ((12, 33, 31), "all", 8),
                                 ((12, 33, 31), "none", 8),
                                 ((64, 128, 170), "half", 8)):
        seg, bins, words = state(shape, kind, n_words)
        ntz, nty = front._tile_grid(shape, tile)
        nt = ntz * nty
        for k_pad, nact in ((nt, nt), (nt + 5, nt - 1), (max(nt // 2, 1), 1),
                            (nt, 0)):
            ids = torch.zeros(k_pad, dtype=torch.int32)
            perm = rng.permutation(nt)[:k_pad]
            ids[:len(perm)] = torch.from_numpy(perm.astype(np.int32))
            ids = ids.to(dev)
            na = torch.tensor([nact], dtype=torch.int32, device=dev)
            for nb in (1, 3):
                a, b = seg.clone(), seg.clone()
                ref = front.frontier_step_plain(a, bins, ids, na, words,
                                                tile, nb)
                out = front.frontier_step(b, bins, ids, na, words, tile, nb)
                same(f"K5 {kind} {shape} k_pad {k_pad} nact {nact} nb {nb}",
                     (b, *out), (a, *ref))
                flips += int(ref[1][:, 0].sum())
                m += 1
    log("sweep_cases", f"K5: {m} calls equal to the plain version (seg, "
        f"dhist and flags; {flips} flips)")


def _in_window(out, window):
    """A windowed sweep's result where it is specified: seg's window
    voxels, and dh."""
    return out[0][tuple(slice(lo, hi) for lo, hi in window)], out[1]


def _window_cases(fused, state, same):
    """K2 with an interior window (the sharded grower's call) against its
    plain version: windows of one plane, one row and one voxel, windows
    touching one face of the block only, an x cut, a padded region, an
    unaligned view, and each halo-padded block of a 2x2 mesh at the
    path's shape, whose interiors reassemble the whole volume's sweep and
    whose deltas sum to its."""
    import torch
    import torch.nn.functional as F

    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       pad_halos,
                                                       shard_volume)

    n = 0
    full = ((0, 17), (0, 17), (0, 170))
    for shape, window in (((17, 17, 170), ((8, 9), (0, 17), (0, 170))),
                          ((17, 17, 170), ((0, 17), (5, 6), (0, 170))),
                          ((17, 17, 170), ((16, 17), (16, 17), (169, 170))),
                          ((17, 17, 170), ((1, 17), (1, 17), (0, 170))),
                          ((17, 17, 170), ((0, 16), (0, 16), (0, 170))),
                          ((17, 17, 170), full),
                          ((17, 33, 513), ((2, 15), (3, 30), (5, 500))),
                          ((40, 100, 170), ((1, 39), (1, 99), (0, 170))),
                          ((3, 3, 33), ((1, 2), (1, 2), (1, 32)))):
        for kind in ("half", "all", "none"):
            seg, bins, words = state(shape, kind)
            same(f"K2 window {window} {kind} {shape}", _in_window(
                fused.fused_sweep_counts(seg, bins, words, window=window),
                window), _in_window(fused.fused_sweep_plain(
                    seg, bins, words, window=window), window))
            n += 1
    seg, bins, words = state((5, 17, 33))
    pad = (0, 95, 0, 15)
    args = (F.pad(seg, pad), F.pad(bins, pad), words, (17, 33))
    win = ((1, 4), (2, 16), (3, 30))
    same("K2 window on a padded region",
         _in_window(fused.fused_sweep_counts(*args, window=win), win),
         _in_window(fused.fused_sweep_plain(*args, window=win), win))
    seg, bins, words = state((18, 17, 170))
    view = (seg[1:], bins[1:], words)
    win = ((1, 16), (1, 16), (0, 170))
    same("K2 window on an unaligned view",
         _in_window(fused.fused_sweep_counts(*view, window=win), win),
         _in_window(fused.fused_sweep_plain(*view, window=win), win))
    n += 2
    seg, bins, words = state(RG_SHAPE)
    whole = fused.fused_sweep_plain(seg, bins, words)
    mesh = make_volume_mesh([seg.device] * 4)
    seg_p = pad_halos(shard_volume(seg, mesh), 1)
    bins_p = pad_halos(shard_volume(bins, mesh), 1)
    dh = torch.zeros_like(whole[1])
    for idx in seg_p.source.indices():
        args = (seg_p.blocks[idx], bins_p.blocks[idx], words)
        win = seg_p.window(idx)
        out = fused.fused_sweep_counts(*args, window=win)
        same(f"K2 on the padded block {idx} of a 2x2 mesh",
             _in_window(out, win),
             _in_window(fused.fused_sweep_plain(*args, window=win), win))
        seg_p.blocks[idx] = out[0]
        dh += out[1]
        n += 1
    same("K2's 2x2 blocks reassembled", (seg_p.crop().gather(), dh), whole)
    return n


def phase_region_grow_kernels(vol, seed):
    """Each region-growing kernel against its plain version on the card,
    at the path's shapes: the tube phantom's bins and its state after 20
    full-grid iterations.  Integers and table entries all: they must agree
    exactly.  Bounds count the bytes this state needs: every mask and seg
    byte, but bins only where a mask is set (histograms) or at boundary
    voxels (sweeps), as the kernels read them."""
    import torch
    import torch.nn.functional as F

    from arterynetwork_tpu_torch.ops.region_grow import (
        _bin_ids, _decision_table, _gaussian_kernel, _quantize, region_grow)
    from arterynetwork_tpu_torch.ops.stencil import dilate26

    hk, fused = _ops("histogram_kernels"), _ops("region_grow_fused")
    front, lk = _ops("region_grow_frontier"), _ops("lookup_kernels")
    dev = torch.device("cuda")
    data = torch.from_numpy(vol).to(dev)
    res = region_grow(data, torch.from_numpy(seed).to(dev), backend="xla",
                      max_segment_size=10 ** 6, iter_max=20)
    seg = res.segmented_map
    idx, values = _quantize(data, 256)
    bins = _bin_ids(idx, 256).contiguous()
    flat = bins.reshape(-1)
    n = flat.numel()
    masks = torch.stack([seg.reshape(-1), ~seg.reshape(-1)])
    K = _gaussian_kernel(values, 2.25, torch.float32)
    hist_all = hk.masked_histogram1(flat, torch.ones_like(masks[0]))
    inner = hk.masked_histogram1(flat, masks[0])
    table = _decision_table(K, inner, hist_all - inner)     # f32[256]
    words = fused.pack_sign_words(table)
    seg8 = seg.to(torch.uint8).contiguous()
    Z, Y, X = seg8.shape            # pad X to 256 lanes, Y to whole
    pad = (0, 256 - X, 0, max(-(-Y // 128), 2) * 128 - Y)    # 128-bands
    seg_p, bins_p = F.pad(seg8, pad), F.pad(bins, pad)
    valid = tuple(seg8.shape[1:])
    tile = (8, 16)
    bnd = dilate26(seg) & dilate26(~seg)
    active = front._per_tile(bnd, tile) > 0
    ids = front._compact(active, 256)
    nact = torch.clamp(active.sum(), max=256).to(torch.int32).reshape(1)
    log("region_grow_kernels", f"state after {int(res.iterations)} "
        f"iterations: {int(res.segmented_count)} segmented voxels; "
        f"{int(nact)} of {active.numel()} tiles active; decision table "
        f"{int((table >= 0).sum())} of 256 bins >= 0")
    w = masks.float()               # the library calls' weights

    def k6b():
        return (hk.masked_histogram1(flat, masks[0]),)

    def k6b_plain():
        return (hk.masked_histograms_plain(flat, masks[:1])[0],)

    def frontier(fn, s):
        return lambda: (s, *fn(s, bins, ids, nact, words, tile))

    front_a, front_b = seg8.clone(), seg8.clone()
    n_seg, n_bnd = int(masks[0].sum()), int(bnd.sum())
    sweep_bytes = 2 * n + n_bnd + 2 * 256 * 4
    # a block of sharded_512's grower: 256 x 256 own rows of the state
    # around the tube with a one-voxel halo on each side, swept over its
    # window (the kernel reads the block, writes and counts the window)
    blk = (slice(127, 385), slice(127, 385))
    seg_b, bins_b = seg8[blk].contiguous(), bins[blk].contiguous()
    win = ((1, 257), (1, 257), (0, X))
    n_b = seg_b.numel()
    n_bnd_win = int(bnd[128:384, 128:384].sum())
    log("region_grow_kernels", f"windowed K2 block {tuple(seg_b.shape)}, "
        f"window {win}: {n_bnd_win} boundary voxels in the window")
    # name: (kernel, plain version, bytes it must move, library call)
    cases = {
        "masked_histogram1": (
            k6b, k6b_plain, n + n_seg + 256 * 4,
            lambda: (torch.bincount(flat, weights=w[0], minlength=256),)),
        "masked_histograms2": (
            lambda: (hk.masked_histograms2(flat, masks),),
            lambda: (hk.masked_histograms_plain(flat, masks),),
            3 * n + 2 * 256 * 4,
            lambda: (torch.bincount(flat, weights=w[0], minlength=256),
                     torch.bincount(flat, weights=w[1], minlength=256))),
        "region_grow_sweep": (
            lambda: fused.fused_sweep_counts(seg8, bins, words),
            lambda: fused.fused_sweep_plain(seg8, bins, words),
            sweep_bytes, None),
        "region_grow_sweep window": (
            lambda: _in_window(fused.fused_sweep_counts(
                seg_b, bins_b, words, window=win), win),
            lambda: _in_window(fused.fused_sweep_plain(
                seg_b, bins_b, words, window=win), win),
            2 * n_b + n_bnd_win + 2 * 256 * 4, None),
        "region_grow_sweep banded (K3)": (
            lambda: fused.fused_sweep_banded(seg_p, bins_p, words, valid),
            lambda: fused.fused_sweep(seg_p, bins_p, words, valid),
            sweep_bytes, None),
        "region_grow_sweep banded_dma (K4)": (
            lambda: fused.fused_sweep_banded_dma(seg_p, bins_p, words,
                                                 valid),
            lambda: fused.fused_sweep(seg_p, bins_p, words, valid),
            sweep_bytes, None),
        "region_grow_frontier": (
            frontier(front.frontier_step, front_a),
            frontier(front.frontier_step_plain, front_b),
            _frontier_bytes(ids.tolist(), int(nact), seg8.shape, tile,
                            n_bnd), None),
        "table_lookup": (
            lambda: (lk.table_lookup(bins, table),),
            lambda: (lk.table_lookup_plain(bins, table),),
            n + 4 * n + 256 * 4, lambda: (table[bins.long()],)),
        "sign_lookup": (
            lambda: (lk.sign_lookup(bins, table),),
            lambda: (lk.sign_lookup_plain(bins, table),),
            2 * n + 256 * 4, lambda: (table[bins.long()] >= 0,)),
    }
    rec = {}
    for name, (kernel, plain, nbytes, library) in cases.items():
        if "banded" in name:           # compare against the plain sweep
            with plain_kernels():
                ref = plain()
        else:
            ref = plain()
        out = kernel()
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        m_k = measure(kernel, own=True)
        with plain_kernels():
            m_p = measure(plain)
        m_l = library and measure(library)
        r = {"max_abs_err": err, **timing(m_k, m_p, nbytes, 0, m_l)}
        lib = "none" if library is None else (
            f"{r['library_ms']:.4f} ms ({r['library_call_ms']:.4f} per call)")
        log("region_grow_kernels", f"{name}: max|d| {err}; {r['timed_by']}"
            f" ms: kernel {r['ms']:.4f} ({r['call_ms']:.4f} per call), "
            f"plain {r['plain_ms']:.4f} ({r['plain_call_ms']:.4f} per call),"
            f" library call {lib}; bound {r['bound_ms']:.4f} ms ({nbytes} "
            f"bytes): {r['bound_ms'] / r['ms']:.1%} of the kernel; device "
            f"events in 10 calls: kernel {'; '.join(m_k[2])}; plain "
            f"{'; '.join(m_p[2])}; library {'; '.join(m_l[2]) if m_l else ''}")
        if err != 0:
            raise SystemExit(f"{name} disagrees with its plain version: "
                             f"max|d| {err}")
        rec[name] = r
    # K5's floor: both kernels launched, no tile active
    none = torch.zeros(1, dtype=torch.int32, device=dev)
    m0 = measure(lambda: front.frontier_step(front_a, bins, ids, none, words,
                                             tile), own=True)
    r = rec["region_grow_frontier"]
    r["nact0_ms"], r["nact0_call_ms"] = m0[0], m0[1]
    log("region_grow_kernels", f"region_grow_frontier fixed cost (nact = "
        f"0, both kernels launched): {_ms(m0[0])} ms on the device "
        f"({m0[1]:.4f} per call), against {r['ms']:.4f} ms at {int(nact)} "
        f"tiles; device events in 10 calls: {'; '.join(m0[2])}")
    return rec


def device_idle(fn):
    """(wall s, device-busy s, idle share) of one run of ``fn`` traced by
    torch.profiler: busy is the union of the device events' intervals,
    wall the host clock around the traced run (the tracer's own host cost
    included, so the share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Activity Buffer Request")
    busy, end = 0.0, float("-inf")
    for a, b in spans:                 # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e6, 1 - busy / 1e6 / wall


def _grow_run(fn):
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts()


def phase_region_grow_512(vol, seed):
    """bench.py::bench_region_grow on the card: the three growers reach
    one fixed point, kernels and plain versions alike."""
    import torch

    from arterynetwork_tpu_torch.ops import (region_grow,
                                             region_grow_frontier)

    dev = torch.device("cuda")
    data = torch.from_numpy(vol).to(dev)
    sd = torch.from_numpy(seed).to(dev)
    excluded = torch.zeros_like(sd)
    excluded[:SLAB] = True                     # far from the tube
    growers = {
        "auto": (lambda: region_grow(data, sd, **RG_KW),
                 ("region_grow_sweep", "masked_histogram1")),
        "xla": (lambda: region_grow(data, sd, backend="xla", **RG_KW),
                ("masked_histogram1", "sign_lookup")),
        "frontier": (lambda: region_grow_frontier(data, sd, **RG_KW),
                     ("region_grow_frontier", "masked_histogram1")),
        "xla excluded": (lambda: region_grow(data, sd, excluded, backend="xla",
                                             **RG_KW),
                         ("masked_histograms2", "sign_lookup")),
    }
    voxels = float(vol.size)
    results, launches = {}, {}
    for name, (fn, kernels) in growers.items():
        fn()                                   # warm-up
        res, secs, counts = _grow_run(fn)
        with plain_kernels():
            ref, p_secs, p_counts = _grow_run(fn)
        it, n = int(res.iterations), int(res.segmented_count)
        same = (torch.equal(res.segmented_map, ref.segmented_map)
                and torch.equal(res.active_map, ref.active_map)
                and (it, n, int(res.stop_reason))
                == (int(ref.iterations), int(ref.segmented_count),
                    int(ref.stop_reason)))
        used = {k: v for k, v in counts.items() if v}
        log("region_grow_512", f"{name}: {secs:.4f} s warm, {it} "
            f"iterations, {n} segmented, stop {int(res.stop_reason)}, "
            f"{voxels * it / secs:.4e} voxel-sweeps/s; launches {used}; "
            f"plain versions on the card {p_secs:.4f} s, identical {same}")
        if not same or any(p_counts.values()):
            raise SystemExit(f"{name}: kernel and plain runs differ "
                             f"(plain launches {p_counts})")
        if not all(counts[k] > 0 for k in kernels):
            raise SystemExit(f"{name}: expected launches of {kernels}, "
                             f"got {counts}")
        # the full-grid loop looks its signs up once per pass: one pass per
        # applied update, and one more that finds no flip
        passes = it + (int(res.stop_reason) == 0)
        if "sign_lookup" in kernels and counts["sign_lookup"] != passes:
            raise SystemExit(f"{name}: {counts['sign_lookup']} K7 launches "
                             f"for {passes} passes")
        results[name], launches[name] = res, counts
        if name in ("auto", "frontier"):
            wall, busy, idle = device_idle(fn)
            log("region_grow_512", f"{name} traced by torch.profiler: "
                f"{wall:.4f} s, device busy {busy:.4f} s, idle {idle:.1%}")
    a = results["auto"]
    for name in ("xla", "frontier"):
        r = results[name]
        if ((int(r.iterations), int(r.segmented_count))
                != (int(a.iterations), int(a.segmented_count))
                or not torch.equal(r.segmented_map, a.segmented_map)):
            raise SystemExit(f"{name} and auto reach different fixed "
                             f"points")
    ex = results["xla excluded"]
    if (ex.segmented_map & excluded).any() or ex.active_map[:SLAB].any() \
            or not 0 < int(ex.segmented_count) < 10 ** 6:
        raise SystemExit("the excluded slab entered the region")
    log("region_grow_512", "auto, xla and frontier: one fixed point; "
        "the excluded slab stays out")
    return launches, ex


def phase_f64_grow():
    """f64 data on the card: region_grow "auto" takes the f64 full-grid
    path (K6b and K7, no K2) and equals the port's CPU full-grid result
    exactly.  The f32 fused grower (backend="fused", the route f64 data
    took before) runs beside it, and the voxels where it differs are
    counted."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import region_grow
    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    shape = (48, 48, 96)          # tests/test_torch_kernels.py::_f64_tube
    vol, seed = tube_phantom(shape, seed=2)
    vol = vol.astype(np.float64) + np.random.default_rng(3).normal(
        0, 1e-3, shape)
    kw = {"max_segment_size": 10 ** 6, "iter_max": 300}
    ref = region_grow(vol, seed, backend="xla", device="cpu", **kw)
    out, secs, counts = _grow_run(
        lambda: region_grow(vol, seed, device="cuda", **kw))
    f32 = region_grow(vol, seed, backend="fused", device="cuda", **kw)

    def key(r):
        return int(r.iterations), int(r.segmented_count), int(r.stop_reason)

    same = (torch.equal(out.segmented_map.cpu(), ref.segmented_map)
            and torch.equal(out.active_map.cpu(), ref.active_map)
            and key(out) == key(ref))
    f32_diff = int((f32.segmented_map.cpu() != ref.segmented_map).sum())
    log("f64_grow", f"f64 tube {shape}: auto on the card {secs:.4f} s, "
        f"(iterations, segmented, stop) {key(out)}, launches "
        f"{ {k: v for k, v in counts.items() if v} }; equal to the CPU "
        f"full-grid result {same}; the f32 fused route {key(f32)}, "
        f"{f32_diff} voxels differ")
    if not same or counts["region_grow_sweep"] \
            or not (counts["masked_histogram1"] and counts["sign_lookup"]):
        raise SystemExit("f64 region growing on the card did not take the "
                         "f64 full-grid path, or differs from the CPU")


def phase_value_map(vol, seed, ex):
    """The reference's interface on the card: region_grow_value_map with
    the excluded slab as state 4 must reproduce the "xla excluded"
    grower ``ex``."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops import (reconstruct_value_map,
                                             region_grow_value_map)

    value_map = np.full(vol.shape, 3)          # int64, as a caller has it
    value_map[seed] = 0
    value_map[:SLAB] = 4

    def run():
        return region_grow_value_map(vol, value_map, device="cuda", **RG_KW)

    run()                                      # warm-up
    totals = []
    for i in range(3):
        (coords, seg_map, vm), secs, counts = _grow_run(run)
        totals.append(secs)
        log("value_map_512", f"run {i + 1}: {secs:.4f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        for k in ("masked_histograms2", "sign_lookup"):
            if not counts[k] > 0:
                raise SystemExit(f"value_map_512 launched no {k}")
    def host_s(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def upload():
        v = torch.as_tensor(value_map, device="cuda")
        return (v == 0) | (v == 1), v == 4

    def outputs():
        s = ex.segmented_map.cpu().numpy()
        return np.argwhere(s), s.astype(np.int64)

    u8 = torch.zeros(vol.shape, dtype=torch.uint8, device="cuda")
    u8_host = u8.cpu().numpy()

    med = statistics.median(totals)
    parts = {"value map upload and masks": upload,
             "reconstruct_value_map": lambda: reconstruct_value_map(
                 ex.segmented_map, ex.active_map, "cuda"),
             "download, int64 map and argwhere": outputs,
             # pieces of the two above
             "a uint8 volume's download": lambda: u8.cpu(),
             "a volume's int64 widening on the host": lambda: u8_host.astype(
                 np.int64)}
    split = {k: host_s(fn) for k, fn in parts.items()}
    log("value_map_512", "outside the grower: " + "; ".join(
        f"{k} {t:.4f} s ({t / med:.1%})" for k, t in split.items()))
    seg_ref = ex.segmented_map.cpu().numpy()
    vm_ref = reconstruct_value_map(seg_ref, ex.active_map.cpu().numpy(),
                                   device="cpu")
    same = (np.array_equal(seg_map, seg_ref.astype(np.int64))
            and np.array_equal(coords, np.argwhere(seg_ref))
            and np.array_equal(vm, vm_ref))
    states = np.bincount(vm.reshape(-1), minlength=5)
    log("value_map_512", f"median {med:.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); reconstruct_value_map "
        f"on the card {split['reconstruct_value_map']:.4f} s = "
        f"{split['reconstruct_value_map'] / med:.1%} of it; {len(coords)} "
        f"segmented; states 0-4 {states.tolist()}; equal to the xla "
        f"excluded grower and its CPU value map {same}")
    if not same:
        raise SystemExit("value_map_512 differs from the xla excluded grower")
    if np.isin(vm[:SLAB], (0, 1)).any():
        raise SystemExit("value_map_512: region voxels in the excluded slab")
    return counts


def phase_seeded_pipeline(phantom, raw):
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.pipeline import (refine_mask_region_grow,
                                                  run_pipeline,
                                                  vesselness_stage)

    cfg = bench_config()
    cfg.segmentation.max_segment_size = 10 ** 6
    seed = np.zeros(raw.shape, bool)
    seed[tuple(slice(max(c - 1, 0), c + 2) for c in phantom["root"])] = True
    totals, seg_s = [], []
    for i in range(4):            # run 0 is the warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, seed_mask=seed, config=cfg,
                              device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        stages = ", ".join(f"{k} {v:.4f}" for k, v in
                           result["timings"].items())
        log("seeded_pipeline_512", f"run {i}{' (warm-up)' if i == 0 else ''}"
            f": total {total:.4f} s; launches {counts}; stages (s): "
            f"{stages}")
        for k in ("frangi_response", "region_grow_sweep",
                  "masked_histogram1"):
            if not counts[k] > 0:
                raise SystemExit(f"seeded run launched no {k}")
        if i:
            totals.append(total)
            seg_s.append(result["timings"]["segmentation"])
    v = vesselness_stage(raw, cfg, device="cuda")
    mask, res = refine_mask_region_grow(v, seed, cfg, device="cuda")
    sol = result["solution"]
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    recall = float(mask[phantom["mask"]].astype(bool).mean())
    log("seeded_pipeline_512", f"median total "
        f"{statistics.median(totals):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); segmentation stage "
        f"median {statistics.median(seg_s):.4f} s; region growing "
        f"{int(res.iterations)} iterations, stop reason "
        f"{int(res.stop_reason)}; mask voxels {int(mask.sum())}; recall "
        f"{recall:.4f}; segments {len(result['segments'])}; flow edges "
        f"{result['network'].num_edges}; pressures/flows finite {finite}")
    if not np.array_equal(mask, result["mask"]):
        raise SystemExit("the seeded mask differs between two runs")
    if not finite or len(result["segments"]) < 1:
        raise SystemExit("seeded pipeline: no segment or non-finite flow")
    return counts


BRAIN_AXES = (250, 250, 82)     # the voxel_options_512 brain ellipsoid
CHUNK_Z = 96                    # frangi_vesselness_chunked's default
THIN_CROP = (slice(200, 312), slice(200, 312), slice(0, 170))  # ~2.1M
EXACT_CROP = (slice(0, 128), slice(0, 128), slice(0, 170))


def _brain_ellipsoid(shape, axes):
    """An ellipsoid centred in the volume with the given semi-axes."""
    import numpy as np

    c = (np.array(shape) - 1) / 2.0
    z, y, x = np.ogrid[:shape[0], :shape[1], :shape[2]]
    return (((z - c[0]) / axes[0]) ** 2 + ((y - c[1]) / axes[1]) ** 2
            + ((x - c[2]) / axes[2]) ** 2) <= 1.0


def _check(ok, phase, msg):
    log(phase, f"{'ok' if ok else 'FAILED'}: {msg}")
    if not ok:
        raise SystemExit(f"{phase}: {msg}")


def _same_partition(a, b):
    """Two label volumes (0 = background) label the same voxels and
    split them into the same components."""
    import numpy as np

    fa, fb = a != 0, b != 0
    if not np.array_equal(fa, fb):
        return False
    pairs = np.unique(np.stack([a[fa], b[fb]]), axis=1)
    return pairs.shape[1] == len(np.unique(a[fa])) == len(np.unique(b[fb]))


def _deletable(skel):
    """Voxels of ``skel`` that one more thinning step could delete:
    simple (by label propagation over each voxel's neighbor planes) and
    with at least two foreground neighbors."""
    import torch

    from arterynetwork_tpu_torch.ops import simple_point, thinning

    code = simple_point.neighborhood_codes(skel).reshape(-1)
    idx = torch.nonzero(skel.reshape(-1)).reshape(-1)
    c = code[idx]
    simple = thinning._simple_from_planes(simple_point.code_bits(c).T)
    return int((simple & ((c & (c - 1)) != 0)).sum())


def phase_voxel_options(phantom, raw):
    """pipeline_512's phantom and configuration with a brain ellipsoid,
    the tip extension and the device thinning, and gates (a)-(g) on the
    slice's modules."""
    import importlib
    import os
    import tempfile

    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops import (cc, native, simple_point,
                                             thinning, vesselness,
                                             vesselness_fused)
    from arterynetwork_tpu_torch.pipeline import (generate_vessel_mask,
                                                  run_pipeline,
                                                  vesselness_stage)
    from arterynetwork_tpu_torch.utils.fidelity import tree_recovery_metrics

    P = "voxel_options_512"
    edt = importlib.import_module("arterynetwork_tpu_torch.ops.edt")
    t_phase = time.perf_counter()
    cfg = bench_config()
    seg = cfg.segmentation
    seg.tip_fraction, seg.tip_iters, seg.tip_neighbor_max = 0.015, 3, 4
    cfg.skeleton.backend = "jax"
    brain = _brain_ellipsoid(raw.shape, BRAIN_AXES)
    torch.cuda.reset_peak_memory_stats()
    totals, stages = [], []
    for i in range(4):            # run 0 is the warm-up (builds the LUT)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, brain_mask=brain, config=cfg,
                              device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        log(P, f"run {i}{' (warm-up)' if i == 0 else ''}: total "
            f"{total:.4f} s; launches {counts}; stages (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        result["timings"].items()))
        if counts["frangi_response"] != 44 or sum(counts.values()) != 44:
            raise SystemExit(f"{P}: launches {counts}, expected K1 x 44")
        if i:
            totals.append(total)
            stages.append(result["timings"])
    pipe_k1 = counts["frangi_response"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    mask, skel = result["mask"], result["skeleton"]
    cfg_n = bench_config()
    cfg_n.segmentation = seg
    native_run = run_pipeline(raw_volume=raw, brain_mask=brain,
                              config=cfg_n, device="cuda")
    fid = {name: tree_recovery_metrics(r["segments"], r["attrs"], phantom)
           for name, r in (("jax", result), ("native", native_run))}
    sol = result["solution"]
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    log(P, f"median total {statistics.median(totals):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); median stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        + f"; mask voxels {int(mask.sum())}; skeleton voxels "
        f"{int(skel.sum())}; segments {len(result['segments'])} (native "
        f"{len(native_run['segments'])}); peak device memory {peak:.0f} "
        f"MiB; pressures/flows finite {finite}")
    for name, m in fid.items():
        log(P, f"{name} thinning: centerline recall "
            f"{m['centerline_recall']:.4f}, precision "
            f"{m['centerline_precision']:.4f}, radius rmse "
            f"{m['radius_rmse']:.4f}, segments {m['segments']} (phantom "
            f"{m['gt_branches']} branches)")
    _check(finite and len(result["segments"]) > 0, P,
           "finite pressures and flows, at least one segment")
    _check(np.array_equal(native_run["mask"], mask), P,
           "the native-backend run has the same mask")

    # (a) the card's brain + tip mask equals the CPU's
    v = vesselness_stage(raw, cfg, device="cuda")
    m_card = generate_vessel_mask(v, brain, cfg, device="cuda")
    t0 = time.perf_counter()
    m_cpu = generate_vessel_mask(v.cpu(), brain, cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    cfg_plain = bench_config()
    m_plain = generate_vessel_mask(v, None, cfg_plain, device="cuda")
    _check(np.array_equal(m_card, m_cpu) and np.array_equal(m_card, mask),
           P, f"(a) brain+tip mask on the card equals the CPU's (CPU "
           f"{t_cpu:.1f} s) and the pipeline's; {int(m_card.sum())} voxels, "
           f"{int((m_plain & ~m_card).sum())} removed and "
           f"{int((m_card & ~m_plain).sum())} added against no brain mask "
           f"and no tip extension")

    # (b) banded EDT against the native exact EDT; exact mode on a crop
    worst = []
    for name, vol, band in (("brain mask", brain, 12),
                            ("pipeline mask", mask, 32)):
        ref = native.edt_native(vol, squared=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d2 = edt.edt_squared(torch.from_numpy(np.asarray(vol)).cuda(),
                             band=band)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        d2 = d2.cpu().numpy()
        clamp = 3 * band * band
        inside, beyond = ref <= band * band, ref >= clamp
        mid = ~inside & ~beyond
        ok = (np.array_equal(d2[inside], ref[inside])
              and bool((d2[beyond] == clamp).all())
              and bool(((d2[mid] >= ref[mid]) & (d2[mid] <= clamp)).all()))
        worst.append(ok)
        log(P, f"(b) banded EDT, band {band}, {name}: {ms:.1f} ms; "
            f"{int(inside.sum())} voxels within the band equal, "
            f"{int(beyond.sum())} beyond the clamp at it, {int(mid.sum())} "
            f"between: {ok}")
    crop = np.ascontiguousarray(brain[EXACT_CROP])
    ref = native.edt_native(crop, squared=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2 = edt.edt_squared(torch.from_numpy(crop).cuda(), band=None)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    exact = np.array_equal(d2.cpu().numpy(), ref)
    _check(all(worst) and exact, P, f"(b) banded EDT within its band and "
           f"clamp; exact EDT of the {crop.shape} crop ({ms:.1f} ms, max d2 "
           f"{float(ref.max()):.0f}) equal to the native EDT: {exact}")

    # (c) LUT thinning against the plain label-propagation thinning, both
    # on the card, on a crop of the pipeline mask
    sub = torch.from_numpy(np.ascontiguousarray(mask[THIN_CROP])).cuda()
    times = {}
    outs = {}
    for pred in ("lut", "labels"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[pred] = thinning.skeletonize(sub, predicate=pred)
        torch.cuda.synchronize()
        times[pred] = time.perf_counter() - t0
    wall, busy, idle = device_idle(lambda: thinning.skeletonize(
        torch.from_numpy(mask).cuda()))
    log(P, f"full-size device thinning traced: {wall:.3f} s wall, "
        f"{busy:.3f} s device busy, idle share {idle:.1%}")
    _check(torch.equal(outs["lut"], outs["labels"]), P,
           f"(c) LUT thinning equals label-propagation thinning on a "
           f"{tuple(sub.shape)} crop ({int(sub.sum())} mask, "
           f"{int(outs['lut'].sum())} skeleton voxels): {times['lut']:.3f} "
           f"s against {times['labels']:.3f} s")

    # (d) the full-size skeleton: inside the mask, thin, as many
    # 26-components as the mask
    sk = torch.from_numpy(skel).cuda()
    n_del = _deletable(sk)
    n_mask = native.label_components_native(mask)[1]
    n_skel = native.label_components_native(skel)[1]
    inside = not (skel & ~mask.astype(bool)).any()
    _check(inside and n_del == 0 and n_mask == n_skel, P,
           f"(d) skeleton inside the mask {inside}; deletable voxels left "
           f"{n_del}; 26-components {n_skel} (mask {n_mask})")

    # (e) the LUT built on the card against the native predicate
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            simple_point._CACHE_DIR)) as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lut = simple_point.build_simple_point_lut(cache_dir=tmp,
                                                  device="cuda")
        t_lut = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 1 << 26, 1 << 20)
    sampled = np.array([native.simple_point_native(int(c)) for c in codes],
                       np.uint8)
    same_sampled = np.array_equal(simple_point.lut_lookup(lut, codes),
                                  sampled)
    native.get_lib()
    with open(os.path.join(native._BUILD_DIR, "simple26.lut"), "rb") as f:
        table = np.frombuffer(f.read()[8:], np.uint8)
    same_all = np.array_equal(lut, table)
    _check(same_sampled and same_all, P,
           f"(e) LUT built on the card in {t_lut:.2f} s (simple share "
           f"{float(np.unpackbits(lut).mean()):.4f}): equal to "
           f"simple_point_native on 2^20 sampled codes {same_sampled}, "
           f"to the native table on all 2^26 codes {same_all}")

    # (f) components on the card against the native flood fill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab64 = cc.connected_components(torch.from_numpy(mask).cuda())
    r64 = cc.connected_components.rounds
    lab = cc.connected_components(torch.from_numpy(mask).cuda(),
                                  max_rounds=1 << 12)
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t0
    rounds = cc.connected_components.rounds
    ref, k = native.label_components_native(mask)
    n64 = len(np.unique(lab64.cpu().numpy())) - 1
    _check(_same_partition(lab.cpu().numpy(), ref), P,
           f"(f) connected_components run to convergence ({rounds} rounds; "
           f"both calls {t_cc:.2f} s) gives the native partition ({k} "
           f"components); at the default 64 rounds ({r64} run) "
           f"{n64} labels")

    # (g) the chunked vesselness driver: K1 per slab and scale
    sig = tuple(cfg.vesselness.sigmas)
    vol = torch.from_numpy(raw).cuda()
    n_chunks = -(-raw.shape[0] // CHUNK_Z)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunked = vesselness.frangi_vesselness_chunked(vol, sigmas=sig,
                                                   chunk_z=CHUNK_Z)
    torch.cuda.synchronize()
    t_ch = time.perf_counter() - t0
    counts = read_counts()
    k1 = vesselness_fused.frangi_response_max_
    vesselness_fused.frangi_response_max_ = \
        vesselness_fused.frangi_response_plain_
    try:
        twin = vesselness.frangi_vesselness_chunked(vol, sigmas=sig,
                                                    chunk_z=CHUNK_Z)
    finally:
        vesselness_fused.frangi_response_max_ = k1
    if read_counts() != counts:
        raise SystemExit(f"{P}: the twin run launched a kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = vesselness.frangi_vesselness(vol, sigmas=sig)
    torch.cuda.synchronize()
    t_wh = time.perf_counter() - t0
    d_twin = (chunked - twin).abs()
    ok_twin = bool((d_twin <= K1_TOL + 1e-4 * twin.abs()).all())
    d_in = (chunked - whole).abs()[1:-1]
    ok_in = bool((d_in <= K1_TOL + 1e-4 * whole.abs()[1:-1]).all())
    face = float((chunked - whole).abs()[[0, -1]].max())
    want = n_chunks * len(sig)
    _check(counts["frangi_response"] == want and ok_twin and ok_in, P,
           f"(g) frangi_vesselness_chunked {t_ch:.3f} s, K1 launches "
           f"{counts['frangi_response']} (expected {n_chunks} chunks x "
           f"{len(sig)} scales = {want}); against its twin on the card "
           f"max|d| {float(d_twin.max()):.3e} within 1e-5 + 1e-4|ref| "
           f"{ok_twin}; against frangi_vesselness ({t_wh:.3f} s) on "
           f"interior rows max|d| {float(d_in.max()):.3e} within the same "
           f"bound {ok_in}, face rows {face:.3e}")
    log("timing", f"{P}: {time.perf_counter() - t_phase:.1f} s")
    return {"pipeline": pipe_k1, "chunked": counts["frangi_response"]}


GRAPH_STORE_FILES = ("fluidSimulationResult.pkl",
                     "graphRepresentationCleanedWithEdgeInfo.graphml",
                     "segmentList.npz", "skeleton.nii.gz",
                     "vesselVolumeMask.nii.gz", "vesselnessFiltered.nii.gz")
MORPHO_FILES = ("segmentInfoDict.pkl", "nodeInfoDict.pkl",
                "partitionInfo.pkl", "chosenVoxelsForPartition.pkl",
                "segmentListCleaned.npz",
                "graphRepresentationCleanedWithAdvancedInfo.graphml")
MORPHO_STORE = "build/graph_path_512_morpho"   # kept for the figures phase


def _edge_set(net, node_of):
    """A network's edges by their end coordinates, radius and length
    (rounded to 1e-6), as a sorted list."""
    coord = {i: c for c, i in node_of.items()}
    return sorted((coord[int(h)], coord[int(t)], round(float(r), 6),
                   round(float(ln), 6))
                  for h, t, r, ln in zip(net.heads, net.tails, net.radius,
                                         net.length))


def _coord_rel(sol_a, of_a, sol_b, of_b):
    """max |p_a - p_b| / max |p_b| over the coordinates both hold."""
    import numpy as np

    common = [c for c in of_a if c in of_b]
    pa = sol_a.pressure.cpu().numpy()[[of_a[c] for c in common]]
    pb = sol_b.pressure.cpu().numpy()[[of_b[c] for c in common]]
    return float(np.max(np.abs(pa - pb)) / np.max(np.abs(pb))), len(common)


def _root_of(segments):
    """run_pipeline's inlet: the lowest-x terminal endpoint."""
    counts = {}
    for seg in segments:
        for v in (tuple(seg[0]), tuple(seg[-1])):
            counts[v] = counts.get(v, 0) + 1
    return min((v for v, c in counts.items() if c == 1), key=lambda v: v[2])


def phase_graph_path(phantom, raw):
    """pipeline_512 with flow.graph_path="nx": the voxel graph, its BFS
    and reduction on the host, K1 on the card; timed runs, a run with the
    artifact store (each write timed), and gates (a)-(e)."""
    import contextlib
    import copy
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from arterynetwork_tpu_torch.__main__ import main as cli
    from arterynetwork_tpu_torch.graphs import voxel_graph as vg
    from arterynetwork_tpu_torch.io.artifacts import ArtifactStore
    from arterynetwork_tpu_torch.pipeline import (flow_stage,
                                                  flow_stage_soa,
                                                  run_pipeline)

    P = "graph_path_512"
    t_phase = time.perf_counter()
    cfg = bench_config()
    cfg.flow.graph_path = "nx"
    torch.cuda.reset_peak_memory_stats()
    totals, stages, launches = [], [], []
    for i in range(4):            # run 0 is the warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, config=cfg, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        launches.append(counts["frangi_response"])
        log(P, f"run {i}{' (warm-up)' if i == 0 else ''}: total "
            f"{total:.4f} s; K1 launches {counts['frangi_response']}; "
            "stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       result["timings"].items()))
        # (e) K1 launches exactly 44 times per run, and nothing else
        if counts["frangi_response"] != 44 or sum(counts.values()) != 44:
            raise SystemExit(f"{P}: launches {counts}, expected K1 x 44")
        if i:
            totals.append(total)
            stages.append(result["timings"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    G, segments, attrs = result["graph"], result["segments"], result["attrs"]
    sol = result["solution"]
    root = _root_of(segments)
    # the soa route on the segments the nx reduction keeps (gate (a))
    kept32 = sorted(int(i) for i in result["network"].edge_segment_index)
    soa32 = flow_stage_soa([segments[i] for i in kept32],
                           [attrs[i] for i in kept32], root, cfg,
                           device="cuda")
    rel32, _ = _coord_rel(sol, result["node_of"], soa32[1], soa32[2])
    log(P, f"median total {statistics.median(totals):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); median stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        + f"; skeleton voxels {int(result['skeleton'].sum())}; voxel graph "
        f"{len(G)} nodes; segments {len(segments)}; flow edges "
        f"{result['network'].num_edges}; f32 pressures against the soa "
        f"route on the kept segments {rel32:.3e} relative; peak device "
        f"memory {peak:.0f} MiB")
    _check(bool(torch.isfinite(sol.pressure).all()
                and torch.isfinite(sol.flow).all()) and len(segments) > 0,
           P, "finite pressures and flows, at least one segment")

    # (a) nx against soa at f64 on the card.  The reduction collapses
    # parallel arcs (two segments joining one pair of junctions) into one
    # edge, as the reference's reduceGraph and the JAX package's do; the
    # soa route keeps each.  So the routes agree on the segments the nx
    # route keeps, and the others must be such parallel arcs.
    cfg64 = copy.deepcopy(cfg)
    cfg64.flow.dtype = "float64"
    t0 = time.perf_counter()
    net_n, sol_n, of_n = flow_stage(G, segments, root, cfg64,
                                    device="cuda")
    t_nx = time.perf_counter() - t0
    t0 = time.perf_counter()
    net_a, _, _ = flow_stage_soa(segments, attrs, root, cfg64,
                                 device="cuda")
    t_soa = time.perf_counter() - t0
    kept = sorted(int(i) for i in net_n.edge_segment_index)
    extra = sorted(set(int(i) for i in net_a.edge_segment_index)
                   - set(kept))
    ends = [frozenset((tuple(sg[0]), tuple(sg[-1]))) for sg in segments]
    kept_ends = {ends[i] for i in kept}
    parallel = (set(kept) <= set(int(i) for i in net_a.edge_segment_index)
                and all(ends[i] in kept_ends for i in extra))
    net_s, sol_s, of_s = flow_stage_soa(
        [segments[i] for i in kept], [attrs[i] for i in kept], root, cfg64,
        device="cuda")
    rel64, n_common = _coord_rel(sol_n, of_n, sol_s, of_s)
    _check(parallel and net_n.num_nodes == net_s.num_nodes
           and _edge_set(net_n, of_n) == _edge_set(net_s, of_s)
           and n_common == net_n.num_nodes and rel64 <= 1e-9, P,
           f"(a) f64 nx route ({t_nx:.4f} s; soa {t_soa:.4f} s): "
           f"{net_n.num_nodes} nodes, {net_n.num_edges} edges; the soa "
           f"route's {net_a.num_edges} edges less {len(extra)} parallel "
           f"arcs give the same edges by coordinates, radius and length "
           f"and pressures within {rel64:.3e} relative (bound 1e-9)")

    # (b) the artifact store: each write timed, each file read back
    class TimedStore(ArtifactStore):
        """Times each write and keeps what each volume write was given."""

        def __init__(self, base_dir):
            super().__init__(base_dir)
            self.write_s, self.volumes, self.graphs = {}, {}, {}

        def _timed(self, name, write, *args, **kwargs):
            t0 = time.perf_counter()
            write(name, *args, **kwargs)
            self.write_s[name] = (self.write_s.get(name, 0.0)
                                  + time.perf_counter() - t0)

        def save_nifti(self, name, volume, *args, **kwargs):
            self.volumes[name] = np.array(volume)
            self._timed(name, super().save_nifti, volume, *args, **kwargs)

        def save_graphml(self, name, graph):
            # the flow stage annotates the graph after it is written
            self.graphs[name] = copy.deepcopy(graph)
            self._timed(name, super().save_graphml, graph)

        def save_segment_list(self, name, segs):
            self._timed(name, super().save_segment_list, segs)

        def save_pickle(self, name, obj):
            self._timed(name, super().save_pickle, obj)

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        store = TimedStore(os.path.join(tmp, "store"))
        affine = np.diag([0.5, 0.5, 0.5, 1.0])
        reset_counts()
        t0 = time.perf_counter()
        stored = run_pipeline(raw_volume=raw, config=cfg, store=store,
                              affine=affine, device="cuda")
        torch.cuda.synchronize()
        t_store = time.perf_counter() - t0
        k1_store = read_counts()["frangi_response"]
        sizes = {n: os.path.getsize(store.path(n)) for n in GRAPH_STORE_FILES
                 if store.exists(n)}
        log(P, f"store run {t_store:.4f} s (stages (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        stored["timings"].items())
            + "); writes (s, MB): " + ", ".join(
                f"{n} {store.write_s.get(n, 0):.4f} "
                f"{sizes.get(n, 0) / 1e6:.2f}" for n in GRAPH_STORE_FILES))
        _check(sorted(os.listdir(store.base_dir)) == list(GRAPH_STORE_FILES)
               and k1_store == 44, P,
               f"(b) the store holds {len(sizes)} files, the JAX store's "
               f"names on this route; K1 {k1_store} launches")
        t0 = time.perf_counter()
        same = {}
        for name, run_arr in (("vesselnessFiltered.nii.gz", None),
                              ("vesselVolumeMask.nii.gz", stored["mask"]),
                              ("skeleton.nii.gz", stored["skeleton"])):
            back, aff = store.load_nifti(name)
            given = store.volumes[name]
            ok = (np.array_equal(back, given) and np.array_equal(aff, affine)
                  and back.dtype == (np.float32 if run_arr is None
                                     else np.uint8))
            if run_arr is not None:
                ok = ok and np.array_equal(back, run_arr.astype(np.uint8))
            same[name] = ok
        same["segmentList.npz"] = \
            store.load_segment_list("segmentList.npz") == stored["segments"]
        res = store.load_pickle("fluidSimulationResult.pkl")
        ssol = stored["solution"]
        same["fluidSimulationResult.pkl"] = (
            np.array_equal(res["pressure"], ssol.pressure.cpu().numpy())
            and np.array_equal(res["flow"], ssol.flow.cpu().numpy())
            and np.array_equal(res["velocity"],
                               ssol.velocity.cpu().numpy())
            and res["node_of"] == {str(k): int(v) for k, v in
                                   stored["node_of"].items()})
        # writing and reading each re-add the edges in edges() order (the
        # relabelled copies of networkx's relabel_nodes), so the loaded
        # graph is the written one relabelled; that rule is idempotent
        name = "graphRepresentationCleanedWithEdgeInfo.graphml"
        back = store.load_graphml(name)
        want = vg.relabel_nodes(store.graphs[name], {})

        def typed(g):
            return ([(v, d, [type(x) for x in d.values()])
                     for v, d in g.nodes(data=True)],
                    [(v, [(u, d, [type(x) for x in d.values()])
                          for u, d in g.adj[v].items()]) for v in g])

        same[name] = (list(want.nodes()) == list(stored["graph"].nodes())
                      and typed(back) == typed(want))
        _check(all(same.values()) and len(same) == len(GRAPH_STORE_FILES),
               P, f"(b) every file reads back equal to the run "
               f"({time.perf_counter() - t0:.2f} s): {same}")

        # (c) the CLI's morphology driver on the store, in this process
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli(["morpho", store.base_dir, "--no-figures", "--device",
                 "cuda"])
        t_morpho = time.perf_counter() - t0
        stats = json.loads(out.getvalue())
        seg_info = store.load_pickle("segmentInfoDict.pkl")
        n_curved = sum("maxCurvatureAveragedInmm" in v
                       for v in seg_info.values())
        overall = stats["statisticsPerPartition"]["Overall"]
        _check(all(store.exists(n) for n in MORPHO_FILES)
               and overall["numBranches"] >= 1 and n_curved >= 1, P,
               f"(c) morpho --no-figures {t_morpho:.2f} s: the bundle "
               f"under the reference's names, Overall.numBranches "
               f"{overall['numBranches']}, partitions "
               f"{sorted(stats['statisticsPerPartition'])}, curvature on "
               f"{n_curved} of {len(seg_info)} segments")
        # the bundle morpho reads, for the figures phase
        shutil.rmtree(MORPHO_STORE, ignore_errors=True)
        os.makedirs(MORPHO_STORE)
        for n in MORPHO_FILES + GRAPH_STORE_FILES[:3]:
            shutil.copy(store.path(n), MORPHO_STORE)

    # (d) the slice never imported networkx, JAX or matplotlib
    loaded = sorted({m.split(".")[0] for m in sys.modules
                     if m.split(".")[0] in ("networkx", "jax", "matplotlib")
                     and sys.modules[m] is not None})
    _check(not loaded, P, f"(d) networkx, jax, matplotlib not imported "
           f"({loaded or 'none'})")
    _check(all(n == 44 for n in launches), P,
           f"(e) K1 launches per run {launches}")
    log(P, f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches[-1]


SHARDED_SIGMAS = (1.0, 2.0)     # mini_pipeline_sharded's defaults
SHARDED_ITERS = 60
SHARDED_WAVES = 16
SHARDED_T = 8


def _rel_diff(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def phase_sharded_512(raw):
    """mini_pipeline_sharded on the pipeline_512 raw volume over a 2x2
    mesh of cuda:0 slots (the four blocks run one after another on the
    one card), at its defaults: one warm-up and three timed runs with
    per-stage times; then the gates: (a) the vesselness bit-equal to
    frangi_vesselness of the whole volume, (b) mask and skeleton equal to
    the single-device composition on the card (tests/test_parallel.py's),
    (c) at least one segment, (d) the dp-split rows of the timestep batch
    (f32 CG, 30 Newton steps at most) on the pipeline's network finite
    and bit-equal to the unsharded batch's, itself bit-equal between two
    runs (the flow sums run in a fixed order; no global switch), (e)
    K2 launched 4 times per sweep of the grower and K6b 8 times (2 per
    block), (f) K6b on each padded block at the grower's inputs (int32,
    own-box and seed masks) equal to its plain version, the blocks' sums
    equal to the whole volume's histograms; the halo bytes per iteration, one traced grow's device idle
    share beside the single-device grower's, and peak device memory.
    Where the ground truth (option 2) is infeasible on the skeleton's
    network, the pipeline returns no pressures (the JAX package's does
    the same), and (d) takes the boundary pressures of the
    terminating-pressure model that run_pipeline falls back to."""
    import dataclasses

    import numpy as np
    import torch

    from arterynetwork_tpu_torch.flow import (build_system,
                                              create_ground_truth)
    from arterynetwork_tpu_torch.flow.solvers import \
        solve_pressure_newton_batch
    from arterynetwork_tpu_torch.ops.region_grow import (_bin_ids,
                                                         _quantize,
                                                         region_grow)
    from arterynetwork_tpu_torch.ops.thinning import skeletonize
    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       pad_halos,
                                                       shard_volume)
    from arterynetwork_tpu_torch.parallel.distributed import solve_batch_dp
    from arterynetwork_tpu_torch.parallel.pipeline_sharded import (
        flow_network, mini_pipeline_sharded)

    dev = torch.device("cuda", 0)
    mesh = make_volume_mesh([dev] * 4)
    kw = {"sigmas": SHARDED_SIGMAS, "max_waves": SHARDED_WAVES,
          "region_grow_iters": SHARDED_ITERS, "n_timesteps": SHARDED_T}
    totals, stage_runs, peaks = [], [], []
    for i in range(4):            # run 0 is the warm-up
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mini_pipeline_sharded(raw, mesh=mesh, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        stages = ", ".join(f"{k} {v:.4f}" for k, v in
                           res["timings"].items())
        log("sharded_512", f"run {i}{' (warm-up)' if i == 0 else ''}: "
            f"total {total:.4f} s; launches {counts}; stages (s): "
            f"{stages}; peak device memory {peak:.0f} MiB")
        if i:
            totals.append(total)
            stage_runs.append(dict(res["timings"]))
            peaks.append(peak)
    rg = res["region_grow"]
    sweeps = rg["iterations"] + (rg["stop_reason"] == 0)
    medians = {k: statistics.median(r[k] for r in stage_runs)
               for k in stage_runs[0]}

    # the single-device composition on the card, each stage timed once
    vol = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(dev)
    single = {}
    t0 = time.perf_counter()
    v1 = frangi_vesselness(vol, sigmas=SHARDED_SIGMAS)
    torch.cuda.synchronize()
    single["vesselness"] = time.perf_counter() - t0
    vmin, vmax = torch.min(v1), torch.max(v1)
    seeds = v1 > vmin + 0.5 * (vmax - vmin)
    t0 = time.perf_counter()
    grown1 = region_grow(v1, seeds, max_segment_size=10 ** 7,
                         iter_max=SHARDED_ITERS)
    single["region_grow"] = time.perf_counter() - t0
    mask1 = grown1.segmented_map
    t0 = time.perf_counter()
    skel1 = skeletonize(mask1, max_waves=SHARDED_WAVES)
    torch.cuda.synchronize()
    single["thinning"] = time.perf_counter() - t0
    gate_a = bool(np.array_equal(res["vesselness"], v1.cpu().numpy()))
    gate_b = (bool(np.array_equal(res["mask"], mask1.cpu().numpy()))
              and bool(np.array_equal(res["skeleton"],
                                      skel1.cpu().numpy()))
              and rg["iterations"] == int(grown1.iterations)
              and rg["segmented_count"] == int(grown1.segmented_count))
    n_seg = len(res["segments"] or [])
    gate_c = n_seg >= 1

    spread = bit_equal = bp_from = n_nodes = resid = None
    if gate_c:
        net = flow_network(res["segments"], res["mask"])
        gt = create_ground_truth(net, option=2,
                                 rng=np.random.default_rng(0))
        if gt.success:
            bp, bp_from = gt.pressure, "ground truth (option 2)"
        else:
            from arterynetwork_tpu_torch.config import PipelineConfig
            from arterynetwork_tpu_torch.pipeline import _solve_network

            bp = _solve_network(net, {}, PipelineConfig().flow,
                                device=dev)[0].node_pressure
            bp_from = "terminating-pressure model"
        n_nodes = net.num_nodes
        system = build_system(net, boundary_pressure=bp,
                              dtype=torch.float32, device=dev)
        scales = torch.linspace(1.0, 0.9, SHARDED_T, dtype=torch.float64)
        fixed = torch.where(system.node_fixed.cpu(), torch.as_tensor(
            bp, dtype=torch.float32)[None] * scales[:, None], 0.0).to(dev)
        batch = dataclasses.replace(
            system, node_fixed_pressure=fixed.to(torch.float32))

        def unsharded():
            return solve_pressure_newton_batch(batch, max_iter=30,
                                               linear_solver="cg")

        one = unsharded().pressure.cpu().numpy()
        two = unsharded().pressure.cpu().numpy()
        spread = _rel_diff(one, two)
        dp_sol = solve_batch_dp(system, fixed, slots=mesh, max_iter=30,
                                linear_solver="cg")
        rows = dp_sol.pressure.cpu().numpy()
        bit_equal = (one.tobytes() == two.tobytes() == rows.tobytes())
        resid = float(dp_sol.residual_norm.max())
        # the network and its boundary for a solve elsewhere (the JAX
        # package's against the port's, on a CPU)
        os.makedirs("build", exist_ok=True)
        np.savez("build/sharded_512_network.npz", boundary_pressure=bp,
                 **{f.name: getattr(net, f.name) for f in
                    dataclasses.fields(net)
                    if isinstance(getattr(net, f.name), np.ndarray)})
    gate_d = bool(bit_equal) and bool(np.isfinite(rows).all())
    gate_e = (counts["region_grow_sweep"] == 4 * sweeps
              and counts["masked_histogram1"] == 8)

    # halo bytes of one exchange, and one traced grow each way
    v_sh = sharded.frangi_vesselness(shard_volume(vol, mesh),
                                     sigmas=SHARDED_SIGMAS)
    seeds_sh = shard_volume(seeds, mesh)
    pad = pad_halos(seeds_sh.map(lambda b: b.to(torch.uint8)), 1)
    halo_bytes = sum(pad.blocks[i].numel() - seeds_sh.blocks[i].numel()
                     for i in seeds_sh.indices())
    # (f) K6b at the grower's inputs: each padded block's int32
    # histograms under its own-box mask and its seed (inner) mask, both
    # false on the halo, exact against the plain version, and the blocks'
    # sums equal to the whole volume's histograms
    hk = _ops("histogram_kernels")
    bins_pad, _ = sharded.quantized_bins(v_sh)
    sums = torch.zeros((2, 256), dtype=torch.int64, device=dev)
    k6b_err, k6b_calls = 0, 0
    for flat, own, inner in sharded.histogram_inputs(bins_pad,
                                                     seeds_sh).values():
        for j, m in enumerate((own, inner)):
            h = hk.masked_histogram1(flat, m, 256, torch.int32)
            ref = hk.masked_histograms_plain(flat, m[None], 256,
                                             torch.int32)[0]
            k6b_err = max(k6b_err, int((h - ref).abs().max()))
            sums[j] += h
            k6b_calls += 1
    bins1 = _bin_ids(_quantize(v1, 256)[0], 256).reshape(-1).long()
    whole = torch.stack([
        torch.bincount(bins1, minlength=256),
        torch.bincount(bins1[seeds.reshape(-1)], minlength=256)])
    gate_f = k6b_err == 0 and bool(torch.equal(sums, whole))
    log("sharded_512", f"K6b on the {k6b_calls // 2} padded blocks "
        f"({', '.join(str(tuple(b.shape)) for b in bins_pad.blocks.reshape(-1))}"
        f"), own and inner masks, int32: max|d| {k6b_err} from the plain "
        f"version; block sums equal to the whole volume's "
        f"{bool(torch.equal(sums, whole))} ({int(whole[0].sum())} voxels, "
        f"{int(whole[1].sum())} seeds)")

    wall, busy, idle = device_idle(lambda: sharded.region_grow(
        v_sh, seeds_sh, max_segment_size=10 ** 7, iter_max=SHARDED_ITERS))
    wall1, busy1, idle1 = device_idle(lambda: region_grow(
        v1, seeds, max_segment_size=10 ** 7, iter_max=SHARDED_ITERS))
    out = {"phase": "sharded_512", "mesh": "2x2 of cuda:0",
           "median_s": statistics.median(totals), "runs_s": totals,
           "stage_medians_s": medians, "single_device_stages_s": single,
           "grow": rg, "sweeps": sweeps, "launches": counts,
           "segments": n_seg, "mask_voxels": int(res["mask"].sum()),
           "skeleton_voxels": int(res["skeleton"].sum()),
           "halo_bytes_per_iteration": halo_bytes,
           "host_reads_per_iteration": 1,
           "traced_grow_s": wall, "traced_grow_busy_s": busy,
           "traced_grow_idle": idle, "single_grow_traced_s": wall1,
           "single_grow_idle": idle1, "peak_mib": max(peaks),
           "pressure_bit_equal": bit_equal,
           "unsharded_two_runs_rel_spread": spread,
           "max_residual_m3s": resid,
           "pipeline_pressures": res["pressure_batch"] is not None,
           "boundary_pressures_from": bp_from, "flow_nodes": n_nodes,
           "gates": {"a_vesselness": gate_a, "b_mask_skeleton": gate_b,
                     "c_segments": gate_c, "d_pressures": gate_d,
                     "e_launches": gate_e, "f_k6b_blocks": gate_f}}
    log("sharded_512", f"median total {out['median_s']:.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); stage medians "
        f"{', '.join(f'{k} {v:.4f}' for k, v in medians.items())}; the "
        f"single-device composition "
        f"{', '.join(f'{k} {v:.4f}' for k, v in single.items())}; "
        f"grower {rg} ({sweeps} sweeps, K2 {counts['region_grow_sweep']}"
        f", K6b {counts['masked_histogram1']}, K1 "
        f"{counts['frangi_response']}); {n_seg} segments, mask "
        f"{out['mask_voxels']} voxels, skeleton {out['skeleton_voxels']}; "
        f"halo {halo_bytes} bytes per iteration, 1 host read per "
        f"iteration; traced grow {wall:.4f} s, device busy {busy:.4f} s "
        f"({idle:.1%} idle), single-device grower {wall1:.4f} s "
        f"({idle1:.1%} idle); peak device memory {max(peaks):.0f} MiB; "
        f"the pipeline's pressures {out['pipeline_pressures']}; dp rows "
        f"on its {n_nodes}-node network ({bp_from}) bit-equal to the "
        f"unsharded batch, and two unsharded runs to each other, "
        f"{bit_equal}, max "
        f"residual {resid} m^3/s; two unsharded runs differ by "
        f"{spread} (relative); gates {out['gates']}")
    print(json.dumps(out), flush=True)
    if not all(out["gates"].values()):
        raise SystemExit(f"sharded_512: a gate failed: {out['gates']}")
    return counts


def phase_dryrun_multichip():
    """flagship.dryrun_multichip(4) and (8) on the card: the slots repeat
    cuda:0 (one card), the sharded grower, the dp split and the sharded
    mini pipeline on tiny shapes."""
    from arterynetwork_tpu_torch import flagship

    counts = None
    for n in (4, 8):
        reset_counts()
        t0 = time.perf_counter()
        out = flagship.dryrun_multichip(n)
        counts = read_counts()
        log("dryrun_multichip", f"n={n}: {time.perf_counter() - t0:.2f} s; "
            f"region count {out['segmented_count']}; dp pressures "
            f"{tuple(out['pressures'].shape)}; pipeline mask "
            f"{int(out['pipeline']['mask'].sum())} voxels; "
            f"{out['distinct_devices']} distinct card(s); launches "
            f"{counts}")
        if not (out["segmented_count"] > 0
                and counts["region_grow_sweep"] > 0):
            raise SystemExit(f"dryrun_multichip({n}): no growth or no K2")
    return counts


FLOW_DEPTH = 13      # bench.py::bench_flow_large, "16k"
STUDY_DEPTH = 10     # BraVa single-subject scale (~2k segments)
LONG_T = 8           # longitudinal timesteps
STUDY_DRIVERS = ("flow_split", "same_flow", "two_timepoint", "tp_fit",
                 "gbm4", "gbm5", "gbm5b", "distribute")   # the study CLI's


def _sync_s(fn):
    """(result, host seconds of ``fn`` ended by torch.cuda.synchronize())."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median_ms(fn, reps=3):
    """(last result, median ms of ``reps`` synchronised runs after one
    warm-up)."""
    fn()
    runs = [_sync_s(fn) for _ in range(reps)]
    return runs[-1][0], 1e3 * statistics.median(t for _, t in runs)


def _bench_tree(depth):
    """bench.py::_build's tree and ground truth: seeds 0 (tree,
    properties) and 1 (ground truth), k = 1.852."""
    import numpy as np

    from arterynetwork_tpu_torch.flow import create_ground_truth
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    rng = np.random.default_rng(0)
    net = generate_tree(max_depth=depth, rng=rng)
    net = set_network_properties(net, k_value=1.852, rng=rng)
    return net, create_ground_truth(net, option=2,
                                    rng=np.random.default_rng(1))


def _no_launches(phase):
    counts = {k: v for k, v in read_counts().items() if v}
    if counts:
        raise SystemExit(f"{phase}: kernel launches {counts}, expected none")


def phase_flow_determinism(net512):
    """Each flow solve run twice on the card, with no global switch, must
    give the same bits (pressures, flows, residuals, iterations):
    pipeline_512's f32 solve (its network and boundary, as run_pipeline
    solves it), the 16k tree's f32 solves with the elimination plan and
    with CG, and GBMTest5's T = 8 f64 batch on that tree.  (sharded_512's
    gate (d) holds its dp rows to the same rule.)"""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.flow import build_system, create_ground_truth
    from arterynetwork_tpu_torch.flow.longitudinal import (
        build_timestep_batch, solve_timestep_batch)
    from arterynetwork_tpu_torch.flow.solvers import solve_pressure_newton
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
    from arterynetwork_tpu_torch.pipeline import _solve_network

    reset_counts()
    net, gt = _bench_tree(FLOW_DEPTH)
    sys32 = build_system(net, boundary_pressure=gt.pressure,
                         dtype=torch.float32, device="cuda")
    plan = plan_elimination(sys32)
    lnet, parts, radius_end, rng = _study_net(FLOW_DEPTH)
    lgt = create_ground_truth(lnet, option=2, rng=rng)
    batch = build_timestep_batch(lnet, lgt.pressure, radius_end, LONG_T, 1,
                                 partitions=parts)
    flow_cfg = bench_config().flow
    cases = {
        "pipeline_512_f32": lambda: _solve_network(
            net512, {}, flow_cfg, device="cuda")[1],
        "flow_16k_tree_f32": lambda: solve_pressure_newton(
            sys32, max_iter=60, tol=1e-9, linear_solver="auto", plan=plan),
        "flow_16k_cg_f32": lambda: solve_pressure_newton(
            sys32, max_iter=60, tol=1e-9, linear_solver="cg"),
        f"longitudinal_T{LONG_T}_f64": lambda: solve_timestep_batch(
            lnet, batch, dtype=torch.float64, device="cuda"),
    }
    out = {"phase": "flow_determinism", "solves": {}}
    for name, fn in cases.items():
        runs = [fn() for _ in range(2)]
        bits = [b"".join(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                         .tobytes() for x in (s.pressure, s.flow,
                                              s.residual_norm, s.iterations))
                for s in runs]
        sol = runs[0]
        rec = {"bit_equal": bits[0] == bits[1],
               "rel_diff": _rel_diff(runs[0].pressure.cpu(),
                                     runs[1].pressure.cpu()),
               "iterations": np.asarray(sol.iterations.cpu() if torch.is_tensor(
                   sol.iterations) else sol.iterations).tolist(),
               "max_residual_m3s": float(sol.residual_norm.max()),
               "dtype": str(sol.pressure.dtype)}
        out["solves"][name] = rec
        log("flow_determinism", f"{name}: two runs bit-equal "
            f"{rec['bit_equal']} (rel diff {rec['rel_diff']:.3e}); "
            f"iterations {rec['iterations']}, max residual "
            f"{rec['max_residual_m3s']:.3e} m^3/s")
    _no_launches("flow_determinism")
    print(json.dumps(out), flush=True)
    if not all(r["bit_equal"] for r in out["solves"].values()):
        raise SystemExit("flow_determinism: a solve differs between runs")
    return out


def phase_flow_solvers():
    """The flow solvers on the 16k-edge tree and the flagship entry."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch import flagship
    from arterynetwork_tpu_torch.flow import build_system
    from arterynetwork_tpu_torch.flow.solvers import (SolveStats,
                                                      solve_pressure_newton)
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination

    reset_counts()
    out = {"phase": "flow_solvers", "depth": FLOW_DEPTH, "solves": {}}
    net, gt = _bench_tree(FLOW_DEPTH)
    sys32, sys64 = (build_system(net, boundary_pressure=gt.pressure,
                                 dtype=dt, device="cuda")
                    for dt in (torch.float32, torch.float64))
    plan = plan_elimination(sys32)
    out.update(edges=net.num_edges, unknowns=sys32.num_unknown_pressures)
    cases = {
        "tree_f32": (sys32, dict(tol=1e-9, linear_solver="auto", plan=plan),
                     1e-6),
        "cg_f32": (sys32, dict(tol=1e-9, linear_solver="cg"), 1e-6),
        "cg_f64": (sys64, dict(linear_solver="cg"), 1e-9),
    }
    for name, (system, kw, limit) in cases.items():
        sol, ms = _median_ms(lambda: solve_pressure_newton(
            system, max_iter=60, **kw))
        stats = SolveStats()

        def counted():
            return solve_pressure_newton(system, max_iter=60, stats=stats,
                                         **kw)

        # cg f64's ~100k ops would take the tracer tens of seconds to list
        wall, busy, idle = ((None,) * 3 if name == "cg_f64" else
                            device_idle(counted))
        if name == "cg_f64":
            counted()
        p = sol.pressure.double().cpu().numpy()
        err = float(np.nanmax(np.abs(p - gt.pressure) / np.abs(gt.pressure)))
        finite = bool(torch.isfinite(sol.pressure).all()
                      and torch.isfinite(sol.flow).all())
        cg = (None if stats.cg_steps is None
              else int(stats.cg_steps.sum()) / stats.linear_solves)
        rec = {"ms": ms, "newton_iterations": sol.iterations,
               "linear_solves": stats.linear_solves,
               "cg_steps_per_linear_solve": cg,
               "host_reads": stats.host_reads,
               "max_rel_pressure_err": err, "limit": limit,
               "residual_norm": float(sol.residual_norm), "finite": finite,
               "traced_s": wall, "device_busy_s": busy, "device_idle": idle}
        out["solves"][name] = rec
        log("flow_solvers", f"{name}: {ms:.3f} ms per solve, {sol.iterations}"
            f" Newton iterations, {stats.linear_solves} linear solves, CG "
            f"steps per linear solve {cg}, {stats.host_reads} host reads, "
            f"max rel pressure error {err:.3e} (limit {limit}); " + (
                "not traced" if wall is None else f"traced {wall:.4f} s, "
                f"device busy {busy:.4f} s ({idle:.1%} idle)"))
        if not (finite and err <= limit):
            raise SystemExit(f"flow_solvers {name}: error {err} > {limit} "
                             f"or non-finite")
    fwd, args = flagship.entry(device="cuda")
    (p, q), ms = _median_ms(lambda: fwd(*args))
    fsys, fgt = flagship.flagship_system(max_depth=9, device="cuda")
    err = float(np.nanmax(np.abs(p.double().cpu().numpy() - fgt.pressure)
                          / np.abs(fgt.pressure)))
    finite = bool(torch.isfinite(p).all() and torch.isfinite(q).all())
    out["solves"]["flagship_entry"] = {
        "ms": ms, "max_rel_pressure_err": err, "finite": finite,
        "edges": int(fsys.num_edges)}
    log("flow_solvers", f"flagship entry (depth 9, f32 CG): {ms:.3f} ms, "
        f"max rel pressure error {err:.3e}, finite {finite}")
    if not (finite and err <= 1e-5):
        raise SystemExit(f"flagship entry: error {err} or non-finite")
    _no_launches("flow_solvers")
    print(json.dumps(out), flush=True)
    return out


def _study_net(depth, physics="hw"):
    """The study CLI's set-up (``__main__._cmd_study``, seed 0): a tree,
    one compartment per depth-1 node, the first shrunk to 0.85."""
    import numpy as np

    from arterynetwork_tpu_torch.flow import apply_darcy_weisbach
    from arterynetwork_tpu_torch.flow.boundary import bfs_partition
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(max_depth=depth, rng=rng),
                                 rng=rng)
    if physics == "dw":
        net = apply_darcy_weisbach(net)
    roots = np.nonzero(net.node_depth == 1)[0]
    parts = {f"P{i}": {"start_nodes": [int(r)], "boundary_nodes": []}
             for i, r in enumerate(roots)}
    radius_end = net.radius.copy()
    radius_end[bfs_partition(net, parts["P0"]["start_nodes"],
                             [])["visited_edges"]] *= 0.85
    return net, parts, radius_end, rng


def _rel(a, b):
    """max |a - b| / max |b| over arrays, or lists of arrays, flattened."""
    import numpy as np

    def flat(v):
        return np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in
                               (v if isinstance(v, list) else [v])])

    a, b = flat(a), flat(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def phase_longitudinal():
    """GBMTest5 on the depth-13 tree: the batched solve and each row's own
    solve on the card."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.flow import build_system, create_ground_truth
    from arterynetwork_tpu_torch.flow.longitudinal import (
        build_timestep_batch, solve_timestep_batch)
    from arterynetwork_tpu_torch.flow.solvers import (SolveStats,
                                                      solve_pressure_newton)
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination

    reset_counts()
    net, parts, radius_end, rng = _study_net(FLOW_DEPTH)
    gt = create_ground_truth(net, option=2, rng=rng)
    (batch, prep_s) = _sync_s(lambda: build_timestep_batch(
        net, gt.pressure, radius_end, LONG_T, 1, partitions=parts))
    sol, batched_ms = _median_ms(lambda: solve_timestep_batch(
        net, batch, dtype=torch.float64, device="cuda"))
    stats = SolveStats()                # counted in the traced run
    wall, busy, idle = device_idle(lambda: solve_timestep_batch(
        net, batch, dtype=torch.float64, device="cuda", stats=stats))
    rows = []
    for t in range(LONG_T):
        net_t = net.replace(radius=batch["radius_m"][t] / net.spacing,
                            c=batch["c"][t], k=batch["k"][t])
        rows.append(build_system(net_t, batch["boundary_pressure"][t],
                                 device="cuda"))
    plan = plan_elimination(rows[0])

    def one_by_one():
        return [solve_pressure_newton(s, linear_solver="auto", plan=plan)
                for s in rows]

    singles, rows_ms = _median_ms(one_by_one)
    its = sol.iterations.tolist()
    row_its = [s.iterations for s in singles]
    row_rel = max(_rel(s.pressure.cpu(), sol.pressure[t].cpu())
                  for t, s in enumerate(singles))
    resid = sol.residual_norm.cpu().numpy()
    p0, q0 = sol.pressure[0].cpu().numpy(), sol.flow[0].cpu().numpy()
    gt_ok = (np.allclose(p0, gt.pressure, rtol=1e-7, atol=1e-6)
             and np.allclose(q0, gt.flow, rtol=1e-6, atol=1e-15))
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    out = {"phase": "longitudinal", "depth": FLOW_DEPTH, "T": LONG_T,
           "edges": net.num_edges, "batch_prep_s": prep_s,
           "batched_ms": batched_ms, "unbatched_rows_ms": rows_ms,
           "iterations": its, "row_iterations": row_its,
           "batched_host_reads": stats.host_reads,
           "batched_traced_s": wall, "batched_device_busy_s": busy,
           "batched_device_idle": idle,
           "max_residual_m3s": float(resid.max()),
           "row0_vs_ground_truth": bool(gt_ok),
           "max_rel_row_diff": row_rel, "finite": finite}
    log("longitudinal", f"T={LONG_T} on {net.num_edges} edges: batch prep "
        f"{prep_s:.3f} s (host); batched solve {batched_ms:.3f} ms, "
        f"{stats.host_reads} host reads, traced {wall:.4f} s with the "
        f"device busy {busy:.4f} s ({idle:.1%} idle); {LONG_T} unbatched "
        f"solves "
        f"{rows_ms:.3f} ms; iterations {its} (rows alone {row_its}); max "
        f"residual {resid.max():.3e} m^3/s; row 0 on the ground truth "
        f"{gt_ok}; max rel diff batch vs rows {row_rel:.3e}")
    if not (finite and resid.max() < 1e-10 and gt_ok and its == row_its
            and row_rel <= 1e-12):
        raise SystemExit("longitudinal: a gate failed")
    _no_launches("longitudinal")
    print(json.dumps(out), flush=True)
    return out


def _drivers(net, parts, radius_end, rng, store, device, physics):
    """The study CLI's drivers (``__main__._cmd_study``) on ``device``:
    {name: a call returning its result (for the solver drivers, the
    fields to hold against the CPU)}."""
    import os

    import torch

    from arterynetwork_tpu_torch import flow
    from arterynetwork_tpu_torch.flow.distribute import distribute_flow_study
    from arterynetwork_tpu_torch.flow.longitudinal import run_longitudinal

    common = dict(num_timesteps=4, interpolation_option=1, partitions=parts)

    def gbm5():
        gt = flow.create_ground_truth(net, option=2, rng=rng)
        batch, sol = run_longitudinal(net, gt.pressure, radius_end,
                                      dtype=torch.float64, device=device,
                                      **common)
        names = flow.save_gbm_test5_results(store, net, batch, sol)
        back = [store.load_pickle(n) for n in names]
        return {"pressure": sol.pressure.cpu().numpy(),
                "flow": sol.flow.cpu().numpy(), "pickles": len(back),
                "keys": sorted(back[0])}

    def tp_fit():
        out = flow.tp_fit_solve_study(net, radius_end, store=store,
                                      device=device, **common)
        return {"pressure": [r["pressure"] for r in out["timesteps"]],
                "flow": [r["flow"] for r in out["timesteps"]],
                "pickles": sum(1 for n in os.listdir(store.base_dir)
                               if n.startswith("fluidSimulationResultTest6"))}

    def gbm4():
        out = flow.gbm_test4(net, partitions=parts,
                             partition_to_perturb=("P0",), store=store,
                             device=device)
        return {"pressure": out["pressure"], "flow": out["flow"],
                "pickle": sorted(store.load_pickle(
                    "fluidSimulationResultGBMTest4(solvedYear=BraVa, "
                    "perturbNetworkOption=1).pkl")["solvedYear"])}

    def distribute():
        out = distribute_flow_study(net, device=device)
        return {"fractions": out["fractions"], "edge_flow": out["edge_flow"],
                "rms": out["rms_mismatch_mmhg"]}

    if physics == "dw":
        return {"gbm5_dw": gbm5}
    return {
        "flow_split": lambda: flow.flow_split_study(net, radius_end,
                                                    **common),
        "same_flow": lambda: flow.same_flow_study(net, radius_end, **common),
        "two_timepoint": lambda: flow.two_timepoint_comparison(net,
                                                               radius_end),
        "tp_fit": tp_fit, "gbm4": gbm4, "gbm5": gbm5,
        "gbm5b": lambda: flow.gbm_test5b(net, radius_end,
                                         excluded_edges=(), **common),
        "distribute": distribute}


def _finite(v):
    import numpy as np

    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_finite(x) for x in v)
    if isinstance(v, (np.ndarray, float)):
        a = np.asarray(v, np.float64)
        return bool(np.isfinite(a[~np.isnan(a)]).all())
    return True


def phase_studies():
    """The study drivers at depth 10 on the card; the solver drivers also
    on the CPU, which they must equal within 1e-9."""
    import os
    import tempfile

    from arterynetwork_tpu_torch.io import ArtifactStore

    reset_counts()
    out = {"phase": "studies", "depth": STUDY_DEPTH, "seconds": {},
           "cpu_seconds": {}, "max_rel_cpu": {}}
    meta = ("pickles", "keys", "pickle")
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        for physics, name in [("hw", n) for n in STUDY_DRIVERS] + [
                ("dw", "gbm5_dw")]:
            def run(device):
                net, parts, radius_end, rng = _study_net(STUDY_DEPTH,
                                                         physics)
                store = ArtifactStore(os.path.join(tmp, device, name))
                return _drivers(net, parts, radius_end, rng, store, device,
                                physics)[name]()

            res, secs = _sync_s(lambda: run("cuda"))
            out["seconds"][name] = secs
            if not _finite(res):
                raise SystemExit(f"studies {name}: non-finite output")
            msg = f"{name}: {secs:.3f} s on the card"
            if name in ("tp_fit", "gbm4", "gbm5", "gbm5_dw", "distribute"):
                t0 = time.perf_counter()
                ref = run("cpu")
                out["cpu_seconds"][name] = time.perf_counter() - t0
                rel = max(_rel(res[k], ref[k]) for k in res if k not in meta)
                same = all(res[k] == ref[k] for k in meta if k in res)
                out["max_rel_cpu"][name] = rel
                pickles = {k: res[k] for k in meta if k in res}
                msg += (f", {out['cpu_seconds'][name]:.3f} s on the CPU, max "
                        f"rel diff {rel:.3e}; pickles {pickles}")
                if not (rel <= 1e-9 and same):
                    raise SystemExit(f"studies {name}: card and CPU differ "
                                     f"({rel}, pickles {same})")
            log("studies", msg)
    _no_launches("studies")
    print(json.dumps(out), flush=True)
    return out


def phase_figures(result512):
    """The figure paths on the card (--device cuda): the CLI's ``study
    gbm5`` and ``gbm5b`` on the studies_2k tree (depth 10, the CLI's T =
    4) and ``morpho`` with its figures on graph_path_512's bundle, each
    timed, with the figure files and their sizes; then viz's numpy part,
    ``pressure_velocity_arrays`` and ``pressure_velocity_volumes`` of
    pipeline_512's solution.  Where matplotlib does not import, one line
    says so with the number of figure calls not run; each command then
    runs up to its first figure, which must raise ImportError naming
    matplotlib (gbm5's four pickles written before it), and the numpy
    part still runs."""
    import io

    import numpy as np

    from arterynetwork_tpu_torch.__main__ import main as cli
    from arterynetwork_tpu_torch.viz import (pressure_velocity_arrays,
                                             pressure_velocity_volumes)

    reset_counts()
    out = {"phase": "figures", "seconds": {}, "files": {}}
    runs = {
        "study gbm5": ["study", "gbm5", "--depth", str(STUDY_DEPTH)],
        "study gbm5b": ["study", "gbm5b", "--depth", str(STUDY_DEPTH)],
        "morpho": ["morpho", MORPHO_STORE],
    }
    n_figures = {"study gbm5": 4 + 2, "study gbm5b": 1, "morpho": 13}
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if not have_mpl:
        log("figures", f"matplotlib does not import here: "
            f"{sum(n_figures.values())} figure calls not run "
            f"({', '.join(f'{k} {v}' for k, v in n_figures.items())}); "
            f"each command runs up to its first figure, which must "
            f"raise ImportError naming matplotlib")
    for name, argv in runs.items():
        d = (MORPHO_STORE if name == "morpho"
             else os.path.join("build", "figures", name.split()[-1]))
        if d != MORPHO_STORE:
            shutil.rmtree(d, ignore_errors=True)
            argv = argv + ["--out", d]
        before = set(os.listdir(d)) if os.path.isdir(d) else set()
        buf = io.StringIO()
        missing = None
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                cli(argv + ["--device", "cuda"])
            except ImportError as exc:
                if have_mpl or "matplotlib" not in str(exc):
                    raise
                missing = str(exc)
        out["seconds"][name] = time.perf_counter() - t0
        written = sorted(set(os.listdir(d)) - before)
        if not have_mpl:
            log("figures", f"{name}: {out['seconds'][name]:.2f} s up to "
                f"its figures, which raised ImportError ({missing}); "
                f"files written before them: {written}")
            if missing is None or (name == "study gbm5" and len(
                    [f for f in written if f.endswith(".pkl")]) != 4):
                raise SystemExit(f"figures {name}: no ImportError, or the "
                                 f"GBMTest5 pickles missing")
            continue
        summary = json.loads(buf.getvalue())
        files = {f: os.path.getsize(os.path.join(d, f)) for f in written
                 if f.endswith(".png")}
        out["files"][name] = files
        figs = summary.get("figures")        # morpho's {name: path}
        failed = {k: v for k, v in (figs if isinstance(figs, dict)
                                    else {}).items()
                  if str(v).startswith("FAILED")}
        log("figures", f"{name}: {out['seconds'][name]:.2f} s; "
            f"{len(files)} figures: "
            + ", ".join(f"{f} {b}" for f, b in files.items()))
        if failed or len(files) != n_figures[name] or \
                min(files.values(), default=0) <= 1000:
            raise SystemExit(f"figures {name}: {len(files)} files of "
                             f"{n_figures[name]}, failed {failed}")
    # viz's numpy part on pipeline_512's solution
    net, segs = result512["network"], result512["segments"]
    t0 = time.perf_counter()
    parr, varr = pressure_velocity_arrays(segs, range(len(segs)), net,
                                          net.node_pressure,
                                          net.edge_velocity)
    pv, vv = pressure_velocity_volumes(result512["mask"].shape, parr, varr)
    out["seconds"]["pressure_velocity"] = time.perf_counter() - t0
    painted = int(np.count_nonzero(pv))
    log("figures", f"pressure_velocity_arrays/volumes of pipeline_512: "
        f"{out['seconds']['pressure_velocity']:.2f} s, {len(parr)} rows "
        f"for {net.num_edges} edges, {painted} voxels painted, pressure "
        f"{float(pv[pv != 0].min()):.1f}-{float(pv.max()):.1f} Pa, "
        f"|velocity| max {float(vv.max()):.4f} m/s")
    if not (len(parr) == len(varr) > 0 and painted > 0
            and np.isfinite(pv).all() and np.isfinite(vv).all()):
        raise SystemExit("figures: pressure_velocity arrays empty or "
                         "non-finite")
    _no_launches("figures")
    out["matplotlib"] = have_mpl
    print(json.dumps(out), flush=True)
    return out


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

    k1, fused_launches = phase_kernel(raw)
    phase_small()
    launches, result512 = phase_pipeline(phantom, raw)

    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    vol, seed = tube_phantom(RG_SHAPE)
    phase_sweep_cases()
    phase_f64_grow()
    rec = phase_region_grow_kernels(vol, seed)
    grown, ex = phase_region_grow_512(vol, seed)
    vmap = phase_value_map(vol, seed, ex)
    seeded = phase_seeded_pipeline(phantom, raw)
    voxel = phase_voxel_options(phantom, raw)
    graph_k1 = phase_graph_path(phantom, raw)
    t1 = time.perf_counter()
    sharded_counts = phase_sharded_512(raw)
    dryrun_counts = phase_dryrun_multichip()
    log("timing", f"sharded_512 and dryrun_multichip: "
        f"{time.perf_counter() - t1:.1f} s")
    t_flow = time.perf_counter()
    for phase in (lambda: phase_flow_determinism(result512["network"]),
                  phase_flow_solvers, phase_longitudinal, phase_studies,
                  lambda: phase_figures(result512)):
        t1 = time.perf_counter()
        phase()
        log("timing", f"{getattr(phase, '__name__', '<lambda>')}: "
            f"{time.perf_counter() - t1:.1f} s")
    log("timing", f"from the data phase to the flow phases "
        f"{t_flow - t0:.1f} s; the flow phases "
        f"{time.perf_counter() - t_flow:.1f} s")

    paths = {"pipeline_512": {"frangi_response": launches},
             **{f"region_grow_512 {k}": v for k, v in grown.items()},
             "value_map_512": vmap, "seeded_pipeline_512": seeded,
             "voxel_options_512": {"frangi_response": voxel["pipeline"]},
             "graph_path_512": {"frangi_response": graph_k1},
             "frangi_vesselness_chunked": {
                 "frangi_response": voxel["chunked"]},
             "sharded_512": sharded_counts,
             "dryrun_multichip(8)": dryrun_counts,
             "frangi_response_fused": {"frangi_response": fused_launches}}
    log("launches", json.dumps({p: {k: v for k, v in c.items() if v}
                                for p, c in paths.items()}))

    csrc = "arterynetwork_tpu_torch/csrc/"
    kernels = [{
        "name": "frangi_response", "route": "cuda",
        "source": csrc + "frangi_response.cu",
        "replaces": "arterynetwork_tpu/ops/vesselness_fused.py:159",
        "launches": launches,
        "launches_by_path": {p: c["frangi_response"] for p, c in
                             paths.items() if c.get("frangi_response")},
        **k1}]
    for name, source, replaces, n in (
            ("masked_histogram1", "histogram.cu",
             "arterynetwork_tpu/ops/pallas_kernels.py:124",
             seeded["masked_histogram1"]),
            ("masked_histograms2", "histogram.cu",
             "arterynetwork_tpu/ops/pallas_kernels.py:63",
             vmap["masked_histograms2"]),
            ("region_grow_sweep", "region_grow_sweep.cu",
             "arterynetwork_tpu/ops/region_grow_fused.py:64",
             seeded["region_grow_sweep"]),
            ("region_grow_frontier", "region_grow_frontier.cu",
             "arterynetwork_tpu/ops/region_grow_frontier.py:100",
             grown["frontier"]["region_grow_frontier"]),
            ("sign_lookup", "table_lookup.cu",
             "arterynetwork_tpu/ops/pallas_kernels.py:176",
             vmap["sign_lookup"] + vmap["table_lookup"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source, "replaces": replaces,
                        "launches": n,
                        "launches_by_path": {p: c[name] for p, c in
                                             paths.items() if c.get(name)},
                        **rec[name]})
    for k in kernels:               # K2's interior-window entry
        if k["name"] == "region_grow_sweep":
            k["window"] = rec["region_grow_sweep window"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
