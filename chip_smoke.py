#!/usr/bin/env python3
"""Smoke test of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

  1. device  — the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. builds  — the six CUDA sources (nvcc, sm_90a, all started together:
               K1, K6, K2, K5, K7 and graph_while, the growers' while
               graph) and the native C++ library (g++), from this
               checkout's sources, with ptxas's register and spill lines;
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
               touching one face, x cuts, heights that the launcher
               splits into strips of unequal height, and each
               halo-padded block of a 2x2 mesh at 512x512x170) and K5
               against their plain
               versions on hard inputs:
               Bernoulli(0.5) states with random decision words, all-
               and none-segmented volumes, ragged shapes, padded calls,
               a view not on a 16-byte boundary; K5 with ragged last
               tiles, nact < k_pad, nact = 0, nb 1 and 3.  Exact;
     f64_grow — region_grow "auto" on an f64 tube on the card takes the
               f64 full-grid path (no K2) and equals the CPU's; the
               voxels where the f32 fused grower differs are counted;
  7. region_grow_kernels — K6b, K6a, K2 (and the banded entries K3/K4
               run on it), K5 and K7 (sign, f32 and f64 values) against
               their plain PyTorch versions on the card, at the region-grow
               path's shapes (bench.py's 512x512x170 tube phantom and its
               state after 20 iterations), K7's values also on uniform
               random uint8 bins (f32, f64) and on the tube's bins as
               int32: equal outputs; device and call
               times of kernel, plain version and, where one PyTorch call
               computes the same function, that call; each kernel's bound;
               K2's window on a 258x258x170 block through the wrapper
               into buffers made once, timed as bare launches (the ctypes
               call alone); K5's fixed cost (no tile active);
     graph_while — csrc/graph_while.cu's two one-thread kernels
               (set_while, count_step: the WHILE and IF nodes' handles
               and the count of steps run) in a while graph around one
               and two one-element steps, 300 passes, against the plain
               loop (the host reads stop and runs the next step): the
               same steps, state and stop; each kernel's device time per
               launch from a trace, its plain version's time, its bound;
  8. region_grow_512 — bench.py's bench_region_grow workload through
               region_grow "auto" (K2 + K6b), "xla" (K6b + K7) and
               region_grow_frontier (K5 + K6b), then "xla" with an
               excluded slab (K6a + K7); each grower driven by its while
               graph (ops/grow_loop.py: the first pass eager, every later
               one from captured CUDA graphs in one launch of a graph
               with a conditional WHILE node), by the eager loop with the
               kernels and by the eager loop with the plain versions on
               the card: the three identical (mask, active map,
               iterations, count, stop reason), the graph run with the
               eager run's K1-K7 launches, one while-graph launch, a
               captured graph run for every pass after the first, the
               while graph's kernels, as they counted themselves on the
               device, once per step (count_step) and once per WHILE
               iteration plus once (set_while), and
               min(passes, 2) + 1 host reads of stop (the eager loop's
               one per pass plus one); one
               (iterations, count) and one mask for auto, xla and
               frontier; graph and eager times, host reads per grow, and
               one traced run of each grower for the device's idle share;
  9. value_map_512 — the reference's interface, region_grow_value_map,
               on the tube with the excluded slab as state 4: one warm-up
               and three timed runs (K6a + K7 per iteration, the value map
               rebuilt on the card), driven by the while graph (the
               counts of region_grow_512's), equal to the "xla" excluded
               grower and to a run of the eager loop;
 10. seeded_pipeline_512 — run_pipeline(raw_volume, seed_mask) on the
               pipeline_512 phantom, seeded with the 3x3x3 cube at the
               tree's root: one warm-up and three timed runs, finite
               pressures and flows, at least one segment, each run's
               grower driven by graphs; the segmentation stage's grower
               on its own, graph, eager and plain (as region_grow_512).
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
               voxel crop), and the full-size LUT thinning, driven by
               captured graphs (a wave and a final pass), equals the eager
               loop and the pipeline's skeleton bit for bit, with the same
               passes, 1 + passes host reads, one graph per loop that ran
               twice and a replay per later pass (wall, busy, idle traced
               and untraced), (d) the full-size skeleton lies in the mask,
               has no deletable voxel left and as many 26-components, (e)
               the simple-point table built on the card equals the native
               predicate (2^20 sampled codes, and the native table on all
               2^26), (f) connected_components at 64 rounds and to
               convergence, each graph-driven and equal to the eager loop
               (one host read per round, one graph, rounds - 1 replays),
               gives the native partition,
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
               skeleton equal to the single-device composition (its
               thinning driven by graphs, equal to its eager loop with
               the counts of voxel_options_512's (c)), (c) a segment,
               (d) the dp pressure rows equal to the
               unsharded batch's and two unsharded runs bit-equal (no
               global switch), (e) K2 4 times per sweep (its interior
               window) and K6b 8 times, (f) K6b on each padded block
               (int32, own-box and seed masks) equal to its plain
               version; halo bytes per iteration, the bytes the grower's
               halo refresh copies per sweep (and those re-padding every
               block would write), the device bytes the grower
               allocates per sweep, peak device memory; then the
               sharded grow and the sharded thinning on the "graph"
               route (each sweep or pass a captured CUDA graph; the
               grow's sweeps after the first in one while-graph launch,
               the thinning's passes replayed), each against the eager
               loop (eager_loop()): the grow bit-equal with the same
               K1-K7 launches and region_grow_512's while-graph counts
               (host reads per iteration computed); the thinning
               bit-equal and equal to the single-device skeleton, 1 +
               passes host reads, each key captured on its second pass;
               captures, replays, capture seconds, and each one's busy
               time and idle share, traced and untraced.
     dryrun_multichip — flagship.dryrun_multichip(4) and (8) on the card.
     Speck scale, 880x880x640 (BASELINE.md config 5), each phase's data
     made on the host from seeds and timed apart, each phase's tensors
     freed before the next:
     speck_pipeline — bench.py::bench_speck_pipeline: run_pipeline on the
               800-branch phantom (root radius 7) with its configuration
               (pipeline_512's with the bq3 wire): one warm-up and two
               timed runs, 76 K1 launches each (4 scales x 19 slabs),
               every slab decoded from 3 bits, mask recall >= 0.95,
               finite pressures and flows, a segment; per-stage medians
               and minima, peak device memory, the tree-recovery metrics;
     speck_region_grow — bench.py::bench_speck_region_grow: the tube
               phantom (radius 3), 60 iterations, 10^7 voxels, through
               "auto" (K2 + K6b), "xla" (K6b + K7) and the frontier
               grower (K5 + K6b), one timed run each after a warm-up,
               graph-driven, eager and plain as in region_grow_512: one
               fixed point and one mask; the bins past 2^24 at iteration
               0 and the decision-table signs they move; then
               frangi_vesselness_chunked (sigmas 1, 2, 3; 110-row slabs):
               24 K1 launches, within K1's bound of its twin;
     speck_kernels — K1 on a smoothed (68, 880, 640) slab, K6b, K6a, K2,
               K3/K4 (padded to (880, 896, 640)), K5 and K7 (sign, f32
               and f64 values) on the Speck tube's
               state after 20 iterations, K2 on each halo-padded block of
               a 2x2 mesh of it (the block with the most boundary
               voxels timed as bare launches), then n = 2^31 + 33 uint8
               bins (K6b on
               random bins and on one bin holding them all, K7 sign and
               f32 values):
               each against its plain version, exact but K1, with ms,
               bounds and library-call ms;
     speck_sharded — sharded_512's phase on the Speck raw volume, one
               warm-up and one timed run, gates (a)-(e), the sharded
               grow's and thinning's graph-driven runs against their
               eager loops as there, the whole-volume
               vesselness's peak memory with its per-voxel passes in one
               slab and in slabs (bit-equal), whether the ground truth is
               feasible.
 Every flow solve from here on, and pipeline_512's and speck_pipeline's
 flow stage, runs driven by captured CUDA graphs (flow/solvers.py on
 ops/grow_loop.py): each must run in a graph loop that replayed graphs
 if it ran a step more than once.
 11. flow_determinism — each solve run twice on the card gives the
               same bits: pipeline_512's f32 solve, the 16k tree's f32
               tree and CG solves, GBMTest5's T = 8 f64 batch (the flow
               sums run in a fixed order, flow/segment_sum.py);
     flow_solvers — bench.py::bench_flow_large's 16k-edge tree (depth
               13, 8,190 unknowns) solved f32 at tol 1e-9 with "auto" and
               the elimination plan (tree) and with "cg", f64 "cg" at the
               default tol 1e-14, and the flagship entry (depth 9, f32
               CG): ms per solve (median of 3 after a warm-up), graph-
               driven and in the eager loop (eager_loop()), which must
               agree bit for bit with the same host reads, linear solves
               and CG steps; Newton iterations, CG steps per linear
               solve, host reads, graphs captured, replays and capture
               seconds per solve, the idle share of a traced run (but CG
               f64's), max relative pressure error against the ground
               truth (<= 1e-6 f32, <= 1e-9 f64);
 12. longitudinal — GBMTest5 on the depth-13 tree, T = 8, f64, "auto"
               with the plan: the batched solve graph-driven and in the
               eager loop (bit-equal, the same host reads), against T
               unbatched solves (same iterations, pressures within
               1e-12), every residual < 1e-10 m^3/s, row 0 on the ground
               truth;
 13. studies — the study CLI's eight drivers at depth 10 (and gbm5 on
               the Darcy-Weisbach network): seconds per driver, the
               graphs its solves captured and replayed, finite outputs,
               the solver drivers equal to the port on the CPU within
               1e-9, pickles written and read back; distribute's
               Gauss-Newton fit graph-driven (40 steps: 1 capture, 39
               replays) and within 1e-9 of its eager loop on the card.
 14. figures — the CLI's study gbm5 and gbm5b (depth 10, T = 4) and
               morpho with its 13 figures on graph_path_512's bundle, on
               the card: seconds and figure files with their sizes (each
               > 1000 bytes, none FAILED); pressure_velocity_arrays and
               _volumes of pipeline_512's solution.  Without matplotlib
               one line says how many figure calls did not run.
 Phases 11-14 launch none of the repository's kernels (checked).

A kernel's "ms" is its own kernels' device time per call from a
torch.profiler trace that holds all of their events (else, after three
traces, its "call_ms": "timed_by" says which; the plain version's and
the library call's: all their device events; K2's window: bare launches, a
trace of them, else CUDA events around 20 of them), "call_ms" the
CUDA-event time of one call, host wrapper included; "bound_ms" the larger of the bytes this run's data
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


def device_ms(fn, own=False, reps=10, tries=3):
    """(device milliseconds per call of ``fn``, or None when the trace
    holds no device event; the events by name).  torch.profiler traces
    ``reps`` calls after two warm-up steps, each call synchronised; the
    profiler's own buffer and step annotations do not count.  ``own``
    keeps only this repository's kernels (csrc/*.cu, in an anonymous
    namespace), not the wrapper's fills and casts, and takes a trace
    that holds each of them ``reps`` times (up to ``tries`` traces, else
    None: a trace that drops events also misreports the durations of
    those it keeps).  Otherwise the trace may drop a few events, and
    each name counts its mean duration times its events per call,
    ceil(count / reps)."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries if own else 1):
        events = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=reps),
                     on_trace_ready=lambda p: events.extend(p.events())) \
                as prof:
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
        names = [f"{len(d)} x {k[:50]}" for k, d in sorted(by_name.items())]
        if not own:
            us = sum(statistics.mean(d) * math.ceil(len(d) / reps)
                     for d in by_name.values())
            return (us / 1e3 if us > 0 else None), names
        if by_name and all(len(d) == reps for d in by_name.values()):
            return sum(map(statistics.mean, by_name.values())) / 1e3, names
    return None, names


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


def k2_launcher(seg, bins, words, window, lib=None):
    """(a function that launches K2 once over ``window`` of the CUDA
    tensors into preallocated buffers, out, dh): the ctypes call alone,
    with no checks and no allocation, for bare-launch timing; dh adds up
    over calls.  ``lib``: another build of csrc/region_grow_sweep.cu."""
    import torch

    fused = _ops("region_grow_fused")
    fn = (lib or fused._kernel_lib()).region_grow_sweep
    out = torch.empty_like(seg)
    dh = torch.zeros((2, 256), dtype=torch.int32, device=seg.device)
    args = fused._launch_args(seg, bins, words, tuple(seg.shape[1:]),
                              window, out, dh)

    def launch():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"region_grow_sweep: CUDA error {rc}")

    return launch, out, dh


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


def _k1_compare(phase, sm, g, sigma, bright, z_lo, zr, label):
    """K1 and its twin on one smoothed field: (max |d|, measure() of each)."""
    import torch

    from arterynetwork_tpu_torch.ops.vesselness_fused import (
        frangi_response_max_, frangi_response_plain_)

    dev = sm.device
    ref = torch.zeros((zr,) + tuple(sm.shape[1:]), device=dev)
    out = torch.zeros_like(ref)
    frangi_response_plain_(ref, 0, sm, z_lo, zr, sigma, g, bright=bright)
    frangi_response_max_(out, 0, sm, z_lo, zr, sigma, g, bright=bright)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    m_k = measure(lambda: frangi_response_max_(
        out, 0, sm, z_lo, zr, sigma, g, bright=bright), own=True)
    m_p = measure(lambda: frangi_response_plain_(
        ref, 0, sm, z_lo, zr, sigma, g, bright=bright))
    log(phase, f"{label}: max|d| {err:.3e}, kernel {_ms(m_k[0])} ms"
        f" on the device ({m_k[1]:.4f} ms per call), twin "
        f"{_ms(m_p[0])} ms ({m_p[1]:.4f} ms per call); max response "
        f"{float(ref.max()):.4f}")
    if not err <= K1_TOL:
        raise SystemExit(f"K1 disagrees with its twin: {err} > {K1_TOL}")
    return err, m_k, m_p


def _k1_slab(phase, raw):
    """K1 against its twin on a smoothed slab of ``raw`` as the streamed
    driver smooths it (48 rows and a halo of 10 each side), per scale of
    the pipeline: (max |d|, the kernel's record over the four scales,
    the slab on the card)."""
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import (_frobenius_max,
                                                        _smooth)

    halo, chunk_z = 10, 48        # the pipelines' chunk geometry
    slab = torch.from_numpy(np.ascontiguousarray(
        raw[200:200 + chunk_z + 2 * halo])).cuda()
    max_err, ms, plain_ms = 0.0, [], []
    for sigma in (0.75, 1.0, 2.0, 3.0):
        sm = _smooth(slab, sigma)
        g = (_frobenius_max(sm, sigma, halo, chunk_z) * 0.5).reshape(())
        err, m_k, m_p = _k1_compare(phase, sm, g, sigma, True, halo,
                                    chunk_z, f"sigma {sigma} bright "
                                    f"{tuple(sm.shape)}")
        max_err = max(max_err, err)
        ms.append(m_k)
        plain_ms.append(m_p)
    # per launch: the rows of sm it reads (one beyond each end of the
    # chunk), best read and written
    zs, plane = slab.shape[0], slab.shape[1] * slab.shape[2]
    rows = min(halo + chunk_z + 1, zs) - max(halo - 1, 0)

    def mean(ts):                  # over the four scales
        return tuple(None if None in c else statistics.mean(c)
                     for c in list(zip(*ts))[:2])

    rec = timing(mean(ms), mean(plain_ms), 4 * plane * (rows + 2 * chunk_z),
                 K1_OPS_PER_VOXEL * plane * chunk_z)
    log(phase, f"K1 on {tuple(slab.shape)}: bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}): {rec['bound_ms'] / rec['ms']:.1%} of it")
    return max_err, rec, slab


def phase_kernel(raw):
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import (_frobenius_max,
                                                        _smooth)
    from arterynetwork_tpu_torch.ops.vesselness_fused import (
        frangi_response_fused, frangi_response_max_, frangi_response_plain_)

    dev = torch.device("cuda")
    halo, chunk_z = 10, 48
    max_err, rec, slab = _k1_slab("kernel", raw)

    sm = _smooth(slab, 2.0)
    g = (_frobenius_max(sm, 2.0, halo, chunk_z) * 0.5).reshape(())
    err, _, _ = _k1_compare("kernel", sm, g, 2.0, False, halo, chunk_z,
                            f"sigma 2.0 dark {tuple(sm.shape)}")
    max_err = max(max_err, err)
    rag = _smooth(slab[:40, :509, :167].contiguous(), 1.0)
    g = (_frobenius_max(rag, 1.0, 5, 30) * 0.5).reshape(())
    err, _, _ = _k1_compare("kernel", rag, g, 1.0, True, 5, 30,
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


def phase_pipeline(phantom, raw, phase="pipeline_512", cfg=None, timed=3):
    """run_pipeline on ``raw`` with ``cfg`` (pipeline_512's by default):
    one warm-up and ``timed`` timed runs, each with the K1 launches the
    streamed driver's slabs give, finite pressures and flows, mask recall
    >= 0.95.  Returns (K1 launches of the last run, its result, the
    timed runs' {"totals", "timings", "peaks_mib", "recall"})."""
    import torch

    from arterynetwork_tpu_torch.ops import vesselness
    from arterynetwork_tpu_torch.ops.vesselness_fused import \
        frangi_response_max_
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    cfg = cfg or bench_config()
    want = vesselness.k1_launches(raw.shape[0], cfg.vesselness.sigmas,
                                  vesselness.STREAMED_CHUNK_Z,
                                  streamed=True)
    runs = {"totals": [], "timings": [], "peaks_mib": []}
    launches = []
    for i in range(timed + 1):            # run 0 is the warm-up
        frangi_response_max_.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with solve_loops() as loops:
            result = run_pipeline(raw_volume=raw, config=cfg, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        n = frangi_response_max_.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        launches.append(n)
        graphs = _graph_solves(f"{phase} flow", loops)
        stages = ", ".join(f"{k} {v:.4f}" for k, v in
                           result["timings"].items())
        log(phase, f"run {i}{' (warm-up)' if i == 0 else ''}: "
            f"total {total:.4f} s; K1 launches {n}; peak device memory "
            f"{peak:.0f} MiB; stages (s): {stages}; flow solve graphs "
            f"{graphs}")
        if i:
            runs["totals"].append(total)
            runs["timings"].append(dict(result["timings"]))
            runs["peaks_mib"].append(peak)
    sol = result["solution"]
    mask = result["mask"]
    recall = float(mask[phantom["mask"]].astype(bool).mean())
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    runs["recall"] = recall
    log(phase, f"median total {statistics.median(runs['totals']):.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in runs['totals'])}); mask "
        f"voxels {int(mask.sum())}; segments {len(result['segments'])}; "
        f"flow edges {result['network'].num_edges}; mask recall "
        f"{recall:.4f}; residual {float(sol.residual_norm):.3e} after "
        f"{sol.iterations} Newton iterations; pressures/flows finite "
        f"{finite}; peak device memory {max(runs['peaks_mib']):.0f} MiB")
    if any(n != want for n in launches):
        raise SystemExit(f"{phase}: K1 launches per run {launches}, "
                         f"expected {want}")
    if not finite:
        raise SystemExit(f"{phase}: non-finite pressures or flows")
    if not recall >= RECALL_MIN:
        raise SystemExit(f"{phase}: mask recall {recall} < {RECALL_MIN}")
    if sol.pressure.shape[0] != result["network"].num_nodes:
        raise SystemExit(f"{phase}: pressure vector does not match the "
                         f"network")
    if not result["segments"]:
        raise SystemExit(f"{phase}: no segment")
    return launches[-1], result, runs


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
        "set_while": _ops("graph_while").set_while,
        "count_step": _ops("graph_while").count_step,
    }


WHILE_KERNELS = ("set_while", "count_step")     # csrc/graph_while.cu


def _k1_k7(counts):
    """The launch counts of K1-K7 alone (those of the while graph's two
    kernels left out: the eager loop launches none)."""
    return {k: v for k, v in counts.items() if k not in WHILE_KERNELS}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counted().items()}


def reset_loop_counts():
    loop = _ops("grow_loop")
    loop.read_stop.reads = 0
    loop.graph_loop.captures = loop.graph_loop.replays = 0
    loop.graph_loop.launches = 0
    loop.graph_loop.capture_s = 0.0


def loop_counts():
    """The growers' host reads of ``stop``, graphs captured, steps run
    from them (replays), while graphs launched, seconds spent capturing
    and building the while graphs."""
    loop = _ops("grow_loop")
    return {"reads": loop.read_stop.reads,
            "captures": loop.graph_loop.captures,
            "replays": loop.graph_loop.replays,
            "launches": loop.graph_loop.launches,
            "capture_s": loop.graph_loop.capture_s}


@contextlib.contextmanager
def eager_loop():
    """Run the growers' steps, the flow solver's, the device thinning's
    and the components' in the eager host loop on the card too (their
    loops, ``grow_loop.drive`` and ``grow_loop.loop_for``, replay
    captured graphs for CUDA tensors)."""
    loop = _ops("grow_loop")
    drive, loop_for = loop.drive, loop.loop_for
    loop.drive = loop.host_loop
    loop.loop_for = lambda *args, **kw: loop.HostLoop()
    try:
        yield
    finally:
        loop.drive, loop.loop_for = drive, loop_for


def _graph_loop_counts(*passes):
    """(captures, replays) of a GraphLoop whose keys ran ``passes``
    times each: a key's first run eager, its second captured (and
    replayed), every later one replayed."""
    return (sum(n >= 2 for n in passes),
            sum(max(n - 1, 0) for n in passes))


def _loop_fn_counts(fn, keys):
    """The counts a loop function (skeletonize, connected_components)
    keeps of its last call: ``keys`` (passes) and the loop's own."""
    return {**{k: getattr(fn, k) for k in keys},
            **{k: getattr(fn, k) for k in ("reads", "captures", "replays",
                                           "capture_s")}}


def _graph_vs_eager(phase, label, fn, counts_of, passes_of, reads_of):
    """``fn()`` on the card driven by captured graphs and in the eager
    loop (``eager_loop()``): the same bits (a tensor), the same passes
    and host reads (``reads_of(counts)``), and the captures and replays
    GraphLoop makes of those passes (``passes_of(counts)``, by key).
    -> (result, counts, graph s, eager s)."""
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, counts_of(), time.perf_counter() - t0

    out, c, secs = run()
    with eager_loop():
        e_out, ec, e_secs = run()
    passes = passes_of(c)
    captures, replays = _graph_loop_counts(*passes)
    same = torch.equal(out, e_out)
    ok = (same and passes == passes_of(ec) and c["reads"] == ec["reads"]
          == reads_of(c) and (c["captures"], c["replays"])
          == (captures, replays) and ec["captures"] == ec["replays"] == 0
          and (max(passes) < 2 or c["replays"] > 0))
    log(phase, f"{label}: graph-driven {secs:.4f} s, eager loop "
        f"{e_secs:.4f} s; passes {passes} (eager {passes_of(ec)}), host "
        f"reads {c['reads']} (eager {ec['reads']}, expected "
        f"{reads_of(c)}), graphs captured {c['captures']} in "
        f"{c['capture_s']:.4f} s (expected {captures}), replays "
        f"{c['replays']} (expected {replays}); bit-equal {same}")
    if not ok:
        raise SystemExit(f"{phase} {label}: the graph-driven run {c} "
                         f"against the eager loop {ec}, equal {same}")
    return out, c, secs, e_secs


def thin_graph_vs_eager(phase, label, mask, **kw):
    """``skeletonize(mask, **kw)`` (the lut route) through
    ``_graph_vs_eager``: reads = 1 + wave passes + final passes."""
    fn = _ops("thinning").skeletonize
    return _graph_vs_eager(
        phase, label, lambda: fn(mask, **kw),
        lambda: _loop_fn_counts(fn, ("wave_passes", "final_passes")),
        lambda c: (c["wave_passes"], c["final_passes"]),
        lambda c: 1 + c["wave_passes"] + c["final_passes"])


def cc_graph_vs_eager(phase, label, mask, **kw):
    """``connected_components(mask, **kw)`` through ``_graph_vs_eager``:
    one host read per round."""
    fn = _ops("cc").connected_components
    return _graph_vs_eager(
        phase, label, lambda: fn(mask, **kw),
        lambda: _loop_fn_counts(fn, ("rounds",)),
        lambda c: (c["rounds"],), lambda c: c["rounds"])


@contextlib.contextmanager
def solve_loops():
    """Collect the loop objects the flow solves inside make
    (``grow_loop.loop_for``): a list, filled as they run."""
    loop = _ops("grow_loop")
    loop_for, made = loop.loop_for, []

    def tracked(*args, **kw):
        made.append(loop_for(*args, **kw))
        return made[-1]

    loop.loop_for = tracked
    try:
        yield made
    finally:
        loop.loop_for = loop_for


def _graph_solves(label, loops):
    """Fail unless every flow solve of ``loops`` ran in a GraphLoop and
    each that ran a step more than once (a second Newton, CG or
    refinement step) replayed captured graphs -> their counts."""
    g = _ops("grow_loop").GraphLoop
    counts = {"solves": len(loops),
              "captures": sum(lp.captures for lp in loops),
              "replays": sum(lp.replays for lp in loops),
              "capture_s": sum(lp.capture_s for lp in loops),
              "reads": sum(lp.reads for lp in loops)}
    bad = [lp for lp in loops if not isinstance(lp, g) or (
        max(lp.runs.values(), default=0) > 1 and not lp.replays)]
    if bad or not loops:
        raise SystemExit(f"{label}: {len(bad)} of {len(loops)} solves not "
                         f"driven by captured graphs ({counts})")
    return counts


def _graph_driven(label, res, loops, counts, steps):
    """Fail unless the grow behind ``res`` (``steps`` step functions)
    ran every pass after the first from captured graphs, all in one
    launch of the while graph (none captured or launched for one pass or
    none), read ``stop`` min(passes, 2) + 1 times, and launched the while
    graph's kernels as often as it ran: ``count_step`` once a pass after
    the first, ``set_while`` once before the WHILE node and once per
    iteration of it (ceil((passes - 1) / steps)).  The two kernels count
    their own launches on the device, and ``passes`` comes from the
    grower's own iteration count (equal to the eager loop's, which read
    ``stop`` once a pass), so a while graph without its head or tail
    node, or whose body ran too often, fails here."""
    passes = int(res.iterations) + (int(res.stop_reason) == 0)
    looped = passes > 1
    whiles = -(-(passes - 1) // steps) if looped else 0
    ok = (loops["reads"] == min(passes, 2) + 1
          and loops["replays"] == max(passes - 1, 0)
          and loops["launches"] == int(looped)
          and (loops["captures"] > 0) == looped
          and counts["count_step"] == max(passes - 1, 0)
          and counts["set_while"] == (1 + whiles) * looped)
    if not ok:
        raise SystemExit(f"{label}: {passes} passes, loop counts {loops}, "
                         f"while-graph kernels set_while "
                         f"{counts['set_while']}, count_step "
                         f"{counts['count_step']}: not every pass after "
                         f"the first in one while-graph launch with "
                         f"min(passes, 2) + 1 stop reads")


def _same_grow(a, b):
    """The two RegionGrowResults agree in mask, active map, iterations,
    count and stop reason."""
    import torch

    return (torch.equal(a.segmented_map, b.segmented_map)
            and torch.equal(a.active_map, b.active_map)
            and [int(a.iterations), int(a.segmented_count),
                 int(a.stop_reason)]
            == [int(b.iterations), int(b.segmented_count),
                int(b.stop_reason)])


@contextlib.contextmanager
def plain_kernels():
    """Route the region growers to the kernels' plain versions for CUDA
    tensors too (the wrappers launch the kernels for every CUDA tensor),
    by swapping the names the growers call, and their loop to the eager
    host loop (the plain versions synchronise, so they cannot be
    captured)."""
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
        with eager_loop():
            yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def _max_err(outs, refs, step=1 << 28):
    """max |a - b| over the pairs, in f64, ``step`` elements at a time
    (an output of 2^31 elements would need 17 GB per f64 copy)."""
    def err(a, b):
        a, b = a.reshape(-1), b.reshape(-1)
        return max((float((a[i:i + step].double() - b[i:i + step].double())
                          .abs().max())
                    for i in range(0, a.numel(), step)), default=0.0)

    return max(err(a, b) for a, b in zip(outs, refs))


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


def _window_case(seg_b, bins_b, words, win, n_bnd_win):
    """K2's interior-window entry on one halo-padded block as a
    ``_run_cases`` case: the wrapper writing into buffers made once (the
    sharded grower's call, which allocates nothing), against the plain
    version; the bound counts the block read and written once."""
    import torch

    fused = _ops("region_grow_fused")
    out = torch.empty_like(seg_b)
    dh = torch.zeros((2, 256), dtype=torch.int32, device=seg_b.device)
    return (
        lambda: _in_window(fused.fused_sweep_counts(
            seg_b, bins_b, words, window=win, out=out, dh=dh.zero_()), win),
        lambda: _in_window(fused.fused_sweep_plain(
            seg_b, bins_b, words, window=win), win),
        2 * seg_b.numel() + n_bnd_win + 2 * 256 * 4, None)


def _time_window_bare(phase, r, seg_b, bins_b, words, win):
    """Times the window case as bare launches (the ctypes call alone):
    CUDA events around 20 back-to-back launches ("bare_ms") and a trace
    of them ("bare_trace_ms", None if every trace dropped events); the
    record's "ms" becomes the trace where it held every event, else the
    events, so that no window time includes the Python wrapper."""
    from kernel_probe import events_ms

    launch, _, _ = k2_launcher(seg_b, bins_b, words, win)
    r["bare_ms"] = events_ms(launch)
    r["bare_trace_ms"] = device_ms(launch, own=True)[0]
    r["ms"] = r["bare_trace_ms"] or r["bare_ms"]
    r["timed_by"] = ("bare launches, trace" if r["bare_trace_ms"]
                     else "bare launches, events")
    log(phase, f"region_grow_sweep window, bare launches: events "
        f"{r['bare_ms']:.4f} ms, trace {_ms(r['bare_trace_ms'])} ms; "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def _window_cases(fused, state, same):
    """K2 with an interior window (the sharded grower's call) against its
    plain version: windows of one plane, one row and one voxel, windows
    touching one face of the block only, an x cut, heights split into
    strips of unequal height (into caller buffers), a padded region, an
    unaligned view, and each halo-padded block of a 2x2 mesh at the
    path's shape, whose interiors reassemble the whole volume's sweep and
    whose deltas sum to its."""
    import torch
    import torch.nn.functional as F

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
    # heights that the launcher splits into strips of unequal height: 257
    # rows of 170 (5 strips of 52, the last 49), 253 (4 of 64, the last
    # 61), 33 rows of 513 (2 of 17, the last 16); into caller buffers
    for shape, window in (((20, 258, 170), ((1, 19), (0, 257), (0, 170))),
                          ((20, 258, 170), ((1, 19), (2, 255), (0, 170))),
                          ((20, 33, 513), ((0, 20), (0, 33), (0, 513)))):
        seg, bins, words = state(shape)
        out = torch.empty_like(seg)
        dh = torch.zeros((2, 256), dtype=torch.int32, device=seg.device)
        same(f"K2 window {window} {shape} into caller buffers",
             _in_window(fused.fused_sweep_counts(
                 seg, bins, words, window=window, out=out, dh=dh), window),
             _in_window(fused.fused_sweep_plain(seg, bins, words,
                                                window=window), window))
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
    return n + _mesh_windows(fused, *state(RG_SHAPE), same)


def _mesh_windows(fused, seg, bins, words, same):
    """K2 on each halo-padded block of a 2x2 mesh over its interior
    window against its plain version (the sharded grower's calls), the
    interiors reassembled into the whole volume's sweep and the deltas
    summed to its; returns the number of blocks."""
    import torch

    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       pad_halos,
                                                       shard_volume)

    whole = fused.fused_sweep_plain(seg, bins, words)
    mesh = make_volume_mesh([seg.device] * 4)
    seg_p = pad_halos(shard_volume(seg, mesh), 1)
    bins_p = pad_halos(shard_volume(bins, mesh), 1)
    dh = torch.zeros_like(whole[1])
    n = 0
    for idx in seg_p.source.indices():
        args = (seg_p.blocks[idx], bins_p.blocks[idx], words)
        win = seg_p.window(idx)
        out = fused.fused_sweep_counts(*args, window=win)
        same(f"K2 on the padded block {idx} {tuple(args[0].shape)} of a "
             f"2x2 mesh", _in_window(out, win),
             _in_window(fused.fused_sweep_plain(*args, window=win), win))
        seg_p.blocks[idx] = out[0]
        dh += out[1]
        n += 1
    same("K2's 2x2 blocks reassembled", (seg_p.crop().gather(), dh), whole)
    return n


def _mesh_block(seg, bins, bnd):
    """The block of a 2x2 mesh of the state with the most boundary voxels,
    with its one-voxel halo (the sharded grower's K2 call): (its index,
    seg block, bins block, window, the boundary voxels in the window)."""
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       pad_halos,
                                                       shard_volume)

    mesh = make_volume_mesh([seg.device] * 4)
    own = shard_volume(bnd, mesh)
    n_bnd = {idx: int(own.blocks[idx].sum()) for idx in own.indices()}
    idx = max(n_bnd, key=n_bnd.get)
    seg_p = pad_halos(shard_volume(seg, mesh), 1)
    bins_p = pad_halos(shard_volume(bins, mesh), 1)
    return (idx, seg_p.blocks[idx], bins_p.blocks[idx], seg_p.window(idx),
            n_bnd[idx])


def _grow_state(phase, vol, seed, max_segment_size):
    """The region-growing kernels' inputs at the path's shapes: the tube
    phantom's bins and its state after 20 full-grid iterations, the
    decision table of that state, its boundary and active tiles."""
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import (
        _bin_ids, _decision_table, _gaussian_kernel, _quantize, region_grow)
    from arterynetwork_tpu_torch.ops.stencil import dilate26

    hk, fused = _ops("histogram_kernels"), _ops("region_grow_fused")
    front = _ops("region_grow_frontier")
    data = torch.from_numpy(vol).cuda()
    res = region_grow(data, torch.from_numpy(seed).cuda(), backend="xla",
                      max_segment_size=max_segment_size, iter_max=20)
    seg = res.segmented_map
    idx, values = _quantize(data, 256)
    del data
    bins = _bin_ids(idx, 256).contiguous()
    del idx
    flat = bins.reshape(-1)
    masks = torch.stack([seg.reshape(-1), ~seg.reshape(-1)])
    K = _gaussian_kernel(values, 2.25, torch.float32)
    hist_all = hk.masked_histogram1(flat, torch.ones_like(masks[0]))
    inner = hk.masked_histogram1(flat, masks[0])
    table = _decision_table(K, inner, hist_all - inner)     # f32[256]
    st = {"seg": seg, "bins": bins, "flat": flat, "masks": masks,
          "table": table, "words": fused.pack_sign_words(table),
          "seg8": seg.to(torch.uint8).contiguous(), "tile": (8, 16),
          "bnd": dilate26(seg) & dilate26(~seg)}
    active = front._per_tile(st["bnd"], st["tile"]) > 0
    st["ids"] = front._compact(active, 256)
    st["nact"] = torch.clamp(active.sum(), max=256).to(
        torch.int32).reshape(1)
    log(phase, f"state after {int(res.iterations)} iterations: "
        f"{int(res.segmented_count)} segmented voxels; {int(st['nact'])} "
        f"of {active.numel()} tiles active; decision table "
        f"{int((table >= 0).sum())} of 256 bins >= 0")
    return st


def _state_cases(st):
    """{name: (kernel, plain version, bytes it must move, library call)}
    of K6b, K6a, K2, K5 and K7 (sign, f32 and f64 values) on a
    ``_grow_state``; K5 sweeps a copy of the state."""
    import torch

    hk, fused = _ops("histogram_kernels"), _ops("region_grow_fused")
    front, lk = _ops("region_grow_frontier"), _ops("lookup_kernels")
    flat, masks, bins = st["flat"], st["masks"], st["bins"]
    seg8, words, table = st["seg8"], st["words"], st["table"]
    t64 = table.double()
    n = flat.numel()
    w = masks.float()               # the library calls' weights
    front_a, front_b = seg8.clone(), seg8.clone()
    n_seg, n_bnd = int(masks[0].sum()), int(st["bnd"].sum())

    def frontier(fn, s):
        return lambda: (s, *fn(s, bins, st["ids"], st["nact"], words,
                               st["tile"]))

    return {
        "masked_histogram1": (
            lambda: (hk.masked_histogram1(flat, masks[0]),),
            lambda: (hk.masked_histograms_plain(flat, masks[:1])[0],),
            n + n_seg + 256 * 4,
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
            2 * n + n_bnd + 2 * 256 * 4, None),
        "region_grow_frontier": (
            frontier(front.frontier_step, front_a),
            frontier(front.frontier_step_plain, front_b),
            _frontier_bytes(st["ids"].tolist(), int(st["nact"]),
                            seg8.shape, st["tile"], n_bnd), None),
        "table_lookup": (
            lambda: (lk.table_lookup(bins, table),),
            lambda: (lk.table_lookup_plain(bins, table),),
            n + 4 * n + 256 * 4, lambda: (table[bins.long()],)),
        "table_lookup f64": (
            lambda: (lk.table_lookup(bins, t64),),
            lambda: (lk.table_lookup_plain(bins, t64),),
            n + 8 * n + 256 * 8, lambda: (t64[bins.long()],)),
        "sign_lookup": (
            lambda: (lk.sign_lookup(bins, table),),
            lambda: (lk.sign_lookup_plain(bins, table),),
            2 * n + 256 * 4, lambda: (table[bins.long()] >= 0,)),
    }


def _run_cases(phase, cases):
    """Each case's kernel against its plain version on the card (exact),
    with device and call times of both and of the library call, and the
    kernel's bound: {name: record}."""
    import torch

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
        del out, ref
        m_k = measure(kernel, own=True)
        with plain_kernels():
            m_p = measure(plain)
        m_l = library and measure(library)
        r = {"max_abs_err": err, **timing(m_k, m_p, nbytes, 0, m_l)}
        lib = "none" if library is None else (
            f"{r['library_ms']:.4f} ms ({r['library_call_ms']:.4f} per call)")
        log(phase, f"{name}: max|d| {err}; {r['timed_by']}"
            f" ms: kernel {r['ms']:.4f} ({r['call_ms']:.4f} per call), "
            f"plain {r['plain_ms']:.4f} ({r['plain_call_ms']:.4f} per call),"
            f" library call {lib}; bound {r['bound_ms']:.4f} ms ({nbytes} "
            f"bytes): {r['bound_ms'] / r['ms']:.1%} of the kernel; device "
            f"events in 10 calls: kernel {'; '.join(m_k[2])}; plain "
            f"{'; '.join(m_p[2])}; library {'; '.join(m_l[2]) if m_l else ''}")
        if err != 0:
            raise SystemExit(f"{phase}: {name} disagrees with its plain "
                             f"version: max|d| {err}")
        rec[name] = r
    return rec


WHILE_ITERS = 300               # region_grow_512's iteration cap


def phase_graph_while():
    """csrc/graph_while.cu's two kernels against their plain versions on
    the card: a loop of one and of two one-element steps (step k adds
    10^k to x; stop set at run WHILE_ITERS) through ``graph_loop`` (one
    while-graph launch: the kernels set the WHILE and IF nodes' handles
    and count the steps) and through ``host_loop`` (the plain versions'
    loop: the host reads stop and runs the next step); the steps run, x,
    stop and the runs must agree (max |d|).  Then each kernel's device
    time per launch from a trace of the two-step loop (which must hold
    each launch it made), its plain version's time per call
    (``set_while``: the host's read of stop; ``count_step``: that and
    the count on the host), its bound (the bytes it reads and writes),
    and the wall per step of both loops.  -> {name: record}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gw, gl = _ops("graph_while"), _ops("grow_loop")
    dev = torch.device("cuda")

    def loop(drive, n_steps):
        x = torch.zeros((), dtype=torch.int64, device=dev)
        runs = torch.zeros((), dtype=torch.int32, device=dev)
        stop = torch.full((), -1, dtype=torch.int32, device=dev)

        def step(k):
            x.add_(10 ** k)
            runs.add_(1)
            stop.copy_(torch.where(runs >= WHILE_ITERS, 0,
                                   -1).to(torch.int32))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = drive([lambda k=k: step(k) for k in range(n_steps)], stop)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return [n, int(x), int(stop), int(runs)], secs

    err, per_step = 0, {}
    for n_steps in (1, 2):
        loop(gl.graph_loop, n_steps)                    # warm-ups
        loop(gl.host_loop, n_steps)
        (a, t_a), (b, t_b) = (loop(gl.graph_loop, n_steps),
                              loop(gl.host_loop, n_steps))
        err = max([err] + [abs(p - q) for p, q in zip(a, b)])
        per_step[n_steps] = (t_a / WHILE_ITERS * 1e3, t_b / WHILE_ITERS * 1e3)
        log("graph_while", f"{n_steps} step(s): the while graph (steps run, "
            f"x, stop, runs) {a}, {per_step[n_steps][0]:.4f} ms a step; the "
            f"plain loop {b}, {per_step[n_steps][1]:.4f} ms a step")
    l0 = {k: fn.launches for k, fn in counted().items()
          if k in WHILE_KERNELS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop(gl.graph_loop, 2)
    made = {k: counted()[k].launches - n for k, n in l0.items()}
    dur = {k: [] for k in WHILE_KERNELS}
    for e in prof.events():
        name = e.name.split("(anonymous namespace)::")[-1]
        for k in WHILE_KERNELS:
            if e.device_type == DeviceType.CUDA and name.startswith(k + "("):
                dur[k].append(e.device_time_total)
    stop = torch.full((), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    plains = {"set_while": lambda: gw.set_while(count, stop),
              "count_step": lambda: gw.count_step(count, stop, 1)}
    out = {}
    for k, nbytes in (("set_while", 12), ("count_step", 12)):
        plains[k]()
        t0 = time.perf_counter()
        for _ in range(100):
            plains[k]()
        plain_ms = (time.perf_counter() - t0) / 100 * 1e3
        b_ms, by = bound(nbytes)
        ms = (statistics.mean(dur[k]) / 1e3 if len(dur[k]) == made[k]
              else None)
        out[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": None, "bound_ms": b_ms, "bound_us": 1e3 * b_ms,
                  "bound_by": by, "timed_by": "device",
                  "traced_launches": len(dur[k]), "launches_in_trace": made[k],
                  "while_ms_per_step": {n: v[0] for n, v in per_step.items()},
                  "plain_loop_ms_per_step": {n: v[1] for n, v in
                                             per_step.items()}}
        log("graph_while", f"{k}: device {_ms(ms)} ms per launch "
            f"({len(dur[k])} of {made[k]} launches traced), plain version "
            f"{plain_ms:.4f} ms per call, bound {b_ms:.2e} ms ({by})")
    if err or any(r["ms"] is None for r in out.values()):
        raise SystemExit(f"graph_while: max |d| {err} against the plain "
                         f"loop, or a trace without every launch: {out}")
    return out


def phase_region_grow_kernels(vol, seed):
    """Each region-growing kernel against its plain version on the card,
    at the path's shapes: the tube phantom's bins and its state after 20
    full-grid iterations.  Integers and table entries all: they must agree
    exactly.  Bounds count the bytes this state needs: every mask and seg
    byte, but bins only where a mask is set (histograms) or at boundary
    voxels (sweeps), as the kernels read them."""
    import torch

    P = "region_grow_kernels"
    front = _ops("region_grow_frontier")
    st = _grow_state(P, vol, seed, 10 ** 6)
    cases = _state_cases(st)
    cases.update(_banded_cases(st))
    seg8, bins, words = st["seg8"], st["bins"], st["words"]
    X = seg8.shape[2]
    # a block of sharded_512's grower: 256 x 256 own rows of the state
    # around the tube with a one-voxel halo on each side, swept over its
    # window (the kernel reads the block, writes and counts the window)
    blk = (slice(127, 385), slice(127, 385))
    seg_b, bins_b = seg8[blk].contiguous(), bins[blk].contiguous()
    win = ((1, 257), (1, 257), (0, X))
    n_bnd_win = int(st["bnd"][128:384, 128:384].sum())
    log(P, f"windowed K2 block {tuple(seg_b.shape)}, window {win}: "
        f"{n_bnd_win} boundary voxels in the window")
    # K7's values on bins the tube never gives: uniform random uint8 bins
    # (every table entry equally often: shared-memory bank conflicts) and
    # the tube's bins as int32
    lk = _ops("lookup_kernels")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    uni = torch.randint(0, 256, tuple(bins.shape), dtype=torch.uint8,
                        device="cuda", generator=g)
    bins32 = bins.int()
    t32, n = st["table"], bins.numel()
    t64 = t32.double()
    for label, b, t in (("uniform bins", uni, t32),
                        ("f64 uniform bins", uni, t64),
                        ("int32 bins", bins32, t32)):
        cases[f"table_lookup {label}"] = (
            lambda b=b, t=t: (lk.table_lookup(b, t),),
            lambda b=b, t=t: (lk.table_lookup_plain(b, t),),
            n * (b.element_size() + t.element_size()) + 256
            * t.element_size(), lambda b=b, t=t: (t[b.long()],))
    cases["region_grow_sweep window"] = _window_case(seg_b, bins_b, words,
                                                     win, n_bnd_win)
    rec = _run_cases(P, cases)
    _time_window_bare(P, rec["region_grow_sweep window"], seg_b, bins_b,
                      words, win)
    # K5's floor: both kernels launched, no tile active
    none = torch.zeros(1, dtype=torch.int32, device=seg8.device)
    seg0 = seg8.clone()
    m0 = measure(lambda: front.frontier_step(seg0, bins, st["ids"], none,
                                             words, st["tile"]), own=True)
    r = rec["region_grow_frontier"]
    r["nact0_ms"], r["nact0_call_ms"] = m0[0], m0[1]
    log(P, f"region_grow_frontier fixed cost (nact = 0, both kernels "
        f"launched): {_ms(m0[0])} ms on the device ({m0[1]:.4f} per call),"
        f" against {r['ms']:.4f} ms at {int(st['nact'])} tiles; device "
        f"events in 10 calls: {'; '.join(m0[2])}")
    return rec


def device_idle(fn, names=None):
    """(wall s, device-busy s, idle share) of one run of ``fn`` traced by
    torch.profiler: busy is the union of the device events' intervals,
    wall the host clock around the traced run (the tracer's own host cost
    included, so the share is an upper bound).  ``names``: a dict that
    gets, for each device event's name (its first 60 characters), [the
    events, their device microseconds summed]."""
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
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name != "Activity Buffer Request"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    for e in events if names is not None else ():
        n = names.setdefault(e.name[:60], [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.end - e.time_range.start
    busy, end = 0.0, float("-inf")
    for a, b in spans:                 # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e6, 1 - busy / 1e6 / wall


def _grow_run(fn):
    """(result, wall s, kernel launches, loop counts) of one run."""
    import torch

    reset_counts()
    reset_loop_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts(), loop_counts()


def _grow_three_ways(phase, name, fn, steps):
    """``fn`` (one grow of ``steps`` step functions) driven by the while
    graph and by the eager loop with the kernels, each after a warm-up,
    and by the eager loop with the plain versions: the three must agree
    (mask, active map, iterations, count, stop reason), the graph run
    must count the eager run's K1-K7 launches and pass
    ``_graph_driven``, the eager run read ``stop`` once per pass plus
    once and launch no kernel of the while graph, and the plain run
    launch nothing.  -> (graph result, graph s, launches, loop counts,
    eager s)."""
    fn()                                       # warm-ups: graph, eager
    res, secs, counts, loops = _grow_run(fn)
    with eager_loop():
        fn()
        eager, e_secs, e_counts, e_loops = _grow_run(fn)
    with plain_kernels():
        ref, p_secs, p_counts, _ = _grow_run(fn)
    same = _same_grow(res, eager) and _same_grow(res, ref)
    passes = int(res.iterations) + (int(res.stop_reason) == 0)
    log(phase, f"{name}: graphs {secs:.4f} s, eager loop {e_secs:.4f} s, "
        f"plain versions {p_secs:.4f} s; {passes} passes, while-graph "
        f"launches {loops['launches']}, host reads of stop "
        f"{loops['reads']} (eager {e_loops['reads']}), graphs captured "
        f"{loops['captures']}, capture + instantiate "
        f"{loops['capture_s']:.4f} s, steps run from graphs "
        f"{loops['replays']}; identical {same}")
    if not same or any(p_counts.values()):
        raise SystemExit(f"{phase} {name}: graph, eager and plain runs "
                         f"differ (plain launches {p_counts})")
    if (_k1_k7(counts) != _k1_k7(e_counts)
            or any(e_counts[k] for k in WHILE_KERNELS)
            or e_loops["reads"] != passes + 1):
        raise SystemExit(f"{phase} {name}: the graph run counts {counts}, "
                         f"{loops}; the eager loop {e_counts}, {e_loops}")
    _graph_driven(f"{phase} {name}", res, loops, counts, steps)
    return res, secs, counts, loops, e_secs


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
        res, secs, counts, _, _ = _grow_three_ways(
            "region_grow_512", name, fn, 2 if name == "auto" else 1)
        it, n = int(res.iterations), int(res.segmented_count)
        used = {k: v for k, v in counts.items() if v}
        log("region_grow_512", f"{name}: {secs:.4f} s warm, {it} "
            f"iterations, {n} segmented, stop {int(res.stop_reason)}, "
            f"{voxels * it / secs:.4e} voxel-sweeps/s; launches {used}")
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
        wall, busy, idle = device_idle(fn)
        log("region_grow_512", f"{name} traced by torch.profiler: "
            f"{wall:.4f} s, device busy {busy:.4f} s, idle {idle:.1%}; "
            f"against the untraced run's {secs:.4f} s idle "
            f"{1 - busy / secs:.1%} (the tracer's host cost taken out)")
        if busy <= 0:
            raise SystemExit(f"{name}: the trace holds no device time")
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
    out, secs, counts, _ = _grow_run(
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
        (coords, seg_map, vm), secs, counts, loops = _grow_run(run)
        totals.append(secs)
        log("value_map_512", f"run {i + 1}: {secs:.4f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }; passes "
            f"{int(ex.iterations) + (int(ex.stop_reason) == 0)}, "
            f"while-graph launches {loops['launches']}, host reads of "
            f"stop {loops['reads']}, graphs captured {loops['captures']}, "
            f"capture + instantiate {loops['capture_s']:.4f} s")
        for k in ("masked_histograms2", "sign_lookup"):
            if not counts[k] > 0:
                raise SystemExit(f"value_map_512 launched no {k}")
        # the same grow as ex, one step
        _graph_driven("value_map_512", ex, loops, counts, 1)
    with eager_loop():
        run()
        eager, e_secs, e_counts, _ = _grow_run(run)
    same_eager = (_k1_k7(e_counts) == _k1_k7(counts) and all(
        np.array_equal(a, b) for a, b in zip(eager, (coords, seg_map, vm))))
    log("value_map_512", f"the eager loop {e_secs:.4f} s (after a "
        f"warm-up); outputs and launches equal to the graph runs' "
        f"{same_eager}")
    if not same_eager:
        raise SystemExit("value_map_512: graph and eager loops differ")
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
    totals, seg_s, run_loops, run_counts = [], [], [], []
    for i in range(4):            # run 0 is the warm-up
        reset_counts()
        reset_loop_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, seed_mask=seed, config=cfg,
                              device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        run_counts.append(counts)
        run_loops.append(loop_counts())
        stages = ", ".join(f"{k} {v:.4f}" for k, v in
                           result["timings"].items())
        log("seeded_pipeline_512", f"run {i}{' (warm-up)' if i == 0 else ''}"
            f": total {total:.4f} s; launches {counts}; stages (s): "
            f"{stages}; grower loop {run_loops[-1]}")
        for k in ("frangi_response", "region_grow_sweep",
                  "masked_histogram1", *WHILE_KERNELS):
            if not counts[k] > 0:
                raise SystemExit(f"seeded run launched no {k}")
        if i:
            totals.append(total)
            seg_s.append(result["timings"]["segmentation"])
    v = vesselness_stage(raw, cfg, device="cuda")
    res, g_s, _, loops, e_s = _grow_three_ways(
        "seeded_pipeline_512", "the segmentation stage's grower",
        lambda: refine_mask_region_grow(v, seed, cfg, device="cuda")[1], 2)
    for i, (lc, c) in enumerate(zip(run_loops, run_counts)):
        # the same grow in every run: the fused grower, two steps
        _graph_driven(f"seeded_pipeline_512 run {i}", res, lc, c, 2)
    mask = res.segmented_map.cpu().numpy().astype(np.uint8)
    sol = result["solution"]
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    recall = float(mask[phantom["mask"]].astype(bool).mean())
    log("seeded_pipeline_512", f"median total "
        f"{statistics.median(totals):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); segmentation stage "
        f"median {statistics.median(seg_s):.4f} s; region growing "
        f"{int(res.iterations)} iterations, stop reason "
        f"{int(res.stop_reason)}, graphs {g_s:.4f} s against the eager "
        f"loop's {e_s:.4f} s, {loops['reads']} host reads per grow; "
        f"mask voxels {int(mask.sum())}; recall "
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
    _check(torch.equal(outs["lut"], outs["labels"]), P,
           f"(c) LUT thinning equals label-propagation thinning on a "
           f"{tuple(sub.shape)} crop ({int(sub.sum())} mask, "
           f"{int(outs['lut'].sum())} skeleton voxels): {times['lut']:.3f} "
           f"s against {times['labels']:.3f} s")
    # the full-size LUT thinning driven by graphs equals the eager loop
    full_mask = torch.from_numpy(mask).cuda()
    skel_g, tc, t_graph, t_eager = thin_graph_vs_eager(
        P, "(c) full-size LUT thinning", full_mask)
    _check(np.array_equal(skel_g.cpu().numpy(), skel), P,
           "(c) the full-size graph-driven skeleton equals the pipeline's")
    wall, busy, idle = device_idle(lambda: thinning.skeletonize(full_mask))
    log(P, f"full-size device thinning: {tc['wave_passes']} wave + "
        f"{tc['final_passes']} final passes, {tc['reads']} host reads, "
        f"{tc['captures']} graphs captured in {tc['capture_s']:.4f} s, "
        f"{tc['replays']} replays; graph-driven {t_graph:.4f} s, eager "
        f"loop {t_eager:.4f} s; traced {wall:.3f} s wall, {busy:.3f} s "
        f"device busy, idle share {idle:.1%} (against the untraced "
        f"graph-driven wall {1 - busy / t_graph:.1%})")

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

    # (f) components on the card against the native flood fill, each
    # call driven by graphs and equal to the eager loop
    lab64, c64, t64, _ = cc_graph_vs_eager(P, "(f) components, 64 rounds",
                                           full_mask)
    lab, cfull, t_cc, _ = cc_graph_vs_eager(
        P, "(f) components to convergence", full_mask, max_rounds=1 << 12)
    rounds, r64 = cfull["rounds"], c64["rounds"]
    wall, busy, idle = device_idle(lambda: cc.connected_components(
        full_mask, max_rounds=1 << 12))
    log(P, f"components to convergence: {rounds} rounds, {cfull['reads']} "
        f"host reads, {cfull['captures']} graph captured in "
        f"{cfull['capture_s']:.4f} s, {cfull['replays']} replays; "
        f"graph-driven {t_cc:.4f} s; traced {wall:.3f} s wall, {busy:.3f} s "
        f"device busy, idle share {idle:.1%} (against the untraced "
        f"graph-driven wall {1 - busy / t_cc:.1%})")
    ref, k = native.label_components_native(mask)
    n64 = len(np.unique(lab64.cpu().numpy())) - 1
    _check(_same_partition(lab.cpu().numpy(), ref), P,
           f"(f) connected_components run to convergence ({rounds} rounds; "
           f"{t_cc:.2f} s) gives the native partition ({k} components); at "
           f"the default 64 rounds ({r64} run, {t64:.2f} s) {n64} labels")

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


def _sharded_grow_vs_eager(phase, v_sh, seeds_sh):
    """The sharded grow of ``phase`` (60 iterations, 10^7 voxels) driven
    by the while graph and in the eager loop (``eager_loop()``): the same
    mask, iterations, count, stop reason and K1-K7 launches, on the
    "graph" route, every sweep after the first in one while-graph launch
    with min(sweeps, 2) + 1 ``stop`` reads (``_graph_driven``: two
    steps), the eager loop's sweeps + 1; then one traced run: busy, idle
    share traced and against the untraced wall -> a record."""
    import torch

    from arterynetwork_tpu_torch.parallel import sharded

    def grow():
        return sharded.region_grow(v_sh, seeds_sh, max_segment_size=10 ** 7,
                                   iter_max=SHARDED_ITERS)

    res, secs, counts, loops = _grow_run(grow)
    route = sharded.region_grow.route
    with eager_loop():
        eager, e_secs, e_counts, e_loops = _grow_run(grow)
    same = (torch.equal(res.segmented_map.gather(),
                        eager.segmented_map.gather())
            and [int(res.iterations), int(res.segmented_count),
                 int(res.stop_reason)]
            == [int(eager.iterations), int(eager.segmented_count),
                int(eager.stop_reason)])
    sweeps = int(res.iterations) + (int(res.stop_reason) == 0)
    wall, busy, idle = device_idle(grow)
    rec = {"route": route, "graph_s": secs, "eager_loop_s": e_secs,
           "sweeps": sweeps, "launches": counts, **loops,
           "eager_reads": e_loops["reads"],
           "host_reads_per_iteration": (loops["reads"] - 1) / max(sweeps, 1),
           "traced_s": wall, "busy_s": busy, "idle": idle,
           "idle_untraced": 1 - busy / secs}
    log(phase, f"sharded grow: graph-driven {secs:.4f} s (route {route}), "
        f"eager loop {e_secs:.4f} s; {sweeps} sweeps, while-graph launches "
        f"{loops['launches']}, host reads {loops['reads']} (eager "
        f"{e_loops['reads']}), graphs captured {loops['captures']}, "
        f"capture + instantiate {loops['capture_s']:.4f} s, steps run from "
        f"graphs {loops['replays']}; launches {counts} (eager {e_counts}); "
        f"bit-equal {same}; traced {wall:.4f} s, device busy {busy:.4f} s"
        f", idle {idle:.1%} traced, {rec['idle_untraced']:.1%} untraced")
    if not (same and route == "graph" and _k1_k7(counts) == _k1_k7(e_counts)
            and not any(e_counts[k] for k in WHILE_KERNELS)
            and e_loops["reads"] == sweeps + 1
            and e_loops["captures"] == e_loops["replays"] == 0):
        raise SystemExit(f"{phase} sharded grow: the graph-driven run "
                         f"{counts}, {loops} against the eager loop "
                         f"{e_counts}, {e_loops}, equal {same}, route "
                         f"{route}")
    _graph_driven(f"{phase} sharded grow", res, loops, counts, 2)
    return rec


def _sharded_thin_vs_eager(phase, mask_sh, skel1):
    """The sharded thinning of ``phase`` (16 waves) through
    ``_graph_vs_eager`` (reads = 1 + wave passes + final passes), on the
    "graph" route, equal to the single-device skeleton ``skel1``; then
    one traced run: busy, idle share traced and against the untraced
    wall -> a record."""
    import torch

    fn = importlib.import_module(
        "arterynetwork_tpu_torch.parallel.sharded").skeletonize
    out, c, secs, e_secs = _graph_vs_eager(
        phase, "sharded thinning",
        lambda: fn(mask_sh, max_waves=SHARDED_WAVES).gather(),
        lambda: _loop_fn_counts(fn, ("wave_passes", "final_passes")),
        lambda c: (c["wave_passes"], c["final_passes"]),
        lambda c: 1 + c["wave_passes"] + c["final_passes"])
    same = torch.equal(out, skel1)
    wall, busy, idle = device_idle(lambda: fn(mask_sh,
                                              max_waves=SHARDED_WAVES))
    rec = {"route": fn.route, "graph_s": secs, "eager_loop_s": e_secs,
           **c, "traced_s": wall, "busy_s": busy, "idle": idle,
           "idle_untraced": 1 - busy / secs}
    log(phase, f"sharded thinning: route {fn.route}, equal to the "
        f"single-device skeleton {same}; traced {wall:.4f} s, device busy"
        f" {busy:.4f} s, idle {idle:.1%} traced, "
        f"{rec['idle_untraced']:.1%} untraced")
    if not (same and fn.route == "graph"):
        raise SystemExit(f"{phase} sharded thinning: route {fn.route}, "
                         f"equal to the single-device skeleton {same}")
    return rec


def phase_sharded(raw, phase="sharded_512", timed=3, extras=True):
    """mini_pipeline_sharded on ``raw`` (the pipeline_512 raw volume for
    sharded_512, the Speck one for speck_sharded) over a 2x2 mesh of
    cuda:0 slots (the four blocks run one after another on the one
    card), at its defaults: one warm-up and ``timed`` timed runs with
    per-stage times; the bytes the grower's halo refresh copies per sweep
    beside those re-padding every block would write, and the device
    bytes the grower allocates per sweep (grows of 1 and of all sweeps);
    then the gates: (a) the vesselness bit-equal to
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
    terminating-pressure model that run_pipeline falls back to.
    ``extras`` (sharded_512) adds gate (f), the traced grows and the
    network's file."""
    import dataclasses

    import numpy as np
    import torch

    from arterynetwork_tpu_torch.flow import (build_system,
                                              create_ground_truth)
    from arterynetwork_tpu_torch.flow.solvers import \
        solve_pressure_newton_batch
    from arterynetwork_tpu_torch.ops.region_grow import region_grow
    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       pad_halos,
                                                       refresh_halos,
                                                       shard_volume)
    from arterynetwork_tpu_torch.parallel.distributed import solve_batch_dp
    from arterynetwork_tpu_torch.parallel.pipeline_sharded import (
        flow_network, mini_pipeline_sharded)

    dev = torch.device("cuda", 0)
    mesh = make_volume_mesh([dev] * 4)
    kw = {"sigmas": SHARDED_SIGMAS, "max_waves": SHARDED_WAVES,
          "region_grow_iters": SHARDED_ITERS, "n_timesteps": SHARDED_T}
    totals, stage_runs, peaks = [], [], []
    for i in range(timed + 1):    # run 0 is the warm-up
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
        log(phase, f"run {i}{' (warm-up)' if i == 0 else ''}: "
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
    peaks_v, one = _vesselness_peaks(vol)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v1 = frangi_vesselness(vol, sigmas=SHARDED_SIGMAS)
    torch.cuda.synchronize()
    single["vesselness"] = time.perf_counter() - t0
    peaks_v["slabs"] = torch.cuda.max_memory_allocated() / 2 ** 20
    vmin, vmax = torch.min(v1), torch.max(v1)
    seeds = v1 > vmin + 0.5 * (vmax - vmin)
    t0 = time.perf_counter()
    grown1 = region_grow(v1, seeds, max_segment_size=10 ** 7,
                         iter_max=SHARDED_ITERS)
    single["region_grow"] = time.perf_counter() - t0
    mask1 = grown1.segmented_map
    skel1, _, single["thinning"], _ = thin_graph_vs_eager(
        phase, "single-device thinning", mask1, max_waves=SHARDED_WAVES)
    v1_host = v1.cpu().numpy()
    if one is not None:
        peaks_v["one_slab_bit_equal"] = bool(np.array_equal(one, v1_host))
    gate_a = (bool(np.array_equal(res["vesselness"], v1_host))
              and peaks_v.get("one_slab_bit_equal", True))
    del v1_host, one
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
        if extras:
            # the network and its boundary for a solve elsewhere (the
            # JAX package's against the port's, on a CPU)
            os.makedirs("build", exist_ok=True)
            np.savez("build/sharded_512_network.npz", boundary_pressure=bp,
                     **{f.name: getattr(net, f.name) for f in
                        dataclasses.fields(net)
                        if isinstance(getattr(net, f.name), np.ndarray)})
    gate_d = bool(bit_equal) and bool(np.isfinite(rows).all())
    gate_e = (counts["region_grow_sweep"] == 4 * sweeps
              and counts["masked_histogram1"] == 8)

    # halo bytes of one exchange (the grower's: the uint8 segmentation
    # with a halo of 1); the bytes the grower copies per sweep to bring
    # its padded blocks up to date with refresh_halos (faces only), and
    # those re-padding every block with one torch.cat per sharded dim
    # would write (each cat the block padded so far); the device
    # bytes allocated per sweep, from a grow of one sweep and one of all
    seeds_sh = shard_volume(seeds, mesh)
    pad = pad_halos(seeds_sh.map(lambda b: b.to(torch.uint8)), 1)
    halo_bytes = sum(pad.blocks[i].numel() - seeds_sh.blocks[i].numel()
                     for i in seeds_sh.indices())
    refresh_bytes = refresh_halos(pad)
    repad_bytes = sum(pad.blocks[i].shape[0] * seeds_sh.blocks[i][0].numel()
                      + pad.blocks[i].numel() for i in seeds_sh.indices())
    del pad
    v_sh = shard_volume(v1, mesh)
    alloc = []
    for n_it in (1, SHARDED_ITERS):
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        g = sharded.region_grow(v_sh, seeds_sh, max_segment_size=10 ** 7,
                                iter_max=n_it)
        n_sw = int(g.iterations) + (int(g.stop_reason) == 0)
        torch.cuda.synchronize()
        alloc.append((torch.cuda.memory_stats()[
            "allocated_bytes.all.allocated"] - a0, n_sw))
        del g
    # the sharded grow and thinning driven by graphs against their eager
    # loops, each traced once
    grow_rec = _sharded_grow_vs_eager(phase, v_sh, seeds_sh)
    mask_sh = shard_volume(mask1, mesh)
    thin_rec = _sharded_thin_vs_eager(phase, mask_sh, skel1)
    del v_sh, mask_sh
    alloc_per_sweep = (alloc[1][0] - alloc[0][0]) / max(
        alloc[1][1] - alloc[0][1], 1)
    out = {"phase": phase, "mesh": "2x2 of cuda:0",
           "median_s": statistics.median(totals), "runs_s": totals,
           "stage_medians_s": medians, "single_device_stages_s": single,
           "grow": rg, "sweeps": sweeps, "launches": counts,
           "segments": n_seg, "mask_voxels": int(res["mask"].sum()),
           "skeleton_voxels": int(res["skeleton"].sum()),
           "halo_bytes_per_iteration": halo_bytes,
           "refresh_bytes_per_iteration": refresh_bytes,
           "repad_bytes_per_iteration": repad_bytes,
           "grow_allocated_bytes_per_sweep": alloc_per_sweep,
           "host_reads_per_iteration": grow_rec["host_reads_per_iteration"],
           "sharded_grow": grow_rec, "sharded_thinning": thin_rec,
           "traced_grow_s": grow_rec["traced_s"],
           "traced_grow_busy_s": grow_rec["busy_s"],
           "traced_grow_idle": grow_rec["idle"], "peak_mib": max(peaks),
           "single_vesselness_peak_mib": peaks_v,
           "pressure_bit_equal": bit_equal,
           "unsharded_two_runs_rel_spread": spread,
           "max_residual_m3s": resid,
           "pipeline_pressures": res["pressure_batch"] is not None,
           "ground_truth_feasible": bp_from == "ground truth (option 2)",
           "boundary_pressures_from": bp_from, "flow_nodes": n_nodes,
           "gates": {"a_vesselness": gate_a, "b_mask_skeleton": gate_b,
                     "c_segments": gate_c, "d_pressures": gate_d,
                     "e_launches": gate_e}}
    traced = ""
    if extras:
        v_sh = sharded.frangi_vesselness(shard_volume(vol, mesh),
                                         sigmas=SHARDED_SIGMAS)
        out["gates"]["f_k6b_blocks"] = _sharded_k6b(phase, v_sh, v1, seeds,
                                                    seeds_sh)
        wall1, busy1, idle1 = device_idle(lambda: region_grow(
            v1, seeds, max_segment_size=10 ** 7, iter_max=SHARDED_ITERS))
        out.update({"single_grow_traced_s": wall1,
                    "single_grow_idle": idle1})
        traced = (f"traced single-device grower {wall1:.4f} s "
                  f"({idle1:.1%} idle); ")
    log(phase, f"median total {out['median_s']:.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); stage medians "
        f"{', '.join(f'{k} {v:.4f}' for k, v in medians.items())}; the "
        f"single-device composition "
        f"{', '.join(f'{k} {v:.4f}' for k, v in single.items())}; "
        f"grower {rg} ({sweeps} sweeps, K2 {counts['region_grow_sweep']}"
        f", K6b {counts['masked_histogram1']}, K1 "
        f"{counts['frangi_response']}); {n_seg} segments, mask "
        f"{out['mask_voxels']} voxels, skeleton {out['skeleton_voxels']}; "
        f"halo {halo_bytes} bytes per iteration, copied by the halo "
        f"refresh {refresh_bytes} bytes per iteration (re-padding every "
        f"block would write {repad_bytes}); device bytes allocated per "
        f"sweep {alloc_per_sweep:.0f} (grows of {alloc[0][1]} and "
        f"{alloc[1][1]} sweeps); {out['host_reads_per_iteration']:.4f} "
        f"host reads per iteration; traced sharded grow "
        f"{grow_rec['traced_s']:.4f} s, device busy {grow_rec['busy_s']:.4f}"
        f" s ({grow_rec['idle']:.1%} idle); {traced}peak device memory "
        f"{max(peaks):.0f} MiB "
        f"(the whole-volume vesselness {peaks_v}); "
        f"the pipeline's pressures {out['pipeline_pressures']}; dp rows "
        f"on its {n_nodes}-node network ({bp_from}) bit-equal to the "
        f"unsharded batch, and two unsharded runs to each other, "
        f"{bit_equal}, max "
        f"residual {resid} m^3/s; two unsharded runs differ by "
        f"{spread} (relative); gates {out['gates']}")
    print(json.dumps(out), flush=True)
    if not all(out["gates"].values()):
        raise SystemExit(f"{phase}: a gate failed: {out['gates']}")
    return counts


def _vesselness_peaks(vol):
    """Where ``vol`` is larger than one slab of frangi_vesselness's
    per-voxel passes: ({"one_slab": its peak device memory in MiB}, the
    result on the host) of the filter with the whole volume as one slab,
    its form before the passes were cut into slabs; else ({}, None)."""
    import torch

    from arterynetwork_tpu_torch.ops import vesselness

    if vol.numel() <= vesselness.SLAB_VOXELS:
        return {}, None
    slab = vesselness.SLAB_VOXELS
    torch.cuda.reset_peak_memory_stats()
    vesselness.SLAB_VOXELS = vol.numel()
    try:
        one = vesselness.frangi_vesselness(vol, sigmas=SHARDED_SIGMAS)
    finally:
        vesselness.SLAB_VOXELS = slab
    torch.cuda.synchronize()
    out = {"one_slab": torch.cuda.max_memory_allocated() / 2 ** 20}
    one = one.cpu().numpy()
    _fresh()
    return out, one


def _sharded_k6b(phase, v_sh, v1, seeds, seeds_sh):
    """Gate (f): K6b at the sharded grower's inputs, each padded block's
    int32 histograms under its own-box mask and its seed (inner) mask,
    both false on the halo, exact against the plain version, and the
    blocks' sums equal to the whole volume's histograms."""
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import _bin_ids, _quantize
    from arterynetwork_tpu_torch.parallel import sharded

    hk = _ops("histogram_kernels")
    bins_pad, _ = sharded.quantized_bins(v_sh)
    sums = torch.zeros((2, 256), dtype=torch.int64, device=v1.device)
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
    log(phase, f"K6b on the {k6b_calls // 2} padded blocks "
        f"({', '.join(str(tuple(b.shape)) for b in bins_pad.blocks.reshape(-1))}"
        f"), own and inner masks, int32: max|d| {k6b_err} from the plain "
        f"version; block sums equal to the whole volume's "
        f"{bool(torch.equal(sums, whole))} ({int(whole[0].sum())} voxels, "
        f"{int(whole[1].sum())} seeds)")
    return gate_f


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


SPECK_SHAPE = (880, 880, 640)   # BASELINE.md config 5; bench.py:443, 505
SPECK_TIMED = 2                 # bench_speck_pipeline's timed runs
SPECK_RG_KW = {"max_segment_size": 10 ** 7, "iter_max": 60}  # bench.py:443-466
SPECK_CHUNK_SIGMAS = (1.0, 2.0, 3.0)    # bench.py:474-475
SPECK_CHUNK_Z = 110
SPECK_N31 = 2 ** 31 + 33        # past the reach of a 32-bit element index


def speck_config():
    """bench.py::bench_speck_pipeline's configuration (bench.py:508-523):
    pipeline_512's with the bq3 wire (x = 640 is 8-aligned)."""
    cfg = bench_config()
    cfg.vesselness.upload_format = "bq3"
    return cfg


def _fresh():
    """Free the card's cached blocks, so that the next phase's peak is
    its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _calls(module, name, keep=lambda args: None):
    """``keep(args)`` of every call of ``module.name`` while inside (the
    arguments themselves are not held: they may be whole volumes)."""
    fn, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        seen.append(keep(args))
        return fn(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def phase_speck_pipeline(phantom, raw):
    """bench.py::bench_speck_pipeline through the port's run_pipeline:
    phase_pipeline's runs and gates at 880x880x640 (one warm-up and two
    timed runs, 4 scales x 19 slabs = 76 K1 launches each), every slab
    uploaded on the bq3 wire, per-stage medians and minima, peak device
    memory, and the tree-recovery metrics against the phantom."""
    from arterynetwork_tpu_torch.ops import vesselness
    from arterynetwork_tpu_torch.utils.fidelity import tree_recovery_metrics

    P = "speck_pipeline"
    cfg = speck_config()
    with _calls(vesselness, "_bq_dequant_packed", lambda a: a[3]) as dq, \
            _calls(vesselness, "_upload_slab_bq_sparse") as sparse:
        k1, result, runs = phase_pipeline(phantom, raw, P, cfg, SPECK_TIMED)
    n_slabs = vesselness.slab_plan(raw.shape[0], cfg.vesselness.sigmas,
                                   vesselness.STREAMED_CHUNK_Z,
                                   streamed=True)[2]
    bits = sorted(set(dq))
    t = runs["timings"]
    out = {"phase": P, "shape": list(raw.shape), "k1_launches": k1,
           "median_s": statistics.median(runs["totals"]),
           "min_s": min(runs["totals"]), "runs_s": runs["totals"],
           "stage_medians_s": {k: statistics.median(r[k] for r in t)
                               for k in t[0]},
           "stage_min_s": {k: min(r[k] for r in t) for k in t[0]},
           "peak_mib": max(runs["peaks_mib"]), "mask_recall": runs["recall"],
           "wire_bits": bits, "slabs_per_run": n_slabs,
           "slabs_decoded": len(dq), "slabs_occupancy_skipped": len(sparse),
           "segments": len(result["segments"]),
           "flow_edges": int(result["network"].num_edges),
           "gt_branches": int(phantom["n_branches"]),
           **{k: v for k, v in tree_recovery_metrics(
               result["segments"], result["attrs"], phantom).items()
              if k not in ("segments", "gt_branches")}}
    log(P, f"wire: {bits}-bit, {len(dq)} slabs decoded in "
        f"{SPECK_TIMED + 1} runs of {n_slabs} slabs, {len(sparse)} through "
        f"the occupancy skip; centerline recall "
        f"{out['centerline_recall']:.4f}, precision "
        f"{out['centerline_precision']:.4f}, terminals {out['terminals']} "
        f"of {out['gt_terminals']}, bifurcations {out['bifurcations']} of "
        f"{out['gt_bifurcations']}")
    print(json.dumps(out), flush=True)
    if bits != [3] or len(dq) != n_slabs * (SPECK_TIMED + 1):
        raise SystemExit(f"{P}: the bq3 wire did not carry every slab "
                         f"(bits {bits}, {len(dq)} slabs)")
    return k1


def _count_rounding(data, seed):
    """At iteration 0 of the growers on ``data``: the bins whose exact
    count passes 2^24, the counts f32 rounds, and the decision-table signs
    that differ between the growers' f32 table and an f64 table built
    from the same exact counts (K6b's int32 counts)."""
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import (_bin_ids,
                                                         _decision_table,
                                                         _gaussian_kernel,
                                                         _quantize)

    hk = _ops("histogram_kernels")
    idx, values = _quantize(data, 256)
    flat = _bin_ids(idx, 256).reshape(-1)
    del idx
    ones = torch.ones_like(flat, dtype=torch.bool)
    hist = hk.masked_histogram1(flat, ones, 256, torch.int32).long()
    inner = hk.masked_histogram1(flat, seed.reshape(-1), 256,
                                 torch.int32).long()
    K = _gaussian_kernel(values, 2.25, torch.float32)
    f32 = _decision_table(K, inner.float(), hist.float() - inner.float())
    f64 = _decision_table(K.double(), inner.double(),
                          (hist - inner).double())
    return {"bins_over_2^24": int((hist > 2 ** 24).sum()),
            "max_bin_count": int(hist.max()),
            "counts_rounded_in_f32": int((hist.float().long() != hist).sum()),
            "table_signs_differing": int(((f32 >= 0) != (f64 >= 0)).sum())}


def phase_speck_region_grow(vol, seed):
    """bench.py::bench_speck_region_grow on the card (bench.py:418-484):
    the tube phantom at 880x880x640 (radius 3), 10^7 voxels and 60
    iterations at most, through region_grow "auto" (K2 + K6b), "xla" (K6b
    + K7) and region_grow_frontier (K5 + K6b), each timed once after a
    warm-up: one (iterations, count, stop reason) and one mask for all
    three, each grower's kernels launched (K7 once per full-grid pass);
    the counts at iteration 0 past 2^24 and the decision-table signs they
    move; then frangi_vesselness_chunked (sigmas 1, 2, 3; 110-row slabs)
    timed once after a warm-up, one K1 launch per slab and scale, within
    K1's bound of its twin.  Returns (launches by grower, the chunked
    driver's K1 launches)."""
    import torch

    from arterynetwork_tpu_torch.ops import (region_grow,
                                             region_grow_frontier,
                                             vesselness, vesselness_fused)

    P = "speck_region_grow"
    data = torch.from_numpy(vol).cuda()
    sd = torch.from_numpy(seed).cuda()
    kw = SPECK_RG_KW
    growers = {
        "auto": (lambda: region_grow(data, sd, **kw),
                 ("region_grow_sweep", "masked_histogram1")),
        "xla": (lambda: region_grow(data, sd, backend="xla", **kw),
                ("masked_histogram1", "sign_lookup")),
        "frontier": (lambda: region_grow_frontier(data, sd, **kw),
                     ("region_grow_frontier", "masked_histogram1")),
    }
    results, launches, secs, eager_s, reads = {}, {}, {}, {}, {}
    for name, (fn, kernels) in growers.items():
        res, secs[name], counts, loops, eager_s[name] = _grow_three_ways(
            P, name, fn, 2 if name == "auto" else 1)
        reads[name] = loops["reads"]
        it, n = int(res.iterations), int(res.segmented_count)
        used = {k: v for k, v in counts.items() if v}
        log(P, f"{name}: {secs[name]:.4f} s warm, {it} iterations, {n} "
            f"segmented, stop {int(res.stop_reason)}, "
            f"{vol.size * it / secs[name]:.4e} voxel-sweeps/s; launches "
            f"{used}")
        if not all(counts[k] > 0 for k in kernels):
            raise SystemExit(f"{P} {name}: expected launches of "
                             f"{kernels}, got {counts}")
        passes = it + (int(res.stop_reason) == 0)
        if "sign_lookup" in kernels and counts["sign_lookup"] != passes:
            raise SystemExit(f"{P} {name}: {counts['sign_lookup']} K7 "
                             f"launches for {passes} passes")
        results[name], launches[name] = res, counts
    a = results["auto"]
    key = (int(a.iterations), int(a.segmented_count), int(a.stop_reason))
    for name in ("xla", "frontier"):
        r = results[name]
        if ((int(r.iterations), int(r.segmented_count), int(r.stop_reason))
                != key or not torch.equal(r.segmented_map, a.segmented_map)):
            raise SystemExit(f"{P}: {name} and auto reach different fixed "
                             f"points")
    del results, a, r
    rounding = _count_rounding(data, sd)
    log(P, f"auto, xla and frontier: one fixed point {key}; at iteration "
        f"0: {json.dumps(rounding)}")

    want = vesselness.k1_launches(vol.shape[0], SPECK_CHUNK_SIGMAS,
                                  SPECK_CHUNK_Z)

    def chunked():
        return vesselness.frangi_vesselness_chunked(
            data, sigmas=SPECK_CHUNK_SIGMAS, chunk_z=SPECK_CHUNK_Z)

    chunked()                                  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = chunked()
    torch.cuda.synchronize()
    t_ch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    counts = read_counts()
    k1 = vesselness_fused.frangi_response_max_
    vesselness_fused.frangi_response_max_ = \
        vesselness_fused.frangi_response_plain_
    try:
        twin = chunked()
    finally:
        vesselness_fused.frangi_response_max_ = k1
    if read_counts() != counts:
        raise SystemExit(f"{P}: the twin run launched a kernel")
    d = (out - twin).abs()
    within = bool((d <= K1_TOL + 1e-4 * twin.abs()).all())
    rec = {"phase": P, "shape": list(vol.shape),
           "grower_s": secs, "eager_loop_s": eager_s,
           "host_reads": reads, "fixed_point": key,
           "launches": {k: {n: v for n, v in c.items() if v}
                        for k, c in launches.items()},
           "count_rounding": rounding, "chunked_s": t_ch,
           "chunked_peak_mib": peak,
           "chunked_k1": counts["frangi_response"],
           "chunked_max_abs_diff_twin": float(d.max())}
    print(json.dumps(rec), flush=True)
    _check(counts["frangi_response"] == want and within, P,
           f"frangi_vesselness_chunked {t_ch:.3f} s warm (peak "
           f"{peak:.0f} MiB), K1 launches {counts['frangi_response']} "
           f"(expected {want}); against its twin on the card max|d| "
           f"{float(d.max()):.3e} within 1e-5 + 1e-4|ref| {within}")
    return launches, counts["frangi_response"]


def _banded_cases(st):
    """K3 and K4 (the banded entries, on K2's kernel) on a ``_grow_state``
    padded as their JAX contract pads it: y to whole 128-row bands (at
    least two), x to 128 lanes; against the plain sweep.  The bound
    counts the valid region read, the padded output written (its pads
    zero) and the bins of the boundary voxels."""
    import torch.nn.functional as F

    fused = _ops("region_grow_fused")
    seg8, bins, words = st["seg8"], st["bins"], st["words"]
    Z, Y, X = seg8.shape
    pad = (0, -(-X // 128) * 128 - X, 0, max(-(-Y // 128), 2) * 128 - Y)
    seg_p, bins_p = F.pad(seg8, pad), F.pad(bins, pad)
    valid = (Y, X)
    nbytes = seg8.numel() + seg_p.numel() + int(st["bnd"].sum()) + 2048
    return {
        "region_grow_sweep banded (K3)": (
            lambda: fused.fused_sweep_banded(seg_p, bins_p, words, valid),
            lambda: fused.fused_sweep(seg_p, bins_p, words, valid), nbytes,
            None),
        "region_grow_sweep banded_dma (K4)": (
            lambda: fused.fused_sweep_banded_dma(seg_p, bins_p, words,
                                                 valid),
            lambda: fused.fused_sweep(seg_p, bins_p, words, valid), nbytes,
            None)}


def phase_speck_kernels(raw, vol, seed):
    """Each kernel against its plain version on the card at Speck shapes:
    K1 on a smoothed (68, 880, 640) slab of the Speck raw volume per
    scale (within 1e-5); K6b, K6a, K2, K5, K7 sign, f32 and f64 values
    on the Speck tube's state after 20 iterations (4.96e8 voxels; 3.96e9
    output bytes in f64), K3 and K4 on it padded to their contract's
    (880, 896, 640); K2 on each halo-padded block of a 2x2 mesh of
    that state, and timed on the one with the most boundary voxels; then
    n = 2^31 + 33 uint8 bins: K6b on random bins under a random mask and
    on one bin under an all-true mask (a count past 2^31, int64), K7 sign
    and f32 values on random bins.  Exact, but for K1.  Device and call
    ms, bounds and library-call ms as at 512 (none past 2^31)."""
    import torch

    P = "speck_kernels"
    hk, lk = _ops("histogram_kernels"), _ops("lookup_kernels")
    k1_err, k1_rec, _ = _k1_slab(P, raw)
    rec = {"frangi_response": {"max_abs_err": k1_err, **k1_rec}}
    _fresh()
    st = _grow_state(P, vol, seed, SPECK_RG_KW["max_segment_size"])
    cases = _state_cases(st)
    bins = st["bins"]
    rec.update(_run_cases(P, cases))
    rec.update(_run_cases(P, _banded_cases(st)))

    def same(label, out, ref):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise SystemExit(f"{P}: {label} differs from the plain "
                             f"version (max|d| {_max_err(out, ref)})")

    blocks = _mesh_windows(_ops("region_grow_fused"), st["seg8"], bins,
                           st["words"], same)
    log(P, f"K2 on the {blocks} halo-padded blocks of a 2x2 mesh of the "
        f"state: equal to the plain version, reassembled equal to the "
        f"whole sweep")
    # one of those blocks timed, as the 512 phase times its window case
    words = st["words"]
    idx, seg_b, bins_b, win, n_bnd_win = _mesh_block(st["seg8"], bins,
                                                     st["bnd"])
    log(P, f"windowed K2 on block {idx} {tuple(seg_b.shape)}, window "
        f"{win}: {n_bnd_win} boundary voxels in the window")
    rec.update(_run_cases(P, {"region_grow_sweep window": _window_case(
        seg_b, bins_b, words, win, n_bnd_win)}))
    _time_window_bare(P, rec["region_grow_sweep window"], seg_b, bins_b,
                      words, win)
    del st, cases, bins, seg_b, bins_b
    _fresh()

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    n = SPECK_N31
    rb = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda",
                       generator=g)
    rm = torch.randint(0, 2, (n,), dtype=torch.uint8, device="cuda",
                       generator=g).bool()
    table = torch.randn(256, device="cuda", generator=g)
    n_set = int(rm.sum())
    rec.update(_run_cases(P, {
        "masked_histogram1 n=2^31+33": (
            lambda: (hk.masked_histogram1(rb, rm),),
            lambda: (hk.masked_histograms_plain(rb, rm[None])[0],),
            n + n_set + 256 * 4, None),
        "sign_lookup n=2^31+33": (
            lambda: (lk.sign_lookup(rb, table),),
            lambda: (lk.sign_lookup_plain(rb, table),),
            2 * n + 256 * 4, None)}))
    del rm
    _fresh()
    # f32 values (8.6 GB out; the plain gather's int64 index 17 GB more)
    rec.update(_run_cases(P, {"table_lookup n=2^31+33": (
        lambda: (lk.table_lookup(rb, table),),
        lambda: (lk.table_lookup_plain(rb, table),),
        5 * n + 256 * 4, None)}))
    del rb
    _fresh()
    one_bin = torch.zeros(n, dtype=torch.uint8, device="cuda")
    all_set = torch.ones(n, dtype=torch.bool, device="cuda")
    out = hk.masked_histogram1(one_bin, all_set, 256, torch.int64)
    ref = hk.masked_histograms_plain(one_bin, all_set[None], 256,
                                     torch.int64)[0]
    torch.cuda.synchronize()
    _check(torch.equal(out, ref), P, f"K6b on one bin of {n} voxels, "
           f"int64: bin 0 {int(out[0])} (plain {int(ref[0])}), the rest "
           f"{int(out[1:].abs().sum())}")
    return rec


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


def _solve_bits(sol):
    """A solution's pressures, flows, residuals and iterations as bytes."""
    import numpy as np
    import torch

    return b"".join(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                    .tobytes() for x in (sol.pressure, sol.flow,
                                         sol.residual_norm, sol.iterations))


def _graph_driven_solve(label, same, stats, e_stats, iterations):
    """Fail unless the graph-driven solve equals the eager loop's bit for
    bit with its host reads, linear solves and CG steps, and replayed
    captured graphs if a row took more than one Newton iteration."""
    import numpy as np
    import torch

    steps = [None if s.cg_steps is None else s.cg_steps.tolist()
             for s in (stats, e_stats)]
    more = int(np.max(np.asarray(iterations.cpu() if torch.is_tensor(
        iterations) else iterations))) > 1
    if not (same and stats.host_reads == e_stats.host_reads
            and stats.linear_solves == e_stats.linear_solves
            and steps[0] == steps[1] and (stats.replays > 0 or not more)):
        raise SystemExit(f"{label}: graph-driven and eager solves differ "
                         f"(bit-equal {same}; {stats}; eager {e_stats})")


def phase_flow_determinism(net512):
    """Each flow solve run twice on the card, graph-driven, with no
    global switch, must give the same bits (pressures, flows, residuals,
    iterations):
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
        with solve_loops() as loops:
            runs = [fn() for _ in range(2)]
        graphs = _graph_solves(f"flow_determinism {name}", loops)
        bits = [_solve_bits(s) for s in runs]
        sol = runs[0]
        rec = {"bit_equal": bits[0] == bits[1],
               "rel_diff": _rel_diff(runs[0].pressure.cpu(),
                                     runs[1].pressure.cpu()),
               "iterations": np.asarray(sol.iterations.cpu() if torch.is_tensor(
                   sol.iterations) else sol.iterations).tolist(),
               "max_residual_m3s": float(sol.residual_norm.max()),
               "dtype": str(sol.pressure.dtype), "graphs": graphs}
        out["solves"][name] = rec
        log("flow_determinism", f"{name}: two runs bit-equal "
            f"{rec['bit_equal']} (rel diff {rec['rel_diff']:.3e}); "
            f"iterations {rec['iterations']}, max residual "
            f"{rec['max_residual_m3s']:.3e} m^3/s; graph-driven: {graphs}")
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
        def solve(stats=None):
            return solve_pressure_newton(system, max_iter=60, stats=stats,
                                         **kw)

        sol, ms = _median_ms(solve)
        stats = SolveStats()            # counted untraced
        solve(stats)
        # cg f64's ~100k kernels would take the tracer tens of seconds to
        # list
        wall, busy, idle = ((None,) * 3 if name == "cg_f64" else
                            device_idle(solve))
        with eager_loop():
            eager, eager_ms = _median_ms(solve)
            e_stats = SolveStats()
            solve(e_stats)
        same = _solve_bits(sol) == _solve_bits(eager)
        p = sol.pressure.double().cpu().numpy()
        err = float(np.nanmax(np.abs(p - gt.pressure) / np.abs(gt.pressure)))
        finite = bool(torch.isfinite(sol.pressure).all()
                      and torch.isfinite(sol.flow).all())
        cg = (None if stats.cg_steps is None
              else int(stats.cg_steps.sum()) / stats.linear_solves)
        rec = {"ms": ms, "eager_loop_ms": eager_ms,
               "newton_iterations": sol.iterations,
               "linear_solves": stats.linear_solves,
               "cg_steps_per_linear_solve": cg,
               "host_reads": stats.host_reads,
               "eager_host_reads": e_stats.host_reads,
               "captures": stats.captures, "replays": stats.replays,
               "capture_s": stats.capture_s, "bit_equal_to_eager": same,
               "max_rel_pressure_err": err, "limit": limit,
               "residual_norm": float(sol.residual_norm), "finite": finite,
               "traced_s": wall, "device_busy_s": busy, "device_idle": idle,
               "device_idle_untraced": (None if busy is None
                                        else 1 - busy / (ms / 1e3))}
        out["solves"][name] = rec
        log("flow_solvers", f"{name}: {ms:.3f} ms per solve graph-driven "
            f"(eager loop {eager_ms:.3f} ms), {sol.iterations} Newton "
            f"iterations, {stats.linear_solves} linear solves, CG steps per "
            f"linear solve {cg}, {stats.host_reads} host reads (eager "
            f"{e_stats.host_reads}), graphs captured {stats.captures} in "
            f"{stats.capture_s:.4f} s, replays {stats.replays}; bit-equal to "
            f"the eager loop {same}; max rel pressure error {err:.3e} (limit "
            f"{limit}); " + (
                "not traced" if wall is None else f"traced {wall:.4f} s, "
                f"device busy {busy:.4f} s ({idle:.1%} idle; "
                f"{rec['device_idle_untraced']:.1%} of the untraced median)"))
        if not (finite and err <= limit):
            raise SystemExit(f"flow_solvers {name}: error {err} > {limit} "
                             f"or non-finite")
        _graph_driven_solve(f"flow_solvers {name}", same, stats, e_stats,
                            sol.iterations)
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
    def batched(stats=None):
        return solve_timestep_batch(net, batch, dtype=torch.float64,
                                    device="cuda", stats=stats)

    sol, batched_ms = _median_ms(batched)
    stats = SolveStats()                # counted untraced
    batched(stats)
    wall, busy, idle = device_idle(batched)
    with eager_loop():
        eager, eager_ms = _median_ms(batched)
        e_stats = SolveStats()
        batched(e_stats)
    same = _solve_bits(sol) == _solve_bits(eager)
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
           "batched_eager_loop_ms": eager_ms,
           "batched_eager_host_reads": e_stats.host_reads,
           "batched_captures": stats.captures,
           "batched_replays": stats.replays,
           "batched_capture_s": stats.capture_s,
           "batched_bit_equal_to_eager": same,
           "batched_traced_s": wall, "batched_device_busy_s": busy,
           "batched_device_idle": idle,
           "batched_device_idle_untraced": 1 - busy / (batched_ms / 1e3),
           "max_residual_m3s": float(resid.max()),
           "row0_vs_ground_truth": bool(gt_ok),
           "max_rel_row_diff": row_rel, "finite": finite}
    log("longitudinal", f"T={LONG_T} on {net.num_edges} edges: batch prep "
        f"{prep_s:.3f} s (host); batched solve {batched_ms:.3f} ms "
        f"graph-driven (eager loop {eager_ms:.3f} ms), {stats.host_reads} "
        f"host reads (eager {e_stats.host_reads}), graphs captured "
        f"{stats.captures} in {stats.capture_s:.4f} s, replays "
        f"{stats.replays}, bit-equal to the eager loop {same}; traced "
        f"{wall:.4f} s with the device busy {busy:.4f} s ({idle:.1%} idle; "
        f"{1 - busy / (batched_ms / 1e3):.1%} of the untraced median); "
        f"{LONG_T} unbatched solves "
        f"{rows_ms:.3f} ms; iterations {its} (rows alone {row_its}); max "
        f"residual {resid.max():.3e} m^3/s; row 0 on the ground truth "
        f"{gt_ok}; max rel diff batch vs rows {row_rel:.3e}")
    if not (finite and resid.max() < 1e-10 and gt_ok and its == row_its
            and row_rel <= 1e-12):
        raise SystemExit("longitudinal: a gate failed")
    _graph_driven_solve("longitudinal", same, stats, e_stats, sol.iterations)
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


DISTRIBUTE_STEPS = 40   # distribute_flow_study's max_iter


def _fit_vs_eager(res, run):
    """distribute's fit graph-driven (``res``, just run; step 1 eager,
    step 2 captured, 3-40 replayed) against ``run("cuda")`` in the eager
    loop: within 1e-9 (relative), the steps, captures and replays as
    said -> a record."""
    fit = importlib.import_module(
        "arterynetwork_tpu_torch.flow.distribute").distribute_flow
    rec = {k: getattr(fit, k) for k in ("steps", "captures", "replays",
                                        "capture_s")}
    with eager_loop():
        eager, e_secs = _sync_s(lambda: run("cuda"))
    rec.update(eager_loop_s=e_secs, eager_captures=fit.captures,
               max_rel_eager=max(_rel(res[k], eager[k]) for k in res))
    if not (rec["max_rel_eager"] <= 1e-9 and rec["eager_captures"] == 0
            and (rec["steps"], rec["captures"], rec["replays"])
            == (DISTRIBUTE_STEPS, 1, DISTRIBUTE_STEPS - 1)):
        raise SystemExit(f"studies distribute: the graph-driven fit "
                         f"against the eager loop: {rec}")
    return rec


def phase_studies():
    """The study drivers at depth 10 on the card; the solver drivers also
    on the CPU, which they must equal within 1e-9."""
    import os
    import tempfile

    from arterynetwork_tpu_torch.io import ArtifactStore

    reset_counts()
    out = {"phase": "studies", "depth": STUDY_DEPTH, "seconds": {},
           "cpu_seconds": {}, "max_rel_cpu": {}, "graphs": {}}
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

            with solve_loops() as loops:
                res, secs = _sync_s(lambda: run("cuda"))
            out["seconds"][name] = secs
            if not _finite(res):
                raise SystemExit(f"studies {name}: non-finite output")
            msg = f"{name}: {secs:.3f} s on the card"
            if loops:
                out["graphs"][name] = _graph_solves(f"studies {name}", loops)
                msg += f" (flow solves graph-driven: {out['graphs'][name]})"
            if name == "distribute":
                out["distribute_fit"] = _fit_vs_eager(res, run)
                msg += f"; the fit {out['distribute_fit']}"
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
    launches, result512, _ = phase_pipeline(phantom, raw)

    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    vol, seed = tube_phantom(RG_SHAPE)
    phase_sweep_cases()
    phase_f64_grow()
    rec = phase_region_grow_kernels(vol, seed)
    while_rec = phase_graph_while()
    grown, ex = phase_region_grow_512(vol, seed)
    vmap = phase_value_map(vol, seed, ex)
    seeded = phase_seeded_pipeline(phantom, raw)
    voxel = phase_voxel_options(phantom, raw)
    graph_k1 = phase_graph_path(phantom, raw)
    t1 = time.perf_counter()
    sharded_counts = phase_sharded(raw)
    dryrun_counts = phase_dryrun_multichip()
    log("timing", f"sharded_512 and dryrun_multichip: "
        f"{time.perf_counter() - t1:.1f} s")
    _fresh()

    t_speck = t1 = time.perf_counter()
    speck = vascular_tree_phantom(SPECK_SHAPE, n_branches=800,
                                  root_radius=7.0, seed=0)
    t_tree = time.perf_counter() - t1
    raw_s = phantom_raw_volume(speck)
    log("data", f"{'x'.join(map(str, SPECK_SHAPE))} phantom, "
        f"{speck['n_branches']} branches, {int(speck['mask'].sum())} vessel "
        f"voxels: tree {t_tree:.1f} s, raw volume "
        f"{time.perf_counter() - t1 - t_tree:.1f} s on the host")
    t1 = time.perf_counter()
    speck_k1 = phase_speck_pipeline(speck, raw_s)
    del speck
    _fresh()
    log("timing", f"speck_pipeline: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    vol_s, seed_s = tube_phantom(SPECK_SHAPE, radius=3)
    log("data", f"{'x'.join(map(str, SPECK_SHAPE))} tube phantom: "
        f"{time.perf_counter() - t1:.1f} s on the host")
    t1 = time.perf_counter()
    speck_grown, speck_chunked = phase_speck_region_grow(vol_s, seed_s)
    _fresh()
    log("timing", f"speck_region_grow: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    speck_rec = phase_speck_kernels(raw_s, vol_s, seed_s)
    del vol_s, seed_s
    _fresh()
    log("timing", f"speck_kernels: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    speck_sharded = phase_sharded(raw_s, "speck_sharded", timed=1,
                                  extras=False)
    del raw_s
    _fresh()
    log("timing", f"speck_sharded: {time.perf_counter() - t1:.1f} s; the "
        f"Speck phases with their data {time.perf_counter() - t_speck:.1f} s")
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
             "frangi_response_fused": {"frangi_response": fused_launches},
             "speck_pipeline": {"frangi_response": speck_k1},
             **{f"speck_region_grow {k}": v for k, v in speck_grown.items()},
             "speck frangi_vesselness_chunked": {
                 "frangi_response": speck_chunked},
             "speck_sharded": speck_sharded}
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
        **k1, "speck": speck_rec["frangi_response"]}]
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
    for k in kernels[1:]:           # at Speck shapes (speck_kernels)
        k["speck"] = {c: r for c, r in speck_rec.items()
                      if c.split()[0] == k["name"]
                      or k["name"] == "sign_lookup" and c.startswith("table")}
    for k in kernels:       # K2's interior-window entry, K7's values route
        if k["name"] == "region_grow_sweep":
            k["window"] = rec["region_grow_sweep window"]
        if k["name"] == "sign_lookup":
            k["values"] = {c: r for c, r in rec.items()
                           if c.startswith("table_lookup")}
    for name in WHILE_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "graph_while.cu",
            "replaces": "arterynetwork_tpu/ops/region_grow_fused.py:297",
            "note": "no Pallas kernel: the condition of the JAX growers' "
                    "lax.while_loop (also ops/region_grow.py:250, "
                    "ops/region_grow_frontier.py:564)",
            "launches": seeded[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if c.get(name)},
            **while_rec[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
