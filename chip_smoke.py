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
               plus a dark and a ragged call; device and call times;
  4. small   — the port's run_pipeline on a small phantom on the CPU (twin)
               and on the card (kernel): the outputs must agree;
  5. pipeline_512 — run_pipeline on the 512x512x170 400-branch phantom
               with bench.py's pipeline_512 configuration: one warm-up
               and three timed runs, 44 kernel launches per run, finite
               pressures and flows, mask recall >= 0.95;
  6. region_grow_kernels — K6b, K6a, K2 (and the banded entries K3/K4
               run on it), K5 and K7 (values and sign modes) against their
               plain PyTorch versions on the card, at the region-grow
               path's shapes (bench.py's 512x512x170 tube phantom and its
               state after 20 iterations): equal outputs; device and call
               times of kernel, plain version and, where one PyTorch call
               computes the same function, that call; each kernel's bound;
  7. region_grow_512 — bench.py's bench_region_grow workload through
               region_grow "auto" (K2 + K6b), "xla" (K6b + K7) and
               region_grow_frontier (K5 + K6b), each also with the plain
               versions on the card: one (iterations, count) and one mask
               for all; then "xla" with an excluded slab (K6a + K7);
  8. value_map_512 — the reference's interface, region_grow_value_map,
               on the tube with the excluded slab as state 4: one warm-up
               and three timed runs (K6a + K7 per iteration, the value map
               rebuilt on the card), equal to the "xla" excluded grower;
  9. seeded_pipeline_512 — run_pipeline(raw_volume, seed_mask) on the
               pipeline_512 phantom, seeded with the 3x3x3 cube at the
               tree's root: one warm-up and three timed runs, finite
               pressures and flows, at least one segment.

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
import json
import statistics
import subprocess
import sys
import time

K1_TOL = 1e-5          # kernel vs twin, max |d| on responses in [0, 1]
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
    return {"max_abs_err": max_err, **rec}


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
    return rec


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
    totals = []
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
    v = vesselness_stage(raw, cfg, device="cuda")
    mask, res = refine_mask_region_grow(v, seed, cfg, device="cuda")
    sol = result["solution"]
    finite = bool(torch.isfinite(sol.pressure).all()
                  and torch.isfinite(sol.flow).all())
    recall = float(mask[phantom["mask"]].astype(bool).mean())
    log("seeded_pipeline_512", f"median total "
        f"{statistics.median(totals):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in totals)}); region growing "
        f"{int(res.iterations)} iterations, stop reason "
        f"{int(res.stop_reason)}; mask voxels {int(mask.sum())}; recall "
        f"{recall:.4f}; segments {len(result['segments'])}; flow edges "
        f"{result['network'].num_edges}; pressures/flows finite {finite}")
    if not np.array_equal(mask, result["mask"]):
        raise SystemExit("the seeded mask differs between two runs")
    if not finite or len(result["segments"]) < 1:
        raise SystemExit("seeded pipeline: no segment or non-finite flow")
    return counts


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

    k1 = phase_kernel(raw)
    phase_small()
    launches = phase_pipeline(phantom, raw)

    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    vol, seed = tube_phantom(RG_SHAPE)
    rec = phase_region_grow_kernels(vol, seed)
    grown, ex = phase_region_grow_512(vol, seed)
    vmap = phase_value_map(vol, seed, ex)
    seeded = phase_seeded_pipeline(phantom, raw)

    paths = {"pipeline_512": {"frangi_response": launches},
             **{f"region_grow_512 {k}": v for k, v in grown.items()},
             "value_map_512": vmap, "seeded_pipeline_512": seeded}
    log("launches", json.dumps({p: {k: v for k, v in c.items() if v}
                                for p, c in paths.items()}))

    csrc = "arterynetwork_tpu_torch/csrc/"
    kernels = [{
        "name": "frangi_response", "route": "cuda",
        "source": csrc + "frangi_response.cu",
        "replaces": "arterynetwork_tpu/ops/vesselness_fused.py:159",
        "launches": launches, **k1}]
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
                        "launches": n, **rec[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
