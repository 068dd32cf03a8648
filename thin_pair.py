#!/usr/bin/env python3
"""The device thinning and the connected components of several trees of
this repository on one CUDA card, each tree in its own process, in the
order given.

    python3 thin_pair.py [--json PATH] TREE [TREE ...]

e.g. the parent commit against this tree, in turns:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 thin_pair.py build/parent build/change build/change \\
        build/parent

Every tree runs, on the same masks (made once, by this tree, and saved
under build/thin_pair/), what chip_smoke.py runs of them:

  * thin_512: ``ops/thinning.skeletonize`` (the LUT route, 64 waves) on
    voxel_options_512's mask (pipeline_512's phantom and configuration
    with the brain ellipsoid and the tip extension);
  * thin_speck: ``skeletonize(max_waves=16)`` on speck_sharded's
    single-device mask (the Speck raw volume's vesselness, sigmas 1 and
    2, grown 60 iterations from the voxels above half its range);
  * cc_512_64 and cc_512_converged: ``ops/cc.connected_components`` on
    the 512 mask at its default 64 rounds and with 4096 (it converges
    first).

Each case: a warm-up (timed: the cold call, with its counts; a tree
that caches its loops' graphs has its caches emptied before it), 3 timed
runs (host clock ended by a synchronise),
one run traced by torch.profiler for the device's idle share (as
chip_smoke.py's ``device_idle``: 1 - busy / wall, the tracer's host cost
included; and 1 - busy / the timed runs' median) and where the device
idled (``traced``: the longest idle intervals, with the device events
around each and the host events during it), the peak memory allocated
and reserved over the case's five calls (the allocator's cache emptied
before each case), and, where the tree's function keeps them,
its passes or rounds, host reads, graphs captured, replays and seconds
spent capturing.  The result of each case (a
checksum) must agree between all the runs of all the trees.  The whole
record goes to ``--json`` (by default build/thin_pair.json) and, as one
JSON line, last to stdout.  Exits non-zero without a CUDA device or if
two runs disagree.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "thin_pair")
RUNS = 3
COUNTS = ("wave_passes", "final_passes", "rounds", "reads", "captures",
          "replays", "capture_s")


def _chip_smoke():
    """This tree's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree the worker put first)."""
    spec = importlib.util.spec_from_file_location(
        "thin_pair_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs():
    """The two masks, bit-packed under build/thin_pair/."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.region_grow import region_grow
    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
    from arterynetwork_tpu_torch.pipeline import (generate_vessel_mask,
                                                  vesselness_stage)
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    cs = _chip_smoke()
    os.makedirs(DATA, exist_ok=True)
    t0 = time.perf_counter()
    raw = phantom_raw_volume(vascular_tree_phantom((512, 512, 170),
                                                   n_branches=400, seed=0))
    cfg = cs.bench_config()
    seg = cfg.segmentation
    seg.tip_fraction, seg.tip_iters, seg.tip_neighbor_max = 0.015, 3, 4
    v = vesselness_stage(raw, cfg, device="cuda")
    mask512 = generate_vessel_mask(
        v, cs._brain_ellipsoid(raw.shape, cs.BRAIN_AXES), cfg,
        device="cuda")
    del raw, v
    raw_s = phantom_raw_volume(vascular_tree_phantom(
        cs.SPECK_SHAPE, n_branches=800, root_radius=7.0, seed=0))
    vol = torch.from_numpy(np.ascontiguousarray(raw_s, np.float32)).cuda()
    del raw_s
    v1 = frangi_vesselness(vol, sigmas=cs.SHARDED_SIGMAS)
    del vol
    vmin, vmax = torch.min(v1), torch.max(v1)
    grown = region_grow(v1, v1 > vmin + 0.5 * (vmax - vmin),
                        max_segment_size=10 ** 7, iter_max=cs.SHARDED_ITERS)
    mask_s = grown.segmented_map.cpu().numpy()
    del v1, grown
    torch.cuda.empty_cache()
    for name, m in (("mask512", mask512), ("mask_speck", mask_s)):
        m = np.asarray(m, bool)
        np.savez(os.path.join(DATA, name + ".npz"), bits=np.packbits(m),
                 shape=np.array(m.shape))
    print(f"inputs: 512 mask {int(mask512.sum())} voxels, Speck mask "
          f"{int(mask_s.sum())} voxels, {time.perf_counter() - t0:.1f} s",
          flush=True)


def _load(name):
    import numpy as np

    with np.load(os.path.join(DATA, name + ".npz")) as f:
        shape = tuple(f["shape"])
        return np.unpackbits(f["bits"])[:int(np.prod(shape))].reshape(
            shape).astype(bool)


def traced(fn, top=8):
    """One run of ``fn`` traced by torch.profiler, as chip_smoke.py's
    ``device_idle`` (busy: the union of the device events' intervals)
    -> (wall s, busy s, idle share, gaps): the device's idle time before
    its first event within the call, its idle time in all, and the
    ``top`` longest idle intervals, each
    with the device events around it and the host events that overlap
    it most (what the host did meanwhile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("thin_pair call"):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    call = next(e.time_range for e in events if e.name == "thin_pair call"
                and e.device_type == DeviceType.CPU)
    # the range's own annotation on the device's timeline is no work
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name not in ("Activity Buffer Request",
                                      "thin_pair call"))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name != "thin_pair call"]
    busy, end, before, idle = 0.0, call.start, "(call start)", []
    for a, b, name in spans:                   # microseconds
        if a > end:
            idle.append((a - end, end, a, before, name))
        if b > end:
            busy += b - max(a, end)
            end, before = b, name
    if call.end > end:
        idle.append((call.end - end, end, call.end, before, "(call end)"))

    def during(a, b):
        over = {}
        for s, e, name in host:
            o = min(b, e) - max(a, s)
            if o > 0 and e - s < 0.5 * (call.end - call.start):
                over[name] = over.get(name, 0.0) + o
        return [(n, round(o / 1e3, 3)) for n, o in
                sorted(over.items(), key=lambda kv: -kv[1])[:4]]

    gaps = {"lead_ms": idle[0][0] / 1e3 if idle and idle[0][1] ==
            call.start else 0.0,
            "idle_ms": sum(g[0] for g in idle) / 1e3, "longest": [
                {"ms": g / 1e3, "at_ms": (a - call.start) / 1e3,
                 "after": x, "before": y, "host_ms": during(a, b)}
                for g, a, b, x, y in sorted(idle, reverse=True)[:top]]}
    return wall, busy / 1e6, 1 - busy / 1e6 / wall, gaps


def worker(tree):
    """One tree's cases on the saved masks; prints one JSON line."""
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != ROOT]
    import numpy as np
    import torch

    import arterynetwork_tpu_torch as pkg
    from arterynetwork_tpu_torch.ops import cc, grow_loop, thinning

    assert pkg.__file__.startswith(os.path.abspath(tree)), pkg.__file__
    cs = _chip_smoke()
    m512 = torch.from_numpy(_load("mask512")).cuda()
    m_speck = torch.from_numpy(_load("mask_speck")).cuda()
    sk, ccf = thinning.skeletonize, cc.connected_components
    cases = {
        "thin_512": (lambda: sk(m512), sk),
        "thin_speck": (lambda: sk(m_speck, max_waves=cs.SHARDED_WAVES), sk),
        "cc_512_64": (lambda: ccf(m512), ccf),
        "cc_512_converged": (lambda: ccf(m512, max_rounds=1 << 12), ccf),
    }
    rec = {"tree": tree, "cases": {}}
    for name, (fn, counted) in cases.items():
        torch.cuda.empty_cache()                   # each case from one state
        torch.cuda.reset_peak_memory_stats()
        getattr(grow_loop, "clear_loop_caches",
                lambda: None)()                    # a cold call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()                                       # warm-up: the cold call
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_counts = {k: getattr(counted, k) for k in COUNTS
                       if hasattr(counted, k)}
        times = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = {k: getattr(counted, k) for k in COUNTS
                  if hasattr(counted, k)}
        wall, busy, idle, gaps = traced(fn)
        med = statistics.median(times)
        rec["cases"][name] = {
            "cold_s": cold_s, "cold_counts": cold_counts,
            "times_s": times, "median_s": med, "traced_wall_s": wall,
            "busy_s": busy, "idle": idle, "idle_untraced": 1 - busy / med,
            "gaps": gaps, "peak_reserved_mib":
                torch.cuda.max_memory_reserved() / 2 ** 20,
            "peak_allocated_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "counts": counts, "voxels": int(out.count_nonzero()),
            "result": hashlib.sha1(np.ascontiguousarray(
                out.cpu().numpy()).tobytes()).hexdigest()}
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="trees of this repository")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "thin_pair.json"),
                    help="where to write the whole record")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("thin_pair: no CUDA device")
    if not args.trees:
        raise SystemExit("thin_pair: name at least one tree")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{smi}", flush=True)
    make_inputs()
    runs = []
    for tree in args.trees:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(tree)],
                           capture_output=True, text=True, timeout=900)
        if p.returncode:
            raise SystemExit(f"thin_pair: the worker of {tree} failed:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        runs.append(rec)
        for name, r in rec["cases"].items():
            print(f"{tree} {name}: cold {r.get('cold_s', 0):.4f} s ("
                  f"counts {r.get('cold_counts')}), median "
                  f"{r['median_s']:.4f} s ("
                  + ", ".join(f"{t:.4f}" for t in r["times_s"])
                  + f"), traced {r['traced_wall_s']:.4f} s, busy "
                  f"{r['busy_s']:.4f} s, idle {r['idle']:.1%} (against the "
                  f"median {r['idle_untraced']:.1%}); {r['voxels']} "
                  f"nonzero; counts {r['counts'] or 'not kept'}; peak "
                  f"allocated {r['peak_allocated_mib']:.0f} MiB, reserved "
                  f"{r['peak_reserved_mib']:.0f} MiB", flush=True)
            g = r["gaps"]
            print(f"  idle in the traced call {g['idle_ms']:.1f} ms, "
                  f"{g['lead_ms']:.1f} before the first device event; "
                  "longest: " + "; ".join(
                      f"{x['ms']:.1f} ms at {x['at_ms']:.1f} ("
                      f"{x['after'][:60]} -> {x['before'][:60]}; host "
                      f"{x['host_ms']})"
                      for x in g["longest"][:5]), flush=True)
        print(f"{tree}: process {rec['process_s']:.1f} s", flush=True)
    same = all({k: r["result"] for k, r in run["cases"].items()}
               == {k: r["result"] for k, r in runs[0]["cases"].items()}
               for run in runs)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "runs": runs, "same_results": same}
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(f"every run gives the same results: {same}", flush=True)
    print(json.dumps(res), flush=True)
    if not same:
        raise SystemExit("thin_pair: the runs' results differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
