#!/usr/bin/env python3
"""The sharded grower, the sharded thinning and the flow distribution's
Gauss-Newton fit of several trees of this repository on one CUDA card,
each tree in its own process, in the order given.

    python3 sharded_pair.py [--json PATH] TREE [TREE ...]

e.g. the parent commit against this tree, in turns:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 sharded_pair.py build/parent build/change build/change \\
        build/parent

Every tree runs, on the same inputs (made once, by this tree, and saved
under build/sharded_pair/), what chip_smoke.py's sharded_512,
speck_sharded and studies phases run of them, on a 2x2 mesh whose slots
repeat cuda:0:

  * grow_512 / grow_speck: ``parallel/sharded.region_grow`` (60
    iterations, 10^7 voxels) of the vesselness (sigmas 1 and 2) of the
    pipeline_512 raw volume / the Speck raw volume (880x880x640), seeded
    above half its range, as ``mini_pipeline_sharded`` calls it;
  * thin_512 / thin_speck: ``parallel/sharded.skeletonize`` (16 waves) of
    that grow's mask;
  * distribute_10: ``flow/distribute.distribute_flow_study`` (40
    Gauss-Newton steps, f64) on the study CLI's depth-10 tree (2,046
    edges), as the studies phase runs it.

Each case: a warm-up (timed: the cold call, with its counts; a tree
that caches its loops' graphs has its caches emptied before it), 3
timed runs (host clock ended by a synchronise),
one run traced by torch.profiler (thin_pair.py's ``traced``: busy time,
the idle share against the traced wall and against the timed runs'
median, the longest idle gaps with the device and host events around
them), the peak memory allocated and reserved over the case's five calls
(the allocator's cache emptied before each case), and, where the tree
keeps them, its host reads of ``stop``, passes, graphs captured, replays
and seconds spent capturing (and the grower's while graphs launched).
The voxel cases' results (a checksum) must
agree between all the runs of all the trees; the fit's fractions, edge
flows and RMS mismatch within 1e-9 (relative; its merge sums use
atomics on the card).  The whole record goes to ``--json`` (by default
build/sharded_pair.json) and, as one JSON line, last to stdout.  Exits
non-zero without a CUDA device or if two runs disagree.
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
DATA = os.path.join(ROOT, "build", "sharded_pair")
RUNS = 3
FIT_TOL = 1e-9
COUNTS = ("route", "wave_passes", "final_passes", "steps", "reads",
          "captures", "replays", "capture_s")


def _module(name):
    """This tree's root script ``name``.py as a module (chip_smoke.py's
    helpers import the package lazily, so they use the tree the worker
    put first)."""
    spec = importlib.util.spec_from_file_location(
        f"sharded_pair_{name}", os.path.join(ROOT, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs():
    """The two vesselness volumes, as .npy under build/sharded_pair/."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    cs = _module("chip_smoke")
    os.makedirs(DATA, exist_ok=True)
    t0 = time.perf_counter()
    for name, phantom in (
            ("v512", lambda: vascular_tree_phantom(
                (512, 512, 170), n_branches=400, seed=0)),
            ("v_speck", lambda: vascular_tree_phantom(
                cs.SPECK_SHAPE, n_branches=800, root_radius=7.0, seed=0))):
        raw = phantom_raw_volume(phantom())
        vol = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).cuda()
        del raw
        v = frangi_vesselness(vol, sigmas=cs.SHARDED_SIGMAS)
        del vol
        np.save(os.path.join(DATA, name + ".npy"), v.cpu().numpy())
        del v
        torch.cuda.empty_cache()
    print(f"inputs: {time.perf_counter() - t0:.1f} s", flush=True)


def _counts(fn):
    return {k: getattr(fn, k) for k in COUNTS if hasattr(fn, k)}


def worker(tree):
    """One tree's cases on the saved inputs; prints one JSON line."""
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != ROOT]
    import numpy as np
    import torch

    import arterynetwork_tpu_torch as pkg
    from arterynetwork_tpu_torch.flow import distribute
    from arterynetwork_tpu_torch.ops import grow_loop
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       shard_volume)

    assert pkg.__file__.startswith(os.path.abspath(tree)), pkg.__file__
    cs = _module("chip_smoke")
    traced = _module("thin_pair").traced
    mesh = make_volume_mesh([torch.device("cuda", 0)] * 4)

    def grow_inputs(name):
        v = shard_volume(torch.from_numpy(np.load(os.path.join(
            DATA, name + ".npy"))).cuda(), mesh)
        blocks = list(v.blocks.reshape(-1))     # mini_pipeline_sharded's
        vmin = torch.min(torch.stack([torch.min(b) for b in blocks]))
        vmax = torch.max(torch.stack([torch.max(b) for b in blocks]))
        thr = vmin + 0.5 * (vmax - vmin)
        return v, v.map(lambda b: b > thr)

    def grow(v, seeds):
        return lambda: sharded.region_grow(v, seeds, max_segment_size=10 ** 7,
                                           iter_max=cs.SHARDED_ITERS)

    def grow_key(res):
        return (res.segmented_map.gather().cpu().numpy().tobytes()
                + np.array([int(res.iterations), int(res.segmented_count),
                            int(res.stop_reason)]).tobytes())

    def grow_counts():
        return {"reads": grow_loop.read_stop.reads,
                "captures": grow_loop.graph_loop.captures,
                "replays": grow_loop.graph_loop.replays,
                "launches": getattr(grow_loop.graph_loop, "launches", None),
                "capture_s": getattr(grow_loop.graph_loop, "capture_s",
                                     None),
                "route": getattr(sharded.region_grow, "route", None)}

    net = cs._study_net(cs.STUDY_DEPTH)[0]

    def fit():
        out = distribute.distribute_flow_study(net, device="cuda")
        return [out["fractions"], out["edge_flow"],
                np.array([out["rms_mismatch_mmhg"]])]

    rec = {"tree": tree, "cases": {}}
    for size in ("512", "speck"):
        v, seeds = grow_inputs("v512" if size == "512" else "v_speck")
        mask = grow(v, seeds)().segmented_map
        cases = [(f"grow_{size}", grow(v, seeds), grow_key, grow_counts),
                 (f"thin_{size}",
                  lambda: sharded.skeletonize(mask, cs.SHARDED_WAVES),
                  lambda out: out.gather().cpu().numpy().tobytes(),
                  lambda: _counts(sharded.skeletonize))]
        if size == "speck":
            cases.append(("distribute_10", fit, None,
                          lambda: _counts(distribute.distribute_flow)))
        for name, fn, key, counts_of in cases:
            torch.cuda.empty_cache()               # each case from one state
            torch.cuda.reset_peak_memory_stats()

            def reset():
                grow_loop.read_stop.reads = 0
                grow_loop.graph_loop.captures = 0
                grow_loop.graph_loop.replays = 0
                grow_loop.graph_loop.capture_s = 0.0
                grow_loop.graph_loop.launches = 0

            reset()
            getattr(grow_loop, "clear_loop_caches",
                    lambda: None)()                # a cold call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()                                   # warm-up: the cold call
            torch.cuda.synchronize()
            cold_s, cold_counts = time.perf_counter() - t0, counts_of()
            times = []
            for _ in range(RUNS):
                reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            counts = counts_of()
            wall, busy, idle, gaps = traced(fn)
            med = statistics.median(times)
            r = {"cold_s": cold_s, "cold_counts": cold_counts,
                 "times_s": times, "median_s": med, "traced_wall_s": wall,
                 "busy_s": busy, "idle": idle, "idle_untraced": 1 - busy / med,
                 "gaps": gaps, "peak_reserved_mib":
                     torch.cuda.max_memory_reserved() / 2 ** 20,
                 "peak_allocated_mib":
                     torch.cuda.max_memory_allocated() / 2 ** 20,
                 "counts": counts}
            if key is None:
                r["arrays"] = [np.asarray(a, np.float64).tolist()
                               for a in out]
                r["result"] = hashlib.sha1(b"".join(
                    np.asarray(a, np.float64).tobytes()
                    for a in out)).hexdigest()
            else:
                r["result"] = hashlib.sha1(key(out)).hexdigest()
            rec["cases"][name] = r
            del out
        del v, seeds, mask, cases
    print(json.dumps(rec), flush=True)


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="trees of this repository")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "sharded_pair.json"),
                    help="where to write the whole record")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sharded_pair: no CUDA device")
    if not args.trees:
        raise SystemExit("sharded_pair: name at least one tree")
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
            raise SystemExit(f"sharded_pair: the worker of {tree} failed:"
                             f"\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
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
                  f"median {r['idle_untraced']:.1%}); counts "
                  f"{r['counts'] or 'not kept'}; peak allocated "
                  f"{r['peak_allocated_mib']:.0f} MiB, reserved "
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
    first = runs[0]["cases"]
    same, fit_rel = True, 0.0
    for run in runs:
        for name, r in run["cases"].items():
            if "arrays" in r:
                fit_rel = max([fit_rel] + [_rel(a, b) for a, b in zip(
                    r["arrays"], first[name]["arrays"])])
            else:
                same &= r["result"] == first[name]["result"]
    for run in runs:
        for r in run["cases"].values():
            r.pop("arrays", None)
    ok = same and fit_rel <= FIT_TOL
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "runs": runs, "same_results": same, "fit_max_rel": fit_rel}
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(f"every run gives the same grows and skeletons: {same}; the fits "
          f"agree within {fit_rel:.3e} (relative; at most {FIT_TOL})",
          flush=True)
    print(json.dumps(res), flush=True)
    if not ok:
        raise SystemExit("sharded_pair: the runs' results differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
