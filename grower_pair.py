#!/usr/bin/env python3
"""The single-device region growers of several trees of this repository
on one CUDA card, each tree in its own process, in the order given.

    python3 grower_pair.py [--json PATH] TREE [TREE ...]

e.g. the parent commit against this tree, in turns:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 grower_pair.py build/parent build/change build/change \\
        build/parent

Every tree runs, on the same inputs (made once from seeds and saved
under build/grower_pair/), what chip_smoke.py's grower phases run:

  * region_grow_512: bench.py's tube phantom at 512x512x170 (10^6
    voxels, 300 iterations) through region_grow "auto" (the fused
    grower), "xla" (the full grid), region_grow_frontier, and "xla" with
    chip_smoke.py's excluded slab;
  * value_map_512: region_grow_value_map on the tube with that slab as
    state 4;
  * seeded_pipeline_512: run_pipeline(raw_volume, seed_mask) on the
    pipeline_512 phantom with bench.py's configuration, seeded at the
    tree's root, its `segmentation` stage being the seeded grower;
  * speck_region_grow: the tube at 880x880x640 (radius 3; 10^7 voxels,
    60 iterations) through "auto", "xla" and the frontier grower.

Each: a warm-up (timed: the cold call, with its loop counts; a tree
that caches its growers' graphs has its caches emptied before it), then
3 timed runs (host clock ended by a synchronise),
then one run traced by torch.profiler for the device's idle share
(chip_smoke.py's ``device_idle``: 1 - busy / wall, an upper bound, the
tracer's host cost included; and 1 - busy / the timed runs' median) and
the device time of that run by event name (events, microseconds); a
tree with ops/grow_loop.py also gives its host reads of ``stop``, graphs
captured and steps run from them per grow, and, with its while graph,
the while graphs launched and the seconds spent capturing and building
them.  The iterations, count, stop reason and a
checksum of each mask (and active map, and value map) must agree between
all the runs.  The whole record goes to ``--json`` (by default
build/grower_pair.json) and, as one JSON line, last to stdout.  Exits
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
DATA = os.path.join(ROOT, "build", "grower_pair")
RUNS = 3


def _chip_smoke():
    """This tree's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree the worker put first)."""
    spec = importlib.util.spec_from_file_location(
        "grower_pair_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs():
    """The tube phantoms, the pipeline_512 phantom's raw volume and the
    seeded pipeline's seed cube, saved as .npy under build/grower_pair/."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, tube_phantom, vascular_tree_phantom)

    cs = _chip_smoke()
    os.makedirs(DATA, exist_ok=True)
    t0 = time.perf_counter()
    vol, seed = tube_phantom(cs.RG_SHAPE)
    np.save(os.path.join(DATA, "tube512.npy"), vol)
    np.save(os.path.join(DATA, "tube512_seed.npy"), seed)
    phantom = vascular_tree_phantom((512, 512, 170), n_branches=400, seed=0)
    raw = phantom_raw_volume(phantom)
    seed = np.zeros(raw.shape, bool)
    seed[tuple(slice(max(c - 1, 0), c + 2) for c in phantom["root"])] = True
    np.save(os.path.join(DATA, "raw512.npy"), raw)
    np.save(os.path.join(DATA, "raw512_seed.npy"), seed)
    vol, seed = tube_phantom(cs.SPECK_SHAPE, radius=3)
    np.save(os.path.join(DATA, "speck_tube.npy"), vol)
    np.save(os.path.join(DATA, "speck_tube_seed.npy"), seed)
    print(f"inputs: {time.perf_counter() - t0:.1f} s on the host",
          flush=True)


def _sha1(a):
    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def worker(tree):
    """One tree's growers on the saved inputs; prints one JSON line."""
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != ROOT]
    import numpy as np
    import torch

    import arterynetwork_tpu_torch as pkg
    from arterynetwork_tpu_torch.ops import (region_grow,
                                             region_grow_frontier,
                                             region_grow_value_map)
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    assert pkg.__file__.startswith(os.path.abspath(tree)), pkg.__file__
    try:
        from arterynetwork_tpu_torch.ops import grow_loop
    except ImportError:              # a tree from before the graph loop
        grow_loop = None
    cs = _chip_smoke()

    cold = []                                  # (s, loop counts) a call
    # a tree without loop caches has nothing to empty
    clear_caches = getattr(grow_loop, "clear_loop_caches", lambda: None)

    def loop_counts(fn):
        if grow_loop is None:
            fn()
            torch.cuda.synchronize()
            return None
        g = grow_loop.graph_loop
        grow_loop.read_stop.reads = 0
        g.captures = g.replays = 0
        g.launches, g.capture_s = 0, 0.0
        fn()
        torch.cuda.synchronize()
        return {"reads": grow_loop.read_stop.reads,
                "captures": g.captures, "replays": g.replays,
                "launches": g.launches, "capture_s": g.capture_s}

    def timed(fn):
        clear_caches()                         # a cold call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold_loop = loop_counts(fn)            # warm-up: the cold call
        cold.append((time.perf_counter() - t0, cold_loop))
        times = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, times

    def grower(fn):
        res, times = timed(fn)
        names = {}
        wall, busy, idle = cs.device_idle(fn, names)    # warm
        med = statistics.median(times)
        return {"cold_s": cold[-1][0], "cold_loop": cold[-1][1],
                "times_s": times, "median_s": med,
                "traced_wall_s": wall, "busy_s": busy, "idle": idle,
                "idle_untraced": 1 - busy / med,
                "device_by_name": dict(sorted(names.items(),
                                              key=lambda kv: -kv[1][1])),
                "loop": loop_counts(fn),
                "result": [int(res.iterations), int(res.segmented_count),
                           int(res.stop_reason),
                           _sha1(res.segmented_map.cpu().numpy()),
                           _sha1(res.active_map.cpu().numpy())]}

    def load(name):
        return np.load(os.path.join(DATA, f"{name}.npy"))

    rec = {"tree": tree}
    vol, seed = load("tube512"), load("tube512_seed")
    data = torch.from_numpy(vol).cuda()
    sd = torch.from_numpy(seed).cuda()
    excluded = torch.zeros_like(sd)
    excluded[:cs.SLAB] = True
    kw = cs.RG_KW
    rec["region_grow_512"] = {
        "auto": grower(lambda: region_grow(data, sd, **kw)),
        "xla": grower(lambda: region_grow(data, sd, backend="xla", **kw)),
        "frontier": grower(lambda: region_grow_frontier(data, sd, **kw)),
        "xla excluded": grower(lambda: region_grow(
            data, sd, excluded, backend="xla", **kw))}
    value_map = np.full(vol.shape, 3)
    value_map[seed] = 0
    value_map[:cs.SLAB] = 4
    out, times = timed(lambda: region_grow_value_map(
        vol, value_map, device="cuda", **kw))
    rec["value_map_512"] = {"times_s": times,
                            "median_s": statistics.median(times),
                            "result": [_sha1(a) for a in out]}
    del data, sd, excluded, vol, seed, value_map, out

    cfg = cs.bench_config()
    cfg.segmentation.max_segment_size = 10 ** 6
    raw, seed = load("raw512"), load("raw512_seed")
    totals, seg_s = [], []
    for i in range(RUNS + 1):                  # run 0 is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_pipeline(raw_volume=raw, seed_mask=seed, config=cfg,
                              device="cuda")
        torch.cuda.synchronize()
        if i:
            totals.append(time.perf_counter() - t0)
            seg_s.append(result["timings"]["segmentation"])
    rec["seeded_pipeline_512"] = {
        "total_s": totals, "segmentation_s": seg_s,
        "median_total_s": statistics.median(totals),
        "median_segmentation_s": statistics.median(seg_s),
        "result": [_sha1(result["mask"]), len(result["segments"])]}
    del raw, seed, result
    torch.cuda.empty_cache()

    vol, seed = load("speck_tube"), load("speck_tube_seed")
    data = torch.from_numpy(vol).cuda()
    sd = torch.from_numpy(seed).cuda()
    del vol, seed
    kw = cs.SPECK_RG_KW
    rec["speck_region_grow"] = {
        "auto": grower(lambda: region_grow(data, sd, **kw)),
        "xla": grower(lambda: region_grow(data, sd, backend="xla", **kw)),
        "frontier": grower(lambda: region_grow_frontier(data, sd, **kw))}
    print(json.dumps(rec), flush=True)


def _results(rec):
    """Every result of a run, by (cell, grower)."""
    out = {}
    for cell, v in rec.items():
        if not isinstance(v, dict):            # the tree, process_s
            continue
        if "result" in v:
            out[cell] = v["result"]
        else:
            out.update({(cell, g): r["result"] for g, r in v.items()})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="trees of this repository")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "grower_pair.json"),
                    help="where to write the whole record")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("grower_pair: no CUDA device")
    if not args.trees:
        raise SystemExit("grower_pair: name at least one tree")
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
            raise SystemExit(f"grower_pair: the worker of {tree} failed:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        runs.append(rec)
        for cell in ("region_grow_512", "speck_region_grow"):
            print(f"{tree} {cell}: " + "; ".join(
                f"{g} cold {r.get('cold_s', 0):.4f} s (loop "
                f"{r.get('cold_loop')}), median {r['median_s']:.4f} s ("
                + ", ".join(f"{t:.4f}" for t in r["times_s"])
                + f"), traced {r['traced_wall_s']:.4f} s, idle "
                f"{r['idle']:.1%} (against the median "
                f"{r['idle_untraced']:.1%}), iterations {r['result'][0]}, loop "
                f"{r['loop']}" for g, r in rec[cell].items()), flush=True)
        s = rec["seeded_pipeline_512"]
        print(f"{tree} value_map_512: median "
              f"{rec['value_map_512']['median_s']:.4f} s; "
              f"seeded_pipeline_512: median total {s['median_total_s']:.4f}"
              f" s, segmentation {s['median_segmentation_s']:.4f} s "
              f"({', '.join(f'{t:.4f}' for t in s['segmentation_s'])}); "
              f"process {rec['process_s']:.1f} s", flush=True)
    same = all(_results(r) == _results(runs[0]) for r in runs)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "runs": runs, "same_results": same}
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(f"every run gives the same results: {same}", flush=True)
    print(json.dumps(res), flush=True)
    if not same:
        raise SystemExit("grower_pair: the runs' results differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
