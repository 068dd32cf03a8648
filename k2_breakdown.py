#!/usr/bin/env python3
"""Where K2's interior-window route spends its time on one CUDA card,
which tiling its launcher keeps, and the sharded grower against an older
tree.

    python3 k2_breakdown.py [--baseline OLD.cu] [--parent DIR]
                            [--no-speck] [--json PATH]

K2 (csrc/region_grow_sweep.cu) on the region-growing path's states, the
tube phantom of bench.py after 20 full-grid iterations (chip_smoke.py's
``_grow_state``), at 512x512x170 and at 880x880x640, swept

  * over the interior window of a block of the sharded grower's 2x2 mesh
    with its one-voxel halo: at 512 the 258x258x170 block around the
    tube that chip_smoke.py's region_grow_kernels times, at Speck the
    block with the most boundary voxels (speck_kernels' block); and
  * over the whole grid (the single-device grower's call).

Every build and every tiling is first held to the plain version on each
case (the window's voxels and the counts, exactly), then timed as bare
launches (the ctypes call alone, into buffers made once): CUDA events
around 20 back-to-back launches, and for each build's own tiling also a
torch.profiler trace (chip_smoke.py's ``device_ms``; None when every
trace dropped events).  The bound of a case is chip_smoke.py's: the
region read and written once and the bins of its boundary voxels, over
3.35 TB/s.

The builds: "port" (the source as it is), variants made from it by
substitution (VARIANTS below), and with ``--baseline`` an older source
with the same C interface, e.g. the parent commit's:

    git show a508944:arterynetwork_tpu_torch/csrc/region_grow_sweep.cu \\
        > build/k2_baseline.cu

One more build, "tiled" (TILED below), adds to the port's launcher an
entry ``force_tiling(rows per strip, planes per z-run)`` that overrides
its own choice; TILINGS below are tried on every case through it, and
the fastest is printed beside the launcher's own.

With ``--parent DIR`` (a tree of an older commit, e.g. ``git archive
a508944 | tar -x -C build/parent``): the sharded grower,
``parallel/sharded.region_grow`` on a 2x2 mesh of cuda:0, of each tree
on the inputs of chip_smoke.py's sharded_512 and speck_sharded (the
vesselness of their raw phantoms, sigmas 1 and 2, and its strong seeds;
60 iterations at most), one process per tree in the order parent,
change, change, parent: a warm-up and 3 timed grows each (host clock
ended by a synchronise), with iterations, count, stop reason and a
checksum of the mask, which must agree between the trees.

The whole record goes to ``--json`` (by default build/k2_breakdown.json)
and, as one JSON line, last to stdout.  Exits non-zero without a CUDA
device or if any build or tiling disagrees with the plain version.
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kernel_probe import build_all, events_ms, variants  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
RG_SHAPE = (512, 512, 170)
SPECK_SHAPE = (880, 880, 640)
SMEM_MAX = 232448               # dynamic shared memory a block may use
GROW_ITERS = 60                 # mini_pipeline_sharded's default
GROW_RUNS = 3

# name: (old, new, ...) substitutions into csrc/region_grow_sweep.cu
VARIANTS = {
    "strips_1word": ("std::min({Yw, 2 * kThreads / nw - 2,",
                     "std::min({Yw, kThreads / nw - 2,"),
    "max_rows48": ("constexpr int kMaxRows = 64;",
                   "constexpr int kMaxRows = 48;"),
    "max_rows96": ("constexpr int kMaxRows = 64;",
                   "constexpr int kMaxRows = 96;"),
    "threads512": ("constexpr int kThreads = 256;",
                   "constexpr int kThreads = 512;"),
}

# The "tiled" build: the launcher's strip height and z-run length, where
# force_tiling set them (0 = its own choice).
TILED = (
    'extern "C" int region_grow_sweep(',
    "static int forced_rb = 0, forced_zc = 0;\n"
    'extern "C" void force_tiling(int rb, int zc) {\n'
    "  forced_rb = rb;\n  forced_zc = zc;\n}\n\n"
    'extern "C" int region_grow_sweep(',
    "const int RB = (Yw + fewest - 1) / fewest,",
    "const int RB = forced_rb ? std::min(forced_rb, Yw)\n"
    "                         : (Yw + fewest - 1) / fewest,",
    "const int zc = (Zw + runs - 1) / runs;",
    "const int zc = forced_zc ? std::min(forced_zc, Zw)\n"
    "                         : (Zw + runs - 1) / runs;")

# forced (rows per strip, planes per z-run), on every case
TILINGS = [(rb, zc) for rb in (4, 8, 10, 12, 16, 20, 24, 32, 37, 43, 52, 64,
                               86, 128)
           for zc in (1, 2, 3, 4, 6, 8, 11, 16, 25, 32, 64)]


def build(sources):
    """{name: (ctypes library, ptxas lines)} of {name: CUDA source text},
    every nvcc started together, into build/k2_probe/; a build that fails
    is reported and left out."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (lib, lines, _) in build_all(sources, "k2_probe").items():
        lib.region_grow_sweep.restype = I
        lib.region_grow_sweep.argtypes = [P, P, P, P, I, I, I, LL, LL] \
            + [I] * 6 + [P, P]
        if hasattr(lib, "force_tiling"):
            lib.force_tiling.argtypes = [I, I]
        libs[name] = (lib, lines)
    return libs


def smem_bytes(rb, x):
    """The launcher's shared memory for strips of ``rb`` rows of ``x``
    bytes (csrc/region_grow_sweep.cu: smem_bytes, plus the static
    histogram and words)."""
    nw = (x + 31) // 32
    stage = ((rb + 1) * x + 32 * nw + 64) // 16 * 16
    return 3 * stage + 4 * (6 * (rb + 2) * nw + 6 * rb * nw) + 2048 + 32


def run_case(name, seg, bins, words, window, nbytes, libs, res):
    """Every build (its own tiling) and every forced tiling of the port
    against the plain version on one case, then timed."""
    import torch

    from chip_smoke import device_ms, k2_launcher
    from arterynetwork_tpu_torch.ops import region_grow_fused as fused

    ref, ref_dh = fused.fused_sweep_plain(seg, bins, words, window=window)
    box = tuple(slice(lo, hi) for lo, hi in window)
    ref = ref[box]
    row = {"shape": list(seg.shape), "window": window, "bytes": nbytes,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "builds": {},
           "tilings": {}, "refused": []}

    def timed(lib, tiling, trace):
        if tiling:
            lib.force_tiling(*tiling)
        launch, out, dh = k2_launcher(seg, bins, words, window, lib)
        launch()
        torch.cuda.synchronize()
        if not (torch.equal(out[box], ref) and torch.equal(dh, ref_dh)):
            raise SystemExit(f"k2_breakdown: {name}, tiling {tiling}: "
                             f"differs from the plain version")
        ms = {"events": events_ms(launch)}
        if trace:
            ms["trace"] = device_ms(launch, own=True)[0]
        return ms

    for name_b, (lib, _) in libs.items():
        row["builds"][name_b] = timed(lib, (0, 0) if name_b == "tiled"
                                      else None, True)
    tiled = libs["tiled"][0]
    for rb, zc in TILINGS:
        if rb > window[1][1] - window[1][0] or zc > window[0][1] - window[
                0][0] or smem_bytes(rb, seg.shape[2]) > SMEM_MAX:
            continue
        try:
            row["tilings"][f"{rb},{zc}"] = timed(tiled, (rb, zc), False)[
                "events"]
        except RuntimeError as e:       # more shared memory than a block
            row["refused"].append([rb, zc, str(e)])
    tiled.force_tiling(0, 0)
    best = min(row["tilings"], key=row["tilings"].get)
    row["fastest_tiling"] = [best, row["tilings"][best]]
    own = row["builds"]["port"]

    def trace(v):
        return "dropped" if v["trace"] is None else f"{v['trace']:.4f}"

    print(f"{name}: {tuple(seg.shape)} window {window}, bound "
          f"{row['bound_ms']:.4f} ms; builds (events / trace ms): "
          + ", ".join(f"{k} {v['events']:.4f} / {trace(v)}"
                      for k, v in row["builds"].items())
          + f"; port's own tiling {own['events']:.4f} ms "
          f"({row['bound_ms'] / own['events']:.1%}); fastest forced tiling "
          f"{best} {row['tilings'][best]:.4f} ms; all tilings (rb,zc: ms) "
          + " ".join(f"{k}:{v:.4f}" for k, v in row["tilings"].items()),
          flush=True)
    res["cases"][name] = row


def state_cases(shape, libs, res, speck):
    """The window and full-grid cases of the tube's state at ``shape``."""
    import torch

    from chip_smoke import _grow_state, _mesh_block
    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    t0 = time.perf_counter()
    vol, seed = tube_phantom(shape, **({"radius": 3} if speck else {}))
    st = _grow_state("k2_breakdown", vol, seed,
                     10 ** 7 if speck else 10 ** 6)
    del vol, seed
    print(f"state at {shape}: {time.perf_counter() - t0:.1f} s", flush=True)
    seg8, bins, words = st["seg8"], st["bins"], st["words"]
    tag = "speck" if speck else "512"
    if speck:
        idx, seg_b, bins_b, win, n_bnd = _mesh_block(seg8, bins, st["bnd"])
    else:
        blk = (slice(127, 385), slice(127, 385))
        seg_b, bins_b = seg8[blk].contiguous(), bins[blk].contiguous()
        win = ((1, 257), (1, 257), (0, shape[2]))
        n_bnd = int(st["bnd"][128:384, 128:384].sum())
    run_case(f"window {tag}", seg_b, bins_b, words, win,
             2 * seg_b.numel() + n_bnd + 2 * 256 * 4, libs, res)
    del seg_b, bins_b
    full = tuple((0, n) for n in shape)
    run_case(f"full {tag}", seg8, bins, words, full,
             2 * seg8.numel() + int(st["bnd"].sum()) + 2 * 256 * 4, libs,
             res)
    del st, seg8, bins
    torch.cuda.empty_cache()


def grow_inputs(shape):
    """(vesselness, strong seeds) of chip_smoke.py's sharded phases on
    the raw phantom at ``shape``, saved as .npy under build/; returns
    their paths."""
    import numpy as np
    import torch

    from chip_smoke import SHARDED_SIGMAS
    from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    t0 = time.perf_counter()
    kw = ({"n_branches": 800, "root_radius": 7.0} if shape == SPECK_SHAPE
          else {"n_branches": 400})
    raw = phantom_raw_volume(vascular_tree_phantom(shape, seed=0, **kw))
    vol = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).cuda()
    del raw
    v = frangi_vesselness(vol, sigmas=SHARDED_SIGMAS)
    del vol
    vmin, vmax = torch.min(v), torch.max(v)
    seeds = v > vmin + 0.5 * (vmax - vmin)
    tag = "x".join(map(str, shape))
    paths = (os.path.join(ROOT, "build", f"k2_grow_v_{tag}.npy"),
             os.path.join(ROOT, "build", f"k2_grow_seeds_{tag}.npy"))
    np.save(paths[0], v.cpu().numpy())
    np.save(paths[1], seeds.cpu().numpy())
    del v, seeds
    torch.cuda.empty_cache()
    print(f"grow inputs at {shape}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def grow_worker(tree, v_path, seeds_path):
    """One tree's sharded grower on saved inputs: a warm-up and
    GROW_RUNS timed grows; prints one JSON line."""
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != ROOT]
    import numpy as np
    import torch

    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       shard_volume)

    assert sharded.__file__.startswith(os.path.abspath(tree)), \
        sharded.__file__
    mesh = make_volume_mesh([torch.device("cuda", 0)] * 4)
    v_sh = shard_volume(np.load(v_path), mesh)
    seeds_sh = shard_volume(np.load(seeds_path), mesh)
    times = []
    for i in range(GROW_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = sharded.region_grow(v_sh, seeds_sh, max_segment_size=10 ** 7,
                                iter_max=GROW_ITERS)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    mask = g.segmented_map.gather().cpu().numpy()
    print(json.dumps({
        "tree": tree, "times_s": times, "iterations": int(g.iterations),
        "segmented_count": int(g.segmented_count),
        "stop_reason": int(g.stop_reason),
        "mask_sha1": hashlib.sha1(mask.tobytes()).hexdigest()}), flush=True)


def grow_pairs(parent, res, speck):
    """The sharded grower of the parent tree and of this one, in the
    order parent, change, change, parent, at 512 and at Speck."""
    import statistics

    shapes = [RG_SHAPE] + ([SPECK_SHAPE] if speck else [])
    for shape in shapes:
        v_path, s_path = grow_inputs(shape)
        runs = []
        for tree in (parent, ROOT, ROOT, parent):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--grow-worker", tree, v_path, s_path],
                               capture_output=True, text=True, timeout=600)
            if p.returncode:
                raise SystemExit(f"k2_breakdown: grow worker of {tree} "
                                 f"failed:\n{p.stdout}\n{p.stderr}")
            runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        keys = ("iterations", "segmented_count", "stop_reason", "mask_sha1")
        same = all(r[k] == runs[0][k] for r in runs for k in keys)
        side = {"parent": [t for r in runs[0::3] for t in r["times_s"]],
                "change": [t for r in runs[1:3] for t in r["times_s"]]}
        tag = "x".join(map(str, shape))
        res["grow"][tag] = {"runs": runs, "same_result": same,
                            "median_s": {k: statistics.median(v)
                                         for k, v in side.items()}}
        print(f"sharded grower at {tag} (parent, change, change, parent; "
              f"{GROW_RUNS} timed grows each): "
              + "; ".join(f"{'parent' if r['tree'] != ROOT else 'change'} "
                          + ", ".join(f"{t:.4f}" for t in r["times_s"])
                          for r in runs)
              + f" s; medians parent {res['grow'][tag]['median_s']['parent']:.4f}"
              f", change {res['grow'][tag]['median_s']['change']:.4f} s; "
              f"iterations {runs[0]['iterations']}, count "
              f"{runs[0]['segmented_count']}; same result {same}",
              flush=True)
        os.remove(v_path)
        os.remove(s_path)
        if not same:
            raise SystemExit(f"k2_breakdown: the trees' growers differ at "
                             f"{tag}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an older csrc/region_grow_sweep.cu")
    ap.add_argument("--parent", help="an older tree, for the grower pairs")
    ap.add_argument("--no-speck", action="store_true",
                    help="skip the 880x880x640 cases")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "k2_breakdown.json"),
                    help="where to write the whole record")
    ap.add_argument("--grow-worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.grow_worker:
        return grow_worker(*args.grow_worker)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown: no CUDA device")
    from arterynetwork_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{smi}", flush=True)
    with open(os.path.join(cuda_build.CSRC, "region_grow_sweep.cu")) as f:
        port = f.read()
    sources = {"port": port, **variants(port, {**VARIANTS, "tiled": TILED})}
    if "tiled" not in sources:
        raise SystemExit("k2_breakdown: the tiled build's text is not in "
                         "the port's source")
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    t0 = time.perf_counter()
    cuda_build.build(("region_grow_sweep", "histogram", "table_lookup"))
    libs = build(sources)
    if "tiled" not in libs:
        raise SystemExit("k2_breakdown: the tiled build failed")
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "build_s": time.perf_counter() - t0,
           "ptxas": {k: v[1] for k, v in libs.items()}, "cases": {},
           "grow": {}}
    for k, v in res["ptxas"].items():
        regs = [int(m) for ln in v
                for m in re.findall(r"Used (\d+) registers", ln)]
        print(f"ptxas {k}: {'; '.join(v)} ({regs} registers)", flush=True)
    state_cases(RG_SHAPE, libs, res, speck=False)
    if not args.no_speck:
        state_cases(SPECK_SHAPE, libs, res, speck=True)
    if args.parent:
        grow_pairs(os.path.abspath(args.parent), res, not args.no_speck)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
