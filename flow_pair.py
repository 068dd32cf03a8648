#!/usr/bin/env python3
"""The flow solves of several trees of this repository on one CUDA card,
each tree in its own process, in the order given.

    python3 flow_pair.py [--json PATH] TREE [TREE ...]

e.g. the parent commit against this tree, in turns:

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 flow_pair.py build/parent build/change build/change \\
        build/parent

Every tree runs, on the same inputs (made once, by this tree, and saved
under build/flow_pair/), what chip_smoke.py's flow phases run:

  * flow_16k: bench.py::bench_flow_large's 16k-edge tree (depth 13,
    8,190 unknowns), f32 at tol 1e-9 with "auto" and the elimination
    plan (tree) and with "cg", and f64 "cg" at the default tol 1e-14;
  * longitudinal_16k: GBMTest5 on the study CLI's depth-13 tree, T = 8,
    f64, "auto" with the plan (``solve_timestep_batch``);
  * pipeline_512 flow: ``pipeline._solve_network`` on the network that
    run_pipeline gives for the pipeline_512 phantom with bench.py's
    configuration (f32, "auto" with the plan): the pipeline's flow
    stage, ground truth and assembly included;
  * studies_2k: the study CLI's eight drivers at depth 10 on the card,
    one run each.

Each solve: a warm-up, 3 timed runs (host clock ended by a synchronise),
one run traced by torch.profiler for the device's idle share
(chip_smoke.py's ``device_idle``: 1 - busy / wall, the tracer's host cost
included; and 1 - busy / the timed runs' median), and, where the tree's
``SolveStats`` counts them, host reads, linear solves, CG steps, graphs
captured, replays and seconds spent capturing.  The pressures, flows,
residuals and iterations of each solve (a checksum) must agree between
all the runs of all the trees.  The whole record goes to ``--json`` (by
default build/flow_pair.json) and, as one JSON line, last to stdout.
Exits non-zero without a CUDA device or if two runs disagree.
"""

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import pickle
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "flow_pair")
RUNS = 3


def _chip_smoke():
    """This tree's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree the worker put first)."""
    spec = importlib.util.spec_from_file_location(
        "flow_pair_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs():
    """The 16k tree and its ground truth, GBMTest5's network and batch
    and pipeline_512's network, pickled under build/flow_pair/."""
    sys.path.insert(0, ROOT)
    from arterynetwork_tpu_torch.flow import create_ground_truth
    from arterynetwork_tpu_torch.flow.longitudinal import \
        build_timestep_batch
    from arterynetwork_tpu_torch.pipeline import run_pipeline
    from arterynetwork_tpu_torch.utils.phantoms import (
        phantom_raw_volume, vascular_tree_phantom)

    cs = _chip_smoke()
    os.makedirs(DATA, exist_ok=True)
    t0 = time.perf_counter()
    net, parts, radius_end, rng = cs._study_net(cs.FLOW_DEPTH)
    gt = create_ground_truth(net, option=2, rng=rng)
    batch = build_timestep_batch(net, gt.pressure, radius_end, cs.LONG_T,
                                 1, partitions=parts)
    phantom = vascular_tree_phantom((512, 512, 170), n_branches=400, seed=0)
    result = run_pipeline(raw_volume=phantom_raw_volume(phantom),
                          config=cs.bench_config(), device="cuda")
    with open(os.path.join(DATA, "inputs.pkl"), "wb") as f:
        pickle.dump({"flow_16k": cs._bench_tree(cs.FLOW_DEPTH),
                     "longitudinal": (net, batch),
                     "net512": result["network"]}, f)
    print(f"inputs: {time.perf_counter() - t0:.1f} s", flush=True)


def _sha1(sol):
    import numpy as np
    import torch

    h = hashlib.sha1()
    for x in (sol.pressure, sol.flow, sol.residual_norm, sol.iterations):
        h.update(np.asarray(x.cpu() if torch.is_tensor(x) else x).tobytes())
    return h.hexdigest()


def worker(tree):
    """One tree's flow solves on the saved inputs; prints one JSON line."""
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != ROOT]
    import tempfile

    import numpy as np
    import torch

    import arterynetwork_tpu_torch as pkg
    from arterynetwork_tpu_torch.flow import build_system
    from arterynetwork_tpu_torch.flow.longitudinal import \
        solve_timestep_batch
    from arterynetwork_tpu_torch.flow.solvers import (SolveStats,
                                                      solve_pressure_newton)
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
    from arterynetwork_tpu_torch.io import ArtifactStore
    from arterynetwork_tpu_torch.pipeline import _solve_network

    assert pkg.__file__.startswith(os.path.abspath(tree)), pkg.__file__
    cs = _chip_smoke()
    with open(os.path.join(DATA, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    net, gt = inputs["flow_16k"]
    sys32, sys64 = (build_system(net, boundary_pressure=gt.pressure,
                                 dtype=dt, device="cuda")
                    for dt in (torch.float32, torch.float64))
    plan = plan_elimination(sys32)
    lnet, batch = inputs["longitudinal"]
    flow_cfg = cs.bench_config().flow
    cases = {
        "tree_f32": lambda stats: solve_pressure_newton(
            sys32, max_iter=60, tol=1e-9, linear_solver="auto", plan=plan,
            stats=stats),
        "cg_f32": lambda stats: solve_pressure_newton(
            sys32, max_iter=60, tol=1e-9, linear_solver="cg", stats=stats),
        "cg_f64": lambda stats: solve_pressure_newton(
            sys64, max_iter=60, linear_solver="cg", stats=stats),
        "longitudinal_T8_f64": lambda stats: solve_timestep_batch(
            lnet, batch, dtype=torch.float64, device="cuda", stats=stats),
        "pipeline_512_flow": lambda stats: _solve_network(
            inputs["net512"], {}, flow_cfg, device="cuda")[1],
    }
    rec = {"tree": tree, "solves": {}, "studies_s": {}}
    for name, fn in cases.items():
        fn(None)                                   # warm-up
        times = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = fn(None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        stats = SolveStats()
        wall, busy, idle = cs.device_idle(lambda: fn(stats))
        med = statistics.median(times)
        its = np.asarray(sol.iterations.cpu() if torch.is_tensor(
            sol.iterations) else sol.iterations).tolist()
        counts = {f.name: getattr(stats, f.name)
                  for f in dataclasses.fields(stats)}
        if counts["cg_steps"] is not None:
            counts["cg_steps"] = counts["cg_steps"].tolist()
        rec["solves"][name] = {
            "times_ms": [1e3 * t for t in times], "median_ms": 1e3 * med,
            "traced_wall_s": wall, "busy_s": busy, "idle": idle,
            "idle_untraced": 1 - busy / med, "iterations": its,
            "stats": counts if name != "pipeline_512_flow" else None,
            "result": _sha1(sol)}
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(tree, "build")) as tmp:
        for name in cs.STUDY_DRIVERS:
            n, parts, radius_end, rng = cs._study_net(cs.STUDY_DEPTH)
            store = ArtifactStore(os.path.join(tmp, name))
            drive = cs._drivers(n, parts, radius_end, rng, store, "cuda",
                                "hw")[name]
            _, secs = cs._sync_s(drive)
            rec["studies_s"][name] = secs
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="trees of this repository")
    ap.add_argument("--json", default=os.path.join(ROOT, "build",
                                                   "flow_pair.json"),
                    help="where to write the whole record")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flow_pair: no CUDA device")
    if not args.trees:
        raise SystemExit("flow_pair: name at least one tree")
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
            raise SystemExit(f"flow_pair: the worker of {tree} failed:\n"
                             f"{p.stdout[-4000:]}\n{p.stderr[-8000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        runs.append(rec)
        for name, r in rec["solves"].items():
            st = r["stats"] or {}
            print(f"{tree} {name}: median {r['median_ms']:.3f} ms ("
                  + ", ".join(f"{t:.3f}" for t in r["times_ms"])
                  + f"), traced {r['traced_wall_s']:.4f} s, busy "
                  f"{r['busy_s']:.4f} s, idle {r['idle']:.1%} (against the "
                  f"median {r['idle_untraced']:.1%}); iterations "
                  f"{r['iterations']}; host reads {st.get('host_reads')}, "
                  f"captures {st.get('captures')} in "
                  f"{st.get('capture_s')} s, replays {st.get('replays')}",
                  flush=True)
        print(f"{tree} studies_2k: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in rec["studies_s"].items())
            + f"; process {rec['process_s']:.1f} s", flush=True)
    same = all({k: r["result"] for k, r in run["solves"].items()}
               == {k: r["result"] for k, r in runs[0]["solves"].items()}
               for run in runs)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "runs": runs, "same_results": same}
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(f"every run gives the same results: {same}", flush=True)
    print(json.dumps(res), flush=True)
    if not same:
        raise SystemExit("flow_pair: the runs' results differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
