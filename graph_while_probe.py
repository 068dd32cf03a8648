#!/usr/bin/env python3
"""What the growers' while graph (csrc/graph_while.cu, ops/graph_while.py)
meets on one CUDA card.

    python3 graph_while_probe.py

Prints, in order:

  * the card's name and power limit, torch's version and CUDA runtime,
    nvcc's version, libcuda's version and the CUDA version it runs, and
    whether ``torch.cuda.CUDAGraph(keep_graph=True)`` and
    ``raw_cuda_graph()`` exist;
  * the build of csrc/graph_while.cu with ``cuda_build.NVCC_FLAGS``
    (ptxas's lines, or the whole log if it fails) and loops of one and
    of two trivial steps through the while graph against the eager loop;
  * for each grower step at 512 (bench.py's tube phantom at 512x512x170,
    chip_smoke.py's RG_KW): the fused "auto" grower's A -> B and B -> A,
    the frontier grower's step, the full-grid grower's without and with
    chip_smoke.py's excluded slab, and the sharded grower's A -> B and
    B -> A on a 2x2 mesh of cuda:0 slots (the tube, 60 iterations): the
    node types of its captured graph; whether a WHILE body takes the
    steps (the build's error otherwise); whether the one launch gives
    the eager loop's bits (mask, active map, iterations, count, stop
    reason); passes, host reads, while-graph launches and
    capture-plus-instantiate seconds;
  * whether torch.profiler sees the kernels inside the conditional body:
    K2's events in a traced "auto" grow against its passes.

A case that fails is reported and the probe goes on; it exits non-zero
if any did, and without a CUDA device.
"""

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def _run(cmd):
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (p.stdout + p.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not run ({e})"


def versions():
    import torch

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                "--format=csv,noheader"])
    print(smi, flush=True)
    from arterynetwork_tpu_torch.ops import cuda_build

    nvcc = _run([cuda_build._nvcc(), "--version"]).splitlines()
    drv = ctypes.c_int(0)
    try:
        ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(drv))
    except OSError as e:
        print(f"libcuda: {e}")
    keep = raw = False
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        keep, raw = True, hasattr(g, "raw_cuda_graph")
    except TypeError:
        pass
    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}; "
          f"nvcc: {nvcc[-1] if nvcc else '?'}; libcuda's CUDA "
          f"{drv.value // 1000}.{drv.value % 1000 // 10}; "
          f"CUDAGraph(keep_graph=True) {keep}, raw_cuda_graph {raw}",
          flush=True)


def _trivial(n_steps, last):
    """A loop of ``n_steps`` one-element steps through graph_loop: step k
    adds 10^k to x; stop is set at run ``last`` -> (steps run, x, the
    eager loop's)."""
    import torch

    from arterynetwork_tpu_torch.ops import grow_loop

    out = []
    for drive in (grow_loop.graph_loop, grow_loop.host_loop):
        x = torch.zeros((), dtype=torch.int64, device="cuda")
        runs = torch.zeros((), dtype=torch.int32, device="cuda")
        stop = torch.full((), -1, dtype=torch.int32, device="cuda")

        def step(k):
            x.add_(10 ** k)
            runs.add_(1)
            stop.copy_(torch.where(runs >= last, 0, -1).to(torch.int32))

        steps = [lambda k=k: step(k) for k in range(n_steps)]
        n = drive(steps, stop)
        out.append((n, int(x)))
    return out


def build_and_check():
    """Build csrc/graph_while.cu and run the trivial loops -> whether
    every loop stopped at the eager loop's step with its state."""
    from arterynetwork_tpu_torch.ops import cuda_build, graph_while

    t0 = time.perf_counter()
    try:
        log = cuda_build.build(("graph_while",))["graph_while"][1]
    except RuntimeError as e:
        print(f"build failed:\n{e}", flush=True)
        return False
    print(f"build with NVCC_FLAGS: {time.perf_counter() - t0:.1f} s; "
          + "; ".join(ln.strip() for ln in log.splitlines()
                      if "registers" in ln), flush=True)
    ok = True
    for n_steps in (1, 2):
        for last in (2, 3, 8, 9):
            (n, x), (e_n, e_x) = _trivial(n_steps, last)
            ok &= (n, x) == (e_n, e_x)
            print(f"  trivial loop, {n_steps} step(s), stop at run {last}: "
                  f"while graph {n} steps, x {x}; eager {e_n}, {e_x}",
                  flush=True)
    print(f"  set_while launches {graph_while.set_while.launches}, "
          f"count_step launches {graph_while.count_step.launches}",
          flush=True)
    return ok


def grower_cases():
    """(name, grow function, steps) at 512."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from arterynetwork_tpu_torch.ops import region_grow, region_grow_frontier
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import (make_volume_mesh,
                                                       shard_volume)
    from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

    vol, seed = tube_phantom(cs.RG_SHAPE)
    data = torch.from_numpy(vol).cuda()
    sd = torch.from_numpy(seed).cuda()
    excluded = torch.zeros_like(sd)
    excluded[:cs.SLAB] = True
    mesh = make_volume_mesh([torch.device("cuda", 0)] * 4)
    v_sh, s_sh = shard_volume(data, mesh), shard_volume(sd, mesh)
    kw = cs.RG_KW

    def key(r):
        m = r.segmented_map
        m = m if isinstance(m, torch.Tensor) else m.gather()
        a = r.active_map
        return [np.asarray(m.cpu()).tobytes(),
                None if a is None else np.asarray(a.cpu()).tobytes(),
                int(r.iterations), int(r.segmented_count),
                int(r.stop_reason)]

    return key, [
        ("auto (A -> B, B -> A)", lambda: region_grow(data, sd, **kw)),
        ("frontier", lambda: region_grow_frontier(data, sd, **kw)),
        ("full grid", lambda: region_grow(data, sd, backend="xla", **kw)),
        ("full grid, excluded slab", lambda: region_grow(
            data, sd, excluded, backend="xla", **kw)),
        ("sharded 2x2 of cuda:0 (A -> B, B -> A)", lambda: sharded.region_grow(
            v_sh, s_sh, max_segment_size=10 ** 7, iter_max=cs.SHARDED_ITERS)),
    ]


def probe_growers():
    import torch

    from arterynetwork_tpu_torch.ops import graph_while, grow_loop

    key, cases = grower_cases()
    seen = []
    base = graph_while.WhileGraph

    class Spy(base):
        def __init__(self, steps, stop, count, lib=None):
            seen.append([graph_while.describe(g) for g in steps])
            super().__init__(steps, stop, count, lib)

    graph_while.WhileGraph = Spy
    failed = 0
    try:
        for name, fn in cases:
            drive = grow_loop.drive
            grow_loop.drive = grow_loop.host_loop
            try:
                eager = key(fn())
            finally:
                grow_loop.drive = drive
            seen.clear()
            grow_loop.read_stop.reads = 0
            grow_loop.graph_loop.launches = 0
            grow_loop.graph_loop.capture_s = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = key(fn())
                torch.cuda.synchronize()
                took = f"{time.perf_counter() - t0:.4f} s"
                same, err = res == eager, None
            except Exception as e:     # report, go on
                torch.cuda.synchronize()
                took, same, err = "-", False, f"{type(e).__name__}: {e}"
                res = eager
            passes = res[2] + (res[4] == 0)
            for i, types in enumerate(seen[-1] if seen else []):
                print(f"{name} step {i}: {types}", flush=True)
            print(f"{name}: WHILE body takes it {err is None}"
                  f"{'' if err is None else ' (' + err + ')'}; bit-equal to "
                  f"the eager loop {same}; passes {passes}, host reads "
                  f"{grow_loop.read_stop.reads}, while-graph launches "
                  f"{grow_loop.graph_loop.launches}, capture + instantiate "
                  f"{grow_loop.graph_loop.capture_s:.4f} s; run {took}",
                  flush=True)
            failed += not same
    finally:
        graph_while.WhileGraph = base
    return failed


def probe_profiler():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, cases = grower_cases()
    fn = cases[0][1]
    res = fn()
    torch.cuda.synchronize()
    passes = int(res.iterations) + (int(res.stop_reason) == 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            short = e.name.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0][-40:]
            names[short] = names.get(short, 0) + 1
    k2 = sum(n for k, n in names.items() if "sweep" in k)
    print(f"profiler: {k2} K2 events for {passes} passes of the auto grower "
          f"(the eager iteration's 1 included); device events by name: "
          + ", ".join(f"{n} x {k}" for k, n in sorted(
              names.items(), key=lambda kv: -kv[1])[:12]), flush=True)


def probe_timing():
    """Each grower: the median of 3 warm runs through the while graph and
    through the eager loop (``host_loop``), and the busy time of one
    traced run (chip_smoke.py's ``device_idle``)."""
    import statistics

    import torch

    import chip_smoke as cs
    from arterynetwork_tpu_torch.ops import grow_loop

    def median_s(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    _, cases = grower_cases()
    for name, fn in cases:
        graph = median_s(fn)
        drive = grow_loop.drive
        grow_loop.drive = grow_loop.host_loop
        try:
            eager = median_s(fn)
        finally:
            grow_loop.drive = drive
        wall, busy, idle = cs.device_idle(fn)
        print(f"timing {name}: while graph {graph:.4f} s, eager loop "
              f"{eager:.4f} s; traced {wall:.4f} s, busy {busy:.4f} s, idle "
              f"{idle:.1%} traced, {1 - busy / graph:.1%} untraced",
              flush=True)


def probe_iteration_cost(n=300):
    """What one iteration of a loop of three one-element kernels costs:
    through one while graph (its first launch, then a relaunch of the
    same instantiated graph), and as a replay of the captured step and a
    host read of stop per iteration (the route before)."""
    import torch

    from arterynetwork_tpu_torch.ops import graph_while, grow_loop

    dev = torch.device("cuda")
    runs = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.full((), -1, dtype=torch.int32, device=dev)

    def step():
        runs.add_(1)
        stop.copy_(torch.where(runs >= n, 0, -1).to(torch.int32))

    def reset():
        runs.zero_()
        stop.fill_(-1)

    loop = grow_loop.GraphLoop(dev)
    out = []
    with loop.stream():
        step()
        g, _ = loop.capture(step, keep_graph=True)
        words = stop.new_zeros(3)        # stop, steps run, set_while's
        wg = graph_while.WhileGraph([g.raw_cuda_graph()], stop, words[1:])
        try:
            for _ in range(3):
                reset()
                words.zero_()
                loop.side.synchronize()
                t0 = time.perf_counter()
                wg.launch(loop.side)
                loop.side.synchronize()
                out.append((time.perf_counter() - t0) / n * 1e6)
                assert words[1:].tolist() == [n, n + 1] and int(runs) == n
        finally:
            loop.side.synchronize()
            wg.close()
        r, counts = loop.capture(step)
        for _ in range(2):
            reset()
            loop.side.synchronize()
            t0 = time.perf_counter()
            while True:
                loop.replay(r, counts)
                if loop.read(stop) >= 0:
                    break
            out.append((time.perf_counter() - t0) / n * 1e6)
    print(f"one iteration of a {n}-iteration loop of 3 one-element kernels: "
          f"while graph {out[0]:.2f} us (first launch), {out[1]:.2f}, "
          f"{out[2]:.2f} us (relaunches); replay and host read "
          f"{out[3]:.2f}, {out[4]:.2f} us", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("graph_while_probe: no CUDA device")
    versions()
    if not build_and_check():
        raise SystemExit("graph_while_probe: csrc/graph_while.cu did not "
                         "build or did not run the trivial loops right")
    failed = probe_growers()
    probe_profiler()
    probe_timing()
    probe_iteration_cost()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
