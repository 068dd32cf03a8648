#!/usr/bin/env python3
"""Which of torch's LU solves a CUDA graph can capture, on one card.

    python3 lu_capture_probe.py [--distribute-only]

For ``torch.linalg.solve_ex`` on a batch of T weighted-Laplacian-like
systems of n unknowns (T in {1, 3, 8}, n from 4 to 4096, f32 and f64),
each made from a seed: one eager call on a side stream, then a capture
of the same call into a CUDA graph in ``thread_local`` mode and a
replay, whose solution must equal the eager one bit for bit; then the
ms per replay and per eager call (20 of each).  A capture that is
refused is reported and the probe goes on.  The flow solver
(flow/solvers.py, flow/tree_solver.py ``lu_steps``) runs a batch's LU
between two graphs because of what this prints.  The index ops the
solver's steps use (``x[:, idx] = v``, ``cand[rows, first]``) and the
``stop`` update are probed first, then the one unbatched f64 system
of 2,046 unknowns that ``flow/distribute.distribute_flow`` solves twice
in each Gauss-Newton step at the study CLI's depth 10 (its step is
captured whole; ``--distribute-only`` stops after it).  Exits non-zero
without a CUDA device.
"""

import subprocess
import sys
import time

import torch


def _system(T, n, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(T, n, n, generator=g, dtype=torch.float64)
    w = (w + w.transpose(1, 2)) * (torch.rand(T, n, n, generator=g) < 0.3)
    L = torch.diag_embed(w.sum(2) + 0.1) - w
    b = torch.rand(T, n, generator=g, dtype=torch.float64)
    return L.to(dtype).to(dev), b.to(dtype).to(dev)


def probe(name, fn):
    """Capture ``fn`` after an eager call on a side stream; print whether
    the replay gives the eager bits, and the times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            ref = fn().clone()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
            graph.replay()
            side.synchronize()
            same = out.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes()
            t0 = time.perf_counter()
            for _ in range(20):
                graph.replay()
            side.synchronize()
            replay_ms = (time.perf_counter() - t0) / 20 * 1e3
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            side.synchronize()
            eager_ms = (time.perf_counter() - t0) / 20 * 1e3
        print(f"{name}: captured, replay bit-equal {same}, replay "
              f"{replay_ms:.3f} ms, eager {eager_ms:.3f} ms", flush=True)
    except Exception as e:              # refused: report, go on
        print(f"{name}: refused ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]})", flush=True)
        torch.cuda.synchronize()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lu_capture_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"linalg {torch.backends.cuda.preferred_linalg_library()}",
          flush=True)
    dev = torch.device("cuda")
    x = torch.zeros(3, 101, device=dev)
    idx = torch.arange(0, 100, 6, device=dev)
    v = torch.rand(3, idx.numel(), device=dev)

    def setitem():
        y = x.clone()
        y[:, idx] = v
        return y

    cand = torch.rand(3, 21, 50, device=dev)
    rows = torch.arange(3, device=dev)
    first = torch.tensor([0, 5, 20], device=dev)
    stop = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.tensor([True, False, True], device=dev)
    probe("x[:, idx] = v", setitem)
    probe("cand[rows, first]", lambda: cand[rows, first])
    probe("stop from any()", lambda: stop.copy_(
        torch.where(active.any(), -1, 0)))
    A, b = _system(1, 2046, torch.float64, 2046, dev)
    A, b = A[0].contiguous(), b[0].contiguous()
    probe("solve_ex n=2046 float64 unbatched (distribute, depth 10)",
          lambda: torch.linalg.solve_ex(A, b)[0])
    if "--distribute-only" in sys.argv[1:]:
        return 0
    for dtype in (torch.float32, torch.float64):
        for T in (1, 3, 8):
            for n in (4, 6, 16, 17, 33, 100, 513, 2000, 4096):
                A, b = _system(T, n, dtype, 10 * n + T, dev)
                probe(f"solve_ex T={T} n={n} {str(dtype)[6:]}",
                      lambda: torch.linalg.solve_ex(A, b)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
