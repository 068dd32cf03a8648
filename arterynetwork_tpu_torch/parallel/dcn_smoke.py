"""Two-process smoke test of the dp axis on the CPU (parallel/distributed.py).

Port of the JAX package's scripts/dcn_smoke.py.  The parent starts itself
twice (``--role child --process-id {0,1}``); each child joins a gloo
process group at ``tcp://localhost:<port>``, builds the global dp mesh
over 2 processes x 4 CPU slots and runs one batched flow solve (f64 CG,
8 perturbed systems) split over the processes (a process's slots share
its one device, so each solves its rows as one batch), then gathers the
rows.  Each child prints one JSON line; the parent checks that both
children agree on the rows, that every residual is below 1e-9 and that
the gathered rows equal the same batch solved in one process, and prints
one JSON line.

Usage:  python -m arterynetwork_tpu_torch.parallel.dcn_smoke
        python -m arterynetwork_tpu_torch.parallel.dcn_smoke --port N
"""

import argparse
import json
import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_PROCESSES = 2
LOCAL_SLOTS = 4
BATCH = 8


def child(process_id: int, num_processes: int, port: int) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..flow import build_system, create_ground_truth
    from ..flow.solvers import solve_pressure_newton_batch
    from ..graphs import generate_tree, set_network_properties
    from .distributed import (global_volume_mesh, initialize_distributed,
                              process_count, solve_batch_dp)

    torch.set_num_threads(1)
    slots = ["cpu"] * LOCAL_SLOTS
    n_global = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes, process_id=process_id, devices=slots)
    try:
        mesh = global_volume_mesh(dp=num_processes, devices=slots)
        net = set_network_properties(
            generate_tree(max_depth=5, rng=np.random.default_rng(0)),
            k_value=1.852, rng=np.random.default_rng(0))
        gt = create_ground_truth(net, option=2,
                                 rng=np.random.default_rng(1))
        if not gt.success:
            raise RuntimeError("ground truth failed")
        system = build_system(net, boundary_pressure=gt.pressure,
                              dtype=torch.float64, device="cpu")
        scales = 1.0 + 0.01 * torch.arange(BATCH, dtype=torch.float64)
        fixed = system.node_fixed_pressure[None, :] * scales[:, None]
        sol = solve_batch_dp(system, fixed, slots=mesh, max_iter=30,
                             linear_solver="cg")
        one = solve_pressure_newton_batch(
            dataclasses.replace(system, node_fixed_pressure=fixed),
            max_iter=30, linear_solver="cg")
        print(json.dumps({
            "process_id": process_id,
            "global_devices": n_global,
            "process_count": process_count(),
            "mesh": mesh.shape,
            "max_residual": float(sol.residual_norm.max()),
            "pressure_checksum": float(sol.pressure.sum()),
            "rows_equal_one_process": bool(torch.equal(sol.pressure,
                                                       one.pressure)),
        }), flush=True)
    finally:
        dist.destroy_process_group()


def parent(port: int) -> int:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--role", "child",
         "--process-id", str(pid), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(N_PROCESSES)]
    outs, ok = [], True
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            ok = False
        if p.returncode != 0:
            ok = False
        line = [ln for ln in out.splitlines() if ln.startswith("{")]
        outs.append(json.loads(line[-1]) if line else {"err": err[-500:]})
    agree = (len(outs) == 2
             and all("pressure_checksum" in o for o in outs)
             and outs[0]["pressure_checksum"] == outs[1]["pressure_checksum"]
             and all(o["max_residual"] < 1e-9 for o in outs)
             and all(o["rows_equal_one_process"] for o in outs))
    print(json.dumps({"section": "dcn_smoke", "ok": bool(ok and agree),
                      "children": outs}), flush=True)
    return 0 if (ok and agree) else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="parent")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)   # 0: a free one
    args = ap.parse_args()
    if args.role == "child":
        child(args.process_id, N_PROCESSES, args.port)
        return 0
    return parent(args.port or _free_port())


if __name__ == "__main__":
    sys.exit(main())
