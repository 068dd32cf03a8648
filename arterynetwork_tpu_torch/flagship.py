"""The flagship entry: the Hazen-Williams network pressure solve.

Port of ``__graft_entry__.py``: ``entry()`` returns a forward step on
the flagship system (a depth-9 random tree, f32, solved by Newton with
the matrix-free CG backend) and its example arguments, on ``device``;
``dryrun_multichip(n)`` runs one sharded step over n mesh slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .flow import build_system, create_ground_truth
from .flow.solvers import solve_pressure_newton
from .graphs import generate_tree, set_network_properties


def flagship_system(max_depth=11, dtype=torch.float32, device="cuda"):
    """(FlowSystem, ground truth) of the seeded flagship tree."""
    rng = np.random.default_rng(0)
    net = generate_tree(max_depth=max_depth, rng=rng)
    net = set_network_properties(net, k_value=1.852, rng=rng)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    system = build_system(net, boundary_pressure=gt.pressure, dtype=dtype,
                          device=device)
    return system, gt


def entry(device="cuda"):
    """(forward, example_args): ``forward(fixed_pressure)`` solves the
    depth-9 flagship system with CG (30 Newton iterations at most) and
    returns (node pressures, edge flows)."""
    system, _ = flagship_system(max_depth=9, device=device)

    def forward(fixed_pressure):
        sys2 = dataclasses.replace(system, node_fixed_pressure=fixed_pressure)
        sol = solve_pressure_newton(sys2, max_iter=30, linear_solver="cg")
        return sol.pressure, sol.flow

    return forward, (system.node_fixed_pressure.clone(),)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one multi-device step on tiny shapes over ``n_devices`` slots
    (port of ``__graft_entry__.dryrun_multichip``).

    The slots are the visible cards, repeated in order when there are
    fewer (``device="cpu"``: CPU slots), as a dp x sx x sy mesh (dp = 2
    when ``n_devices`` is even).  It runs:

    * sx, sy: the sharded region grower (parallel/sharded.py, K2 on each
      block's interior window) on a tube volume;
    * dp: the flagship system (depth 6, f32 CG) on a batch of boundary
      scalings, its rows split over the dp slots;
    * the sharded mini pipeline (parallel/pipeline_sharded.py) on a tiny
      raw volume, its timesteps split over all the slots.

    Checks what the JAX package's dry run asserts, prints how many
    distinct devices the slots used, and returns the grower's count and
    result, the dp pressures and the pipeline's result."""
    from .parallel import sharded
    from .parallel.distributed import global_volume_mesh, solve_batch_dp
    from .parallel.halo import VolumeMesh, shard_volume
    from .parallel.pipeline_sharded import mini_pipeline_sharded

    if device is not None:
        cards = [torch.device(device)]
    else:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if not cards:
            raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                               "device='cpu' to run on CPU slots)")
    slots = [cards[i % len(cards)] for i in range(n_devices)]

    # mesh: dp x sx x sy (dp=2 when divisible, else 1)
    dp = 2 if n_devices % 2 == 0 else 1
    mesh = global_volume_mesh(dp=dp, devices=slots).local
    _, sx, sy = mesh.devices.shape
    dev0 = slots[0]
    system, _ = flagship_system(max_depth=6, dtype=torch.float32,
                                device=dev0)

    # --- spatially sharded voxel work -------------------------------
    shape = (16 * max(sx, 1), 16 * max(sy, 1), 24)
    vol = np.zeros(shape, np.float32)
    cz, cy = shape[0] // 2, shape[1] // 2
    vol[cz - 2:cz + 2, cy - 2:cy + 2, 4:20] = 1.0
    seed = np.zeros(shape, bool)
    seed[cz - 1:cz + 1, cy - 1:cy + 1, 10:13] = True
    grown = sharded.region_grow(shard_volume(vol, mesh, ("sx", "sy")),
                                shard_volume(seed, mesh, ("sx", "sy")),
                                iter_max=20, max_segment_size=100000)

    # --- dp-split batched flow solve ---------------------------------
    base = system.node_fixed_pressure
    scale = 1.0 + 0.01 * torch.arange(dp, dtype=torch.float32,
                                      device=base.device)
    sol = solve_batch_dp(system, base[None, :] * scale[:, None],
                         slots=mesh.devices[:, 0, 0], max_iter=20,
                         linear_solver="cg")
    count, out = int(grown.segmented_count), sol.pressure
    _check(count > 0, "the sharded grower segmented nothing")
    _check(tuple(out.shape) == (dp, system.num_nodes),
           f"pressures of shape {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()), "non-finite pressures")

    # --- composed sharded end-to-end mini pipeline --------------------
    vmesh = VolumeMesh(mesh.devices.reshape(dp * sx, sy), ("sx", "sy"))
    rng = np.random.default_rng(0)
    shape2 = (8 * dp * sx, 8 * sy, 16)
    raw = rng.normal(100.0, 3.0, shape2).astype(np.float32)
    cz, cy = shape2[0] // 2, shape2[1] // 2
    raw[cz - 2:cz + 2, cy - 2:cy + 2, :] += 80.0
    res = mini_pipeline_sharded(raw, mesh=vmesh, sigmas=(1.0,),
                                max_waves=6, region_grow_iters=12,
                                n_timesteps=n_devices)
    _check(res["mask"].any(), "the pipeline's mask is empty")
    _check(res["skeleton"].sum() <= res["mask"].sum(),
           "the skeleton is larger than the mask")
    if res["pressure_batch"] is not None:
        _check(res["pressure_batch"].shape[0] == n_devices,
               f"{res['pressure_batch'].shape[0]} timestep rows")
        _check(bool(np.isfinite(res["pressure_batch"]).all()),
               "non-finite timestep pressures")
    distinct = mesh.distinct_devices()
    print(f"dryrun_multichip: {n_devices} slots as dp x sx x sy = {dp} x "
          f"{sx} x {sy} on {len(distinct)} distinct device(s) "
          f"({', '.join(map(str, distinct))})", flush=True)
    return {"segmented_count": count, "grown": grown, "pressures": out,
            "pipeline": res, "distinct_devices": len(distinct)}
