"""Multi-process setup and the dp-batched flow solve.

Port of the JAX package's parallel/distributed.py.  There, the spatial
axes ride one host's device mesh and only the longitudinal ``dp`` axis
spans processes (``jax.distributed``).  Here the same split:

* the spatial mesh is single-process (parallel/halo.py);
* ``initialize_distributed`` joins a ``torch.distributed`` process group
  (NCCL for CUDA slots, gloo for CPU slots), given its address, size and
  rank explicitly: nothing on the machine announces a cluster;
* ``global_volume_mesh`` is dp x sx x sy over every process's slots, dp
  defaulting to the process count, of which each process holds its own
  dp rows;
* ``solve_batch_dp`` splits the T rows of a batched solve over the
  processes, then over each process's devices in proportion to their
  slots, solves each device's rows as one
  ``flow/solvers.solve_pressure_newton_batch`` and gathers the rows
  (``all_gather``) in order.  Slots that repeat a device share one batch:
  a card runs its rows together, not one slot after another, and a
  process with one card solves exactly the unsharded batch.

NCCL will not put two ranks on one card, so the multi-process path is
run with gloo on CPU slots (parallel/dcn_smoke.py); on a card only one
process runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .halo import VolumeMesh, grid_2d


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_slots(devices=None):
    """This process's slots: ``devices`` (repeats allowed), else its
    visible CUDA devices."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    slots = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    if not slots:
        raise RuntimeError("no CUDA device is visible: pass devices=[...] "
                           "(e.g. ['cpu'] * 4)")
    return slots


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           devices=None) -> int:
    """Join the process group (a no-op for one process) and return the
    global slot count: this process's slots times the process count.
    ``coordinator_address`` is "host:port" (or a ``tcp://`` URL) of rank
    0; the backend is NCCL when every slot is a CUDA device, else
    gloo."""
    slots = local_slots(devices)
    if (num_processes is not None and num_processes > 1
            and not dist.is_initialized()):
        if coordinator_address is None or process_id is None:
            raise ValueError("a process group needs coordinator_address "
                             "and process_id")
        backend = "nccl" if all(d.type == "cuda" for d in slots) \
            else "gloo"
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    return len(slots) * process_count()


@dataclasses.dataclass
class GlobalMesh:
    """A dp x sx x sy mesh over every process's slots, of which this
    process holds ``local``: its own dp rows (dp / process_count of them)
    of sx x sy slots."""

    local: VolumeMesh
    process_count: int
    process_index: int

    @property
    def axis_names(self):
        return self.local.axis_names

    @property
    def shape(self):
        shape = dict(self.local.shape)
        shape[self.axis_names[0]] *= self.process_count
        return shape


def global_volume_mesh(axis_names: Sequence[str] = ("dp", "sx", "sy"),
                       dp: Optional[int] = None, devices=None):
    """dp x sx x sy over all processes' slots (``devices``: this
    process's, as for ``local_slots``).  ``dp`` defaults to the process
    count, so the batch axis spans processes while each process's
    spatial halo exchanges stay among its own slots; it must be a
    multiple of the process count."""
    slots = local_slots(devices)
    procs = process_count()
    n = len(slots) * procs
    if dp is None:
        dp = procs
        while n % dp:
            dp -= 1
    if dp % procs or n % dp:
        raise ValueError(f"dp={dp} must be a multiple of the process "
                         f"count {procs} and divide the {n} slots")
    devs = np.empty(len(slots), dtype=object)
    devs[:] = slots
    local = VolumeMesh(devs.reshape(dp // procs, *grid_2d(n // dp)),
                       axis_names)
    return GlobalMesh(local, procs, process_index())


def _system_to(system, device):
    return dataclasses.replace(system, **{
        f.name: getattr(system, f.name).to(device)
        for f in dataclasses.fields(system)
        if torch.is_tensor(getattr(system, f.name))})


def _device_shares(slots, device):
    """[(device, number of slots)] in first-appearance order."""
    if slots is None:
        slots = [device]
    elif isinstance(slots, GlobalMesh):
        slots = slots.local.devices.reshape(-1)
    elif isinstance(slots, VolumeMesh):
        slots = slots.devices.reshape(-1)
    shares = {}
    for s in slots:
        d = torch.device(s)
        shares[d] = shares.get(d, 0) + 1
    return list(shares.items())


def solve_batch_dp(system, fixed_pressure, slots=None, max_iter: int = 30,
                   linear_solver: str = "cg", **kwargs):
    """Solve the rows of ``fixed_pressure`` (f[T, N], each a
    ``node_fixed_pressure``) on ``system``'s graph, data-parallel.

    The T rows split evenly over the processes (T must divide), then over
    the devices of this process's ``slots`` (a mesh, a list of devices,
    or by default the system's device) in proportion to the slots each
    holds: each device's rows are one ``solve_pressure_newton_batch``
    there.  The rows are gathered in order on every process.  Returns a
    FlowSolution of [T, ...] rows on the system's device; ``kwargs`` go
    to the solver."""
    from ..flow.solvers import FlowSolution, solve_pressure_newton_batch

    procs, rank = process_count(), process_index()
    fixed = torch.as_tensor(fixed_pressure, dtype=system.radius_m.dtype)
    T = fixed.shape[0]
    if T % procs:
        raise ValueError(f"{T} rows do not split over {procs} processes")
    mine = fixed[rank * (T // procs):(rank + 1) * (T // procs)]
    shares = _device_shares(slots, system.device)
    per_slot = [len(c) for c in np.array_split(
        np.arange(mine.shape[0]), sum(n for _, n in shares))]
    parts, start, k = [], 0, 0
    for dev, n in shares:
        stop = start + sum(per_slot[k:k + n])
        k += n
        if stop > start:
            parts.append(solve_pressure_newton_batch(
                dataclasses.replace(_system_to(system, dev),
                                    node_fixed_pressure=mine[start:stop]
                                    .to(dev)),
                max_iter=max_iter, linear_solver=linear_solver, **kwargs))
        start = stop
    fields = {name: torch.cat([getattr(s, name).to(system.device)
                               for s in parts])
              for name in FlowSolution._fields}
    if procs > 1:
        fields = {k: _all_gather_rows(v) for k, v in fields.items()}
    return FlowSolution(**fields)


def _all_gather_rows(x):
    """Every process's rows of ``x``, in rank order, on ``x``'s device
    (through the host for gloo)."""
    comm = x if dist.get_backend() == "nccl" else x.cpu()
    out = [torch.empty_like(comm) for _ in range(process_count())]
    dist.all_gather(out, comm.contiguous())
    return torch.cat(out).to(x.device)
