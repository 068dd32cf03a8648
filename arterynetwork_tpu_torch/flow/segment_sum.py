"""Sums of edge values into node slots, in a fixed order on every device.

``Tensor.index_add_`` with repeated indices adds in no fixed order on a
CUDA device, so a flow solve built on it could change from run to run on
the card.  A ``SegmentSum`` plan lists, for every output slot, the source
entries that land there, in the order in which a chain of CPU
``index_add_`` calls adds them, as a padded [D, U] gather table (D is the
most entries of one slot, U the number of output slots; padding points at
a zero appended to the source).  ``segment_sum`` gathers the table and
adds its rows:

* on the CPU, left to right, starting from 0: the sum ``index_add_`` into
  zeros gives, bit for bit (0 + a = a exactly);
* on a card, by one ``sum`` over the row axis, whose order the reduction
  kernel fixes: the same bits on every run, in about the host ops that
  the two ``index_add_`` calls cost.

Plans depend only on the graph, so they are built once on the host and
cached with their owner (``cached``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SegmentSum:
    """out[..., j] = sum over table[:, j] of sign * src[..., table[:, j]]."""
    table: torch.Tensor            # i64[D * U] source positions; K = the zero
    sign: Optional[torch.Tensor]   # i8[D, U], None when every entry adds
    slots: Optional[torch.Tensor]  # i64[U] output slots; None: 0..U-1
    num_sources: int               # K
    depth: int                     # D
    width: int                     # U
    # the signs in each source dtype used so far (no promotion per call)
    signs: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


def plan_segment_sum(slot, source, num_slots: int, num_sources: int,
                     sign=None, dense: bool = True,
                     device="cpu") -> SegmentSum:
    """Plan the sum of entries ``(slot[i], source[i], sign[i])``, taken in
    the order i: the slot each lands in, the source position it reads and
    +1 or -1.  Entries whose slot lies outside [0, num_slots) are dropped.
    ``dense``: one output per slot 0..num_slots-1 (0 where none lands);
    otherwise one per slot that some entry reaches, in ascending order
    (``plan.slots``)."""
    slot = np.asarray(slot, np.int64).ravel()
    source = np.asarray(source, np.int64).ravel()
    sign = (np.ones(slot.shape, np.int8) if sign is None
            else np.asarray(sign, np.int8).ravel())
    keep = (slot >= 0) & (slot < num_slots)
    order = np.argsort(slot[keep], kind="stable")
    slot, source, sign = (slot[keep][order], source[keep][order],
                          sign[keep][order])
    if dense:
        slots, col = None, slot
        width = int(num_slots)
    else:
        slots, col = np.unique(slot, return_inverse=True)
        width = len(slots)
    counts = np.bincount(col, minlength=width)
    depth = max(int(counts.max(initial=0)), 1)
    rank = np.arange(len(col)) - (np.cumsum(counts) - counts)[col]
    table = np.full((depth, width), num_sources, np.int64)
    table[rank, col] = source
    signs = np.ones((depth, width), np.int8)
    signs[rank, col] = sign
    return SegmentSum(
        table=torch.as_tensor(table.ravel(), device=device),
        sign=(None if (signs > 0).all()
              else torch.as_tensor(signs, device=device)),
        slots=None if slots is None else torch.as_tensor(slots,
                                                         device=device),
        num_sources=int(num_sources), depth=depth, width=width)


def segment_sum(plan: SegmentSum, src: torch.Tensor) -> torch.Tensor:
    """The plan's sums of ``src[..., :K]``: a [..., U] tensor."""
    lead = src.shape[:-1]
    if src.shape[-1] != plan.num_sources:
        src = src[..., :plan.num_sources]
    # a 2-D gather: index_select along the last dim of a 3-D tensor takes
    # a slower path
    g = F.pad(src, (0, 1)).view(-1, plan.num_sources + 1).index_select(
        1, plan.table).view(lead + (plan.depth, plan.width))
    if plan.sign is not None:
        sign = plan.signs.get(g.dtype)
        if sign is None:
            sign = plan.signs[g.dtype] = plan.sign.to(g.dtype)
        g = g * sign
    if g.device.type != "cpu":
        return g.sum(dim=-2)
    out = g[..., 0, :] + 0.0           # 0 + a, as index_add_ into zeros
    for j in range(1, plan.depth):
        out = out + g[..., j, :]
    return out


def cached(store: dict, key, owners: tuple, build):
    """``build()``'s plan, cached in ``store`` under ``key`` for as long
    as the tensors it was built from are ``owners`` (by identity: a
    system copied by ``dataclasses.replace`` with other index tensors
    shares the dict but not the plan)."""
    hit = store.get(key)
    if hit is not None and len(hit[0]) == len(owners) and all(
            a is b for a, b in zip(hit[0], owners)):
        return hit[1]
    plan = build()
    store[key] = (owners, plan)
    return plan


def edge_plan(system, kind: str) -> SegmentSum:
    """The system's cached plan of one edge sum over the unknown-pressure
    slots 0..M-1 (fixed nodes' slot M is dropped), source = one value
    per edge:

    * ``"diag"``: + at the head, then + at the tail (the Laplacian's
      diagonal);
    * ``"div"``: + at the head, then - at the tail (the Laplacian's
      product);
    * ``"net"``: + at the tail, then - at the head (inflow - outflow);
    * ``"laplacian"``: the Laplacian itself on the M x M grid, sparse:
      + (h, h), + (t, t), - (h, t), - (t, h)."""
    M, E = system.num_unknown_pressures, system.num_edges
    owners = (system.head, system.tail, system.node_unknown_index)

    def build():
        slot = system.node_unknown_index.cpu().numpy()
        hu = slot[system.head.cpu().numpy()]
        tu = slot[system.tail.cpu().numpy()]
        edges = np.arange(E)
        dev = system.device
        if kind == "laplacian":
            def cell(r, c):
                return np.where((r < M) & (c < M), r * M + c, -1)
            return plan_segment_sum(
                np.concatenate([cell(hu, hu), cell(tu, tu), cell(hu, tu),
                                cell(tu, hu)]),
                np.tile(edges, 4), M * M, E,
                sign=np.repeat([1, 1, -1, -1], E), dense=False, device=dev)
        first, second, sign = {"diag": (hu, tu, 1), "div": (hu, tu, -1),
                               "net": (tu, hu, -1)}[kind]
        return plan_segment_sum(
            np.concatenate([first, second]), np.tile(edges, 2), M, E,
            sign=np.repeat([1, sign], E), device=dev)

    return cached(system.plans, (kind, str(system.device)), owners, build)
