# Copy of arterynetwork_tpu/flow/distribute.py in torch: the level scan is a loop, the Gauss-Newton scan steps run in ops/grow_loop, the Jacobian torch.func.jacfwd.
"""Flow-distribution optimizer — the reference's unfinished distributeFlow slot.

Reference: ``fluidSimulation.py:1053`` (``setupEquationsForDistributeFlow``),
``:2758`` (``distributeFlowTest``) and ``:4730`` (``distributeFlowDetail``),
all of which carry "Unfinished!" docstrings.  The intended semantics (read
from the partial code): each edge gets a *split fraction* ``args[edgeIndex]``
in [0, 1] of the flow arriving at its head node; flows propagate down the
depth-ordered network with Hazen-Williams pressure drops
(``dP = 10.67 Q^k L / c^k D^4.8704``); merging nodes reconcile the several
arriving pressures "by optimization"; and the fractions are chosen so the
resulting terminating pressures match desired values (the reference
hard-codes ``13560*9.8*0.12`` Pa).

This module finishes that design (ported from the JAX package's
flow/distribute.py; the level scan is a Python loop of out-of-place
``index_add``, the Jacobian ``torch.func.jacfwd``):

* **Constraints by construction, not by penalty.**  One unconstrained logit
  per edge; the fractions are a per-head-node segment softmax, so sibling
  fractions always sum to 1 and live in (0, 1) — the box bounds and the
  conservation constraint the reference would have had to feed a bounded
  optimizer are structural.
* **Static level-synchronous propagation.**  The forward pass is a loop
  over depth levels with padded per-level edge tables (static shapes, no
  data-dependent control flow, no host reads).  An edge's
  level is its head-node depth, so every node's pressure is final before its
  out-edges are processed — including DAG merge nodes, whose pressure is the
  flow-weighted mean of the arriving branch pressures.
* **Damped Gauss-Newton.**  The residual stacks (terminating pressure −
  desired) with the per-edge merge-consistency gap (arriving branch pressure
  − merged node pressure; identically zero on trees).  Problems are small
  (E ≲ a few thousand), so a dense ``jacfwd`` + Levenberg-damped normal
  equation solve converges in a handful of iterations; the damping also
  absorbs the softmax's per-group logit-shift null space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd

from ..constants import (HW_COEFF, HW_DIAMETER_EXPONENT, INLET_PRESSURE,
                         PASCAL_PER_MMHG)
from ..graphs.network import FlowNetwork
from ..ops import grow_loop

# the reference's desired terminating pressure (fluidSimulation.py:1100)
# — the same 13560*9.8*0.12 Pa as the inlet constant
DEFAULT_DESIRED_TERMINATING_PRESSURE = INLET_PRESSURE
_MMHG = PASCAL_PER_MMHG


def _default_dtype():
    """f64: the card computes f64 (the JAX package picks f32 only on a
    TPU, which has no working f64)."""
    return torch.float64


class DistributeSystem(NamedTuple):
    """Static-shape description of the split-fraction problem.

    Per-level tables are padded to the widest level with ``valid == 0``
    rows (clipped indices + zeroed contributions keep the scatter-adds
    inert), mirroring ``distributeFlowEqnDict['connectInfoDictList']``'s
    depth-sorted edge walk (fluidSimulation.py:1077-1090).
    """

    level_edge: torch.Tensor     # i64[L, W]  edge index (clipped at pad)
    level_head: torch.Tensor     # i64[L, W]
    level_tail: torch.Tensor     # i64[L, W]
    level_valid: torch.Tensor    # f[L, W]      1.0 on real rows
    dp_coeff: torch.Tensor       # f[E]  10.67 L / (c^k D^4.8704)
    k: torch.Tensor              # f[E]
    heads: torch.Tensor          # i64[E]     for the sibling softmax
    tails: torch.Tensor          # i64[E]
    merge_weight: torch.Tensor   # f[E]  1.0 on edges entering a merge node
    terminal_nodes: torch.Tensor  # i64[T]
    desired_pressure: torch.Tensor  # f[T]  Pa
    root: int
    inlet_flow: float            # m^3/s
    inlet_pressure: float        # Pa
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.dp_coeff.shape[0])


def build_distribute_system(
    net: FlowNetwork,
    inlet_flow: float,
    inlet_pressure: float,
    desired_terminating_pressure=None,
    dtype=None,
    device="cuda",
) -> DistributeSystem:
    """Assemble the padded level tables from a ``FlowNetwork``, on
    ``device``.

    Mirrors ``setupEquationsForDistributeFlow`` (fluidSimulation.py:1053):
    edges sorted by depth, merge nodes = nodes with >1 lower-depth
    neighbor, desired terminating pressure defaulting to the reference's
    hard-coded value at every degree-1 non-entry node.  ``dtype=None``
    picks f64.
    """
    if dtype is None:
        dtype = _default_dtype()
    heads = np.asarray(net.heads, dtype=np.int64)
    tails = np.asarray(net.tails, dtype=np.int64)
    depth = np.asarray(net.node_depth, dtype=np.int64)
    E = heads.shape[0]

    # the level-synchronous loop finalizes a node's pressure before its
    # out-edges run, which requires every edge to strictly descend the
    # depth field — the same precondition as the reference's depth
    # sweep.  A cross edge (equal depths, e.g. from a skeleton loop)
    # would read its tail's inflow mid-level and silently misroute flow,
    # so reject it loudly instead.
    if E and not (depth[heads] < depth[tails]).all():
        bad = int((depth[heads] >= depth[tails]).sum())
        raise ValueError(
            f"distribute_flow needs a depth-acyclic network: {bad} "
            "edge(s) do not strictly descend the depth field (loopy "
            "skeletons are out of this solver's scope, as they are for "
            "the reference's depth sweep — use flow.solvers on those)")

    level_of_edge = depth[heads]
    n_levels = int(level_of_edge.max()) + 1 if E else 1
    order = np.argsort(level_of_edge, kind="stable")
    width = max(int(np.bincount(level_of_edge, minlength=n_levels).max()), 1)

    le = np.zeros((n_levels, width), dtype=np.int64)
    lh = np.zeros((n_levels, width), dtype=np.int64)
    lt = np.zeros((n_levels, width), dtype=np.int64)
    lv = np.zeros((n_levels, width), dtype=np.float64)
    fill = np.zeros(n_levels, dtype=np.int64)
    for e in order:
        lvl = level_of_edge[e]
        j = fill[lvl]
        le[lvl, j], lh[lvl, j], lt[lvl, j] = e, heads[e], tails[e]
        lv[lvl, j] = 1.0
        fill[lvl] += 1

    in_degree = np.bincount(tails, minlength=net.num_nodes)
    merge_weight = (in_degree[tails] > 1).astype(np.float64)

    terminals = np.asarray(net.terminal_nodes(), dtype=np.int64)
    if desired_terminating_pressure is None:
        desired = np.full(terminals.shape,
                          DEFAULT_DESIRED_TERMINATING_PRESSURE)
    else:
        desired = np.broadcast_to(
            np.asarray(desired_terminating_pressure, dtype=np.float64),
            terminals.shape).copy()

    radius_m = np.asarray(net.radius_m(), dtype=np.float64)
    length_m = np.asarray(net.length_m(), dtype=np.float64)
    c = np.asarray(net.c, dtype=np.float64)
    k = np.asarray(net.k, dtype=np.float64)
    dp_coeff = (HW_COEFF * length_m
                / c ** k / (2.0 * radius_m) ** HW_DIAMETER_EXPONENT)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    root = int(net.entry_nodes[0]) if len(net.entry_nodes) else 0
    return DistributeSystem(
        level_edge=idx(le), level_head=idx(lh), level_tail=idx(lt),
        level_valid=real(lv), dp_coeff=real(dp_coeff), k=real(k),
        heads=idx(heads), tails=idx(tails),
        merge_weight=real(merge_weight),
        terminal_nodes=idx(terminals),
        desired_pressure=real(desired),
        root=root,
        inlet_flow=float(inlet_flow),
        inlet_pressure=float(inlet_pressure),
        num_nodes=net.num_nodes,
    )


def split_fractions(theta: torch.Tensor,
                    system: DistributeSystem) -> torch.Tensor:
    """Per-head-node segment softmax: sibling fractions sum to 1."""
    seg_max = theta.new_zeros(system.num_nodes).scatter_reduce(
        0, system.heads, theta, "amax", include_self=False)
    ex = torch.exp(theta - seg_max[system.heads])
    denom = ex.new_zeros(system.num_nodes).index_add(0, system.heads, ex)
    return ex / denom[system.heads]


def propagate(theta: torch.Tensor, system: DistributeSystem):
    """Forward pass: level-synchronous flow + pressure propagation.

    Returns ``(node_pressure[N], node_inflow[N], edge_flow[E],
    edge_tail_pressure[E])`` — the last being each edge's arriving
    pressure before merge reconciliation (distributeFlowDetail's
    ``tailPressure``, fluidSimulation.py:4747).  Every scatter is
    out-of-place, so ``torch.func`` transforms run through it.
    """
    dtype = system.dp_coeff.dtype
    frac = split_fractions(theta, system)
    N, E = system.num_nodes, system.num_edges
    tiny = torch.finfo(dtype).tiny
    is_root = torch.arange(N, device=theta.device) == system.root

    zeros = torch.zeros(N, dtype=dtype, device=theta.device)
    inflow = zeros.masked_fill(is_root, system.inlet_flow)
    pnum = zeros.masked_fill(is_root,
                             system.inlet_flow * system.inlet_pressure)
    eflow = theta.new_zeros(E)
    ptail = theta.new_zeros(E)
    for eid, h, t, valid in zip(system.level_edge, system.level_head,
                                system.level_tail, system.level_valid):
        # head pressures are final: every in-edge has a lower level
        p_head = pnum[h] / torch.clamp(inflow[h], min=tiny)
        q = inflow[h] * frac[eid] * valid
        dp = system.dp_coeff[eid] * torch.abs(q) ** system.k[eid]
        p_cand = p_head - dp
        inflow = inflow.index_add(0, t, q)
        pnum = pnum.index_add(0, t, q * p_cand)
        eflow = eflow.index_add(0, eid, q)  # pads clip to edge 0: add 0
        ptail = ptail.index_add(0, eid, p_cand * valid)
    pressure = pnum / torch.clamp(inflow, min=tiny)
    pressure = torch.where(is_root, system.inlet_pressure, pressure)
    return pressure, inflow, eflow, ptail


def residuals(theta: torch.Tensor, system: DistributeSystem,
              merge_scale: float = 100.0) -> torch.Tensor:
    """[terminal pressure mismatch; merge-consistency gap], in mmHg.

    ``merge_scale`` weights the merge gap: arriving branch pressures at a
    physical junction MUST agree, while the desired terminating pressures
    are targets to approach — so when the targets are infeasible the
    optimizer must sacrifice them, not junction consistency."""
    pressure, _, _, ptail = propagate(theta, system)
    r_term = (pressure[system.terminal_nodes]
              - system.desired_pressure) / _MMHG
    # per-edge arriving pressure vs the merged node pressure (zero unless
    # the tail is a merge node) — the reference's two-pressure list that
    # "optimization" was meant to reconcile (fluidSimulation.py:4749-4752)
    r_merge = ((ptail - pressure[system.tails])
               * system.merge_weight * merge_scale / _MMHG)
    return torch.cat([r_term, r_merge])


class DistributeResult(NamedTuple):
    fractions: torch.Tensor        # f[E] split fraction per edge
    edge_flow: torch.Tensor        # f[E] m^3/s
    node_pressure: torch.Tensor    # f[N] Pa
    residual_norm: torch.Tensor    # RMS terminal mismatch, mmHg
    iterations: torch.Tensor
    theta: torch.Tensor


# the fits' cache: per device and thread, at most this many entries
# (the flow solves' number, flow/solvers.py; an entry holds an E x E
# matrix and the system's small tables)
_CACHE_SIZE = 8
_cache = grow_loop.LoopCache(_CACHE_SIZE)
# the system's tensor fields, copied into an entry; its Python numbers,
# which the captured step takes as constants, are in the key
_TENSOR_FIELDS = ("level_edge", "level_head", "level_tail", "level_valid",
                  "dp_coeff", "k", "heads", "tails", "merge_weight",
                  "terminal_nodes", "desired_pressure")
_NUMBER_FIELDS = ("root", "inlet_flow", "inlet_pressure", "num_nodes")


def clear_distribute_cache(device=None):
    """Drop this thread's cached fits on ``device`` (or on every
    device): the next fit of each key captures its step anew."""
    _cache.clear(device)


def distribute_cache_info():
    """The fits' cache: hits, misses, evictions, entries by device."""
    return _cache.info()


def _key(system: DistributeSystem, max_iter):
    """What the JAX jit keys on: the shape and dtype of every tensor
    field, the Python numbers the step takes as constants (root, inlet
    flow and pressure, node count) and ``max_iter``."""
    return (tuple((tuple(getattr(system, f).shape), getattr(system, f).dtype)
                  for f in _TENSOR_FIELDS),
            tuple(getattr(system, f) for f in _NUMBER_FIELDS), max_iter)


class _Fit(grow_loop.CachedLoop):
    """A cached fit, the counterpart of one executable in the JAX jit's
    cache: a copy of the system's tensors (which ``residuals``,
    ``propagate`` and the Jacobian ``jacfwd(res_fn)`` read), ``theta``,
    the damping ``lam``, the identity ``eye``, and the Gauss-Newton
    step, which reads nothing else, under the key "gn"."""

    def __init__(self, system: DistributeSystem):
        dtype = system.dp_coeff.dtype
        device = system.dp_coeff.device
        super().__init__(torch.device(device))
        E = system.num_edges
        self.system = system._replace(
            **{f: getattr(system, f).clone() for f in _TENSOR_FIELDS})
        self.theta = torch.zeros(E, dtype=dtype, device=device)
        self.lam = torch.zeros((), dtype=dtype, device=device)
        self.eye = torch.eye(E, dtype=dtype, device=device)

    def load(self, system: DistributeSystem, init_theta):
        """Copy a call's system and initial ``theta`` in, and reset
        ``lam`` to 1e-3 (eagerly: a capture refuses a host number
        written into a device tensor)."""
        for f in _TENSOR_FIELDS:
            getattr(self.system, f).copy_(getattr(system, f))
        if init_theta is None:
            self.theta.zero_()
        else:
            self.theta.copy_(torch.as_tensor(init_theta,
                                              dtype=self.theta.dtype))
        self.lam.fill_(1e-3)

    def step(self):
        """One damped Gauss-Newton step: two trial dampings, the better
        kept if it lowers the cost; ``theta`` and ``lam`` updated."""
        system, theta, lam, eye = self.system, self.theta, self.lam, self.eye

        def res_fn(th):
            return residuals(th, system)

        r = res_fn(theta)
        J = jacfwd(res_fn)(theta)
        g = J.T @ r
        H = J.T @ J

        def try_lambda(lam):
            delta = torch.linalg.solve_ex(H + lam * eye, -g)[0]
            r_new = res_fn(theta + delta)
            return delta, torch.sum(r_new ** 2)

        cost = torch.sum(r ** 2)
        d1, c1 = try_lambda(lam)
        d2, c2 = try_lambda(lam * 10.0)
        use1 = c1 <= c2
        delta = torch.where(use1, d1, d2)
        new_cost = torch.where(use1, c1, c2)
        accept = new_cost <= cost
        theta.copy_(torch.where(accept, theta + delta, theta))
        lam.copy_(torch.clamp(torch.where(
            accept, torch.where(use1, lam * 0.3, lam * 3.0), lam * 10.0),
            1e-12, 1e8))


@grow_loop.frees_loop_caches
def distribute_flow(
    system: DistributeSystem,
    max_iter: int = 40,
    tol_mmhg: float = 1e-9,
    init_theta: Optional[torch.Tensor] = None,
) -> DistributeResult:
    """Solve for split fractions by Levenberg-damped Gauss-Newton.

    Completes ``distributeFlowTest`` (fluidSimulation.py:2758): "find a way
    (by optimization) to distribute the flow ... such that the resulting
    terminating pressures match the desired values".  Runs ``max_iter``
    steps on the device with no host read; ``tol_mmhg`` is accepted and
    unused, as in the JAX package.

    The steps are the JAX package's ``lax.scan``
    (arterynetwork_tpu/flow/distribute.py:310): each writes ``theta`` and
    the damping ``lam``, buffers made before the loop, in place, and runs
    under the key "gn" in ``ops/grow_loop.loop_for``'s loop: on a card
    step 1 eagerly, step 2 captured as a CUDA graph (the Jacobian and
    both damped solves in it), steps 3.. replayed; on the CPU eagerly.

    As ``jax.jit`` compiles the scan once per shape, the step and every
    tensor it reads lie in a cached entry (``_Fit``), one per key: the
    shape and dtype of each of the system's tensors, its root, inlet
    flow and pressure and node count, ``max_iter``, and the loop route.
    A call copies its system and ``init_theta`` in first; on a hit all
    ``max_iter`` steps are replays and nothing is captured, on a miss
    the step is captured on its second run (or, after one step, at the
    call's end).  The results are new tensors.  The last call's counts
    are ``distribute_flow.steps``, ``.captures``, ``.replays``,
    ``.capture_s`` and ``.hit``; ``clear_distribute_cache()`` and
    ``distribute_cache_info()`` manage the cache.
    """
    device = torch.device(system.dp_coeff.device)
    with _cache.use(device, _key(system, max_iter),
                    lambda: _Fit(system)) as (fit, hit):
        fit.load(system, init_theta)
        loop = fit.loop
        with loop.stream():
            for _ in range(max_iter):
                loop.run("gn", fit.step)
            loop.capture_pending()
        theta = fit.out(fit.theta)
    distribute_flow.steps = loop.runs.get("gn", 0)
    distribute_flow.captures = loop.captures
    distribute_flow.replays = loop.replays
    distribute_flow.capture_s = loop.capture_s
    distribute_flow.hit = hit

    pressure, _, eflow, _ = propagate(theta, system)
    r_term = (pressure[system.terminal_nodes]
              - system.desired_pressure) / _MMHG
    rms_term = torch.sqrt(torch.mean(r_term ** 2))
    return DistributeResult(
        fractions=split_fractions(theta, system),
        edge_flow=eflow,
        node_pressure=pressure,
        residual_norm=rms_term,
        iterations=torch.tensor(max_iter),
        theta=theta,
    )


distribute_flow.steps = distribute_flow.captures = 0
distribute_flow.replays = 0
distribute_flow.capture_s = 0.0
distribute_flow.hit = False


def distribute_flow_study(
    net: FlowNetwork,
    inlet_flow: Optional[float] = None,
    inlet_pressure: Optional[float] = None,
    desired_terminating_pressure=None,
    max_iter: int = 40,
    dtype=None,
    device="cuda",
) -> dict:
    """The ``distributeFlowTest`` entry point (fluidSimulation.py:2758).

    Defaults the inlet boundary from the network's ground-truth-style
    state when present (``edge_flow``/``node_pressure``), else from a
    nominal 750 ml/min cerebral inflow at 100 mmHg.
    """
    root = int(net.entry_nodes[0]) if len(net.entry_nodes) else 0
    if inlet_flow is None:
        if net.edge_flow is not None:
            out_of_root = (np.asarray(net.heads) == root)
            inlet_flow = float(np.abs(
                np.asarray(net.edge_flow)[out_of_root]).sum())
        else:
            inlet_flow = 750e-6 / 60.0  # 750 ml/min in m^3/s
    if inlet_pressure is None:
        if net.node_pressure is not None:
            inlet_pressure = float(np.asarray(net.node_pressure)[root])
        else:
            inlet_pressure = 100.0 * _MMHG  # 100 mmHg in Pa

    system = build_distribute_system(
        net, inlet_flow=inlet_flow, inlet_pressure=inlet_pressure,
        desired_terminating_pressure=desired_terminating_pressure,
        dtype=dtype, device=device)
    result = distribute_flow(system, max_iter=max_iter)
    term_p = result.node_pressure[system.terminal_nodes].cpu().numpy()
    return {
        "result": result,
        "system": system,
        "fractions": result.fractions.cpu().numpy(),
        "edge_flow": result.edge_flow.cpu().numpy(),
        "terminal_pressure_mmhg": term_p / _MMHG,
        "desired_pressure_mmhg":
            system.desired_pressure.cpu().numpy() / _MMHG,
        "rms_mismatch_mmhg": float(result.residual_norm),
    }
