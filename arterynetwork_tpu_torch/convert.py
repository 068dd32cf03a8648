"""State carried across from the JAX package into the port's objects.

The functions read their inputs by attribute only (no import of JAX or of
the JAX package): any object with the fields of the JAX package's
``FlowSystem``, ``EliminationPlan`` or ``PipelineConfig`` converts, with
array fields given as numpy arrays or anything ``np.asarray`` takes.
Used by the parity tests to feed both solvers the same system.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import PipelineConfig
from .flow.system import FlowSystem
from .flow.tree_solver import EliminationPlan

_INDEX_FIELDS = ("head", "tail", "node_arg", "node_unknown_index",
                 "conserve_nodes", "bc_edge", "node_depth")
_REAL_FIELDS = ("radius_m", "length_m", "c", "k", "node_fixed_pressure",
                "bc_velocity")


def flow_system(src, device="cuda") -> FlowSystem:
    """A JAX ``FlowSystem`` -> the port's, on ``device`` (the floating
    fields keep their dtype)."""
    def idx(name):
        return torch.as_tensor(np.array(getattr(src, name), np.int64),
                               device=device)

    def real(name):
        return torch.as_tensor(np.array(getattr(src, name)),
                               device=device)

    return FlowSystem(
        **{f: idx(f) for f in _INDEX_FIELDS},
        **{f: real(f) for f in _REAL_FIELDS},
        node_fixed=torch.as_tensor(np.array(src.node_fixed, bool),
                                   device=device),
        num_unknown_pressures=int(src.num_unknown_pressures),
        num_nodes=int(src.num_nodes))


def elimination_plan(src, device="cuda") -> EliminationPlan:
    """A JAX ``EliminationPlan`` -> the port's, on ``device``."""
    def idx(name):
        return torch.as_tensor(np.array(getattr(src, name), np.int64),
                               device=device)

    return EliminationPlan(
        elim_nodes=idx("elim_nodes"), parents=idx("parents"),
        edge_idx=idx("edge_idx"),
        valid=torch.as_tensor(np.array(src.valid, bool), device=device),
        core_nodes=idx("core_nodes"), core_slot=idx("core_slot"),
        num_rounds=int(src.num_rounds), core_size=int(src.core_size))


def pipeline_config(src) -> PipelineConfig:
    """A JAX ``PipelineConfig`` -> the port's (same fields and values)."""
    out = PipelineConfig()
    for section in dataclasses.fields(out):
        values = dataclasses.asdict(getattr(src, section.name))
        setattr(out, section.name, type(getattr(out, section.name))(**values))
    return out
