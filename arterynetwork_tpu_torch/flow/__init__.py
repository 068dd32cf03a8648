"""Hazen-Williams network flow: physics, assembly, solvers and the
longitudinal studies (the JAX package's ``flow`` exports)."""

from .ground_truth import GroundTruthResult, create_ground_truth
from .physics import (
    darcy_weisbach_ck,
    dp_from_flow,
    edge_admittance,
    flow_from_dp,
    flow_from_velocity,
    signed_flow_from_dp,
    velocity_from_flow,
)
from .residual import pack_velocity_pressure, residual_reference, validate_equations
from .solvers import FlowSolution, solve_poiseuille, solve_pressure_newton
from .system import FlowSystem, apply_velocity_pressure, build_system
from .adan import ADANModel, set_network_ck
from .network_setup import (
    BRAVA_FIT_PARAMS,
    COW_BRANCH_ADJUSTMENTS,
    adjust_network,
    apply_darcy_weisbach,
    convert_network,
    edge_partition_names,
    load_network,
    set_network,
)
from .studies import (
    flow_proportions_per_partition,
    flow_split_study,
    gbm_test4,
    gbm_test5b,
    same_flow_study,
    save_gbm_test5_results,
    tp_fit_solve_study,
    two_timepoint_comparison,
)
from .tree_solver import EliminationPlan, plan_elimination
from .distribute import (
    DistributeResult,
    DistributeSystem,
    build_distribute_system,
    distribute_flow,
    distribute_flow_study,
)

__all__ = [
    "GroundTruthResult",
    "create_ground_truth",
    "darcy_weisbach_ck",
    "dp_from_flow",
    "edge_admittance",
    "flow_from_dp",
    "flow_from_velocity",
    "signed_flow_from_dp",
    "velocity_from_flow",
    "pack_velocity_pressure",
    "residual_reference",
    "validate_equations",
    "FlowSolution",
    "solve_poiseuille",
    "solve_pressure_newton",
    "FlowSystem",
    "build_system",
    "apply_velocity_pressure",
    "ADANModel",
    "set_network_ck",
    "BRAVA_FIT_PARAMS",
    "COW_BRANCH_ADJUSTMENTS",
    "adjust_network",
    "apply_darcy_weisbach",
    "convert_network",
    "edge_partition_names",
    "load_network",
    "set_network",
    "flow_proportions_per_partition",
    "flow_split_study",
    "gbm_test4",
    "gbm_test5b",
    "same_flow_study",
    "save_gbm_test5_results",
    "tp_fit_solve_study",
    "two_timepoint_comparison",
    "EliminationPlan",
    "plan_elimination",
    "DistributeResult",
    "DistributeSystem",
    "build_distribute_system",
    "distribute_flow",
    "distribute_flow_study",
]
