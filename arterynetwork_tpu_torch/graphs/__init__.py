"""Vessel graphs: segments, branch attributes, the flow network."""

from .network import (FlowNetwork, make_network, orient_edges_by_depth,
                      validate_network)
from .tree import generate_tree, set_network_properties

__all__ = [
    "FlowNetwork",
    "make_network",
    "orient_edges_by_depth",
    "validate_network",
    "generate_tree",
    "set_network_properties",
]
