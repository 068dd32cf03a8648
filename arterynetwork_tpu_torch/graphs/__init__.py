"""Vessel graphs: segments, branch attributes, the flow network."""

from .tree import generate_tree, set_network_properties

__all__ = ["generate_tree", "set_network_properties"]
