"""Vessel graphs: segments, branch attributes, the flow network."""
