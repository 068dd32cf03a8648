"""Hazen-Williams network flow: physics, assembly and solvers."""
