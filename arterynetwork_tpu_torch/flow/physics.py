"""Hazen-Williams pipe physics (port of the JAX package's flow/physics.py).

The reference expresses the pressure drop along a branch as

    dP = 10.67 * Q**k * L / c**k / D**4.8704       [Pa]

(fluidSimulation.py:530, 749, 4677) with Q in m^3/s, D = 2*radius and L in
meters.  ``k = 1`` recovers a linear (Poiseuille-like) law; the classic
Hazen-Williams exponent is 1.852.

Every function is written with arithmetic operators only, so it takes
torch tensors (the solver) and numpy arrays or floats (the host-side
ground-truth sweep) alike.  Only the functions the main path calls are
ported.
"""

from __future__ import annotations

import math

from ..constants import HW_COEFF, HW_DIAMETER_EXPONENT


def edge_admittance(radius_m, length_m, c, k):
    """A_e such that Q**k = A_e * dP  (Q in m^3/s, dP in Pa).

    From dP = 10.67 Q^k L / (c^k D^4.8704):
        A = c^k * D^4.8704 / (10.67 * L)
    """
    d = 2.0 * radius_m
    return c ** k * d ** HW_DIAMETER_EXPONENT / (HW_COEFF * length_m)


def dp_from_flow(flow, radius_m, length_m, c, k):
    """Pressure drop (Pa) for a given flow (m^3/s).

    Mirrors ``getDeltaPressureFromFlow`` (fluidSimulation.py:509-532).
    """
    d = 2.0 * radius_m
    return HW_COEFF * flow ** k * length_m / c ** k / d ** HW_DIAMETER_EXPONENT


def flow_from_dp(dp, radius_m, length_m, c, k):
    """Flow (m^3/s) for a given pressure drop (Pa), dp >= 0.

    Mirrors ``getFlowInfoFromDeltaPressure`` (fluidSimulation.py:481-507).
    """
    a = edge_admittance(radius_m, length_m, c, k)
    return (dp * a) ** (1.0 / k)


def velocity_from_flow(flow, radius_m):
    return flow / (math.pi * radius_m ** 2)

