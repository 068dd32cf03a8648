"""Hazen-Williams pipe physics (port of the JAX package's flow/physics.py).

The reference expresses the pressure drop along a branch as

    dP = 10.67 * Q**k * L / c**k / D**4.8704       [Pa]

(fluidSimulation.py:530, 749, 4677) with Q in m^3/s, D = 2*radius and L in
meters.  ``k = 1`` recovers a linear (Poiseuille-like) law; the classic
Hazen-Williams exponent is 1.852.

Every function takes torch tensors (the solvers) and numpy arrays or
floats (the host-side ground-truth sweep and network setup) alike: the
arithmetic is written with operators, and the two functions that need
``sign`` / ``ones_like`` dispatch on the argument's type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import (
    BLOOD_KINEMATIC_VISCOSITY,
    HW_COEFF,
    HW_DIAMETER_EXPONENT,
    RHO_BLOOD,
)


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


def signed_flow_from_dp(dp, radius_m, length_m, c, k, eps=0.0):
    """Signed flow for a signed pressure drop; odd extension of flow_from_dp."""
    a = edge_admittance(radius_m, length_m, c, k)
    mag = (abs(dp) + eps) * a
    sign = torch.sign(dp) if isinstance(dp, torch.Tensor) else np.sign(dp)
    return sign * mag ** (1.0 / k)


def poiseuille_equivalent_c(radius_m, mu=3.5e-3):
    """c such that the k=1 Hazen-Williams law equals Hagen-Poiseuille.

    Poiseuille: dP = 128 mu L Q / (pi D^4).  Setting k=1 in the H-W form and
    matching gives c = 10.67 pi / (128 mu) * D^(-0.8704).  Useful for the
    physically calibrated linear (graph-Laplacian) solve path.
    """
    d = 2.0 * radius_m
    return HW_COEFF * math.pi / (128.0 * mu) * d ** (4.0 - HW_DIAMETER_EXPONENT)


def darcy_weisbach_ck(radius_m, nu=BLOOD_KINEMATIC_VISCOSITY, rho=RHO_BLOOD):
    """Per-edge ``(c, k)`` completing the reference's ``method='DW'`` slot.

    ``computeNetworkDetail`` declares a Darcy-Weisbach option with laminar
    friction ``f = 64/Re = 64*nu/(v*D)`` and blood constants
    (fluidSimulation.py:4640-4645) but leaves the branch an empty ``pass``
    (fluidSimulation.py:4692-4693).  For laminar ``f`` the D-W head loss

        dP = f * (L/D) * (rho * v**2 / 2) = 32 rho nu L v / D**2
           = 128 mu L Q / (pi D**4),        mu = rho * nu

    is exactly Hagen-Poiseuille, i.e. the k=1 Hazen-Williams law with
    ``c = poiseuille_equivalent_c(radius_m, mu=rho*nu)``.  Expressing it as
    per-edge (c, k) makes every downstream consumer — assembly, solvers,
    ground truth, studies, audits — handle DW networks unchanged.
    """
    c = poiseuille_equivalent_c(radius_m, mu=rho * nu)
    ones = (torch.ones_like(c) if isinstance(c, torch.Tensor)
            else np.ones_like(c))
    return c, ones


def velocity_from_flow(flow, radius_m):
    return flow / (math.pi * radius_m ** 2)


def flow_from_velocity(velocity, radius_m):
    return velocity * math.pi * radius_m ** 2
