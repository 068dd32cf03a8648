# Copy of arterynetwork_tpu/flow/adan.py; Darcy-Weisbach networks raise (flow/network_setup is not ported).
"""ADAN-derived Hazen-Williams coefficient model (reference C13 part).

``setNetwork`` option 2 (fluidSimulation.py:401-439) assigns each edge a
Hazen-Williams ``c`` from a linear regression of ADAN simulation results
against radius, and one global exponent ``k``:

    c = slope_c_radius * radius_m + intercept_c_radius
    c = 1        if 1.5 mm <= radius <= 2.5 mm
    c = 0.1      if the regression gives c < 0 (outside that band)

The regression constants live in the reference's ``resultADANDict.pkl``
(not redistributable); ``ADANModel`` defaults reproduce the c≈1 regime the
reference operates in and can be loaded from the original pickle via
``ADANModel.from_dict`` when available.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..graphs.network import FlowNetwork


@dataclasses.dataclass
class ADANModel:
    slope_c_radius: float = 0.0
    intercept_c_radius: float = 1.0
    k: float = 1.852
    radius_thresholds: Optional[np.ndarray] = None  # meters, for binning
    ck_candidates: Optional[np.ndarray] = None
    slope_pressure_path_length: float = -10000.0    # Pa/m
    intercept_pressure_path_length: float = 0.0

    @classmethod
    def from_dict(cls, d):
        """Build from the reference's resultADANDict contents."""
        return cls(
            slope_c_radius=float(d["slopeCRadius"]),
            intercept_c_radius=float(d["interceptCRadius"]),
            k=float(np.asarray(d["CKCandidates"])[-1]),
            radius_thresholds=np.asarray(d.get("radiusThresholds")),
            ck_candidates=np.asarray(d.get("CKCandidates")),
            slope_pressure_path_length=float(
                d.get("slopePressurePathLength", -10000.0)),
            intercept_pressure_path_length=float(
                d.get("interceptPressurePathLength", 0.0)),
        )

    def _radius_band(self, radius_m):
        """(min, max) of the ADAN binning table (meters), or None."""
        if self.radius_thresholds is None or self.ck_candidates is None:
            return None
        th = np.asarray(self.radius_thresholds, float)
        return float(th.min()), float(th.max())

    def c_of_radius(self, radius_m):
        """setNetwork option 2 (fluidSimulation.py:427-439): radii inside
        the ADAN table band take the c-radius regression directly; outside
        the band the regression applies with two special cases — c = 1
        for 1.5 mm <= r <= 2.5 mm, else clamp negative c to 0.1.  Without
        a binning table everything is 'out of band' (the reference always
        has the table; the defaults reproduce its c~1 regime)."""
        radius_m = np.asarray(radius_m, float)
        c = self.slope_c_radius * radius_m + self.intercept_c_radius
        band = self._radius_band(radius_m)
        if band is None:
            in_band = np.zeros(radius_m.shape, bool)
        else:
            in_band = (radius_m > band[0]) & (radius_m < band[1])
        mm = radius_m * 1000.0
        special = (mm >= 1.5) & (mm <= 2.5)
        c_out = np.where(special, 1.0, np.where(c < 0, 0.1, c))
        return np.where(in_band, c, c_out)

    def c_of_radius_binned(self, radius_m):
        """setNetwork option 1 (fluidSimulation.py:384-399): radii inside
        the table band take the *binned* candidate
        ``ck_candidates[digitize(r, radius_thresholds) - 1]``; outside,
        the regression clamped below at 0.1."""
        radius_m = np.asarray(radius_m, float)
        c_reg = self.slope_c_radius * radius_m + self.intercept_c_radius
        c_reg = np.where(c_reg > 0, c_reg, 0.1)
        band = self._radius_band(radius_m)
        if band is None:
            return c_reg
        th = np.asarray(self.radius_thresholds, float)
        cand = np.asarray(self.ck_candidates, float)
        bins = np.clip(np.digitize(radius_m, th) - 1, 0, len(cand) - 1)
        c_binned = cand[bins]
        in_band = (radius_m > band[0]) & (radius_m < band[1])
        return np.where(in_band, c_binned, c_reg)


def set_network_ck(net: FlowNetwork, model: ADANModel = None) -> FlowNetwork:
    """Re-derive per-edge c and k from the current radii.

    Dispatches on ``net.physics``: Hazen-Williams networks get the ADAN
    model (setNetwork option 2, the reference's path); Darcy-Weisbach
    networks re-derive the laminar DW law instead, so a radius update
    (updateEdgeRadius -> setNetwork, fluidSimulation.py:2989-3005) keeps
    the friction law the user selected rather than silently reverting
    to HW."""
    if getattr(net, "physics", "hw") == "dw":
        raise NotImplementedError(
            "Darcy-Weisbach networks need flow/network_setup, which the "
            "port does not carry yet")
    if model is None:
        model = ADANModel()
    c = model.c_of_radius(net.radius_m())
    k = np.full(net.num_edges, model.k)
    return net.replace(c=c, k=k)
