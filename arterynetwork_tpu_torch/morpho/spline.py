# Copy of arterynetwork_tpu/morpho/spline.py, unchanged.
"""Spline utilities shared by the morphology metrics.

Same semantics as the reference helpers (myFunctions.py:184-277):
weighted 3D B-spline fitting with the reference's smoothing defaults, and
the circumscribed-triangle curvature formula kappa = 4S/(abc).
"""

from __future__ import annotations

import numpy as np
from numpy.linalg import norm
from scipy import interpolate


def spline_interpolation(coords, point_loc, smoothing=None,
                         return_derivative=False, k=3, w=None):
    """Fit a B-spline through 3D coords; evaluate value (and normalized
    derivative) at parameter locations.

    Defaults mirror mf.splineInterpolation (myFunctions.py:214-227):
    smoothing = 100 for <= 20 points else n + sqrt(2n); spline degree
    reduced when there are too few points.
    """
    coords = np.asarray(coords, dtype=float)
    n = len(coords)
    if smoothing is None:
        smoothing = 100.0 if n <= 20 else n + np.sqrt(2.0 * n)
    if n <= k:
        k = n - 1
    if w is None:
        w = np.ones(n)

    tck, u = interpolate.splprep(
        [coords[:, 0], coords[:, 1], coords[:, 2]], s=smoothing, k=k, w=w)
    point_loc = np.atleast_1d(point_loc)
    v1, v2, v3 = interpolate.splev(point_loc, tck, der=0)
    if len(point_loc) == 1:
        value = np.array([v1, v2, v3]).reshape(3)
    else:
        value = np.stack([v1, v2, v3], axis=1)

    if not return_derivative:
        return tck, u, value

    d1, d2, d3 = interpolate.splev(point_loc, tck, der=1)
    if len(point_loc) == 1:
        derivative = np.array([d1, d2, d3]).reshape(3)
        derivative = derivative / norm(derivative)
    else:
        derivative = np.stack([d1, d2, d3], axis=1)
        derivative = derivative / norm(derivative, axis=1, keepdims=True)
    return tck, u, value, derivative


def curvature_by_triangle(points):
    """kappa = 4S/(abc) through three consecutive points
    (myFunctions.py:249-277; S from Heron's formula, clamped at 0)."""
    A, B, C = np.asarray(points, dtype=float)
    a, b, c = norm(A - B), norm(A - C), norm(B - C)
    c, b, a = np.sort([a, b, c])
    t = (a + (b + c)) * (c - (a - b)) * (c + (a - b)) * (a + (b - c))
    s = 0.0 if t < 0 else np.sqrt(t) / 4.0
    return 4.0 * s / (a * b * c)
