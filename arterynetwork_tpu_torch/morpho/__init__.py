# Copy of arterynetwork_tpu/morpho/__init__.py, unchanged.
from .curvature import calculate_curvature
from .metrics import calculate_property, summarize
from .spline import curvature_by_triangle, spline_interpolation

__all__ = ["calculate_curvature", "calculate_property", "summarize",
           "curvature_by_triangle", "spline_interpolation"]
