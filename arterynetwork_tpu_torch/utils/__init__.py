"""Transfer helpers, phantoms, profiling and debug utilities."""

from .debug import assert_solution_valid, check_finite, enable_nan_checks
from .profiling import StageTimer, device_sync, device_trace, span

__all__ = ["assert_solution_valid", "check_finite", "enable_nan_checks",
           "StageTimer", "device_sync", "device_trace", "span"]
