"""Per-partition statistics of the morphology driver (the figures of
the JAX package's viz are not ported yet)."""

from .study_plots import (PARTITION_NAMES, statistics_per_partition,
                          statistics_per_partition2)

__all__ = ["PARTITION_NAMES", "statistics_per_partition",
           "statistics_per_partition2"]
