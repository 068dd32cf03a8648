"""matplotlib for the figure functions, imported at their first call.

Importing ``arterynetwork_tpu_torch.viz`` does not import matplotlib:
the statistics and the numpy helpers run where it is missing, and a
figure function raises ``ImportError`` there."""

from __future__ import annotations

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("the figures of arterynetwork_tpu_torch.viz need "
                          "matplotlib, which does not import here") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def as_numpy(x):
    """A torch tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)
