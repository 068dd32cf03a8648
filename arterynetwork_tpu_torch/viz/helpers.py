# Copy of arterynetwork_tpu/viz/helpers.py, unchanged (no matplotlib import: the axes are the caller's).
"""Plot helpers (reference C24: myFunctions.py:153-366)."""

from __future__ import annotations

import numpy as np

# Matlab-style jet control points (myFunctions.py:172-175 uses the same
# 64-entry table; here generated procedurally).
def _jet64():
    x = np.linspace(0, 1, 64)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=1)


_JET = _jet64()


def generate_colormap(data, max_value=None):
    """RGBA colors for data values via a jet map
    (generateColormap, myFunctions.py:153-182)."""
    data = np.asarray(data, dtype=float).copy()
    data -= data.min()
    if max_value is None:
        max_value = data.max() if data.max() > 0 else 1.0
    out = np.ones((len(data), 4))
    bins = np.linspace(0, 1, 64)
    idx = np.clip(np.digitize(data / max_value, bins) - 1, 0, 63)
    out[:, :3] = _JET[idx]
    return out


def line_plot_binned(x, y, ax, bins=10, statistic="mean", label=None,
                     xlabel=None, ylabel=None):
    """Binned line plot (linePlot, myFunctions.py:279-333)."""
    from scipy.stats import binned_statistic

    x = np.asarray(x, float)
    y = np.asarray(y, float)
    edges = np.linspace(x.min(), x.max(), bins)
    stat, _, _ = binned_statistic(x, y, statistic=statistic, bins=edges)
    ax.plot(edges[:-1], stat, "o-", label=label)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if label:
        ax.legend(loc="best")
    return stat


def box_plot_whiskers(values, ax, positions=None, xlabel=None, ylabel=None):
    """Whisker box plot (boxPlotWithWhiskers, myFunctions.py:335-366)."""
    if positions is None:
        positions = list(range(1, len(values) + 1))
    widths = 0.8 * np.mean(np.diff(positions)) if len(positions) > 1 else 0.8
    ax.boxplot(values, widths=widths, positions=positions,
               whis=(0, 100))
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
