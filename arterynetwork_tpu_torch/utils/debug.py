"""Numerical-safety utilities.

Port of the JAX package's utils/debug.py.  The reference guards its
residual against NaN/Inf by printing (fluidSimulation.py:4699-4712).
Equivalents here: explicit finite checks with context, NaN trapping in
autograd, and a solution validity gate for the solvers (the reference's
``success`` flags, :594-596).
"""

from __future__ import annotations

import numpy as np
import torch


def enable_nan_checks(enable: bool = True):
    """Turn on autograd's anomaly mode with its NaN check
    (``torch.autograd.set_detect_anomaly(enable, check_nan=True)``).

    What it covers: during a backward pass, any backward function that
    returns a NaN raises at once, and the error carries the traceback of
    the forward op that made the node.  What it does not: PyTorch has no
    forward trap like JAX's ``jax_debug_nans``, so a NaN produced by a
    forward op, by any op outside autograd (``torch.no_grad``, integer
    or in-place work on tensors that need no gradient) or by a kernel of
    this package passes silently.  The port's solvers and voxel stages
    run no backward pass, so for them use ``check_finite`` on the
    results."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def check_finite(tree, name: str = "value"):
    """Raise with context if any floating leaf of ``tree`` (tensors,
    arrays and scalars in nested dicts, lists and tuples, NamedTuples
    included) holds a non-finite entry.  Returns ``tree``."""
    for i, leaf in enumerate(_leaves(tree)):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = ~np.isfinite(arr)
        if bad.any():
            idx = np.argwhere(bad)[0]
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad.sum()} non-finite entries "
                f"(first at index {tuple(idx)})")
    return tree


def assert_solution_valid(solution, max_nodal_imbalance=1e-9,
                          name="flow solution"):
    """Failure detection for the solvers: finite fields and conservation
    within tolerance, else a diagnostic error (instead of the reference's
    silent success=False)."""
    check_finite((solution.pressure, solution.flow, solution.velocity),
                 name)
    rn = float(np.max(_host(solution.residual_norm)))
    if rn > max_nodal_imbalance:
        its = _host(solution.iterations)
        raise ValueError(
            f"{name}: max nodal flow imbalance {rn:.3e} m^3/s exceeds "
            f"{max_nodal_imbalance:.1e} — solver did not converge "
            f"({int(np.max(its))} iterations)")
    return solution


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
