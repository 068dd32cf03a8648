"""The sign gate of K1 (csrc/frangi_response.cu) is exact.

The kernel skips the eigen-solve and the response of every voxel whose
``qm = (a11 + a22 + a33) * (1/3)``, computed in f32 as the kernel computes
it, is >= 0 (bright) or <= 0 (dark), and folds 0 into the running max
there instead.  That is exact only if the response is exactly 0 at every
such voxel.  It is: after the sort by |lambda|, keeping a voxel needs
lambda2 and lambda3 of one sign, and then |lambda1| <= |lambda2| puts the
eigenvalue sum on that sign by at least |lambda3|, while the computed
``e2 = 3 qm - e1 - e3`` keeps the sum within a few ulps of |lambda3| of
``3 qm``; the degenerate branch sets every eigenvalue to qm.

Here the port's twin (``_response_from_hessian``) and the JAX package's
function take the same seeded f32 Hessians, drawn to stress the
predicate's edge: Gaussian, traceless (qm exactly 0), diagonal with ties
and zeros, near-traceless, scaled by 1e-20, Cauchy, and the Hessians of a
smoothed vessel volume at sigmas 0.75 and 3.  Each must be exactly 0
wherever the predicate holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arterynetwork_tpu.ops.vesselness import \
    _response_from_hessian as j_response
from arterynetwork_tpu_torch.ops.vesselness import (_hessian_from_smoothed,
                                                    _response_from_hessian)
from tests.test_torch_kernels import _smoothed

N = 400_000


def _traceless(rng):
    h = rng.normal(0, 1, (6, N)).astype(np.float32)
    h[2] = -(h[0] + h[1])               # qm is exactly +0 in f32
    return h


def _hessians(kind):
    """Six f32 arrays (a11, a22, a33, a12, a13, a23)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "gaussian":
        return rng.normal(0, 1, (6, N)).astype(np.float32)
    if kind == "traceless":
        return _traceless(rng)
    if kind == "diagonal_ties":
        h = np.zeros((6, N), np.float32)
        h[:3] = rng.integers(-2, 3, (3, N))
        return h
    if kind == "near_traceless":
        h = _traceless(rng)
        h[:3] += rng.normal(0, 1e-6, (3, N)).astype(np.float32)
        return h
    if kind == "tiny":
        return (rng.normal(0, 1, (6, N)) * 1e-20).astype(np.float32)
    if kind == "cauchy":
        return rng.standard_cauchy((6, N)).astype(np.float32)
    sigma = float(kind.split("_")[1])
    sm = _smoothed((24, 40, 56), sigma, seed=3)
    return np.stack([t.reshape(-1).numpy()
                     for t in _hessian_from_smoothed(sm, sigma)])


def _g(h):
    """The S-max pass's scale weight: half the largest Frobenius norm."""
    h = h.astype(np.float64)
    s2 = (h[:3] ** 2).sum(0) + 2 * (h[3:] ** 2).sum(0)
    return np.float32(0.5 * np.sqrt(s2.max()))


@pytest.mark.parametrize("impl", ["port", "jax"])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("kind", ["gaussian", "traceless", "diagonal_ties",
                                  "near_traceless", "tiny", "cauchy",
                                  "smoothed_0.75", "smoothed_3.0"])
def test_response_is_zero_where_the_kernel_gates(kind, bright, impl):
    h = _hessians(kind)
    qm = ((h[0] + h[1]) + h[2]) * np.float32(1.0 / 3.0)
    assert qm.dtype == np.float32
    gated = qm >= 0 if bright else qm <= 0
    g = _g(h)
    if impl == "port":
        v = _response_from_hessian(tuple(torch.from_numpy(a) for a in h),
                                   0.5, 0.5, torch.tensor(g), bright).numpy()
    else:
        v = np.asarray(j_response(tuple(jnp.asarray(a) for a in h), 0.5, 0.5,
                                  jnp.float32(g), bright))
    assert v.dtype == np.float32 and v.shape == (h.shape[1],)
    assert gated.sum() > 0
    assert np.count_nonzero(v[gated]) == 0
    if kind != "traceless":                    # both sides of the edge
        assert (~gated).sum() > 0
    if kind not in ("traceless", "near_traceless", "tiny"):
        assert np.count_nonzero(v[~gated]) > 0       # the test can fail
