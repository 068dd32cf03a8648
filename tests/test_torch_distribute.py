"""The flow-distribution optimizer of the PyTorch port against the JAX
package, on the CPU (f64, depth 4-6 trees).

Tolerances, with the values measured on a CPU in brackets:
  * the assembled system: equal to the JAX one carried across;
  * residuals of a random theta: <= 1e-12 relative [1e-15];
  * the Jacobian (``torch.func.jacfwd`` against ``jax.jacfwd``): <= 1e-10
    relative [3e-15];
  * ``distribute_flow`` after 40 Gauss-Newton steps: fractions within
    1e-12 absolute [2.6e-14 at depth 10], the RMS mismatch and the edge
    flows within 1e-12 relative [6e-16, 7e-15]; both run every step
    (``tol_mmhg`` is unused, as in the JAX package).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arterynetwork_tpu.flow import distribute as jd
from arterynetwork_tpu.graphs import generate_tree, set_network_properties
from arterynetwork_tpu_torch import convert
from arterynetwork_tpu_torch.flow import distribute as pd
from arterynetwork_tpu_torch.graphs import generate_tree as pgenerate_tree

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _net(depth, seed=0):
    rng = np.random.default_rng(seed)
    return set_network_properties(generate_tree(max_depth=depth, rng=rng),
                                  rng=rng)


@pytest.mark.parametrize("depth", [4, 6])
def test_system_and_residuals_match_jax(depth):
    net = _net(depth)
    sys_j = jd.build_distribute_system(net, inlet_flow=1e-5,
                                       inlet_pressure=13000.0,
                                       desired_terminating_pressure=9000.0)
    sys_t = pd.build_distribute_system(net, inlet_flow=1e-5,
                                       inlet_pressure=13000.0,
                                       desired_terminating_pressure=9000.0,
                                       device="cpu")
    ref = convert.distribute_system(sys_j, "cpu")
    for f in pd.DistributeSystem._fields:
        a, b = getattr(sys_t, f), getattr(ref, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    assert sys_t.dp_coeff.dtype == torch.float64
    theta = np.random.default_rng(1).normal(0.0, 0.3, net.num_edges)
    r_j = np.asarray(jd.residuals(jnp.asarray(theta), sys_j))
    r_t = pd.residuals(torch.tensor(theta), sys_t).numpy()
    assert _rel(r_t, r_j) <= 1e-12
    for a, b in zip(pd.propagate(torch.tensor(theta), sys_t),
                    jd.propagate(jnp.asarray(theta), sys_j)):
        assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("depth", [4, 6])
def test_jacobian_matches_jax(depth):
    net = _net(depth, seed=2)
    sys_j = jd.build_distribute_system(net, 1e-5, 13000.0)
    sys_t = pd.build_distribute_system(net, 1e-5, 13000.0, device="cpu")
    theta = np.random.default_rng(3).normal(0.0, 0.5, net.num_edges)
    jac_j = np.asarray(jax.jacfwd(lambda th: jd.residuals(th, sys_j))(
        jnp.asarray(theta)))
    jac_t = torch.func.jacfwd(lambda th: pd.residuals(th, sys_t))(
        torch.tensor(theta)).numpy()
    assert jac_t.shape == jac_j.shape == (
        int(sys_j.terminal_nodes.shape[0]) + net.num_edges, net.num_edges)
    assert _rel(jac_t, jac_j) <= 1e-10


@pytest.mark.parametrize("depth", [4, 6])
def test_distribute_flow_study_matches_jax(depth):
    net = _net(depth)
    ref = jd.distribute_flow_study(net)
    out = pd.distribute_flow_study(net, device="cpu")
    assert np.max(np.abs(out["fractions"] - ref["fractions"])) <= 1e-12
    assert abs(out["rms_mismatch_mmhg"] - ref["rms_mismatch_mmhg"]) \
        <= 1e-12 * ref["rms_mismatch_mmhg"]
    assert _rel(out["edge_flow"], ref["edge_flow"]) <= 1e-12
    assert _rel(out["terminal_pressure_mmhg"],
                ref["terminal_pressure_mmhg"]) <= 1e-12
    assert np.array_equal(out["desired_pressure_mmhg"],
                          ref["desired_pressure_mmhg"])
    assert int(out["result"].iterations) == int(ref["result"].iterations)
    # sibling fractions sum to one at every branching node
    heads = out["system"].heads.numpy()
    sums = np.bincount(heads, weights=out["fractions"])
    assert np.allclose(sums[np.unique(heads)], 1.0, atol=1e-12)


def test_distribute_from_state_and_init_theta():
    """The inlet boundary read from a solved network's state, and a warm
    start: both packages agree."""
    from arterynetwork_tpu.flow import create_ground_truth

    net = _net(5)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(1))
    net = net.replace(node_pressure=gt.pressure, edge_flow=gt.flow)
    ref = jd.distribute_flow_study(net, max_iter=12)
    out = pd.distribute_flow_study(net, max_iter=12, device="cpu")
    assert _rel(out["edge_flow"], ref["edge_flow"]) <= 1e-12
    theta0 = np.random.default_rng(4).normal(0.0, 0.1, net.num_edges)
    sys_j = jd.build_distribute_system(net, 1e-5, 13000.0)
    sys_t = pd.build_distribute_system(net, 1e-5, 13000.0, device="cpu")
    a = jd.distribute_flow(sys_j, max_iter=5, init_theta=theta0)
    b = pd.distribute_flow(sys_t, max_iter=5, init_theta=theta0)
    assert _rel(b.theta.numpy(), a.theta) <= 1e-12
    assert _rel(b.node_pressure.numpy(), a.node_pressure) <= 1e-12


def test_rejects_cross_edges():
    """A network with an edge between equal depths (a merge loop made
    flat) is out of the level sweep's scope in both packages."""
    net = pgenerate_tree(max_depth=4, rng=np.random.default_rng(0))
    depth = net.node_depth.copy()
    depth[net.tails[-1]] = depth[net.heads[-1]]
    bad = net.replace(node_depth=depth)
    with pytest.raises(ValueError):
        pd.build_distribute_system(bad, 1e-5, 13000.0, device="cpu")
    with pytest.raises(ValueError):
        jd.build_distribute_system(bad, 1e-5, 13000.0)
