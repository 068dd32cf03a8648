"""The port's utilities against the JAX package's, on the CPU.

Copies of numpy modules (io/stitch.py, utils/reference_protocol.py,
utils/reference_region_grow.py, utils/hostmem.py) are held to the JAX
package's on the same inputs: stitch exactly (tests/test_stitch.py's
four cases), the reference objective exactly, ``reference_protocol_solve``
within 1e-12 relative on a small f64 tree, the reference grower exactly
and equal to the port's grower's fixed point.  The torch utilities
(profiling, debug) are held to JAX's tests of theirs, where no JAX call
computes the same thing.
"""

import os

import numpy as np
import pytest
import torch

from arterynetwork_tpu.io import stitch as J_stitch
from arterynetwork_tpu.utils import check_finite as j_check_finite
from arterynetwork_tpu.utils import reference_protocol as J_rp
from arterynetwork_tpu.utils.reference_region_grow import \
    reference_region_grow as j_reference_region_grow
from arterynetwork_tpu_torch.io import stitch as T_stitch
from arterynetwork_tpu_torch.utils import (StageTimer,
                                           assert_solution_valid,
                                           check_finite, device_sync,
                                           device_trace, enable_nan_checks)
from arterynetwork_tpu_torch.utils import reference_protocol as T_rp
from arterynetwork_tpu_torch.utils.reference_region_grow import \
    reference_region_grow

torch.set_num_threads(1)


# --- io/stitch.py --------------------------------------------------------

def test_get_boundary_matches_jax():
    rng = np.random.default_rng(0)
    vol = (rng.random((6, 7, 8)) > 0.7).astype(np.uint8)
    vol[:, 2, :] = 0  # all-zero lines exercise the argmax==0 convention
    for axis in range(3):
        for flip in (False, True):
            np.testing.assert_array_equal(
                T_stitch.get_boundary(vol, axis, flip),
                J_stitch.get_boundary(vol, axis, flip))


def test_merge_volume_axis0_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 5, (6, 5, 4))
    b = rng.integers(0, 5, (6, 5, 4))
    lower = rng.integers(0, 3, (5, 4))
    upper = lower + rng.integers(0, 3, (5, 4))
    dst_t, dst_j = b.copy(), b.copy()
    idx_t = T_stitch.merge_volume(a, dst_t, lower, upper, axis=0)
    idx_j = J_stitch.merge_volume(a, dst_j, lower, upper, axis=0)
    np.testing.assert_array_equal(dst_t, dst_j)
    np.testing.assert_array_equal(idx_t, idx_j)
    assert idx_t.flags.writeable


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_merge_volume_scalar_bounds_matches_jax(axis):
    a = np.ones((4, 4, 4), int)
    dst_t, dst_j = np.zeros((4, 4, 4), int), np.zeros((4, 4, 4), int)
    T_stitch.merge_volume(a, dst_t, 1, 2, axis=axis)
    J_stitch.merge_volume(a, dst_j, 1, 2, axis=axis)
    np.testing.assert_array_equal(dst_t, dst_j)


def test_stitch_scans_matches_jax():
    a = np.zeros((3, 3, 10), int)
    b = np.zeros((3, 3, 10), int)
    a[..., :7] = 1
    b[..., 4:] = 2
    a[1, 1] = 0                          # an empty line keeps scan b
    merged = T_stitch.stitch_scans(a, b, axis=2)
    np.testing.assert_array_equal(merged, J_stitch.stitch_scans(a, b, axis=2))
    assert (merged[0, 0, :7] == 1).all() and (merged[0, 0, 7:] == 2).all()
    np.testing.assert_array_equal(merged[1, 1], b[1, 1])


# --- utils/profiling.py ----------------------------------------------------

def test_stage_timer():
    t = StageTimer()
    x = torch.ones(3)
    with t.stage("a"):
        pass
    with t.stage("a", sync_on={"x": [x]}):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2
    assert rep["a"]["seconds"] >= 0
    assert device_sync(x) is x


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    assert len(prof.key_averages()) > 0


# --- utils/debug.py ----------------------------------------------------

def test_check_finite_raises_with_context():
    bad = np.array([1.0, np.nan, 2.0])
    with pytest.raises(FloatingPointError, match="pressure") as t_err:
        check_finite(torch.tensor(bad), "pressure")
    with pytest.raises(FloatingPointError) as j_err:
        j_check_finite(bad, "pressure")
    assert str(t_err.value) == str(j_err.value)
    # nested structures: the leaf index is counted as JAX counts leaves
    tree = {"a": torch.ones(2), "b": [np.ones(2), torch.tensor([np.inf])]}
    with pytest.raises(FloatingPointError, match="leaf 2"):
        check_finite(tree, "tree")
    with pytest.raises(FloatingPointError, match="leaf 2"):
        j_check_finite({"a": np.ones(2), "b": [np.ones(2),
                                               np.array([np.inf])]}, "t")
    assert check_finite(torch.ones(3), "ok") is not None
    check_finite(torch.arange(3), "ints are skipped")


def test_assert_solution_valid():
    from arterynetwork_tpu_torch.flow.solvers import FlowSolution

    good = FlowSolution(pressure=torch.ones(4), flow=torch.ones(3),
                        velocity=torch.ones(3),
                        residual_norm=torch.tensor(1e-12), iterations=3)
    assert assert_solution_valid(good) is good
    bad = good._replace(residual_norm=torch.tensor(1e-3))
    with pytest.raises(ValueError, match="did not converge"):
        assert_solution_valid(bad)
    batch = good._replace(residual_norm=torch.tensor([1e-12, 1e-3]),
                          iterations=torch.tensor([3, 60]))
    with pytest.raises(ValueError, match=r"\(60 iterations\)"):
        assert_solution_valid(batch)
    nan = good._replace(flow=torch.tensor([1.0, float("nan"), 1.0]))
    with pytest.raises(FloatingPointError, match="flow solution"):
        assert_solution_valid(nan)


def test_enable_nan_checks():
    was = torch.is_anomaly_enabled()
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        # the error names the backward function and the warning carries
        # the traceback of the forward call that made it
        with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"), \
                pytest.warns(UserWarning, match="forward call"):
            (torch.sqrt(x) * 0.0).sum().backward()
        enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


# --- utils/hostmem.py ----------------------------------------------------

def test_configure_host_allocator_idempotent():
    from arterynetwork_tpu.utils import hostmem as J_hm
    from arterynetwork_tpu_torch.utils import hostmem as T_hm

    first = T_hm.configure_host_allocator()
    assert T_hm.configure_host_allocator() == first
    assert first == J_hm.configure_host_allocator()


# --- utils/reference_protocol.py -------------------------------------------

def _trees(depth, seed):
    from arterynetwork_tpu.graphs import generate_tree as j_tree
    from arterynetwork_tpu.graphs import \
        set_network_properties as j_props
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    def make(gen, props):
        rng = np.random.default_rng(seed)
        return props(gen(max_depth=depth, rng=rng), k_value=1.852, rng=rng)

    return make(generate_tree, set_network_properties), make(j_tree, j_props)


def test_reference_objective_matches_jax():
    net_t, net_j = _trees(5, 0)
    rng = np.random.default_rng(3)
    bp = rng.uniform(8000.0, 12000.0, net_t.num_nodes)
    eq_t, fixed_t, idx_t = T_rp.build_equation_dicts(net_t, bp)
    eq_j, fixed_j, idx_j = J_rp.build_equation_dicts(net_j, bp)
    assert eq_t == eq_j
    np.testing.assert_array_equal(fixed_t, fixed_j)
    x = rng.uniform(0.1, 1.0, idx_t["num_unknowns"])
    np.testing.assert_array_equal(T_rp.reference_objective(eq_t)(x),
                                  J_rp.reference_objective(eq_j)(x))
    p = rng.uniform(8000.0, 12000.0, net_t.num_nodes)
    o_t, rev_t = T_rp.orient_by_flow(net_t, p)
    o_j, rev_j = J_rp.orient_by_flow(net_j, p)
    np.testing.assert_array_equal(rev_t, rev_j)
    np.testing.assert_array_equal(o_t.heads, o_j.heads)


def test_reference_protocol_solve_matches_jax():
    """scipy least_squares on the reference objective, f64, on a depth-3
    tree with the ground truth's boundary pressures: the port's copy and
    the JAX package's within 1e-12 relative, and the cross-check of the
    port's Newton solution scored alike."""
    from arterynetwork_tpu_torch.flow import (build_system,
                                              create_ground_truth)
    from arterynetwork_tpu_torch.flow.solvers import solve_pressure_newton

    net_t, net_j = _trees(3, 1)
    gt = create_ground_truth(net_t, option=2, rng=np.random.default_rng(1))
    assert gt.success
    out_t = T_rp.reference_protocol_solve(net_t, gt.pressure)
    out_j = J_rp.reference_protocol_solve(net_j, gt.pressure)
    for key in ("x", "pressure", "flow"):
        ref = np.asarray(out_j[key])
        assert np.max(np.abs(out_t[key] - ref)) <= 1e-12 * np.max(
            np.abs(ref)), key
    assert abs(out_t["cost"] - out_j["cost"]) <= 1e-12 * max(
        abs(out_j["cost"]), 1e-300)
    sol = solve_pressure_newton(build_system(
        net_t, boundary_pressure=gt.pressure, dtype=torch.float64,
        device="cpu"))
    p, v = sol.pressure.numpy(), sol.velocity.numpy()
    chk_t = T_rp.cross_check_solution(net_t, gt.pressure, p, v,
                                      warm_start=False)
    chk_j = J_rp.cross_check_solution(net_j, gt.pressure, p, v,
                                      warm_start=False)
    assert chk_t == chk_j
    assert chk_t["cost_at_solution"] < 1e-6 * chk_t["cost_at_reference_init"]


# --- utils/reference_region_grow.py ----------------------------------------

def test_reference_region_grow_matches_jax_and_the_port():
    """The boundary-list reference grower: the port's copy equals the JAX
    package's (mask, iterations, boundary evaluations) and the port's
    full-grid grower reaches the same fixed point."""
    from arterynetwork_tpu_torch.ops.region_grow import region_grow

    rng = np.random.default_rng(5)
    vol = np.zeros((16, 16, 32), np.float32)
    vol[6:9, 6:9, 4:28] = 1.0
    vol += rng.normal(0, 0.01, vol.shape).astype(np.float32)
    seed = np.zeros(vol.shape, bool)
    seed[7, 7, 14:18] = True
    seg, it, evals = reference_region_grow(vol, seed)
    seg_j, it_j, evals_j = j_reference_region_grow(vol, seed)
    np.testing.assert_array_equal(seg, seg_j)
    assert (it, evals) == (it_j, evals_j)
    out = region_grow(vol, seed, num_bins=1024, backend="xla",
                      device="cpu")
    np.testing.assert_array_equal(out.segmented_map.numpy(), seg)
