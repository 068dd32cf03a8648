"""The plain references agree with the program's CPU path at small
sizes, and their checks of the skeleton and the branches read what they
should on shapes whose answers are known."""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi

from conftest import BENCH
from frozen.phantom import phantom_volume
from reference import frangi, judge_volume, network, structure

with open(os.path.join(BENCH, "workloads", "mra512.volumes.json")) as f:
    LIMITS = json.load(f)["limits"]
SIGMAS = (0.75, 1.0, 2.0, 3.0)
SETTINGS = {"sigmas": SIGMAS, "bits": 4, "upload_skip": True, "chunk_z": 48,
            "weak_threshold_fraction": 0.03,
            "global_threshold_fraction": 0.3, "border_margin_voxels": 6,
            "min_component_size": 50, "prune_min_length": 4,
            "prune_radius_factor": 2.5, "spacing": 0.0004,
            "inlet_pressure": 15946.56, "inlet_flow": 1.2566666666666666e-05}


def _pipeline(shape, patient, seed):
    from arterynetwork_tpu_torch.config import PipelineConfig
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    cfg = PipelineConfig()
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.linear_solver = "auto"
    raw, _, _ = phantom_volume(shape, [patient], [seed, patient], "cpu",
                               n_branches=40, root_radius=4.0)
    return raw, run_pipeline(raw_volume=raw, config=cfg, device="cpu")


@pytest.mark.parametrize("patient", [1, 2])
def test_reference_network_and_sweep_match_the_program(patient):
    from arterynetwork_tpu_torch.flow.ground_truth import \
        create_ground_truth

    raw, r = _pipeline((100, 96, 64), patient, 3100000201)
    net, segs = r["network"], r["segments"]
    mine = network.build(segs, network.inlet(segs))
    assert np.array_equal(mine["coord"], net.node_coord)
    assert np.array_equal(mine["depth"], net.node_depth)
    assert np.array_equal(mine["heads"], net.heads)
    assert np.array_equal(mine["tails"], net.tails)
    assert np.array_equal(mine["segment"], net.edge_segment_index)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(0))
    sp = net.spacing
    bp = network.ground_truth(mine, net.radius, net.radius * sp,
                              net.length * sp, SETTINGS["inlet_pressure"],
                              SETTINGS["inlet_flow"])
    assert gt.success
    assert np.allclose(bp, gt.pressure, rtol=1e-12, atol=0)


@pytest.mark.parametrize("patient", [1, 2])
def test_pipeline_outputs_pass_the_structure_checks(patient):
    raw, r = _pipeline((100, 96, 64), patient, 3100000202)
    out = {"mask": r["mask"], "skeleton": r["skeleton"],
           "segments": r["segments"]}
    dist_of = judge_volume.distances(out, "cpu")
    nums = judge_volume.structure_numbers(out, SETTINGS, dist_of, "cpu")
    assert nums["skeleton_removable"] == 0
    assert nums["skeleton_euler_gap"] == 0
    assert nums["branch_off_skeleton"] == 0
    assert nums["branch_components_gap"] == 0
    assert 0 <= nums["uncovered_reach"] <= LIMITS["uncovered_reach"]
    assert structure.removable(r["mask"]) > 0


def test_simple_point_test_matches_the_programs_oracle():
    from arterynetwork_tpu_torch.ops.native import simple_point_native

    rng = np.random.default_rng(5)
    codes = np.concatenate([
        rng.integers(0, 1 << 26, 3000),
        # sparse and dense neighbourhoods, where the answers vary most
        [int(sum(1 << int(k) for k in rng.choice(26, n, replace=False)))
         for n in rng.integers(1, 6, 1500)],
        [int(((1 << 26) - 1) ^ sum(1 << int(k) for k in
                                   rng.choice(26, n, replace=False)))
         for n in rng.integers(1, 6, 1500)]])
    nb = np.zeros((len(codes), 27), bool)
    nb[:, structure.CENTRE] = True
    for k, pos in enumerate(structure.N26):
        nb[:, pos] = (codes >> k) & 1
    want = np.asarray([simple_point_native(int(c)) for c in codes])
    got = structure.simple(nb)
    assert 0.05 < want.mean() < 0.95
    assert np.array_equal(got, want)


def _ball(shape, centre, r):
    g = np.indices(shape)
    return ((g - np.asarray(centre)[:, None, None, None]) ** 2).sum(0) <= r * r


def test_euler_characteristic_of_known_shapes():
    cube = np.zeros((9, 9, 9), bool)
    cube[2:7, 2:7, 2:7] = True
    shell = cube.copy()
    shell[3:6, 3:6, 3:6] = False
    ring = cube.copy()
    ring[2:7, 4, 4] = False
    two = np.zeros((9, 9, 9), bool)
    two[1, 1, 1] = two[5, 5, 5] = True
    assert [structure.euler(v) for v in (cube, shell, ring, two)] == [
        1, 2, 0, 2]


def test_deleting_simple_points_keeps_the_topology():
    rng = np.random.default_rng(8)
    vol = ndi.binary_dilation(rng.random((20, 20, 20)) < 0.03,
                              iterations=2)
    vol = np.pad(vol[2:-2, 2:-2, 2:-2], 2)
    chi = structure.euler(vol)
    comps = judge_volume.volume_ref.components(vol)
    pts = np.argwhere(vol)
    for p in pts[rng.permutation(len(pts))[:400]]:
        nb = structure.neighbourhoods(vol, p[None])
        if structure.simple(nb)[0]:
            vol[tuple(p)] = False
    assert structure.euler(vol) == chi
    assert judge_volume.volume_ref.components(vol) == comps


def _skeleton(dist=1.0):
    """A 40-voxel line with a 12-voxel side branch at voxel 20."""
    s = np.zeros((50, 30, 10), bool)
    s[5:45, 10, 5] = True
    s[25, 11:23, 5] = True
    dist_of = {tuple(p): dist for p in np.argwhere(s).tolist()}
    return s, dist_of


def test_coverage_reads_a_dropped_branch_by_its_length():
    s, dist_of = _skeleton()
    sk = structure.Skeleton(s, dist_of)
    line = [(z, 10, 5) for z in range(5, 45)]
    side = [(25, 10, 5)] + [(25, y, 5) for y in range(11, 23)]
    both = [sk.index(np.asarray(b)) for b in (line[:21], line[20:], side)]
    assert all((p >= 0).all() for p in both)
    assert structure.coverage(sk, np.concatenate(both), 4, 2.5) == 0.0
    assert structure.branch_components(sk, both) == 0
    # the side branch dropped: 12 steps over max(4, 2.5 x 1)
    assert structure.coverage(sk, np.concatenate(both[:2]), 4, 2.5) == 3.0
    # the line's far half dropped too: one piece, as the skeleton
    assert structure.branch_components(sk, both[:1]) == 0
    # the line cut between its halves: two pieces of one component
    cut = [both[0][:-1], both[1][1:]]
    assert structure.branch_components(sk, cut) == 1


def test_reference_vesselness_and_mask_match_the_program():
    from arterynetwork_tpu_torch.ops.vesselness import \
        frangi_vesselness_streamed

    for shape, patient in (((100, 96, 64), 1), ((96, 80, 64), 2)):
        raw, _, _ = phantom_volume(shape, [patient], [5, patient], "cpu",
                                   n_branches=40, root_radius=4.0)
        v, _, _ = frangi_vesselness_streamed(raw, sigmas=SIGMAS, bits=4,
                                             skip_background=True,
                                             device="cpu")
        ref = frangi.vesselness(raw, SIGMAS, bits=4, skip=True)
        assert float((v.double() - ref).abs().max()) < 1e-3
        prog = judge_volume.volume_ref.hysteresis_mask(
            v.double(), 0.03, 0.3, 6, 50)
        mine = judge_volume.reference_mask(raw, SETTINGS, "cpu")
        assert np.count_nonzero(prog != mine) <= 1e-3 * mine.sum()


def test_reference_edt_is_exact():
    import scipy.ndimage as ndi

    rng = np.random.default_rng(0)
    m = ndi.binary_dilation(rng.random((30, 30, 30)) < 0.02, iterations=2)
    m[:2] = m[-2:] = False
    m[:, :2] = m[:, -2:] = False
    m[:, :, :2] = m[:, :, -2:] = False
    pts = np.argwhere(m)
    d = judge_volume.volume_ref.edt_at(m, pts, "cpu")
    assert np.allclose(d, ndi.distance_transform_edt(m)[tuple(pts.T)])
