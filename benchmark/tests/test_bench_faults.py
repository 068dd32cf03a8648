"""The comparison that decides ``correct`` fails what it must: the
control (the reference one precision below the configuration's, in the
program's place) and the faults a cell can have, each planted in the
program underneath a run that skips the look for a card.

The cells run on one card, so no fault of the exchange between cards
applies."""

import json
import os

import numpy as np
import pytest

import faults
import harness


def _main(tree, cell, capsys, seed=3100000101):
    import run

    run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
              "--trace", "0", "--device", "cpu"],
             base=os.path.join(tree, "benchmark"))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _failing(r):
    return sorted(k for k, c in r["compared"].items()
                  if not c["value"] <= c["limit"])


def test_sound_runs_are_correct(tiny_tree, capsys):
    r = _main(tiny_tree, "tiny.volumes", capsys)
    assert r["correct"] is True, r["compared"]


def _state(tree, cell, seed):
    c = harness.load_cell(cell, os.path.join(tree, "benchmark"))
    driver = c.driver()
    state = driver.setup(c.config, c.traffic, seed, "cpu")
    for i in range(len(state["volumes"])):
        driver.request(state, i)
    driver.release(state)
    return c, driver, state


@pytest.mark.parametrize("seed", [3100000121, 3100000122, 3100000123])
def test_control_fails_the_volumes(tiny_tree, seed):
    import readings

    c, driver, state = _state(tiny_tree, "tiny.volumes", seed)
    _, info = driver.judge(state, seed, "cpu")
    prog, ctrl = readings.control_volume(state, info["judged"], "cpu")
    lim = c.limits["limits"]
    assert all(prog[k] <= lim[k] for k in prog)
    failed = {k for k in ctrl if ctrl[k] > lim[k]}
    assert {"mask_mismatch", "radius_gap", "pressure_gap",
            "flow_gap"} <= failed


def test_volume_step_that_keeps_its_state(tiny_tree, capsys, monkeypatch):
    from arterynetwork_tpu_torch.flow import solvers

    solve = solvers.solve_pressure_newton
    monkeypatch.setattr(solvers, "solve_pressure_newton",
                        lambda s, *a, **kw: solve(s, *a,
                                                  **dict(kw, max_iter=0)))
    r = _main(tiny_tree, "tiny.volumes", capsys)
    assert r["correct"] is False and "pressure_gap" in _failing(r)


def test_volume_answer_altered(tiny_tree, capsys, monkeypatch):
    from arterynetwork_tpu_torch import pipeline

    make = pipeline.generate_vessel_mask

    def altered(*a, **kw):
        mask = make(*a, **kw)
        idx = np.flatnonzero(mask)
        mask.reshape(-1)[idx[::50]] = 0      # 2% of the vessel voxels
        return mask

    monkeypatch.setattr(pipeline, "generate_vessel_mask", altered)
    r = _main(tiny_tree, "tiny.volumes", capsys)
    assert r["correct"] is False and "mask_mismatch" in _failing(r)


def test_volume_thinning_that_stops_early(tiny_tree, capsys, monkeypatch):
    faults.thinning_stops_early(monkeypatch.setattr)
    r = _main(tiny_tree, "tiny.volumes", capsys)
    assert r["correct"] is False and "skeleton_removable" in _failing(r)


def test_volume_branch_dropped(tiny_tree, monkeypatch):
    """Every patient served and judged: which ones a one-second window
    serves depends on the CPU's speed, and at this size one patient's
    longest free-end branch is short enough to pass for a spur."""
    import readings

    faults.dropped_branch(monkeypatch.setattr)
    c, _, state = _state(tiny_tree, "tiny.volumes", 3100000131)
    worst, info = readings.judge_all(state, "cpu")
    assert len(info["judged"]) == 3
    assert worst["uncovered_reach"] > c.limits["limits"]["uncovered_reach"]


def test_volume_boundary_pressures_split_by_count(tiny_tree, capsys,
                                                 monkeypatch):
    faults.boundary_split_by_count(monkeypatch.setattr)
    r = _main(tiny_tree, "tiny.volumes", capsys)
    assert r["correct"] is False and "pressure_gap" in _failing(r)
