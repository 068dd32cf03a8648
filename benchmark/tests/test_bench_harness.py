"""The harness: cells, configurations and metrics found by name; the
import guard; the refusals; the traffic generators; the trace's
reduction."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, add_cell

import harness


def _run(tree, *args, device="cpu"):
    cmd = [sys.executable, "benchmark/run.py", *args]
    if device:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                          timeout=600)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_added_cell_config_and_metric_run_by_name(tiny_tree, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and BENCHMARK.json entries run without an edit to any
    file that was there."""
    tree = str(tmp_path / "tree")
    shutil.copytree(tiny_tree, tree, symlinks=True)
    before = {}
    for d, _, files in os.walk(os.path.join(tree, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            before[p] = open(p, "rb").read()
    with open(os.path.join(tree, "benchmark", "configs",
                           "tiny_mra.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_sparse")
    cfg["volume"].update(shape=[96, 88, 64], n_branches=24)
    with open(os.path.join(tree, "benchmark", "workloads",
                           "tiny.volumes.json")) as f:
        limits = json.load(f)["limits"]
    spec = add_cell(tree, "tinysparse.volumes2", cfg,
                    {"driver": "pipeline_volumes", "distinct_volumes": 2,
                     "warm_volumes": 1, "judged_volumes": 1}, limits)
    with open(os.path.join(tree, "benchmark", "metrics",
                           "volumes_done.volumes2.py"), "w") as f:
        f.write("def read(run):\n    return float(run.attempted)\n")
    spec["per_layer"].append({
        "name": "volumes_done.volumes2", "unit": "volumes",
        "better": "higher", "source": "host_clock", "layer": "graph",
        "moves": "volume_s", "workloads": ["tinysparse.volumes2"]})
    for m in spec["end_to_end"]:
        if "tiny.volumes" in m.get("workloads", []):
            m["workloads"].append("tinysparse.volumes2")
    with open(os.path.join(tree, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    cell = harness.load_cell("tinysparse.volumes2",
                             os.path.join(tree, "benchmark"))
    assert cell.config["volume"]["n_branches"] == 24
    assert sorted(m["name"] for m in cell.end_to_end) == [
        "setup_s", "volume_s"]
    r = _result(_run(tree, "--workload", "tinysparse.volumes2", "--seed",
                     "3000000123", "--seconds", "1", "--trace", "1"))
    assert r["correct"] is True
    assert r["metrics"]["volumes_done.volumes2"]["value"] == r["attempted"]
    assert "graph_s" not in r["metrics"]      # listed for other cells
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_volume_cell_end_to_end(tiny_tree):
    r = _result(_run(tiny_tree, "--workload", "tiny.volumes", "--seed",
                     "2200000011", "--seconds", "1", "--trace", "0"))
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"volume_s", "setup_s"}
    assert list(r)[-1] == "compared"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in r


def test_traced_volume_cell_reports_its_layers(tiny_tree):
    proc = _run(tiny_tree, "--workload", "tiny.volumes", "--seed", "5",
                "--seconds", "1", "--trace", "1")
    r = _result(proc)
    assert r["correct"] is True
    # the stage timers; on the CPU no device metric is reported
    assert {"vesselness_upload_s", "skeleton_s", "flow_stage_s"} <= set(
        r["metrics"])
    assert "device_idle_pct.volumes" not in r["metrics"]
    assert "k1_roofline_pct" not in r["metrics"]
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    last = proc.stderr.strip().splitlines()[-len(r["compared"]):]
    assert all(line.startswith("compared ") for line in last)


def test_refuses_without_a_card(tiny_tree):
    proc = _run(tiny_tree, "--workload", "tiny.volumes", "--seed", "1",
                "--seconds", "1", "--trace", "0", device=None)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_refuses_without_the_program(tiny_tree, tmp_path):
    tree = str(tmp_path / "bare")
    os.makedirs(tree)
    shutil.copytree(os.path.join(tiny_tree, "benchmark"),
                    os.path.join(tree, "benchmark"))
    shutil.copy(os.path.join(tiny_tree, "BENCHMARK.json"), tree)
    proc = _run(tree, "--workload", "tiny.volumes", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["jax.numpy", "arterynetwork_tpu_torch.flow", "jaxlib",
         "arterynetwork_tpu.ops.native", "flax.linen", "jaxtyping",
         "arterynetwork_tpu_torch", "numpy"]) == [
        "arterynetwork_tpu.ops.native", "flax.linen", "jax.numpy",
        "jaxlib"]
    assert harness.forbidden_modules(["arterynetwork_tpu_torch.flow"]) == []


def test_run_fails_when_jax_was_loaded(tiny_tree, monkeypatch, capsys):
    import types

    import run

    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "tiny.volumes", "--seed", "3", "--seconds",
                  "0.5", "--trace", "0", "--device", "cpu"],
                 base=os.path.join(tiny_tree, "benchmark"))
    assert exc.value.code != 0
    assert "jax.numpy" in capsys.readouterr().err


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*dirs):
    for d in dirs:
        for dp, _, files in os.walk(os.path.join(BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dp, f)


def test_no_module_of_the_benchmark_imports_jax():
    files = list(_sources("drivers", "metrics", "reference", "frozen"))
    files += [os.path.join(BENCH, f) for f in os.listdir(BENCH)
              if f.endswith(".py")]
    for path in files:
        assert not harness.forbidden_modules(_imports(path)), path


def test_reference_and_frozen_copies_import_nothing_of_the_program():
    for path in _sources("reference", "frozen"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"arterynetwork_tpu_torch", "arterynetwork_tpu",
                           "jax", "drivers", "harness"}, path


def test_phantoms_repeat_per_seed_and_differ_across_seeds():
    from frozen.phantom import phantom_volume

    shape = (40, 48, 32)
    a = phantom_volume(shape, [1], [9, 1], "cpu", n_branches=8,
                       root_radius=3.0)
    b = phantom_volume(shape, [1], [9, 1], "cpu", n_branches=8,
                       root_radius=3.0)
    c = phantom_volume(shape, [1], [10, 1], "cpu", n_branches=8,
                       root_radius=3.0)
    d = phantom_volume(shape, [2], [9, 1], "cpu", n_branches=8,
                       root_radius=3.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])       # the noise is the seed's
    assert np.array_equal(a[1], c[1])           # the patient's tree is not
    assert not np.array_equal(a[1], d[1])
    assert 0.001 < a[1].mean() < 0.2


def test_volume_traffic_serves_the_same_patients_in_another_order():
    from drivers import pipeline_volumes as pv

    cfg = {"volume": {"shape": [40, 48, 32], "n_branches": 8,
                      "root_radius": 3.0}}
    tr = {"distinct_volumes": 5}
    a = pv.make_volumes(cfg, tr, 3000000001, "cpu")
    b = pv.make_volumes(cfg, tr, 3000000001, "cpu")
    c = pv.make_volumes(cfg, tr, 3000000002, "cpu")
    assert [v["patient"] for v in a] == [v["patient"] for v in b]
    assert all(np.array_equal(x["raw"], y["raw"]) for x, y in zip(a, b))
    assert sorted(v["patient"] for v in a) == sorted(
        v["patient"] for v in c) == list(range(5))
    assert not all(np.array_equal(x["raw"], y["raw"]) for x, y in zip(a, c))


def test_reduce_trace_busy_idle_and_labels():
    ev = [("bench.window", False, 0, 1000), ("aten::add", False, 160, 130),
          ("bench.volume", False, 0, 1000),
          ("k1", True, 0, 100), ("k1", True, 50, 100), ("k2", True, 500, 100),
          ("k2", True, 2000, 10)]
    spans = [("a", 0, 300), ("b", 300, 700), ("c", 700, 1000)]
    t = harness.reduce_trace(ev, "bench.window", spans)
    assert t["busy_s"] == pytest.approx(250e-9)
    assert t["window_s"] == pytest.approx(1000e-9)
    assert t["kernels"]["k1"] == (2, pytest.approx(200e-9))
    assert dict(t["idle_gaps"]) == pytest.approx({
        "a: aten::add": 150e-9, "b: host outside torch ops": 300e-9,
        "c: host outside torch ops": 300e-9})
    assert harness.reduce_trace(ev, "no.window") is None


def test_percentile_is_linear_between_ranks():
    assert harness.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert harness.percentile([], 95) is None
