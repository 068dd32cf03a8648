"""Fixtures of the benchmark's CPU tests: a copy of the benchmark folder
beside links to the program, holding tiny cells of its own, so that the
tests add cells the way a later change would: as new files and new
BENCHMARK.json entries."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


TINY_VOLUME = {"shape": [100, 96, 64], "n_branches": 40,
               "root_radius": 4.0, "chunk_z": 48}


def add_cell(tree, cell, config, traffic, limits, spec_config=None):
    """Add one cell to the copy at ``tree``: its configuration file, its
    traffic file, its limits and its BENCHMARK.json entries."""
    b = os.path.join(tree, "benchmark")
    with open(os.path.join(b, "configs", config["name"] + ".json"),
              "w") as f:
        json.dump(config, f)
    name = cell.split(".", 1)[1]
    with open(os.path.join(b, "traffic", name + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(b, "workloads", cell + ".json"), "w") as f:
        json.dump({"limits": limits}, f)
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append(spec_config or {
        "name": config["name"], "source": "tiny copy for the tests",
        "file": f"benchmark/configs/{config['name']}.json", "reduced": [],
        "why": "tests"})
    spec["workloads"].append({"name": cell, "config": config["name"],
                              "traffic": name, "chips": 1, "why": "tests"})
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec


def _limits(cell):
    with open(os.path.join(BENCH, "workloads", cell + ".json")) as f:
        return json.load(f)["limits"]


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    """A checkout-like folder: BENCHMARK.json, a copy of benchmark/, links
    to the program and its native sources, and a tiny cell,
    ``tiny.volumes``, that reports every metric of mra512.volumes."""
    tree = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(BENCH, os.path.join(tree, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tree)
    for name in ("arterynetwork_tpu_torch", "native"):
        os.symlink(os.path.join(REPO, name), os.path.join(tree, name))
    os.makedirs(os.path.join(tree, "build"))
    vol = _config("mra_512")
    vol.update(name="tiny_mra", volume=dict(TINY_VOLUME))
    spec = add_cell(tree, "tiny.volumes", vol,
                    {"driver": "pipeline_volumes", "distinct_volumes": 3,
                     "warm_volumes": 1, "judged_volumes": 2},
                    _limits("mra512.volumes"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        w = m.get("workloads")
        if w is not None and "mra512.volumes" in w:
            w.append("tiny.volumes")
    with open(os.path.join(tree, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return tree
