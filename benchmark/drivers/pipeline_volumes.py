"""Driver of the volume cells: raw MRA volumes through
``arterynetwork_tpu_torch.pipeline.run_pipeline``, one after another.

Reads from the configuration: ``volume`` (shape, branches, root radius)
and ``pipeline`` (PipelineConfig's fields by section).  Reads from the
traffic mix: ``distinct_volumes`` (the patients, made in set-up and
cycled: patient i's vessel tree is the same for every seed, so every
seed serves the same work; the seed draws each volume's noise and the
order of the cycle), ``warm_volumes`` (the last ones of the cycle, run
once in set-up) and ``judged_volumes`` (how many patients the reference
judges after the window, drawn from the seed).
"""

from __future__ import annotations

import time

import numpy as np

SPAN = "bench.volume"
# the pipeline's stage timers, in the order the stages run
STAGES = ("vesselness_upload", "vesselness_compute", "segmentation", "edt",
          "skeletonization", "graph", "flow")


def pipeline_config(config):
    from arterynetwork_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    for section, values in config["pipeline"].items():
        sub = getattr(cfg, section)
        for key, value in values.items():
            if not hasattr(sub, key):
                raise KeyError(f"PipelineConfig.{section} has no {key}")
            setattr(sub, key, tuple(value) if isinstance(value, list)
                    else value)
    return cfg


def reference_settings(config):
    """What the reference needs of the configuration."""
    p = config["pipeline"]
    bits = {"bq2": 2, "bq3": 3, "bq4": 4}[p["vesselness"]["upload_format"]]
    return {"sigmas": tuple(p["vesselness"]["sigmas"]), "bits": bits,
            "upload_skip": p["vesselness"].get("upload_skip", True),
            "chunk_z": config["volume"].get("chunk_z", 48),
            **{k: p["segmentation"][k] for k in
               ("weak_threshold_fraction", "global_threshold_fraction",
                "border_margin_voxels", "min_component_size")},
            **{k: p["skeleton"][k] for k in
               ("prune_min_length", "prune_radius_factor")},
            **{k: p["flow"][k] for k in
               ("spacing", "inlet_pressure", "inlet_flow")}}


def make_volumes(config, traffic, seed, device):
    from frozen.phantom import phantom_volume

    v = config["volume"]
    n = int(traffic["distinct_volumes"])
    order = np.random.default_rng([int(seed), 1]).permutation(n)
    out = []
    for patient in order.tolist():
        raw, _, _ = phantom_volume(
            tuple(v["shape"]), [patient], [int(seed), patient], device,
            n_branches=int(v["n_branches"]),
            root_radius=float(v["root_radius"]))
        out.append({"raw": raw, "patient": patient})
    return out


def setup(config, traffic, seed, device="cuda"):
    t0 = time.perf_counter()
    state = {"config": config, "traffic": traffic, "device": device,
             "cfg": pipeline_config(config),
             "volumes": make_volumes(config, traffic, seed, device),
             "outputs": {}, "timings": []}
    t1 = time.perf_counter()
    n = len(state["volumes"])
    for j in range(n - int(traffic.get("warm_volumes", 1)), n):
        serve(state, j)
    state["outputs"].clear()
    state["setup_parts"] = {"inputs_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}
    return state


def serve(state, j):
    from arterynetwork_tpu_torch.pipeline import run_pipeline

    return run_pipeline(raw_volume=state["volumes"][j]["raw"],
                        config=state["cfg"], device=state["device"])


def request(state, i):
    j = i % len(state["volumes"])
    r = serve(state, j)
    net = r["network"]
    state["outputs"][j] = {
        "mask": r["mask"], "skeleton": r["skeleton"],
        "segments": r["segments"],
        "network": {"heads": net.heads, "tails": net.tails,
                    "node_coord": net.node_coord,
                    "edge_segment_index": net.edge_segment_index,
                    "radius": net.radius, "length": net.length,
                    "entry_nodes": net.entry_nodes, "spacing": net.spacing,
                    "node_pressure": net.node_pressure,
                    "edge_flow": net.edge_flow}}
    state["timings"].append(dict(r["timings"]))


def readings(state):
    """The driver's per-layer readings of the window."""
    return {"timings": state["timings"],
            "volume_shape": tuple(state["config"]["volume"]["shape"]),
            "sigmas": tuple(state["config"]["pipeline"]["vesselness"]
                            ["sigmas"]),
            "chunk_z": state["config"]["volume"].get("chunk_z", 48)}


def stage_spans(state):
    """Per request, its stages in order as (label, seconds)."""
    return [[(s, t.get(s, 0.0)) for s in STAGES] for t in state["timings"]]


def release(state):
    """Drop the program's state, its caches of solves and of loops
    included, before the reference runs."""
    from arterynetwork_tpu_torch.flow.solvers import clear_solve_cache
    from arterynetwork_tpu_torch.ops.grow_loop import clear_loop_caches

    state.pop("cfg", None)
    clear_solve_cache()
    clear_loop_caches()


def judge(state, seed, device):
    """Numbers of the judged volumes: the worst of each over them."""
    from reference.judge_volume import judge as judge_one

    done = sorted(state["outputs"])
    k = min(int(state["traffic"].get("judged_volumes", 2)), len(done))
    rng = np.random.default_rng([int(seed), 7])
    pick = sorted(rng.choice(done, size=k, replace=False).tolist())
    settings = reference_settings(state["config"])
    worst = {}
    for j in pick:
        nums, _ = judge_one(state["volumes"][j]["raw"], state["outputs"][j],
                            settings, device)
        for key, v in nums.items():
            worst[key] = max(worst.get(key, v), v)
    return worst, {"judged": [state["volumes"][j]["patient"]
                              for j in pick]}
