"""The port's spans (utils/profiling.span) on the CPU.

A span adds its seconds and a call to the active timer, nests, and
records nothing without one; it enters ``record_function`` only under an
active profiler.  ``run_pipeline``'s spans, traced by ``torch.profiler``,
give one host range ``an.<key>`` per key of its ``timings``, nested as
its docstring lists them, and they cover the call's wall time; the
benchmark's trace reduction names device-idle gaps by them.  The
``graph_capture`` span is held to ``GraphLoop``'s ``capture_s`` through
the stand-in of torch.cuda in tests/test_torch_grow_loop.py.  The
benchmark's six span readers return the mean of their keys.
"""

import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from arterynetwork_tpu_torch.config import PipelineConfig
from arterynetwork_tpu_torch.ops import grow_loop
from arterynetwork_tpu_torch.pipeline import run_pipeline
from arterynetwork_tpu_torch.utils import profiling
from arterynetwork_tpu_torch.utils.phantoms import (phantom_raw_volume,
                                                    vascular_tree_phantom)
from arterynetwork_tpu_torch.utils.profiling import (PORT_SPANS, PREFIX,
                                                     StageTimer, span)

from .test_torch_grow_loop import _counted_step, _fake_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
# the benchmark's modules, found as its own tests find them
for _p in (BENCH, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

# each key's enclosing span in run_pipeline (None: top level)
PARENT = {
    "vesselness": None, "vesselness_upload": "vesselness",
    "vesselness_compute": "vesselness",
    "vesselness_pack": "vesselness_upload",
    "vesselness_h2d": "vesselness_upload",
    "segmentation": None, "segmentation_download": "segmentation",
    "segmentation_flood": "segmentation",
    "edt": None, "skeletonization": None, "thinning": "skeletonization",
    "graph": None, "graph_segments": "graph", "graph_attrs": "graph",
    "inlet": None, "flow": None, "flow_network": "flow",
    "flow_boundary": "flow", "flow_system": "flow", "flow_solve": "flow",
    "flow_download": "flow"}
TOP = [k for k, p in PARENT.items() if p is None]


# --- the mechanism ---------------------------------------------------------

def test_span_nests_and_adds_to_the_active_timer():
    timer = StageTimer()
    with timer.active():
        for _ in range(2):
            with span("outer") as outer:
                with span("inner") as inner:
                    time.sleep(0.002)
    assert timer.counts == {"outer": 2, "inner": 2}
    assert timer.seconds["inner"] >= 0.004
    assert timer.seconds["outer"] >= timer.seconds["inner"]
    assert outer.seconds >= inner.seconds >= 0.002
    # the timer is active only inside its block
    with span("after"):
        pass
    assert "after" not in timer.seconds


def test_span_without_a_timer_records_nothing_but_its_seconds():
    with span("alone") as s:
        time.sleep(0.001)
    assert s.seconds >= 0.001 and s.timer is None


def test_timers_nest_and_restore():
    a, b = StageTimer(), StageTimer()
    with a.active():
        with b.active():
            with span("x"):
                pass
        with span("y"):
            pass
    assert set(a.seconds) == {"y"} and set(b.seconds) == {"x"}


def _refuse(*args, **kw):
    raise AssertionError("record_function entered with no profiler")


@pytest.mark.parametrize("opener", ["span", "stage"])
def test_no_record_function_without_a_profiler(monkeypatch, opener):
    monkeypatch.setattr(profiling, "record_function", _refuse)
    timer = StageTimer()
    with timer.active():
        with (span("k") if opener == "span" else timer.stage("k")):
            pass
    assert timer.counts == {"k": 1}


@pytest.mark.parametrize("opener", ["span", "stage"])
def test_range_under_a_profiler(opener):
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.active():
            with (span("k") if opener == "span" else timer.stage("k")):
                torch.ones(8).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(PREFIX + "k") == 1
    assert not PREFIX.startswith("bench.")


def test_an_error_inside_a_span_is_recorded_and_raised():
    timer = StageTimer()
    with pytest.raises(ValueError):
        with timer.active(), span("k"):
            raise ValueError("stage failed")
    assert timer.counts == {"k": 1}


# --- run_pipeline's spans --------------------------------------------------

def _config():
    cfg = PipelineConfig()
    cfg.vesselness.sigmas = (0.75, 1.0, 2.0, 3.0)
    cfg.vesselness.upload_format = "bq4"
    cfg.segmentation.global_threshold_fraction = 0.3
    cfg.segmentation.weak_threshold_fraction = 0.03
    cfg.segmentation.border_margin_voxels = 6
    cfg.segmentation.min_component_size = 50
    cfg.skeleton.backend = "native"
    cfg.skeleton.prune_min_length = 4
    cfg.flow.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def traced():
    """A warm run_pipeline on a small tree, then one under the profiler
    inside a "bench.window" range -> (result, wall seconds, events)."""
    ph = vascular_tree_phantom((48, 64, 64), n_branches=12,
                               root_radius=3.0, branch_length=(12, 25),
                               seed=1)
    raw = phantom_raw_volume(ph)
    cfg = _config()
    run_pipeline(raw_volume=raw, config=cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            out = run_pipeline(raw_volume=raw, config=cfg, device="cpu")
            wall = time.perf_counter() - t0
    return out, wall, harness.profiler_events(prof)


def _spans(events):
    return [(n[len(PREFIX):], s, s + d) for n, dev, s, d in events
            if not dev and n.startswith(PREFIX)]


def test_pipeline_keys_are_the_documented_spans(traced):
    out, _, _ = traced
    assert set(out["timings"]) == set(PARENT)
    assert set(out["timings"]) <= PORT_SPANS
    assert not any(k.startswith("bench.") for k in PORT_SPANS)
    assert isinstance(out["timings"], dict)


def test_pipeline_ranges_nest_as_documented(traced):
    out, _, events = traced
    spans = _spans(events)
    assert {k for k, _, _ in spans} == set(out["timings"])
    for key, s, e in spans:
        around = [(e1 - s1, k1) for k1, s1, e1 in spans
                  if s1 <= s and e <= e1 and (k1, s1, e1) != (key, s, e)]
        parent = min(around)[1] if around else None
        assert parent == PARENT[key], key


def test_each_child_fits_in_its_parent(traced):
    t = traced[0]["timings"]
    for parent in set(PARENT.values()) - {None}:
        kids = sum(t[k] for k, p in PARENT.items() if p == parent)
        assert kids <= t[parent], parent


def test_top_level_spans_cover_the_call(traced):
    out, wall, _ = traced
    assert sum(out["timings"][k] for k in TOP) >= 0.98 * wall


def test_trace_reduction_names_gaps_by_the_spans(traced):
    """Device events around one idle instant in each span, where no
    deeper host event runs: the reduction names each gap ``an.<key>``."""
    _, _, events = traced
    window = [(s, s + d) for n, dev, s, d in events
              if n == "bench.window" and not dev][0]
    host = [(s, s + d) for n, dev, s, d in events
            if not dev and n != "bench.window"]
    instants = {}
    for key, s, e in _spans(events):
        inner = sorted((a, b) for a, b in host if s < a <= e)
        t = s + 1
        for a, b in inner:
            if a > t:
                break
            t = max(t, b + 1)
        assert t < e, key
        instants[key] = t
    cuts = sorted(instants.values())
    device, prev = [], window[0]
    for t in cuts:
        device.append(("kernel", True, prev, t - 1 - prev))
        prev = t + 1
    device.append(("kernel", True, prev, window[1] - prev))
    trace = harness.reduce_trace(events + device, "bench.window",
                                 top=len(cuts) + 2)
    named = dict(trace["idle_gaps"])
    assert set(named) == {PREFIX + k for k in instants}
    assert "host outside torch ops" not in named


# --- graph_capture ---------------------------------------------------------

def test_graph_capture_span_is_capture_s(monkeypatch):
    fake, _ = _fake_torch(monkeypatch)
    stop = torch.tensor(-1, dtype=torch.int32)
    ran = []
    steps = [_counted_step("ab", fake, ran, stop, 7),
             _counted_step("ba", fake, ran, stop, 7)]
    grow_loop.graph_loop.capture_s = 0.0
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.active(), span("flow_solve"):
            assert grow_loop.graph_loop(steps, stop) == 7
    # two steps captured, one while graph built around them
    assert timer.counts["graph_capture"] == 3
    assert timer.seconds["graph_capture"] == pytest.approx(
        grow_loop.graph_loop.capture_s)
    spans = _spans(harness.profiler_events(prof))
    (_, s0, e0), = [x for x in spans if x[0] == "flow_solve"]
    inner = [(s, e) for k, s, e in spans if k == "graph_capture"]
    assert len(inner) == 3 and all(s0 <= s and e <= e0 for s, e in inner)


# --- the benchmark's readers -----------------------------------------------

READERS = {"vesselness_pack_s": ("vesselness_pack",),
           "vesselness_h2d_s": ("vesselness_h2d",),
           "thinning_s": ("thinning",),
           "graph_segments_s": ("graph_segments",),
           "flow_plan_s": ("flow_network", "flow_boundary", "flow_system"),
           "graph_capture_s": ("graph_capture",)}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "spans_metric_" + name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_the_mean_of_its_keys(name):
    keys = READERS[name]
    rng = np.random.default_rng(len(name))
    timings = [{k: float(rng.uniform(0.01, 0.2)) for k in keys}
               | {"flow": 1.0, "graph": 1.0} for _ in range(4)]
    del timings[1][keys[0]]       # a volume without the key reads 0
    run = harness.Run()
    run.readings = {"timings": timings}
    want = np.mean([sum(t.get(k, 0.0) for k in keys) for t in timings])
    assert _reader(name).read(run) == pytest.approx(want)
    # the parent program: no timings, or none of its keys
    run.readings = {}
    assert _reader(name).read(run) is None
    run.readings = {"timings": [{"flow": 1.0}, {"graph": 2.0}]}
    assert _reader(name).read(run) is None
