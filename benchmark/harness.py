"""The benchmark's machinery, driven by BENCHMARK.json and the files it
names: a cell's configuration (``configs/``), its traffic mix
(``traffic/<name>.json``, which names its driver in ``drivers/``), its
limits (``workloads/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``).  A new cell, configuration or metric is new
files and new BENCHMARK.json entries; nothing here changes.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# top-level module names that may not be loaded in a run: JAX and the
# JAX package (compared whole: the port's name begins with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "arterynetwork_tpu")


def forbidden_modules(names):
    """The names among ``names`` whose top-level part is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of BENCHMARK.json's ``workloads`` with everything it
    names, found by name under ``base``."""

    def __init__(self, name, spec, base=HERE):
        self.base = base
        w = {x["name"]: x for x in spec["workloads"]}
        if name not in w:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = w[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _json(os.path.join(os.path.dirname(base),
                                         configs[self.entry["config"]]["file"]))
        self.traffic = _json(os.path.join(base, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(base, "workloads", name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in spec["per_layer"] if self.reports(m)]

    def reports(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def driver(self):
        name = self.traffic["driver"]
        return _load_file(os.path.join(self.base, "drivers", name + ".py"),
                          f"bench_driver_{name}")

    def reader(self, metric):
        return _load_file(os.path.join(self.base, "metrics",
                                       metric["name"] + ".py"),
                          "bench_metric_" + metric["name"].replace(".", "_"))


def load_cell(name, base=HERE):
    return Cell(name, _json(os.path.join(os.path.dirname(base),
                                         "BENCHMARK.json")), base)


class Run:
    """What one run measured: the window's requests and the driver's
    readings, and with ``--trace 1`` the reduced profiler trace."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.latencies = []
        self.attempted = 0
        self.failed = 0
        self.readings = {}
        self.trace = None
        self.gc_full = []       # seconds of each full collection


def closed_loop(driver, state, seconds, run, span=None):
    """Requests back to back from one client until ``seconds`` have
    passed; the window ends when the last request started in it ends, so
    it holds all the work and all the time of the requests it counts."""
    gc_start = 0.0

    def on_gc(phase, info):
        nonlocal gc_start
        if phase == "start":
            gc_start = time.perf_counter()
        elif info["generation"] == 2:
            run.gc_full.append(time.perf_counter() - gc_start)

    gc.callbacks.append(on_gc)
    try:
        t_start = time.perf_counter()
        t_end = t_start
        i = 0
        while t_end - t_start < seconds:
            run.attempted += 1
            t0 = time.perf_counter()
            try:
                if span is None:
                    driver.request(state, i)
                else:
                    with span(driver.SPAN):
                        driver.request(state, i)
            except Exception:   # a failed request is counted, not fatal
                traceback.print_exc()
                run.failed += 1
            t_end = time.perf_counter()
            run.latencies.append(t_end - t0)
            i += 1
    finally:
        gc.callbacks.remove(on_gc)
    run.window_s = t_end - t_start


def percentile(values, q):
    """The q-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ----------------------------------------------------------------------
# the profiler's trace
# ----------------------------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_name, host_spans=None, top=10):
    """Reduce a profiler's events to busy and window seconds, device time
    by operation, the longest idle gaps by what the host was doing, and
    per-kernel (launches, device seconds).

    ``events``: (name, is_device, start_ns, duration_ns) tuples.
    ``host_spans``: optional (label, start_ns, end_ns) spans of the
    program's stages, which name a gap before the host's torch ops do."""
    window = [(s, s + d) for n, dev, s, d in events
              if not dev and n == window_name]
    if not window:
        return None
    w0, w1 = window[0]
    dev = [(s, s + d, n) for n, is_dev, s, d in events
           if is_dev and s + d > w0 and s < w1]
    merged = _merge([[max(s, w0), min(e, w1)] for s, e, _ in dev])
    busy = sum(e - s for s, e in merged)
    by_op = {}
    for s, e, n in dev:
        t, c = by_op.get(n, (0, 0))
        by_op[n] = (t + (e - s), c + 1)
    gaps = []
    prev = w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((s, s + d, n) for n, is_dev, s, d in events
                  if not is_dev and n != window_name)
    starts = [h[0] for h in host]
    spans = sorted(host_spans or [], key=lambda s: s[1])
    span_starts = [s[1] for s in spans]

    def op_at(t):
        i = bisect.bisect_right(starts, t) - 1
        for k in range(i, max(i - 400, -1), -1):
            if host[k][1] >= t:
                name = host[k][2]
                return None if name.startswith("bench.") else name
        return None

    def pieces(a, b):
        """The gap cut at the stage spans' edges, each piece with its
        stage (or None)."""
        j = max(bisect.bisect_right(span_starts, a) - 1, 0)
        t = a
        while t < b and j < len(spans):
            label, s0, s1 = spans[j]
            if s1 <= t:
                j += 1
                continue
            if s0 > t:
                yield None, t, min(b, s0)
                t = min(b, s0)
                continue
            yield label, t, min(b, s1)
            t = min(b, s1)
            j += 1
        if t < b:
            yield None, t, b

    idle = {}
    for a, b in gaps:
        for stage, x, y in pieces(a, b):
            op = op_at((x + y) // 2) or "host outside torch ops"
            name = f"{stage}: {op}" if stage else op
            idle[name] = idle.get(name, 0) + (y - x)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": {n: (c, t / 1e9) for n, (t, c) in by_op.items()},
        "device_ops": [[n[:160], t / 1e9] for n, (t, c) in ops[:top]],
        "idle_gaps": [[n[:160], t / 1e9] for n, t in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def profiler_events(prof):
    """(name, is_device, start_ns, duration_ns) of a torch.profiler run:
    CUDA kernels, copies and sets on the device; ops and annotations on
    the host."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if on_device and (annotation or e.name().startswith("bench.")):
            continue        # a host span's shadow on the device's rows
        out.append((e.name(), on_device, int(e.start_ns()),
                    int(e.duration_ns())))
    return out
