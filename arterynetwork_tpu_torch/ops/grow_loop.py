"""The port's device loops: the counterpart of the JAX package's
``lax.while_loop`` and ``lax.scan``, for the region growers
(arterynetwork_tpu/ops/region_grow.py:250, region_grow_fused.py:297,
region_grow_frontier.py:564), the flow solver
(arterynetwork_tpu/flow/solvers.py:258,273,314,358 and CG's loop), the
device thinning (arterynetwork_tpu/ops/thinning.py:173,187), the
connected components (arterynetwork_tpu/ops/cc.py:80), the sharded
grower and thinning (parallel/sharded.py, where GSPMD runs those loops
over a mesh) and the flow distribution's Gauss-Newton scan
(arterynetwork_tpu/flow/distribute.py:310).

A loop's body is written once, as step functions that read their state
from tensors made before the loop and write the new state back into them
in place, with an int32 scalar ``stop`` on the device (-1: go on; else
the loop is done, and for a grower the stop reason).

A grower's steps go to ``drive``, which runs them in turn, ``steps[0]``,
``steps[1]``, ... (a grower that sweeps from one buffer into another
gives two steps, A -> B and B -> A), while ``stop`` < 0, and returns how
many ran:

* CPU tensors take ``host_loop``: a plain loop that reads ``stop`` once
  per iteration;
* CUDA tensors take ``graph_loop``, on a side stream: iteration 1 runs
  eagerly, which also warms up what capture cannot do (cuBLAS's
  workspace for ``K @ hist``, the kernels' one-time attribute calls);
  then each step is captured once as a CUDA graph, all in one memory
  pool, and the graphs are replayed in turn, one iteration per replay.
  ``stop`` is read once before the loop and once after each iteration,
  through a pinned host word.

So a grow reads ``stop`` (iterations run + 1) times, the JAX loop's
passes one by one.

The flow solver drives its own loops (a Newton loop, CG blocks within a
Newton step, a fixed number of refinement steps), and the thinning and
the components theirs (a wave pass, a final pass; a round), through an
object that ``loop_for`` gives: ``run(key, step)`` runs one step and
``read(stop)`` reads a ``stop`` on the host, inside ``with
loop.stream():``.

* ``HostLoop`` (CPU tensors): ``run`` calls the step; ``read`` is
  ``int(stop)``;
* ``GraphLoop`` (CUDA tensors), on a side stream: a key's first step
  runs eagerly, its second is captured as a CUDA graph (all of a loop's
  graphs in one pool) and replayed, and every later one is a replay;
  ``read`` goes through the pinned word.  A step may be a generator
  that yields callables: each splits the step there, and runs eagerly
  between the replays of the graphs before and after it (an LU that
  capture refuses).

Graphs are captured anew on every call and dropped at its end, after the
side stream has finished, so no pointer outlives the buffers of the
call.  A capture that fails raises: nothing carries on eagerly.  Capture
runs nothing, so a cache entry that a step made while it was captured
would hold memory that no kernel has written; a loop given ``watch``
raises if the objects ``watch()`` lists changed during a capture.

The kernels' wrappers count their launches in Python, which runs once,
while a step is captured, and so may a caller's own counters.  A capture
takes out what it added to each counter and each replay adds it back,
so a counter counts what ran.  ``read_stop.reads`` counts the growers'
host reads of their ``stop``, ``graph_loop.captures`` the graphs they
captured, ``graph_loop.replays`` their replays and
``graph_loop.capture_s`` the seconds spent capturing; a loop object counts
its own in ``reads``, ``captures``, ``replays``, ``capture_s`` (seconds
spent capturing) and ``runs`` (steps run, by key), which the solver
hands to its ``SolveStats``.
"""

from __future__ import annotations

import contextlib
import inspect
import time

import torch


def _read(stop, pinned=None):
    """``stop`` on the host: ``int(stop)``, or, with a pinned host word,
    a non-blocking copy into it and a synchronise of the current
    stream."""
    if pinned is None:
        return int(stop)
    pinned.copy_(stop.reshape(1), non_blocking=True)
    torch.cuda.current_stream(stop.device).synchronize()
    return int(pinned[0])


def read_stop(stop, pinned=None):
    """A grower's read of its ``stop`` (``_read``), counted in
    ``read_stop.reads``."""
    read_stop.reads += 1
    return _read(stop, pinned)


read_stop.reads = 0


def host_loop(steps, stop):
    """Run ``steps`` in turn while ``stop`` < 0, eagerly -> steps run."""
    n = 0
    while read_stop(stop) < 0:
        steps[n % len(steps)]()
        n += 1
    return n


def _counted():
    """Every kernel wrapper a grower's step may launch; each counts its
    launches in ``launches``."""
    from .histogram_kernels import masked_histogram1, masked_histograms2
    from .lookup_kernels import sign_lookup, table_lookup
    from .region_grow_frontier import frontier_step
    from .region_grow_fused import fused_sweep_counts
    return (masked_histogram1, masked_histograms2, sign_lookup, table_lookup,
            fused_sweep_counts, frontier_step)


def run_eagerly(gen):
    """Run a step that is a generator eagerly, each callable it yields
    at once -> what it returns."""
    while True:
        try:
            split = next(gen)
        except StopIteration as done:
            return done.value
        split()


def _eager(step):
    """Run ``step`` eagerly."""
    out = step()
    if inspect.isgenerator(out):
        run_eagerly(out)


def _same(a, b):
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class HostLoop:
    """A loop's steps run eagerly (CPU tensors)."""

    def __init__(self):
        self.reads = self.captures = self.replays = 0
        self.capture_s = 0.0
        self.runs = {}         # key -> steps run

    @contextlib.contextmanager
    def stream(self):
        yield self

    def read(self, stop):
        self.reads += 1
        return _read(stop)

    def run(self, key, step):
        self.runs[key] = self.runs.get(key, 0) + 1
        _eager(step)


class GraphLoop(HostLoop):
    """A loop's steps on a CUDA device: each key's first step eager, its
    second captured once as a CUDA graph (or one graph per segment of a
    step that yields) and replayed, later ones replayed.

    ``counters``: (object, attribute) pairs of the caller's Python
    counters, kept as the kernels' launch counters are; ``watch``: a
    function -> a list of objects (a cache's entries), which must be the
    same objects after a capture as before."""

    def __init__(self, device, counters=(), watch=None):
        super().__init__()
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.pinned = torch.empty(1, dtype=torch.int32, pin_memory=True)
        self.counters = list(counters)
        self.watch = watch
        self.pool = None
        self.graphs = {}       # key -> [(graph, counts, split or None)]
        self.seen = set()

    @contextlib.contextmanager
    def stream(self):
        caller = torch.cuda.current_stream(self.device)
        self.side.wait_stream(caller)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.side):
                yield self
        finally:
            self.side.synchronize()      # before the graphs and pool go
            caller.wait_stream(self.side)
            self.graphs.clear()

    def read(self, stop):
        self.reads += 1
        return _read(stop, self.pinned)

    def capture(self, step):
        """``step`` captured into the loop's pool -> (graph, what it
        added to each counter); the counters are left as they were."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        counters = self.counters + [(w, "launches") for w in _counted()]
        before = [getattr(o, a) for o, a in counters]
        watched = None if self.watch is None else self.watch()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread of the caller may use the card
        # meanwhile; this thread's unsafe calls still raise
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            step()
        except BaseException:
            try:
                graph.capture_end()     # leave capture mode; the step's
            except RuntimeError:        # error is the one to report
                pass
            raise
        graph.capture_end()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        added = [getattr(o, a) - b for (o, a), b in zip(counters, before)]
        for (o, a), b in zip(counters, before):
            setattr(o, a, b)
        if self.watch is not None and not _same(self.watch(), watched):
            raise RuntimeError("a cache changed while a step was captured: "
                               "its new entries hold memory no kernel wrote")
        return graph, list(zip(counters, added))

    def replay(self, graph, counts):
        graph.replay()
        self.replays += 1
        for (o, a), n in counts:
            setattr(o, a, getattr(o, a) + n)

    def run(self, key, step):
        self.runs[key] = self.runs.get(key, 0) + 1
        if key in self.graphs:
            for graph, counts, split in self.graphs[key]:
                self.replay(graph, counts)
                if split is not None:
                    split()
        elif key in self.seen:
            self.graphs[key] = self._capture_parts(step)
        else:
            self.seen.add(key)
            _eager(step)

    def _capture_parts(self, step):
        """``step`` captured segment by segment, each segment replayed
        (and the callable it yields run) before the next is captured, as
        the segments read what the ones before wrote."""
        parts, state = [], {}

        def segment():
            if "gen" not in state:
                out = step()
                state["gen"] = out if inspect.isgenerator(out) else iter(())
            state["split"] = next(state["gen"], None)

        while True:
            graph, counts = self.capture(segment)
            self.replay(graph, counts)
            split = state["split"]
            parts.append((graph, counts, split))
            if split is None:
                return parts
            split()


def graph_loop(steps, stop):
    """Run ``steps`` in turn while ``stop`` < 0: the first eagerly, then
    each captured once as a CUDA graph and replayed -> steps run."""
    loop = GraphLoop(stop.device)
    try:
        with loop.stream():
            if read_stop(stop, loop.pinned) >= 0:
                return 0
            steps[0]()
            if read_stop(stop, loop.pinned) >= 0:
                return 1
            order = steps[1:] + steps[:1]
            graphs = [loop.capture(s) for s in order]
            n = 1
            while True:
                loop.replay(*graphs[(n - 1) % len(graphs)])
                n += 1
                if read_stop(stop, loop.pinned) >= 0:
                    return n
    finally:
        graph_loop.captures += loop.captures
        graph_loop.replays += loop.replays
        graph_loop.capture_s += loop.capture_s


graph_loop.captures = 0
graph_loop.replays = 0
graph_loop.capture_s = 0.0


def drive(steps, stop):
    """Run a grower's ``steps`` in turn while its ``stop`` < 0 -> steps
    run: ``graph_loop`` on a CUDA device, ``host_loop`` on the CPU."""
    if stop.device.type == "cuda":
        return graph_loop(steps, stop)
    return host_loop(steps, stop)


def loop_for(device, counters=(), watch=None):
    """The loop a solve's steps run in on ``device`` (a torch.device):
    a ``GraphLoop`` on a CUDA device, else a ``HostLoop``."""
    if device.type == "cuda":
        return GraphLoop(device, counters, watch)
    return HostLoop()
