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
  per iteration, so a grow reads it (iterations run + 1) times, the JAX
  loop's passes one by one;
* CUDA tensors take ``graph_loop``, on a side stream: ``stop`` is read
  once before the loop, iteration 1 runs eagerly (which also warms up
  what capture cannot do: cuBLAS's workspace for ``K @ hist``, the
  kernels' one-time attribute calls) and ``stop`` is read again; then
  each step is captured once as a CUDA graph, all in one memory pool,
  and kept uninstantiated (``keep_graph=True``); ``ops/graph_while``
  builds around them one graph whose conditional WHILE node runs the
  steps in turn while ``stop`` < 0 on the device (csrc/graph_while.cu,
  the counterpart of the JAX loop's ``cond``), the graph is launched
  once, and ``stop``, the device's count of steps run and its count of
  the WHILE node's head and tail launches are read together, through
  three pinned host words.  So a grow reads ``stop``
  min(passes, 2) + 1 times whatever its iterations, and a grow of 0 or
  1 passes captures nothing.  A build, instantiation or launch of the
  while graph that fails raises: nothing falls back to replays or to
  the eager loop.

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

A loop's graphs are dropped at the end of its call, after the side
stream has finished, so no pointer outlives the buffers of the call;
except a loop made with ``keep=True`` (the flow solver's cached solves,
flow/solvers.py): it keeps its graphs, and the steps that ran once, from
call to call, until ``close()``.  Such a loop captures, at the end of a
call (``capture_pending``), each step that ran once and so was never
captured, without running it, so that a later call replays every step
the first call reached.  A capture that fails raises: nothing carries
on eagerly.  Capture runs nothing, so a cache entry that a step made
while it was captured would hold memory that no kernel has written; a
loop given ``watch`` raises if the objects ``watch()`` lists changed
during a capture.

Every capture goes into one ``torch.cuda.MemPool`` per (device, thread),
which lives for the process (``graph_pool``): the pool keeps its blocks
when the graphs that used them are gone, and the next capture reuses
them, where a pool per loop stayed reserved after its call.  The loops
of a thread on a device share one side stream too, as the caching
allocator gives a freed block to its own stream only.  Per thread,
because captures run in ``thread_local`` mode and may run in two
threads at once.  Graphs that share a pool may alias in the memory a
capture allocated and freed again (a step's temporaries), so no two of
them may run at once; and no step hands another a tensor allocated
during a capture, except from one segment of a step to the next (a
batch's LU): every state a loop keeps lies in buffers made before the
loop.  Then graphs of one pool may replay in any order.  In one thread
these loops can be live together: the cached solves' loops (idle
between their calls) and one loop that runs, whose calls do not nest
(no step starts a loop).  A loop runs on the side stream, which waits
for the caller's stream when its call starts, and the caller waits for
the side stream, after a synchronise, when it ends; so a later loop's
graphs start after an earlier one's have finished.

The kernels' wrappers count their launches in Python, which runs once,
while a step is captured, and so may a caller's own counters.  A capture
takes out what it added to each counter and each replay adds it back
(``graph_loop``: each step's additions times the times it ran), so a
counter counts what ran.  ``read_stop.reads`` counts the growers' host
reads of their ``stop``, ``graph_loop.captures`` the graphs they
captured, ``graph_loop.replays`` the steps run from captured graphs,
``graph_loop.launches`` the while graphs launched and
``graph_loop.capture_s`` the seconds spent capturing and building them
(``graph_while.set_while.launches`` and ``count_step.launches`` count
the while graphs' two kernels, as the kernels counted themselves on the
device); a loop object counts
its own in ``reads``, ``captures``, ``replays``, ``capture_s`` (seconds
spent capturing) and ``runs`` (steps run, by key), which the solver
hands to its ``SolveStats``.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time

import torch

from . import graph_while


_pools = threading.local()


class _GraphPool:
    """One thread's graph pool on one device: a ``torch.cuda.MemPool``,
    which holds the pool's blocks in the device allocator, the last
    graph captured into it, and the side stream every loop of the
    thread runs on there.  torch's pinned-host allocator counts a pool's
    live graphs on its own, and refuses a capture into a pool whose
    count fell to 0 (torch 2.11: "use_count > 0 INTERNAL ASSERT
    FAILED"); the kept graph holds that count at 1 or more.  The caching
    allocator gives a freed block only to its own stream again, so with
    one side stream each call reuses the blocks of the last, captured
    and eager."""

    def __init__(self, device):
        with torch.cuda.device(device):
            self.mempool = torch.cuda.MemPool()
        self.id = self.mempool.id
        self.last = None
        self.side = torch.cuda.Stream(device)


def graph_pool(device):
    """This thread's graph pool on ``device`` (a torch.device), made at
    its first use and kept for the process: ``.id`` for
    ``capture_begin(pool=...)``, ``.last`` the last graph captured,
    ``.side`` the loops' side stream."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pools = _pools.__dict__.setdefault("by_device", {})
    pool = pools.get(device)
    if pool is None:
        pool = pools[device] = _GraphPool(device)
    return pool


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


def read_stop_and_counts(words, pinned):
    """A grower's one read of its ``stop`` (``words[0]``) and the while
    graph's device counts (``words[1:]``) together: one copy into the
    pinned host words and a synchronise, counted in
    ``read_stop.reads``."""
    read_stop.reads += 1
    pinned.copy_(words, non_blocking=True)
    torch.cuda.current_stream(words.device).synchronize()
    return [int(w) for w in pinned]


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
        self.reset_counts()

    def reset_counts(self):
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

    def capture_pending(self):
        pass

    def close(self):
        pass


class GraphLoop(HostLoop):
    """A loop's steps on a CUDA device: each key's first step eager, its
    second captured once as a CUDA graph (or one graph per segment of a
    step that yields) and replayed, later ones replayed.

    ``counters``: (object, attribute) pairs of the caller's Python
    counters, kept as the kernels' launch counters are; ``watch``: a
    function -> a list of objects (a cache's entries), which must be the
    same objects after a capture as before; ``keep``: the graphs stay
    from call to call (the module's docstring)."""

    def __init__(self, device, counters=(), watch=None, keep=False):
        super().__init__()
        self.device = device
        self.side = graph_pool(device).side
        self.pinned = torch.empty(1, dtype=torch.int32, pin_memory=True)
        self.counters = list(counters)
        self.watch = watch
        self.keep = keep
        self.graphs = {}       # key -> [(graph, counts, split or None)]
        self.seen = {}         # key -> its step, once it ran eagerly

    @contextlib.contextmanager
    def stream(self):
        caller = torch.cuda.current_stream(self.device)
        self.side.wait_stream(caller)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.side):
                yield self
        finally:
            self.side.synchronize()      # before the graphs go
            caller.wait_stream(self.side)
            if not self.keep:
                self.graphs.clear()

    def close(self):
        """Drop the graphs, once the side stream has finished."""
        self.side.synchronize()
        self.graphs.clear()
        self.seen.clear()

    def read(self, stop):
        self.reads += 1
        return _read(stop, self.pinned)

    def capture(self, step, keep_graph=False):
        """``step`` captured into the loop's pool -> (graph, what it
        added to each counter); the counters are left as they were.
        ``keep_graph``: the graph is kept uninstantiated, for its
        ``raw_cuda_graph()`` (never ``replay()`` it)."""
        counters = self.counters + [(w, "launches") for w in _counted()]
        before = [getattr(o, a) for o, a in counters]
        watched = None if self.watch is None else self.watch()
        t0 = time.perf_counter()
        graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
                 else torch.cuda.CUDAGraph())
        # thread_local: another thread of the caller may use the card
        # meanwhile; this thread's unsafe calls still raise
        pool = graph_pool(self.device)
        graph.capture_begin(pool=pool.id, capture_error_mode="thread_local")
        try:
            step()
        except BaseException:
            try:
                graph.capture_end()     # leave capture mode; the step's
            except RuntimeError:        # error is the one to report
                pass
            raise
        graph.capture_end()
        pool.last = graph
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
            self.seen[key] = step
            _eager(step)

    def capture_pending(self):
        """Capture, without running them, the steps that ran once and
        were never captured (inside ``stream()``)."""
        for key, step in self.seen.items():
            if key not in self.graphs:
                self.graphs[key] = self._capture_parts(step, run=False)

    def _capture_parts(self, step, run=True):
        """``step`` captured segment by segment, each segment replayed
        (and the callable it yields run) before the next is captured, as
        the segments read what the ones before wrote; with ``run=False``
        captured only (what a segment allocates stays for the next)."""
        parts, state = [], {}

        def segment():
            if "gen" not in state:
                out = step()
                state["gen"] = out if inspect.isgenerator(out) else iter(())
            state["split"] = next(state["gen"], None)

        while True:
            graph, counts = self.capture(segment)
            if run:
                self.replay(graph, counts)
            split = state["split"]
            parts.append((graph, counts, split))
            if split is None:
                return parts
            if run:
                split()


def graph_loop(steps, stop):
    """Run ``steps`` in turn while ``stop`` < 0: the first eagerly, then
    the rest in one launch of a while graph around each step captured
    once -> steps run."""
    loop = GraphLoop(stop.device)
    loop_graph = None
    try:
        with loop.stream():
            if read_stop(stop, loop.pinned) >= 0:
                return 0
            steps[0]()
            if read_stop(stop, loop.pinned) >= 0:
                return 1
            order = steps[1:] + steps[:1]
            graphs = [loop.capture(s, keep_graph=True) for s in order]
            # stop, steps run (count_step), set_while's launches
            words = stop.new_zeros(3)
            t0 = time.perf_counter()
            loop_graph = graph_while.WhileGraph(
                [g.raw_cuda_graph() for g, _ in graphs], stop, words[1:])
            loop.capture_s += time.perf_counter() - t0
            loop_graph.launch(loop.side)
            graph_loop.launches += 1
            words[:1].copy_(stop.reshape(1))
            code, ran, heads = read_stop_and_counts(
                words, torch.empty(3, dtype=torch.int32, pin_memory=True))
            if code < 0 or ran < 1:
                raise RuntimeError(f"the while graph ended with stop {code} "
                                   f"after {ran} steps")
            _count_runs(loop, graphs, ran, heads)
            return 1 + ran
    finally:
        if loop_graph is not None:      # after the side stream finished
            loop_graph.close()
        graph_loop.captures += loop.captures
        graph_loop.replays += loop.replays
        graph_loop.capture_s += loop.capture_s


def _count_runs(loop, graphs, ran, heads):
    """Add what each captured step adds to the counters times the times
    it ran (step k of s ran ceil((ran - k) / s) times), and the while
    graph's kernel launches as the kernels counted them on the device:
    ``count_step`` ``ran``, ``set_while`` ``heads``."""
    for k, (_, counts) in enumerate(graphs):
        times = -(-(ran - k) // len(graphs))
        for (o, a), n in counts:
            setattr(o, a, getattr(o, a) + n * times)
    loop.replays += ran
    graph_while.count_step.launches += ran
    graph_while.set_while.launches += heads


graph_loop.captures = 0
graph_loop.replays = 0
graph_loop.launches = 0
graph_loop.capture_s = 0.0


def drive(steps, stop):
    """Run a grower's ``steps`` in turn while its ``stop`` < 0 -> steps
    run: ``graph_loop`` on a CUDA device, ``host_loop`` on the CPU."""
    if stop.device.type == "cuda":
        return graph_loop(steps, stop)
    return host_loop(steps, stop)


def loop_for(device, counters=(), watch=None, keep=False):
    """The loop a solve's steps run in on ``device`` (a torch.device):
    a ``GraphLoop`` on a CUDA device, else a ``HostLoop``."""
    if device.type == "cuda":
        return GraphLoop(device, counters, watch, keep)
    return HostLoop()
