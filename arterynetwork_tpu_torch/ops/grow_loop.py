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

As ``jax.jit`` compiles a loop once per shape and static arguments, a
loop's graphs stay from call to call of the same shapes: every tensor
its steps read or write lies in a cached entry (a ``CachedLoop``), the
counterpart of one executable in the jit's cache, one per key, in a
``LoopCache`` per user (per device and thread, the least recently used
entry evicted and closed before a new one is made).  An entry holds its
steps, which read nothing else, and a loop made with ``keep=True``,
which keeps its graphs, and the steps that ran once, until ``close()``.
A call copies its inputs into the entry before any step runs; on a hit
every step is a replay, the first one too, and nothing is captured.  On
a miss the loop captures as above and, at the end of the call
(``capture_pending``), each step that ran once and so was never
captured, without running it, so that a later call replays every step
the first call reached (a key that no call of the entry has run yet is
captured on its second run, as on a miss).  A key holds every shape and
dtype of the entry's tensors, every Python number a captured step
takes as a constant, and the loop route (``loop_for`` itself, so a
caller that swaps it gets entries of its own).  Only a loop on CUDA
graphs keeps its entry (``CachedLoop.kept``): on the host loop a call's
entry is its own, used once, and its tensors may be the results.
Results are new tensors, never a kept entry's (``CachedLoop.out``).  A
capture, replay or copy-in that fails raises and drops the entry:
nothing carries on eagerly.  The users: the flow solver
(flow/solvers.py, its own cache of the same design), ``distribute_flow``,
both thinnings and the components (``CachedLoop`` entries), and the four
growers (``CachedGrow`` entries: ``graph_loop`` keeps an entry's
captured steps and instantiated while graph, and a later grow runs pass
1 eagerly and launches that graph again).  A loop with no entry
(``graph_loop`` called without one, a ``GraphLoop`` made without
``keep``) drops its graphs at the end of its call, after the side stream
has finished.  Capture runs nothing, so a cache entry that a step made
while it was captured would hold memory that no kernel has written; a
loop given ``watch`` raises if the objects ``watch()`` lists changed
during a capture.

An entry of a volume loop holds volumes between calls, which JAX's
cache of executables does not: each of those loops keeps one entry,
``clear_loop_caches()`` empties every cache, and a function that
``frees_loop_caches`` wraps (each cached loop, the vesselness filters,
the EDTs) that runs out of device memory while this thread holds
entries or graph pools releases them all, the flow solves' cache and
the pools' blocks too (``release_device_memory``), and runs once more.

torch.profiler does not see the kernels of a while graph instantiated
before it started, so a grow traced by it builds a while graph of its
own from the entry's kept steps for that launch (``graph_loop``): a
warm grow's kernels show in the trace, at the cost of one instantiation
(counted in ``capture_s``).

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

import collections
import contextlib
import functools
import gc
import inspect
import threading
import time

import torch
from torch import OutOfMemoryError
from torch.autograd import _profiler_enabled

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
        # the host words every read goes through, made once: a pinned
        # block freed while a stream captures makes the host allocator
        # record an event into the capture, whose later query fails
        self.pinned = torch.empty(1, dtype=torch.int32, pin_memory=True)
        self.pinned3 = torch.empty(3, dtype=torch.int32, pin_memory=True)


def _pool_device(device):
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def graph_pool(device):
    """This thread's graph pool on ``device`` (a torch.device), made at
    its first use and kept for the process: ``.id`` for
    ``capture_begin(pool=...)``, ``.last`` the last graph captured,
    ``.side`` the loops' side stream, ``.pinned`` and ``.pinned3`` the
    pinned host words of the loops' reads."""
    device = _pool_device(device)
    pools = _pools.__dict__.setdefault("by_device", {})
    pool = pools.get(device)
    if pool is None:
        pool = pools[device] = _GraphPool(device)
    return pool


def _retire_pool(device):
    """After a capture into this thread's pool on ``device`` that failed
    to end: torch stops routing the capture's allocations into the pool
    only when a capture ends cleanly, so every later capture into it
    would fail ("already recording to mempool_id").  Later captures go
    into a new pool; the old one is kept for the graphs captured into
    it."""
    pools = _pools.__dict__.setdefault("by_device", {})
    old = pools.pop(_pool_device(device), None)
    if old is not None:
        _pools.__dict__.setdefault("retired", []).append(old)


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


def host_loop(steps, stop, entry=None):
    """Run ``steps`` in turn while ``stop`` < 0, eagerly -> steps run
    (an ``entry``'s graphs, if any, are not used)."""
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
        pool = graph_pool(device)
        self.side, self.pinned = pool.side, pool.pinned
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
        # no garbage collection inside a capture: a finalizer run there
        # (a loop's pinned word, an event) would act on the capturing
        # stream
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph.capture_begin(pool=pool.id,
                                capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                try:
                    graph.capture_end()     # leave capture mode; the
                except RuntimeError:        # step's error is the one to
                    _retire_pool(self.device)       # report
                raise
            graph.capture_end()
        finally:
            if collecting:
                gc.enable()
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


def graph_loop(steps, stop, entry=None):
    """Run ``steps`` in turn while ``stop`` < 0: the first eagerly, then
    the rest in one launch of a while graph around each step captured
    once -> steps run.  With ``entry`` (a ``CachedGrow``, whose tensors
    the steps alone read) the captured steps and the while graph are the
    entry's, built at its first grow of two passes or more and launched
    again by every later one; else they are built for this grow and
    closed at its end.  Under torch.profiler a grow with an entry's while
    graph builds one of its own from the entry's steps, launches it and
    closes it: the profiler misses the kernels of a while graph
    instantiated before it started."""
    loop = GraphLoop(stop.device) if entry is None else entry.graph_loop()
    loop.reset_counts()
    loop_graph = None if entry is None else entry.while_graph
    built = None
    try:
        with loop.stream():
            if read_stop(stop, loop.pinned) >= 0:
                return 0
            steps[0]()
            if read_stop(stop, loop.pinned) >= 0:
                return 1
            if loop_graph is None:
                order = steps[1:] + steps[:1]
                graphs = [loop.capture(s, keep_graph=True) for s in order]
                # stop, steps run (count_step), set_while's launches
                words = stop.new_zeros(3)
                t0 = time.perf_counter()
                loop_graph = built = graph_while.WhileGraph(
                    [g.raw_cuda_graph() for g, _ in graphs], stop,
                    words[1:])
                loop.capture_s += time.perf_counter() - t0
                if entry is not None:
                    entry.graphs, entry.words = graphs, words
                    entry.while_graph = loop_graph
            else:
                graphs, words = entry.graphs, entry.words
                words.zero_()
                if _profiler_enabled():
                    t0 = time.perf_counter()
                    loop_graph = built = graph_while.WhileGraph(
                        [g.raw_cuda_graph() for g, _ in graphs], stop,
                        words[1:])
                    loop.capture_s += time.perf_counter() - t0
            loop_graph.launch(loop.side)
            graph_loop.launches += 1
            words[:1].copy_(stop.reshape(1))
            code, ran, heads = read_stop_and_counts(
                words, graph_pool(stop.device).pinned3)
            if code < 0 or ran < 1:
                raise RuntimeError(f"the while graph ended with stop {code} "
                                   f"after {ran} steps")
            _count_runs(loop, graphs, ran, heads)
            return 1 + ran
    finally:
        if built is not None and (entry is None       # after the side
                                  or built is not entry.while_graph):
            built.close()                           # stream finished
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


def drive(steps, stop, entry=None):
    """Run a grower's ``steps`` in turn while its ``stop`` < 0 -> steps
    run: ``graph_loop`` on a CUDA device (with the while graph of
    ``entry``, a ``CachedGrow``, when given), ``host_loop`` on the
    CPU."""
    if stop.device.type == "cuda":
        return graph_loop(steps, stop, entry)
    return host_loop(steps, stop)


def loop_for(device, counters=(), watch=None, keep=False):
    """The loop a solve's steps run in on ``device`` (a torch.device):
    a ``GraphLoop`` on a CUDA device, else a ``HostLoop``."""
    if device.type == "cuda":
        return GraphLoop(device, counters, watch, keep)
    return HostLoop()


class CachedLoop:
    """An entry of a ``LoopCache``: a subclass makes, on the entry's
    device, every tensor its steps read or write, and its steps; this
    holds ``loop``, ``loop_for``'s loop with ``keep=True``, which keeps
    their graphs from call to call (or ``loop``, for a caller that runs
    the steps once, without a cache).  ``begin()`` opens a call (before
    its copy-in), ``end()`` closes it (after its results were made)."""

    def __init__(self, device, counters=(), watch=None, loop=None):
        self.device = device
        self.loop = (loop_for(device, counters, watch, keep=True)
                     if loop is None else loop)
        self.done = None        # the last call's end, on a card

    @property
    def kept(self):
        """Whether a ``LoopCache`` keeps the entry after its call: its
        loop is a ``GraphLoop`` (a host loop captures nothing to keep)."""
        return isinstance(self.loop, GraphLoop)

    def out(self, t):
        """A result made of the entry's tensor ``t``: a copy when the
        cache keeps the entry, else ``t`` itself."""
        return t.clone() if self.kept else t

    def begin(self):
        """Wait, on the current stream, for the reads the last call made
        of the entry's tensors after its loop, and zero the loop's
        counts."""
        if self.done is not None:
            torch.cuda.current_stream(self.device).wait_event(self.done)
        if self.loop is not None:
            self.loop.reset_counts()

    def end(self):
        if self.device.type == "cuda":
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))

    def close(self):
        """Drop the graphs, once the side stream has finished."""
        self.loop.close()


_caches = []            # every LoopCache, for clear_loop_caches()


class LoopCache:
    """One loop's cached entries, per device and thread: at most ``size``
    of them, the least recently used evicted (and closed) before a new
    one is made.  ``hits``, ``misses`` and ``evictions`` count what it
    did since the process started."""

    def __init__(self, size):
        self.size = size
        self.local = threading.local()
        self.hits = self.misses = self.evictions = 0
        _caches.append(self)

    def entries(self, device):
        """This thread's entries on ``device``, least recent first."""
        by_device = self.local.__dict__.setdefault("by_device", {})
        return by_device.setdefault(str(device),
                                    collections.OrderedDict())

    @contextlib.contextmanager
    def use(self, device, key, make):
        """The entry of ``key`` (with ``loop_for`` in front of it) on
        ``device``, made by ``make()`` on a miss -> (entry, hit), inside
        the entry's ``begin()`` and ``end()``; an error inside drops the
        entry and is raised.  A new entry is kept after its call if it
        is ``kept``, else dropped (a host loop's: every call makes its
        own).  Where the cache holds entries of this ``loop_for``, the
        least recent go before ``make()``, so that no more than ``size``
        entries live at once; others go when a new one is kept."""
        key = (loop_for,) + tuple(key)
        entries = self.entries(device)
        entry = entries.get(key)
        hit = entry is not None
        if hit:
            entries.move_to_end(key)
            self.hits += 1
        else:
            if any(k[0] is loop_for for k in entries):
                self._evict(entries)
            entry = make()
        try:
            entry.begin()
            yield entry, hit
            entry.end()
        except BaseException:
            if entries.get(key) is entry:
                del entries[key]
            try:
                entry.close()
            except RuntimeError:    # the error above is the one to report
                pass
            raise
        if not hit and entry.kept:
            self._evict(entries)
            entries[key] = entry
            self.misses += 1

    def _evict(self, entries):
        """Close the least recent ``entries`` until one more fits."""
        while len(entries) >= self.size:
            entries.pop(next(iter(entries))).close()
            self.evictions += 1

    def clear(self, device=None):
        """Drop this thread's entries on ``device`` (a torch.device or a
        string), or on every device."""
        by_device = self.local.__dict__.get("by_device", {})
        for name in list(by_device) if device is None else [str(device)]:
            entries = by_device.get(name, {})
            while entries:
                entries.popitem(last=False)[1].close()

    def held(self):
        """This thread's entries, on every device."""
        return sum(len(e) for e in
                   self.local.__dict__.get("by_device", {}).values())

    def info(self):
        """Hits, misses and evictions since the process started, and
        this thread's entries by device."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "entries": {d: len(e) for d, e in
                            self.local.__dict__.get("by_device",
                                                    {}).items()}}


def clear_loop_caches(device=None):
    """Drop this thread's entries of every ``LoopCache`` on ``device``
    (or on every device): the next call of each loop is a miss.  The
    flow solves' cache (flow/solvers.py) has its own
    ``clear_solve_cache``."""
    for cache in _caches:
        cache.clear(device)


# the other caches of graphs in the pools, emptied with the loops' when
# device memory runs out (flow/solvers.py's clear_solve_cache)
release_hooks = []


def _holds_memory():
    """Whether this thread holds cached entries or graph pools."""
    return (bool(_pools.__dict__.get("by_device"))
            or any(c.held() for c in _caches))


def release_device_memory():
    """Drop this thread's loop caches, the caches in ``release_hooks``
    and its graph pools (the next capture makes a new pool), and hand
    torch's cached blocks back to the device: a private pool's blocks go
    back only once every graph captured into it is gone."""
    clear_loop_caches()
    for hook in release_hooks:
        hook()
    _pools.__dict__.pop("by_device", None)
    _pools.__dict__.pop("retired", None)
    gc.collect()
    torch.cuda.empty_cache()


def frees_loop_caches(fn):
    """``fn``, which on running out of device memory while this thread
    holds cached entries or graph pools releases them
    (``release_device_memory()``) and runs once more; the times it did
    are counted in ``frees_loop_caches.frees``."""

    @functools.wraps(fn)
    def call(*args, **kw):
        try:
            return fn(*args, **kw)
        except OutOfMemoryError:
            if not _holds_memory():
                raise
        # out of the handler, so the failed run's frames are gone
        release_device_memory()
        frees_loop_caches.frees += 1
        return fn(*args, **kw)

    return call


frees_loop_caches.frees = 0


class CachedGrow(CachedLoop):
    """An entry of a grower's ``LoopCache``: a subclass makes the
    grower's state and input buffers and its ``steps``, which read
    nothing else; this holds what ``graph_loop`` builds around them at
    the entry's first grow of two passes or more (the steps captured
    once, uninstantiated, the instantiated while graph and its three
    device words), and the ``GraphLoop`` that captured them.  A later
    grow runs pass 1 eagerly and launches the same while graph
    (``set_while`` at its head re-arms the condition): it captures
    nothing.  A grow of 0 or 1 passes builds nothing."""

    def __init__(self, device):
        self.device = device
        self.done = None
        self.loop = None
        self.graphs = self.words = self.while_graph = None

    def graph_loop(self):
        """The entry's GraphLoop, made at its first graph-driven grow."""
        if self.loop is None:
            self.loop = GraphLoop(self.device)
        return self.loop

    def close(self):
        """Destroy the while graph and drop the steps' graphs, once the
        side stream has finished."""
        if self.loop is None:
            return
        self.loop.side.synchronize()
        graph, self.while_graph, self.graphs = self.while_graph, None, None
        if graph is not None:
            graph.close()
        self.loop.close()
