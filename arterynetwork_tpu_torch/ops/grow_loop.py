"""The region growers' loop, the counterpart of the JAX growers'
``lax.while_loop`` (arterynetwork_tpu/ops/region_grow.py:250,
region_grow_fused.py:297, region_grow_frontier.py:564).

A grower writes its iteration once, as step functions that read their
state from tensors made before the loop and write the new state back
into them in place, and keeps an int32 scalar ``stop`` on its device
(-1: go on; else the stop reason).  ``drive`` runs the steps in turn,
``steps[0]``, ``steps[1]``, ... (a grower that sweeps from one buffer
into another gives two steps, A -> B and B -> A), while ``stop`` < 0,
and returns how many ran:

* CPU tensors take ``host_loop``: a plain loop that reads ``stop`` once
  per iteration;
* CUDA tensors take ``graph_loop``, on a side stream: iteration 1 runs
  eagerly, which also warms up what capture cannot do (cuBLAS's
  workspace for ``K @ hist``, the kernels' one-time attribute calls);
  then each step is captured once as a CUDA graph, all in one memory
  pool, and the graphs are replayed in turn, one iteration per replay.
  ``stop`` is read once before the loop and once after each iteration,
  through a pinned host word.  A failed capture raises: there is no
  fallback to the eager loop.

So a grow reads ``stop`` (iterations run + 1) times, the JAX loop's
passes one by one.  Graphs are captured anew on every call and dropped
at its end, so no pointer outlives the buffers of the call.

The kernels' wrappers count their launches in Python, which runs once,
while a step is captured.  ``graph_loop`` takes out what a capture added
to each counter and adds it back once per replay, so a counter counts
the launches that ran.  ``read_stop.reads`` counts host reads of
``stop``, ``graph_loop.captures`` the graphs captured and
``graph_loop.replays`` the replays.
"""

from __future__ import annotations

import torch


def read_stop(stop, pinned=None):
    """``stop`` on the host: ``int(stop)``, or, with a pinned host word,
    a non-blocking copy into it and a synchronise of the current
    stream."""
    read_stop.reads += 1
    if pinned is None:
        return int(stop)
    pinned.copy_(stop.reshape(1), non_blocking=True)
    torch.cuda.current_stream(stop.device).synchronize()
    return int(pinned[0])


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


def _capture(step, pool, wrappers):
    """``step`` captured on the current (side) stream into ``pool`` ->
    (graph, launches the capture counted, by wrapper); the counters are
    left as they were."""
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    # thread_local: another thread of the caller may use the card
    # meanwhile; this thread's unsafe calls still raise
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        step()
    except BaseException:
        try:
            graph.capture_end()     # leave capture mode; the step's error
        except RuntimeError:        # is the one to report
            pass
        raise
    graph.capture_end()
    graph_loop.captures += 1
    added = [w.launches - b for w, b in zip(wrappers, before)]
    for w, b in zip(wrappers, before):
        w.launches = b
    return graph, added


def graph_loop(steps, stop):
    """Run ``steps`` in turn while ``stop`` < 0: the first eagerly, then
    each captured once as a CUDA graph and replayed -> steps run."""
    dev = stop.device
    pinned = torch.empty(1, dtype=torch.int32, pin_memory=True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.device(dev), torch.cuda.stream(side):
        if read_stop(stop, pinned) >= 0:
            return 0
        steps[0]()
        if read_stop(stop, pinned) >= 0:
            return 1
        wrappers = _counted()
        pool = torch.cuda.graph_pool_handle()
        order = steps[1:] + steps[:1]
        graphs = [_capture(s, pool, wrappers) for s in order]
        n = 1
        while True:
            graph, added = graphs[(n - 1) % len(graphs)]
            graph.replay()
            graph_loop.replays += 1
            for w, a in zip(wrappers, added):
                w.launches += a
            n += 1
            if read_stop(stop, pinned) >= 0:
                return n


graph_loop.captures = 0
graph_loop.replays = 0


def drive(steps, stop):
    """Run a grower's ``steps`` in turn while its ``stop`` < 0 -> steps
    run: ``graph_loop`` on a CUDA device, ``host_loop`` on the CPU."""
    if stop.device.type == "cuda":
        return graph_loop(steps, stop)
    return host_loop(steps, stop)
