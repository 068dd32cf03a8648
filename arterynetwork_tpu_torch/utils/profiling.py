"""Tracing and profiling utilities.

Port of the JAX package's utils/profiling.py.  The reference's
observability is wall-clock prints at entry points; here the same role
is filled by one span mechanism plus a ``torch.profiler`` trace of the
host and the card:

* ``device_sync`` waits for the work behind a tensor (or a nested
  structure of tensors): ``torch.cuda.synchronize`` on each CUDA device it
  finds, nothing for host tensors and arrays;
* ``StageTimer`` accumulates wall-clock seconds and calls per key:
  ``timer.stage(key)`` times a block into that timer, optionally
  synchronizing on a value before the clock stops;
* ``span(key)`` times a block into the *active* timer, the one a caller
  installed with ``with timer.active():`` (a ``contextvars.ContextVar``),
  so code deep in the stack opens spans without a ``timings`` argument.
  With no active timer it records nothing.  ``run_pipeline`` installs
  its timer around the whole pipeline; its ``timings`` are the timer's
  ``{key: seconds}``, every key one of ``PORT_SPANS``;
* both, while a ``torch.profiler`` is active, also open a
  ``torch.profiler.record_function`` range named ``an.<key>`` on the
  profiler's clock, the clock of the device's events, so an idle gap of
  the card can be put down to the span it falls in.  With no profiler
  active no range is entered.  No name starts with ``bench.``: a
  benchmark reserves that prefix for its own spans;
* ``device_trace`` records a ``torch.profiler`` trace and writes it as a
  Chrome trace file (``trace.json``) into ``log_dir``; it needs no
  tensorboard package (``export_chrome_trace`` is part of torch).

A span is host code: never open one inside a step that a CUDA graph
captures (``ops/grow_loop.GraphLoop.capture`` opens its ``graph_capture``
span around the capture, not in it).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Dict

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# the prefix of every span's profiler range
PREFIX = "an."

# every key ``run_pipeline``'s spans may record in its ``timings``; the
# JAX package's pipeline records the ten in the first two lines
PORT_SPANS = frozenset({
    "vesselness", "vesselness_upload", "vesselness_compute",
    "segmentation", "segmentation_download", "segmentation_flood",
    "edt", "skeletonization", "graph", "flow",
    # the port's own
    "vesselness_pack", "vesselness_h2d", "thinning", "graph_segments",
    "graph_attrs", "inlet", "flow_network", "flow_boundary",
    "flow_system", "flow_solve", "flow_download", "graph_capture"})

_ACTIVE = contextvars.ContextVar("arterynetwork_tpu_torch_timer",
                                 default=None)


def _cuda_devices(x, out):
    if torch.is_tensor(x):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def device_sync(x):
    """Wait until the devices holding the tensors in ``x`` (a tensor, or
    dicts, lists and tuples of them) have finished their queued work.
    Returns ``x``."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


class Span:
    """One timed block: records its seconds into ``timer`` (if any) and,
    under an active profiler, opens the range ``an.<name>``.  After the
    block ``seconds`` holds its wall-clock time."""

    __slots__ = ("timer", "name", "sync_on", "seconds", "_range", "_t0")

    def __init__(self, timer, name, sync_on=None):
        self.timer = timer
        self.name = name
        self.sync_on = sync_on
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.sync_on is not None:
                device_sync(self.sync_on)
        finally:
            self.seconds = time.perf_counter() - self._t0
            if self.timer is not None:
                self.timer.add(self.name, self.seconds)
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
        return False


class StageTimer:
    """Accumulating per-key wall-clock timer."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def stage(self, name: str, sync_on=None) -> Span:
        """A span that records into this timer."""
        return Span(self, name, sync_on)

    @contextlib.contextmanager
    def active(self):
        """Make this the timer that ``span`` records into."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def report(self) -> Dict[str, dict]:
        return {name: {"seconds": self.seconds[name],
                       "calls": self.counts[name]}
                for name in self.seconds}


def span(name: str, sync_on=None) -> Span:
    """A span that records into the active timer (none: it records
    nothing, and still opens its profiler range)."""
    return Span(_ACTIVE.get(), name, sync_on)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where there is one, the card with
    ``torch.profiler``; on exit the trace is written to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler, whose ``key_averages()`` sums time by op."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
