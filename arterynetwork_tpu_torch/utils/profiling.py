"""Tracing and profiling utilities.

Port of the JAX package's utils/profiling.py.  The reference's
observability is wall-clock prints at entry points; here the same role
is filled by a structured stage timer plus a ``torch.profiler`` trace of
the host and the card:

* ``device_sync`` waits for the work behind a tensor (or a nested
  structure of tensors): ``torch.cuda.synchronize`` on each CUDA device it
  finds, nothing for host tensors and arrays;
* ``StageTimer`` accumulates wall-clock seconds and calls per stage,
  optionally synchronizing on a value before the clock stops;
* ``device_trace`` records a ``torch.profiler`` trace and writes it as a
  Chrome trace file (``trace.json``) into ``log_dir``; it needs no
  tensorboard package (``export_chrome_trace`` is part of torch).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


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


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {name: {"seconds": self.seconds[name],
                       "calls": self.counts[name]}
                for name in self.seconds}


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
