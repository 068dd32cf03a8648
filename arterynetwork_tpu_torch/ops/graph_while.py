"""Binding of ``csrc/graph_while.cu``: a grower's loop as one CUDA graph
with a conditional WHILE node (the counterpart of the JAX growers'
``lax.while_loop`` condition; see ops/grow_loop.py's ``graph_loop``).

``WhileGraph(steps, stop, counts)`` builds and instantiates, around the
raw ``cudaGraph_t`` of each captured step (1 or 2, from
``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``), the graph

    set_while -> WHILE [ step 0 -> count_step
                         (-> IF [ step 1 -> count_step ]) -> set_while ]

on the device int32 ``stop`` (< 0: go on) and two device int32
``counts``: ``count_step``'s launches (the steps run) and ``set_while``'s
launches, each added to by its kernel where it runs; ``launch(stream)``
launches it once; ``close()`` destroys it.  A build, instantiation or launch that fails raises RuntimeError
with the library's message (a step holding a node a conditional body
may not hold names the node type and the step).  ``describe(graph)``
counts a graph's node types.

The two kernels are launched by the device inside the graph, so the
caller adds to their Python counters, ``set_while.launches`` and
``count_step.launches``, what the kernels counted on the device in
``counts``.  The functions themselves are the kernels' plain versions:
what each adds to its count and writes into its conditional handle.
"""

from __future__ import annotations

import ctypes

from . import cuda_build

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p

# the C entry points' argument types, in csrc/graph_while.cu's order
SIGNATURES = {
    "graph_while_build": [_P, _I, _P, _P, _P, _S, _I],
    "graph_while_launch": [_P, _P, _S, _I],
    "graph_while_destroy": [_P, _P, _S, _I],
    "graph_while_describe": [_P, _S, _I],
}
_ERR_LEN = 512


def _lib():
    return cuda_build.load("graph_while", **SIGNATURES)


def set_while(launches, stop):
    """The plain version of the ``set_while`` kernel: ``launches`` + 1,
    and the WHILE node's condition, 1 while ``stop`` < 0, else 0."""
    return int(launches) + 1, int(int(stop) < 0)


def count_step(count, stop, set_if):
    """The plain version of the ``count_step`` kernel: ``count`` + 1, and
    the IF node's condition (1 while ``stop`` < 0) when ``set_if``."""
    return int(count) + 1, (int(int(stop) < 0) if set_if else None)


set_while.launches = 0
count_step.launches = 0


def _message(buf, rc, what):
    text = buf.value.decode(errors="replace") or f"CUDA error {rc}"
    return f"{what} failed: {text}"


class WhileGraph:
    """The instantiated while graph around ``steps`` (raw cudaGraph_t
    handles, ints), on ``stop`` (an int32 device tensor of one element)
    and ``counts`` (two contiguous int32 on the device, zeroed by the
    caller before a launch: steps run, set_while's launches)."""

    def __init__(self, steps, stop, counts, lib=None):
        self.lib = lib or _lib()
        self.exec = self.graph = None
        handles = (ctypes.c_void_p * len(steps))(*steps)
        out = (ctypes.c_void_p * 2)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self.lib.graph_while_build(handles, len(steps), stop.data_ptr(),
                                        counts.data_ptr(), out, err,
                                        _ERR_LEN)
        if rc:
            raise RuntimeError(_message(err, rc, "graph_while_build"))
        self.exec, self.graph = out[0], out[1]

    def launch(self, stream):
        """One launch on ``stream`` (a torch.cuda.Stream)."""
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self.lib.graph_while_launch(self.exec, stream.cuda_stream, err,
                                         _ERR_LEN)
        if rc:
            raise RuntimeError(_message(err, rc, "graph_while_launch"))

    def close(self):
        """Destroy the instantiated and the parent graph (after the
        stream that ran them has finished)."""
        if self.exec is None and self.graph is None:
            return
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self.lib.graph_while_destroy(self.exec, self.graph, err,
                                          _ERR_LEN)
        self.exec = self.graph = None
        if rc:
            raise RuntimeError(_message(err, rc, "graph_while_destroy"))


def describe(graph, lib=None):
    """The node types of ``graph`` (a raw cudaGraph_t), its child graphs
    walked, counted: e.g. "kernel 87, memset 1"."""
    lib = lib or _lib()
    text = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.graph_while_describe(graph, text, _ERR_LEN)
    if rc:
        raise RuntimeError(_message(text, rc, "graph_while_describe"))
    return text.value.decode()
