"""The growers' while graph: ops/grow_loop.py's ``graph_loop`` on
csrc/graph_while.cu (bound by ops/graph_while.py), the counterpart of
the JAX growers' ``lax.while_loop`` condition.

On the CPU, through the stand-ins of tests/test_torch_grow_loop.py
(torch.cuda's stream and graph calls, ``_FakeCuda``; the library's
entry points, ``FakeWhileLib``, which runs the captured steps while
stop < 0, as the WHILE and IF nodes do):

  * one and two steps for 0, 1, 2, 3, 7 and 8 passes: the steps run in
    turn, the first eagerly and the rest by one launch, each kernel
    counter counting what ran, min(passes, 2) + 1 host reads,
    ``replays`` (steps run from graphs) passes - 1, ``launches`` one per
    grow of 2+ passes, one capture per step (kept, ``keep_graph``), the
    while graph's two kernels counted (``set_while`` once before the
    WHILE node and once per iteration of it, ``count_step`` once per
    step) and the instantiated graph destroyed;
  * those two kernels' counters are what the kernels counted on the
    device (a graph without its head set_while shows one fewer);
  * a build, instantiation or launch that fails raises, with the
    library's message, and runs nothing more;
  * ``drive`` on CPU tensors still reads stop once per pass plus once;
  * ops/graph_while.py's ctypes signatures are the ``extern "C"``
    declarations of csrc/graph_while.cu, read from its text.

On a card (``gpu``, skipped here): a step holding an event record node
is refused, naming it.  (The growers' while route against the eager
loop, bit for bit, with its reads, launches and device-counted kernels,
is held on the card by tests/test_torch_kernels.py's
``test_graph_driven_growers_match_eager_loop`` and
``test_graph_driven_sharded_grower_matches_eager_loop``.)  This file
imports JAX only inside the CPU tests' fixture (through
tests/test_torch_grow_loop.py), so on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_grow_while.py
"""

import ctypes
import importlib
import os
import re

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import graph_while, grow_loop
from arterynetwork_tpu_torch.ops import region_grow_fused as rfu

# the module (the package exports a function of the same name)
rfr_mod = importlib.import_module(
    "arterynetwork_tpu_torch.ops.region_grow_frontier")

torch.set_num_threads(1)

PASSES = [0, 1, 2, 3, 7, 8]
CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "arterynetwork_tpu_torch", "csrc", "graph_while.cu")


@pytest.fixture
def fake(monkeypatch):
    """A function fail -> (fake torch.cuda, fake library) installed."""
    from .test_torch_grow_loop import _fake_torch

    return lambda fail=None: _fake_torch(monkeypatch, fail)


def _counters():
    return {"reads": grow_loop.read_stop.reads,
            "captures": grow_loop.graph_loop.captures,
            "replays": grow_loop.graph_loop.replays,
            "launches": grow_loop.graph_loop.launches,
            "set_while": graph_while.set_while.launches,
            "count_step": graph_while.count_step.launches,
            "k2": rfu.fused_sweep_counts.launches,
            "k5": rfr_mod.frontier_step.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _counters().items()}


def _steps(cuda, n_steps, stop, last, ran):
    """``n_steps`` steps; step k counts one launch of K2 (k = 0) or K5
    (k = 1) in Python, as the wrappers do, and enqueues its work: logs
    k and sets stop at run ``last``."""
    counters = [rfu.fused_sweep_counts, rfr_mod.frontier_step]

    def make(k):
        def work():
            ran.append(k)
            if len(ran) == last:
                stop.fill_(0)

        def step():
            counters[k].launches += 1
            if cuda.capturing is not None:
                cuda.capturing.ops.append(work)
            else:
                work()
        return step
    return [make(k) for k in range(n_steps)]


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("n_steps", [1, 2])
def test_while_route_bookkeeping(fake, n_steps, passes):
    cuda, lib = fake()
    stop = torch.tensor(0 if passes == 0 else -1, dtype=torch.int32)
    ran = []
    steps = _steps(cuda, n_steps, stop, passes, ran)
    before = _counters()
    assert grow_loop.graph_loop(steps, stop) == passes
    assert ran == [k % n_steps for k in range(passes)]
    looped = passes > 1
    runs = [sum(1 for k in ran if k == j) for j in range(2)]
    iterations = -(-(passes - 1) // n_steps) if looped else 0
    assert _delta(before) == {
        "reads": min(passes, 2) + 1, "captures": n_steps * looped,
        "replays": max(passes - 1, 0), "launches": int(looped),
        "set_while": (1 + iterations) * looped,
        "count_step": max(passes - 1, 0), "k2": runs[0], "k5": runs[1]}
    assert cuda.modes == [("pool", "thread_local")] * (n_steps * looped)
    assert all(g.keep for g in cuda.made.values())
    # the launch's own order: set_while, then per iteration its steps'
    # count_steps and a set_while
    want = ["set_while"]
    for i in range(iterations):
        n = min(n_steps, passes - 1 - i * n_steps)
        want += ["count_step"] * n + ["set_while"]
    assert lib.log == (want if looped else [])
    assert len(lib.destroyed) == int(looped)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_while_kernel_counts_are_the_devices(fake, n_steps):
    """``set_while.launches`` and ``count_step.launches`` take what the
    kernels counted on the device: a while graph without its head
    set_while node shows one launch fewer."""
    cuda, lib = fake()
    launch = lib.graph_while_launch

    def headless(exec_, stream, err, err_len):
        rc = launch(exec_, stream, err, err_len)
        (ctypes.c_int32 * 2).from_address(lib.execs[exec_][2])[1] -= 1
        return rc

    lib.graph_while_launch = headless
    stop = torch.tensor(-1, dtype=torch.int32)
    steps = _steps(cuda, n_steps, stop, 7, [])
    before = _counters()
    assert grow_loop.graph_loop(steps, stop) == 7
    d = _delta(before)
    assert (d["set_while"], d["count_step"], d["replays"]) == (
        -(-6 // n_steps), 6, 6)


@pytest.mark.parametrize("fail", ["build", "instantiate", "launch"])
def test_while_route_raises_and_runs_nothing_more(fake, fail):
    cuda, lib = fake(fail)
    stop = torch.tensor(-1, dtype=torch.int32)
    ran = []
    steps = _steps(cuda, 2, stop, 7, ran)
    before = _counters()
    with pytest.raises(RuntimeError, match=re.escape(
            lib.ERRORS[fail][1].decode()[:40])):
        grow_loop.graph_loop(steps, stop)
    assert ran == [0]                          # the eager pass alone
    d = _delta(before)
    assert (d["reads"], d["launches"], d["replays"], d["set_while"],
            d["count_step"], d["k2"], d["k5"]) == (2, 0, 0, 0, 0, 1, 0)
    assert d["captures"] == 2
    assert int(stop) == -1 and not lib.log
    # a graph that was built is destroyed, one that was not is not
    assert len(lib.destroyed) == (fail == "launch")


@pytest.mark.parametrize("passes", [0, 1, 2, 7])
def test_cpu_drive_reads_per_pass(passes):
    """CPU tensors take host_loop: passes + 1 reads, no while graph."""
    stop = torch.tensor(0 if passes == 0 else -1, dtype=torch.int32)
    ran = []

    def step(k):
        ran.append(k)
        if len(ran) == passes:
            stop.fill_(0)

    before = _counters()
    n = grow_loop.drive([lambda: step(0), lambda: step(1)], stop)
    assert n == passes and ran == [k % 2 for k in range(passes)]
    d = _delta(before)
    assert (d["reads"], d["launches"], d["captures"], d["set_while"]) \
        == (passes + 1, 0, 0, 0)


_CTYPES = {"int": ctypes.c_int, "char*": ctypes.c_char_p}


def _c_signatures(text):
    """{name: [ctypes type]} of the ``extern "C" int name(...)``
    declarations in ``text``: pointers are c_void_p, ``char*`` c_char_p,
    ``int`` c_int."""
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for arg in args.split(","):
            t = " ".join(arg.split()[:-1]).replace("const ", "")
            t = t.replace(" *", "*").replace(" ", "")
            types.append(_CTYPES.get(t, ctypes.c_void_p if "*" in t
                                     else None))
        out[name] = types
    return out


def test_signatures_match_the_source():
    with open(CSRC) as f:
        declared = _c_signatures(f.read())
    assert set(declared) == set(graph_while.SIGNATURES)
    for name, types in declared.items():
        assert None not in types, (name, types)
        assert graph_while.SIGNATURES[name] == types, name


# ----------------------------------------------------------------------
# on a card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the while graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_while_graph_refuses_an_event_record_node(cuda):
    """A step whose graph holds a node a conditional body may not hold
    (an event record) is refused at the build, naming its type and
    step; nothing is launched."""
    x = torch.zeros(4, device=cuda)
    runs = torch.zeros((), dtype=torch.int32, device=cuda)
    stop = torch.full((), -1, dtype=torch.int32, device=cuda)
    ev = torch.cuda.Event(external=True)

    def step():
        x.add_(1)
        ev.record()
        runs.add_(1)
        stop.copy_(torch.where(runs >= 5, 0, -1).to(torch.int32))

    l0 = grow_loop.graph_loop.launches
    with pytest.raises(RuntimeError,
                       match="step 0 holds a node of type 'event record'"):
        grow_loop.graph_loop([step, step], stop)
    torch.cuda.synchronize()
    assert grow_loop.graph_loop.launches == l0
    assert np.array_equal(x.cpu().numpy(), np.ones(4, np.float32))
