"""The growers' loop (ops/grow_loop.py) on the CPU.

Each grower writes its iteration once, as a step that updates fixed
buffers in place, and ``grow_loop.drive`` runs it: replayed from
captured CUDA graphs on a card, in ``host_loop`` here.  Held here, on
bench.py's tube phantom at 48^3 and at a ragged (40, 37, 45) (Y and X
off every tiling), for every stop reason (converged, size cap,
iteration cap, a seed already at the cap: no iteration):

  * the fused grower (K2's plain version; its step sweeps from one seg
    buffer into the other, so the loop alternates two step closures,
    A -> B and B -> A, as the two graphs alternate on a card), the
    frontier grower (K5's), the full-grid grower and the full-grid
    grower with an excluded slab across the tube (which the front partly
    wakes), each equal (mask,
    active map, iterations, count, stop reason) to the loop the port ran
    before its steps wrote in place (a copy below, ``_rebinding_*``:
    every iteration binds new tensors) and to the JAX package's
    ``_region_grow_xla``;
  * one host read of ``stop`` per iteration plus one, and no launch;
  * ``host_loop`` alternating its steps, and ``drive`` taking it for CPU
    tensors;
  * ``graph_loop``'s bookkeeping, with a stand-in for torch.cuda's stream
    and graph calls (a "captured" step is recorded, and runs when the
    stand-in of csrc/graph_while.cu's library, ``FakeWhileLib``, runs
    the while graph): the first step eager, each step captured once and
    run in turn while stop < 0 by one launch, the launch counters
    counting runs and not captures, min(passes, 2) + 1 stop reads, and a
    step that cannot be captured raising (tests/test_torch_grow_while.py
    has the rest of the while route's bookkeeping).

The CUDA graphs themselves need a card: the ``gpu`` tests in
tests/test_torch_kernels.py and tests/test_torch_grow_while.py hold the
graph-driven growers to this eager loop there.
"""

import contextlib
import ctypes
import functools
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arterynetwork_tpu.ops.region_grow import _region_grow_xla as j_xla
from arterynetwork_tpu_torch.ops import graph_while, grow_loop
from arterynetwork_tpu_torch.ops import region_grow_fused as rfu
from arterynetwork_tpu_torch.ops.histogram import (masked_histogram_one,
                                                   masked_histograms_best,
                                                   sign_lookup)
from arterynetwork_tpu_torch.ops.stencil import dilate26
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

# the modules (the package exports functions of the same names)
rg = importlib.import_module("arterynetwork_tpu_torch.ops.region_grow")
rfr = importlib.import_module("arterynetwork_tpu_torch.ops.region_grow_frontier")

torch.set_num_threads(1)

SHAPES = [(48, 48, 48), (40, 37, 45)]
# the tube converges in 21-23 iterations at 1,125-1,200 voxels; its seed
# is the 27-voxel cube
STOPS = {"converged": ({"max_segment_size": 10 ** 6, "iter_max": 300}, 0),
         "size_cap": ({"max_segment_size": 600, "iter_max": 300}, 1),
         "iter_cap": ({"max_segment_size": 10 ** 6, "iter_max": 5}, 2),
         "seed_at_cap": ({"max_segment_size": 27, "iter_max": 300}, 1)}
GROWERS = ["fused", "frontier", "xla", "xla_excluded"]


@functools.lru_cache(maxsize=None)
def _case(shape):
    vol, seed = tube_phantom(shape)
    excluded = np.zeros(shape, bool)
    excluded[:, :, 30:34] = True        # across the tube, 4 planes
    return vol, seed, excluded


@functools.lru_cache(maxsize=None)
def _jax(shape, stop, excluded):
    vol, seed, ex = _case(shape)
    r = j_xla(jnp.asarray(vol), jnp.asarray(seed),
              jnp.asarray(ex) if excluded else None, **STOPS[stop][0])
    return tuple(np.asarray(x) for x in (r.segmented_map, r.active_map,
                                         r.iterations, r.segmented_count,
                                         r.stop_reason))


def _key(r):
    return tuple(np.asarray(x) for x in (r.segmented_map, r.active_map,
                                         r.iterations, r.segmented_count,
                                         r.stop_reason))


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# the loops before their steps wrote in place (a new tensor bound per
# update each iteration), kept as the reference
# ----------------------------------------------------------------------
def _rebinding_fused(data, seed0, max_segment_size, iter_max, H=2.25):
    bin_idx, bin_values = rg._quantize(data, 256)
    bins = rg._bin_ids(bin_idx, 256).contiguous()
    flat = bins.reshape(-1)
    K = rg._gaussian_kernel(bin_values, H, torch.float32)
    hist_all = masked_histogram_one(flat, torch.ones_like(flat,
                                                          dtype=torch.bool))
    inner = masked_histogram_one(flat, seed0.reshape(-1)).to(torch.int32)
    seg = seed0.to(torch.uint8).contiguous()
    count = torch.sum(seed0, dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)
    while int(stop) < 0:
        inner_f = inner.to(torch.float32)
        diff = rg._decision_table(K, inner_f, hist_all - inner_f)
        seg, dh = rfu.fused_sweep_counts(seg, bins,
                                         rfu.pack_sign_words(diff))
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner = inner + dh[0] - dh[1]
        count = count + n_pos - n_neg
        it = it + (~converged).to(torch.int32)
        stop = rg._stop_code(converged, count >= max_segment_size, it,
                             iter_max)
    seg = seg != 0
    return rg.RegionGrowResult(seg, torch.ones_like(seg), it, count, stop)


def _rebinding_frontier(data, seed0, max_segment_size, iter_max, H=2.25,
                        tile=(8, 16), k_max=256, nb=1):
    ntz, nty = rfr._tile_grid(data.shape, tile)
    NT = ntz * nty
    k_max = min(k_max, NT)
    bin_idx, bin_values = rg._quantize(data, 256)
    bins = rg._bin_ids(bin_idx, 256).contiguous()
    flat = bins.reshape(-1)
    hist_all = masked_histogram_one(flat, torch.ones_like(flat,
                                                          dtype=torch.bool))
    inner = masked_histogram_one(flat, seed0.reshape(-1)).to(torch.int32)
    K = rg._gaussian_kernel(bin_values, H, torch.float32)
    active = rfr._per_tile(dilate26(seed0) & dilate26(~seed0), tile) > 0
    seg = seed0.to(torch.uint8).contiguous()
    nact_cap = torch.tensor(k_max, dtype=torch.int64)
    slots = torch.arange(k_max)
    it = torch.zeros((), dtype=torch.int32)
    stop = torch.where(torch.sum(inner) >= max_segment_size, 1,
                       -1).to(torch.int32)
    while int(stop) < 0:
        inner_f = inner.to(torch.float32)
        diff = rg._decision_table(K, inner_f, hist_all - inner_f)
        n_active = torch.sum(active)
        ids = rfr._compact(active, k_max)
        nact = torch.minimum(n_active, nact_cap)
        dhist, flags = rfr.frontier_step(seg, bins, ids,
                                         nact.to(torch.int32).reshape(1),
                                         rfu.pack_sign_words(diff), tile, nb)
        valid = slots < nact
        nf = flags[:, 0] * valid
        hb = flags[:, 1] * valid
        tid = ids.long()
        zeros = torch.zeros(NT, dtype=torch.int32)
        flipped = zeros.scatter_reduce(0, tid, nf, "amax") > 0
        keep = zeros.scatter_reduce(0, tid, hb, "amax") > 0
        proc = zeros.scatter_reduce(0, tid, valid.to(torch.int32),
                                    "amax") > 0
        active = ((active & ~proc) | keep
                  | dilate26(flipped.reshape(ntz, nty)).reshape(-1))
        inner = inner + dhist
        converged = (torch.sum(nf) == 0) & (n_active <= k_max)
        it = it + (~converged).to(torch.int32)
        stop = rg._stop_code(converged, torch.sum(inner) >= max_segment_size,
                             it, iter_max)
    seg = seg != 0
    return rg.RegionGrowResult(seg, torch.ones_like(seg), it,
                               torch.sum(seg, dtype=torch.int32), stop)


def _rebinding_xla(data, seg, excluded, max_segment_size, iter_max,
                   H=2.25):
    track = excluded is not None
    active = ~excluded if track else torch.ones_like(seg)
    active = active | dilate26(seg)
    bin_idx, bin_values = rg._quantize(data, 256)
    bins = rg._bin_ids(bin_idx, 256)
    flat = bins.reshape(-1)
    K = rg._gaussian_kernel(bin_values, H, torch.float32)
    hist_all = masked_histogram_one(flat, torch.ones_like(flat,
                                                          dtype=torch.bool))
    count = torch.sum(seg, dtype=torch.int32)
    it = torch.zeros((), dtype=torch.int32)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)
    while int(stop) < 0:
        if track:
            bnd = (seg & dilate26(~seg)) | ((~seg) & active & dilate26(seg))
            h = masked_histograms_best(flat, torch.stack(
                [seg.reshape(-1), ((~seg) & active).reshape(-1)]))
            inner_hist, outer_hist = h[0], h[1]
        else:
            bnd = dilate26(seg) & dilate26(~seg)
            inner_hist = masked_histogram_one(flat, seg.reshape(-1))
            outer_hist = hist_all - inner_hist
        diff = rg._decision_table(K, inner_hist, outer_hist)
        flips = bnd & torch.logical_xor(seg, sign_lookup(bins, diff))
        n_pos = torch.sum(flips & ~seg, dtype=torch.int32)
        n_neg = torch.sum(flips & seg, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        seg = torch.logical_xor(seg, flips)
        if track:
            active = active | dilate26(dilate26(flips))
        count = count + n_pos - n_neg
        it = it + (~converged).to(torch.int32)
        stop = rg._stop_code(converged, count >= max_segment_size, it,
                             iter_max)
    return rg.RegionGrowResult(seg, active, it, count, stop)


def _run(grower, shape, stop):
    """(port's result, rebinding loop's result) on the CPU."""
    vol, seed, ex = _case(shape)
    kw = STOPS[stop][0]
    data, sd = torch.from_numpy(vol), torch.from_numpy(seed)
    if grower == "fused":
        return (rfu.region_grow_fused(data, sd, device="cpu", **kw),
                _rebinding_fused(data, sd, **kw))
    if grower == "frontier":
        return (rfr.region_grow_frontier(data, sd, device="cpu", **kw),
                _rebinding_frontier(data, sd, **kw))
    exc = torch.from_numpy(ex) if grower == "xla_excluded" else None
    return (rg.region_grow(data, sd, exc, backend="xla", device="cpu", **kw),
            _rebinding_xla(data, sd, exc, **kw))


@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("shape", SHAPES, ids=["48", "ragged"])
@pytest.mark.parametrize("grower", GROWERS)
def test_in_place_steps_match_rebinding_loop_and_jax(grower, shape, stop):
    grow_loop.read_stop.reads = 0
    launches = rfu.fused_sweep_counts.launches + rfr.frontier_step.launches
    out, ref = _run(grower, shape, stop)
    assert _same(_key(out), _key(ref))
    assert _same(_key(out), _jax(shape, stop, grower == "xla_excluded"))
    assert int(out.stop_reason) == STOPS[stop][1]
    passes = int(out.iterations) + (int(out.stop_reason) == 0)
    if stop == "seed_at_cap":
        assert passes == 0
    # (the rebinding loop reads stop with int(), not through grow_loop)
    assert grow_loop.read_stop.reads == passes + 1
    assert rfu.fused_sweep_counts.launches + rfr.frontier_step.launches \
        == launches


@pytest.mark.parametrize("stop", ["converged", "size_cap", "iter_cap"])
def test_excluded_slab_moves_the_active_map(stop):
    """The excluded case must exercise the active map's updates: the
    front wakes part of the slab (reference state 4 -> 3) and leaves the
    rest excluded."""
    vol, seed, ex = _case(SHAPES[0])
    cut = rg.region_grow(vol, seed, ex, backend="xla", device="cpu",
                         **STOPS[stop][0])
    asleep = int((~cut.active_map).sum())
    assert 0 < asleep < int(ex.sum())
    assert not (~cut.active_map.numpy() & ~ex).any()


def test_grower_leaves_its_inputs_alone():
    """The in-place steps write only the grower's own buffers: a bool
    seed tensor on the grower's device is the caller's."""
    vol, seed, ex = _case(SHAPES[1])
    sd, exc = torch.from_numpy(seed.copy()), torch.from_numpy(ex.copy())
    for fn in (lambda: rg.region_grow(vol, sd, exc, backend="xla",
                                      device="cpu"),
               lambda: rg.region_grow(vol, sd, backend="xla", device="cpu"),
               lambda: rfu.region_grow_fused(vol, sd, device="cpu"),
               lambda: rfr.region_grow_frontier(vol, sd, device="cpu")):
        fn()
        assert np.array_equal(sd.numpy(), seed)
        assert np.array_equal(exc.numpy(), ex)


def test_host_loop_alternates_steps_and_reads_stop_per_iteration():
    stop = torch.tensor(-1, dtype=torch.int32)
    ran = []

    def step(k):
        ran.append(k)
        if len(ran) == 5:
            stop.fill_(2)

    grow_loop.read_stop.reads = 0
    n = grow_loop.host_loop([lambda: step("ab"), lambda: step("ba")], stop)
    assert n == 5 and ran == ["ab", "ba", "ab", "ba", "ab"]
    assert grow_loop.read_stop.reads == 6
    assert grow_loop.host_loop([lambda: step("x")], stop) == 0


def test_drive_takes_the_host_loop_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(grow_loop, "graph_loop",
                        lambda *a: calls.append(a))
    stop = torch.tensor(1, dtype=torch.int32)
    assert grow_loop.drive([lambda: None], stop) == 0
    assert not calls


class _FakeCuda:
    """torch.cuda's stream and graph calls as graph_loop makes them, on
    the CPU.  Between capture_begin and capture_end ``capturing`` is the
    graph, and what would be enqueued (a step, a copy into the pinned
    word) is appended to its ops instead of run; a replay runs the ops
    with ``replaying`` set (no Python of a step's own runs there).
    ``made`` maps each graph's ``raw_cuda_graph()`` handle to it."""

    class _Stream:
        cuda_stream = 0

        def wait_stream(self, other):
            pass

        def synchronize(self):
            pass

    class _Graph:
        def __init__(self, cuda, keep_graph):
            self.cuda, self.ops, self.keep = cuda, [], keep_graph
            cuda.made[id(self)] = self

        def capture_begin(self, pool, capture_error_mode):
            self.cuda.modes.append((pool, capture_error_mode))
            self.cuda.capturing = self

        def capture_end(self):
            self.cuda.capturing = None

        def raw_cuda_graph(self):
            assert self.keep, "raw_cuda_graph needs keep_graph=True"
            return id(self)

        def replay(self):
            self.cuda.replaying = True
            try:
                for op in self.ops:
                    op()
            finally:
                self.cuda.replaying = False

    class _Pinned:
        """The pinned words: a copy into them is enqueued like a
        kernel."""

        def __init__(self, cuda, n=1):
            self.cuda, self.word = cuda, np.zeros(n, np.int32)

        def copy_(self, src, non_blocking=False):
            def op():
                self.word[:] = src.numpy()
            if self.cuda.capturing is not None:
                self.cuda.capturing.ops.append(op)
            else:
                op()

        def __getitem__(self, i):
            return self.word[i]

    def __init__(self):
        self.capturing, self.replaying, self.modes = None, False, []
        self.made = {}

    def Stream(self, device=None):
        return self._Stream()

    current_stream = Stream

    def device(self, device):
        return contextlib.nullcontext()

    def stream(self, stream):
        return contextlib.nullcontext()

    def graph_pool_handle(self):
        return "pool"

    def CUDAGraph(self, keep_graph=False):
        return self._Graph(self, keep_graph)


class FakeWhileLib:
    """csrc/graph_while.cu's entry points on the CPU, called as
    ops/graph_while.py calls them: a build looks each step's graph up by
    its raw handle (``graph_of``); a launch runs what the while graph
    runs (set_while; while stop < 0: step 0, count_step, and for two
    steps, if stop < 0, step 1 and count_step; set_while), reading stop
    and adding to the two counts (count_step's, set_while's) at their
    device pointers, as the kernels do, and logs it.
    ``fail`` ("build", "instantiate" or "launch") makes that call return
    an error with a message, as the library does."""

    ERRORS = {"build": (801, b"step 0 holds a node of type 'host' (3), "
                             b"which the body of a conditional node may "
                             b"not hold"),
              "instantiate": (1, b"cudaGraphInstantiate: invalid argument "
                                 b"(CUDA error 1)"),
              "launch": (700, b"cudaGraphLaunch: an illegal memory access "
                              b"was encountered (CUDA error 700)")}

    def __init__(self, graph_of, fail=None):
        self.graph_of, self.fail = graph_of, fail
        self.execs, self.log, self.destroyed = {}, [], []

    def _failed(self, what, err):
        rc, msg = self.ERRORS[what]
        err.value = msg
        return rc

    def graph_while_build(self, steps, n_steps, stop, counts, out, err,
                          err_len):
        graphs = [self.graph_of(steps[i]) for i in range(n_steps)]
        if self.fail in ("build", "instantiate"):
            return self._failed(self.fail, err)
        out[0], out[1] = 2 * len(self.execs) + 2, 2 * len(self.execs) + 3
        self.execs[out[0]] = (graphs, stop, counts)
        return 0

    def graph_while_launch(self, exec_, stream, err, err_len):
        if self.fail == "launch":
            return self._failed("launch", err)
        graphs, stop, counts = self.execs[exec_]
        s = ctypes.c_int32.from_address(stop)
        c = (ctypes.c_int32 * 2).from_address(counts)

        def set_while():
            c[1] += 1
            self.log.append("set_while")
            return s.value < 0

        while set_while():
            for k, g in enumerate(graphs):
                if k and s.value >= 0:
                    break
                g.replay()
                c[0] += 1
                self.log.append("count_step")
        return 0

    def graph_while_destroy(self, exec_, graph, err, err_len):
        self.destroyed.append((exec_, graph))
        return 0


def _fake_torch(monkeypatch, fail=None):
    """graph_loop's torch on ``_FakeCuda`` and its while-graph library on
    ``FakeWhileLib`` -> (the fake torch.cuda, the fake library)."""
    fake = _FakeCuda()
    monkeypatch.setattr(grow_loop, "torch", types.SimpleNamespace(
        cuda=fake, int32=torch.int32,
        empty=lambda *a, pin_memory=False, **k: fake._Pinned(fake, *a)))
    lib = FakeWhileLib(fake.made.__getitem__, fail)
    monkeypatch.setattr(graph_while, "_lib", lambda: lib)
    return fake, lib


def _counted_step(name, fake, ran, stop, last):
    """A step that counts one K2 launch in Python, as the wrapper does,
    and enqueues its work: appends ``name`` and sets stop at run
    ``last``."""
    def work():
        ran.append(name)
        if len(ran) == last:
            stop.fill_(0)

    def step():
        rfu.fused_sweep_counts.launches += 1
        if fake.capturing is not None:
            fake.capturing.ops.append(work)
        else:
            work()
    return step


@pytest.mark.parametrize("last", [0, 1, 2, 7])
def test_graph_loop_bookkeeping(monkeypatch, last):
    fake, _ = _fake_torch(monkeypatch)
    stop = torch.tensor(0 if last == 0 else -1, dtype=torch.int32)
    ran = []
    steps = [_counted_step("ab", fake, ran, stop, last),
             _counted_step("ba", fake, ran, stop, last)]
    grow_loop.read_stop.reads = 0
    grow_loop.graph_loop.captures = grow_loop.graph_loop.replays = 0
    n0 = rfu.fused_sweep_counts.launches
    assert grow_loop.graph_loop(steps, stop) == last
    assert ran == ["ab", "ba"] * (last // 2) + ["ab"] * (last % 2)
    assert rfu.fused_sweep_counts.launches - n0 == last
    assert grow_loop.read_stop.reads == min(last, 2) + 1
    assert grow_loop.graph_loop.replays == max(last - 1, 0)
    assert grow_loop.graph_loop.captures == (2 if last > 1 else 0)
    assert fake.modes == [("pool", "thread_local")] * (2 if last > 1 else 0)


def test_graph_loop_raises_when_capture_fails(monkeypatch):
    fake, _ = _fake_torch(monkeypatch)
    stop = torch.tensor(-1, dtype=torch.int32)

    def step():
        if fake.capturing is not None:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        grow_loop.graph_loop([step], stop)
    assert fake.capturing is None          # the capture was ended
