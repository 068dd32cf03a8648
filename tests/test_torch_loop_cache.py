"""The device loops' caches (ops/grow_loop.py's ``LoopCache``): graphs
kept across calls of the same shapes, the counterpart of ``jax.jit``'s
cache, for ``distribute_flow``, the device thinning, the sharded
thinning, the components and the four growers (the full grid, with and
without an excluded mask, the fused sweep, the frontier tiles and the
sharded fused grower).

Every tensor a loop's steps read lies in a cached entry, and a call
copies its inputs into it before any step runs.  Held here on the CPU,
where the entries run their steps eagerly and are kept as on a card
(``CachedLoop.kept`` made true; with its own answer the CPU keeps none,
which one test checks) (the thinnings on the table
route, the native table served on the CPU; the sharded stages on a 2x2
mesh of CPU slots, their "graph" route forced), at small sizes (a depth-5
tree, (12, 14, 16) masks, (20, 24, 28) components, 48^3 and (12, 18, 20)
growers):

  * the sequences A, B, A and A, A, B with A's shapes and other data
    (another tree's radii and targets, another random mask, the tube's
    noise drawn from another seed): each result bit-equal to the same
    call with the caches cleared before it, the warm calls hits;
  * an earlier result unchanged by later calls: no result is an entry's
    tensor;
  * a different shape or static argument takes a new entry, and past the
    cache's size the least recent entry goes;
  * ``_LUTS.clear()`` drops the thinnings' entries, and
    ``clear_loop_caches()`` every cache's;
  * a wrapped call that runs out of device memory while entries are
    held empties the caches and runs once more;
  * one warm call of each loop against the JAX package: the thinning
    (both) and the components exactly, ``distribute_flow`` within
    tests/test_torch_distribute.py's 1e-12, the growers exactly;
  * through ``GraphLoop`` with tests/test_torch_solve_loop.py's stand-in
    for torch.cuda's graph calls (a capture records the aten ops, a
    replay runs them again on the tensors they were recorded with) and,
    for the sharded grower, tests/test_torch_grow_loop.py's stand-in of
    the while graph's library: the warm calls capture nothing and replay
    every step (the grower: launch the entry's while graph again), and
    still give a fresh call's bits, so no graph reads a tensor of the
    call that captured it; a step that cannot be captured raises and
    drops the entry; a warm grow under torch.profiler builds a while
    graph of its own for the trace and destroys it after.

The ``gpu`` tests run A, B, A on the card, graph-driven against the
eager loop, and a loop that captures after a capture that failed (the
graph pool is retired and a new one made).
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.flow import distribute as pd
from arterynetwork_tpu_torch.graphs import (generate_tree,
                                            set_network_properties)
from arterynetwork_tpu_torch.ops import cc as tcc
from arterynetwork_tpu_torch.ops import graph_while, grow_loop
from arterynetwork_tpu_torch.ops import region_grow_fused as rfu
from arterynetwork_tpu_torch.ops import simple_point as tsp
from arterynetwork_tpu_torch.ops import thinning as tt
from arterynetwork_tpu_torch.parallel import sharded
from arterynetwork_tpu_torch.parallel.halo import (ShardedVolume,
                                                   make_volume_mesh,
                                                   shard_volume)
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

# the modules (the package exports functions of the same names)
rg = importlib.import_module("arterynetwork_tpu_torch.ops.region_grow")
rfr = importlib.import_module(
    "arterynetwork_tpu_torch.ops.region_grow_frontier")

torch.set_num_threads(1)

THIN_SHAPE = (12, 14, 16)       # a 60% random mask: its box is the volume
CC_SHAPE = (20, 24, 28)
GROW_SHAPE = (48, 48, 48)
SHARDED_GROW_SHAPE = (12, 18, 20)
CACHES = {"distribute": pd._cache, "thin": tt._cache,
          "sharded_thin": sharded._cache, "cc": tcc._cache,
          "xla": rg._cache, "xla_excluded": rg._cache, "fused": rfu._cache,
          "frontier": rfr._cache, "sharded_grow": sharded._grow_cache}
LOOPS = list(CACHES)


_KEPT = grow_loop.CachedLoop.__dict__["kept"]     # False on the CPU


def _clear():
    grow_loop.clear_loop_caches()


@pytest.fixture(autouse=True)
def _empty_caches(request, monkeypatch):
    """Empty caches around each test; on the CPU, entries kept as a
    card keeps them."""
    if request.node.get_closest_marker("gpu") is None:
        monkeypatch.setattr(grow_loop.CachedLoop, "kept",
                            property(lambda self: True))
    _clear()
    yield
    _clear()


@pytest.fixture(scope="module")
def native_lut(tmp_path_factory):
    """The lut route on the CPU: the native library's table in the
    cache (tests/test_torch_thinning.py does the same)."""
    from .test_torch_thinning import _native_table

    tmp = tmp_path_factory.mktemp("simple_point")
    np.save(tmp / tsp._CACHE_NAME, _native_table())
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsp, "_CACHE_DIR", str(tmp))
        tt._device_lut.cache_clear()
        yield
        tt._device_lut.cache_clear()


@pytest.fixture
def graph_route(native_lut, monkeypatch):
    """The sharded stages' "graph" route, with the table, on CPU
    blocks."""
    monkeypatch.setattr(sharded, "loop_route", lambda devices: "graph")
    monkeypatch.setattr(sharded, "_lut_for", tt._device_lut)


# ----------------------------------------------------------------------
# inputs: A and B of one key per loop
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _tree(depth=5):
    rng = np.random.default_rng(depth)
    return set_network_properties(generate_tree(max_depth=depth, rng=rng),
                                  rng=rng)


def _fit_system(name, device="cpu"):
    """A: the tree at 9,000 Pa targets; B: its radii x (1 + 0.1 u) at
    8,500 Pa (the same shapes and inlet)."""
    net = _tree()
    if name == "B":
        rng = np.random.default_rng(8)
        net = net.replace(radius=net.radius * (1.0 + 0.1 * rng.random(
            net.num_edges)))
    return pd.build_distribute_system(
        net, inlet_flow=1e-5, inlet_pressure=13000.0,
        desired_terminating_pressure=9000.0 if name == "A" else 8500.0,
        device=device)


def _mask(shape, name, p):
    seed = {"A": 0, "B": 1, "C": 2}[name]
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _grow_case(name, shape=GROW_SHAPE):
    """The tube phantom (A), or a wider tube with its noise from another
    seed (B)."""
    vol, seed = (tube_phantom(shape) if name == "A"
                 else tube_phantom(shape, radius=3, seed=1))
    excluded = np.zeros(shape, bool)
    excluded[:, :, 30:34] = True        # across the tube, 4 planes
    return vol, seed, excluded


def _sharded_grow_case(name):
    """A bright tube along x through every block (A) or bright boxes of
    two intensities across the blocks' faces (B), seeded inside
    (tests/test_torch_sharded_loop.py's)."""
    shape = SHARDED_GROW_SHAPE
    rng = np.random.default_rng(11 if name == "A" else 12)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    seed = np.zeros(shape, bool)
    if name == "A":
        vol[4:8, 7:11, 2:-2] = 1.0
        seed[6, 9, 9:12] = True
    else:
        vol[1:7, 2:10, 1:9] = 0.9
        vol[5:11, 8:16, 7:15] = 1.0
        vol[2:10, 12:17, 13:19] = 0.8
        seed[3:5, 4:6, 3:5] = True
    return vol, seed


def _mesh():
    return make_volume_mesh(["cpu"] * 4)


GROW_KW = {"max_segment_size": 10 ** 6, "iter_max": 300}


def _inputs(loop, name, device="cpu"):
    """The arguments of ``_call(loop, ...)`` for input ``name``."""
    dev = torch.device(device)
    if loop == "distribute":
        return _fit_system(name, device)
    if loop in ("thin", "sharded_thin"):
        mask = torch.from_numpy(_mask(THIN_SHAPE, name, 0.6)).to(dev)
        return shard_volume(mask, _mesh()) if loop == "sharded_thin" \
            else mask
    if loop == "cc":
        return torch.from_numpy(_mask(CC_SHAPE, name, 0.5)).to(dev)
    if loop == "sharded_grow":
        vol, seed = _sharded_grow_case(name)
        m = _mesh()
        return shard_volume(vol, m), shard_volume(seed, m)
    vol, seed, ex = _grow_case(name)
    return (torch.from_numpy(vol).to(dev), torch.from_numpy(seed).to(dev),
            torch.from_numpy(ex).to(dev) if loop == "xla_excluded"
            else None)


def _call(loop, args, **kw):
    if loop == "distribute":
        return pd.distribute_flow(args, **{"max_iter": 8, **kw})
    if loop == "thin":
        return tt.skeletonize(args, predicate="lut", **kw)
    if loop == "sharded_thin":
        return sharded.skeletonize(args, **kw)
    if loop == "cc":
        return tcc.connected_components(args, **kw)
    if loop == "sharded_grow":
        return sharded.region_grow(*args, **{**GROW_KW, **kw})
    vol, seed, ex = args
    kw = {**GROW_KW, **kw}
    if loop == "fused":
        return rfu.region_grow_fused(vol, seed, **kw)
    if loop == "frontier":
        return rfr.region_grow_frontier(vol, seed, **kw)
    return rg.region_grow(vol, seed, ex, backend="xla", **kw)


def _host(x):
    if isinstance(x, ShardedVolume):
        x = x.gather()
    return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))


def _bits(loop, out):
    """A result's bytes (a grow: mask, active map, iterations, count,
    stop reason)."""
    if loop == "distribute":
        parts = list(out)
    elif torch.is_tensor(out) or isinstance(out, ShardedVolume):
        parts = [out]
    else:
        parts = [out.segmented_map, out.iterations, out.segmented_count,
                 out.stop_reason]
        if out.active_map is not None:
            parts.append(out.active_map)
    return b"".join(_host(p).tobytes() for p in parts)


def _fresh(loop, name, **kw):
    _clear()
    out = _bits(loop, _call(loop, _inputs(loop, name), **kw))
    _clear()
    return out


def _info(loop):
    return CACHES[loop].info()


NEEDS = {"thin": "native_lut", "sharded_thin": "graph_route",
         "sharded_grow": "graph_route"}


def _fixtures(request, loop):
    if loop in NEEDS:
        request.getfixturevalue(NEEDS[loop])


# ----------------------------------------------------------------------
# A, B, A and A, A, B against fresh calls
# ----------------------------------------------------------------------
@pytest.mark.parametrize("order", ["ABA", "AAB"])
@pytest.mark.parametrize("loop", LOOPS)
def test_sequence_matches_fresh_calls(request, loop, order):
    _fixtures(request, loop)
    fresh = {n: _fresh(loop, n) for n in "AB"}
    assert fresh["A"] != fresh["B"]
    before = _info(loop)
    for i, name in enumerate(order):
        out = _call(loop, _inputs(loop, name))
        assert _bits(loop, out) == fresh[name], (i, name)
        info = _info(loop)
        assert (info["hits"] - before["hits"],
                info["misses"] - before["misses"]) == (i, 1)
    assert _info(loop)["entries"] == {"cpu": 1}
    if loop in ("distribute", "thin", "sharded_thin", "cc"):
        fn = {"distribute": pd.distribute_flow, "thin": tt.skeletonize,
              "sharded_thin": sharded.skeletonize,
              "cc": tcc.connected_components}[loop]
        assert fn.hit and fn.captures == fn.replays == 0   # no graph here


@pytest.mark.parametrize("loop", LOOPS)
def test_earlier_results_unchanged(request, loop):
    """A result is not a view of the entry: calls of B and A after it
    leave its bytes as they were."""
    _fixtures(request, loop)
    first = _call(loop, _inputs(loop, "A"))
    before = _bits(loop, first)
    for name in "BA":
        _call(loop, _inputs(loop, name))
    assert _bits(loop, first) == before


# a static argument of each loop and two other values of it
STATIC = {"distribute": ("max_iter", [8, 3, 5]),
          "thin": ("max_waves", [64, 1, 2]),
          "sharded_thin": ("max_waves", [64, 1, 2]),
          "cc": ("max_rounds", [64, 1, 2]),
          "xla": ("iter_max", [300, 5, 6]),
          "xla_excluded": ("iter_max", [300, 5, 6]),
          "fused": ("iter_max", [300, 5, 6]),
          "frontier": ("iter_max", [300, 5, 6]),
          "sharded_grow": ("iter_max", [300, 5, 6])}


@pytest.mark.parametrize("loop", LOOPS)
def test_static_arguments_take_new_entries_and_the_least_recent_goes(
        request, loop, monkeypatch):
    """With a cache of two entries: keys x, y, z in turn leave y and z,
    x misses again (with a fresh call's bits), and z hits."""
    _fixtures(request, loop)
    monkeypatch.setattr(CACHES[loop], "size", 2)
    arg, values = STATIC[loop]
    x, y, z = ({arg: v} for v in values)
    ref = _fresh(loop, "A", **x)
    before = _info(loop)
    for kw in (x, y, z):
        _call(loop, _inputs(loop, "A"), **kw)
    info = _info(loop)
    assert info["entries"] == {"cpu": 2}
    assert (info["misses"] - before["misses"],
            info["evictions"] - before["evictions"]) == (3, 1)
    out = _call(loop, _inputs(loop, "A"), **x)
    assert _bits(loop, out) == ref
    assert _info(loop)["misses"] - before["misses"] == 4
    _call(loop, _inputs(loop, "A"), **z)
    assert _info(loop)["hits"] - before["hits"] == 1


@pytest.mark.parametrize("loop", ["thin", "cc", "fused"])
def test_a_new_shape_takes_a_new_entry(request, loop):
    _fixtures(request, loop)
    a = _inputs(loop, "A")
    small = (tuple(x[1:-1, 1:, :-1].contiguous() if torch.is_tensor(x)
                   else x for x in a) if isinstance(a, tuple)
             else a[1:-1, 1:, :-1].contiguous())
    ref = _fresh_of(loop, small)
    before = _info(loop)
    _call(loop, a)
    out = _call(loop, small)
    assert _bits(loop, out) == ref
    info = _info(loop)
    assert (info["misses"] - before["misses"],
            info["evictions"] - before["evictions"]) == (2, 1)
    assert info["entries"] == {"cpu": 1}       # one entry per volume loop


def _fresh_of(loop, args):
    _clear()
    out = _bits(loop, _call(loop, args))
    _clear()
    return out


def test_a_thinning_of_another_box_misses(native_lut):
    """The box comes from a host read: the same mask moved by an even
    offset in its frame hits (the box's shape and origin parity are the
    key), moved by an odd one it misses."""
    a = torch.from_numpy(_mask(THIN_SHAPE, "A", 0.6))
    masks = {}
    for name, at in (("at2", (2, 2, 2)), ("at4", (4, 2, 4)),
                     ("odd", (3, 2, 2))):
        m = torch.zeros((18, 20, 22), dtype=torch.uint8)
        m[at[0]:at[0] + 12, at[1]:at[1] + 14, at[2]:at[2] + 16] = a
        masks[name] = m
    ref = {k: _fresh_of("thin", m) for k, m in masks.items()}
    for name, hit in (("at2", False), ("at4", True), ("odd", False)):
        out = tt.skeletonize(masks[name], predicate="lut")
        assert _bits("thin", out) == ref[name]
        assert tt.skeletonize.hit == hit, name
    assert _info("thin")["entries"] == {"cpu": 1}


def test_clearing_the_tables_drops_the_thinnings(graph_route):
    tt.skeletonize(_inputs("thin", "A"), predicate="lut")
    sharded.skeletonize(_inputs("sharded_thin", "A"))
    assert _info("thin")["entries"] == {"cpu": 1}
    assert _info("sharded_thin")["entries"] == {"cpu": 1}
    tt._LUTS.clear()
    assert _info("thin")["entries"] == {"cpu": 0}
    assert _info("sharded_thin")["entries"] == {"cpu": 0}


def test_clear_loop_caches_empties_every_cache(graph_route):
    for loop in LOOPS:
        _call(loop, _inputs(loop, "A"))
    assert {c for c in CACHES.values()} <= set(grow_loop._caches)
    assert all(c.held() == 1 for c in CACHES.values())
    grow_loop.clear_loop_caches()
    assert not any(c.held() for c in grow_loop._caches)


@pytest.mark.parametrize("loop", LOOPS)
def test_host_loop_keeps_no_entry(request, monkeypatch, loop):
    """With ``kept``'s own answer the CPU's host loop keeps nothing: each
    call makes its own entry, and gives a kept entry's bits."""
    _fixtures(request, loop)
    fresh = _fresh(loop, "A")
    monkeypatch.setattr(grow_loop.CachedLoop, "kept", _KEPT)
    before = _info(loop)
    for _ in range(2):
        assert _bits(loop, _call(loop, _inputs(loop, "A"))) == fresh
    info = _info(loop)
    assert info["entries"].get("cpu", 0) == 0
    assert (info["hits"], info["misses"]) == (before["hits"],
                                              before["misses"])


def test_out_of_memory_empties_the_caches_and_runs_again(native_lut,
                                                          monkeypatch):
    """A thinning whose EDT runs out of memory while an entry is held
    releases the caches (the flow solves' too) and the graph pools and
    runs again, with a fresh call's bits; with nothing held the error
    is raised."""
    from arterynetwork_tpu_torch.flow import solvers

    fresh = _fresh("thin", "A")
    real, calls = tt.edt_squared, []

    def edt_once_short(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("out of memory (a stand-in)")
        return real(*args, **kw)

    tt.skeletonize(_inputs("thin", "B"), predicate="lut")
    assert _info("thin")["entries"] == {"cpu": 1}
    monkeypatch.setattr(grow_loop.torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(tt, "edt_squared", edt_once_short)
    frees = grow_loop.frees_loop_caches.frees
    out = tt.skeletonize(_inputs("thin", "A"), predicate="lut")
    assert _bits("thin", out) == fresh
    assert len(calls) == 2 and grow_loop.frees_loop_caches.frees == frees + 1
    assert not tt.skeletonize.hit          # the B entry went
    assert solvers.clear_solve_cache in grow_loop.release_hooks
    calls.clear()
    grow_loop.release_device_memory()
    with pytest.raises(torch.OutOfMemoryError):
        tt.skeletonize(_inputs("thin", "A"), predicate="lut")
    assert grow_loop.frees_loop_caches.frees == frees + 1


def test_labels_route_takes_no_entry():
    mask = _inputs("thin", "A")
    tt.skeletonize(mask, predicate="labels")
    sharded.skeletonize(_inputs("sharded_thin", "A"))   # "host" route
    assert _info("thin")["entries"].get("cpu", 0) == 0
    assert _info("sharded_thin")["entries"].get("cpu", 0) == 0


# ----------------------------------------------------------------------
# one warm call of each loop against the JAX package
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_skeleton(name):
    from arterynetwork_tpu.ops import thinning as jt

    return np.asarray(jt.skeletonize(_mask(THIN_SHAPE, name, 0.6),
                                     max_waves=1))


@functools.lru_cache(maxsize=None)
def _jax_grow(sharded_case=False, excluded=False):
    """The JAX package's full-grid grower on input A."""
    import jax.numpy as jnp

    from arterynetwork_tpu.ops.region_grow import _region_grow_xla

    case = _sharded_grow_case("A") if sharded_case else _grow_case("A")
    vol, seed = case[:2]
    ex = jnp.asarray(case[2]) if excluded else None
    r = _region_grow_xla(jnp.asarray(vol), jnp.asarray(seed), ex, **GROW_KW)
    return tuple(np.asarray(x) for x in (r.segmented_map, r.active_map,
                                         r.iterations, r.segmented_count,
                                         r.stop_reason))


def _grow_host(r):
    return tuple(_host(x) for x in (r.segmented_map, r.active_map,
                                    r.iterations, r.segmented_count,
                                    r.stop_reason)
                 if x is not None)


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("loop", LOOPS)
def test_warm_call_matches_jax(request, loop):
    _fixtures(request, loop)
    kw = {"max_waves": 1} if loop in ("thin", "sharded_thin") else {}
    before = _info(loop)
    for name in "BA":
        out = _call(loop, _inputs(loop, name), **kw)
    assert _info(loop)["hits"] - before["hits"] == 1
    if loop in ("thin", "sharded_thin"):
        np.testing.assert_array_equal(_host(out), _jax_skeleton("A"))
    elif loop == "cc":
        from arterynetwork_tpu.ops import cc as jcc

        ref = jcc.connected_components(_mask(CC_SHAPE, "A", 0.5))
        np.testing.assert_array_equal(_host(out), np.asarray(ref))
    elif loop == "distribute":
        from arterynetwork_tpu.flow import distribute as jd

        sys_j = jd.build_distribute_system(
            _tree(), 1e-5, 13000.0, desired_terminating_pressure=9000.0)
        ref = jd.distribute_flow(sys_j, max_iter=8)
        assert np.max(np.abs(out.fractions.numpy()
                             - np.asarray(ref.fractions))) <= 1e-12
        for f in ("edge_flow", "node_pressure"):
            a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
            assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b)), f
    elif loop == "sharded_grow":
        ref = _jax_grow(sharded_case=True)
        got = _grow_host(out)
        assert _same(got, (ref[0],) + ref[2:])
    else:
        ref = _jax_grow(excluded=loop == "xla_excluded")
        assert _same(_grow_host(out), ref)


# ----------------------------------------------------------------------
# GraphLoop with the stand-in for torch.cuda's graph calls
# ----------------------------------------------------------------------
def _stand_in(monkeypatch):
    """``grow_loop``'s torch.cuda calls on the stand-in of
    tests/test_torch_solve_loop.py, ``loop_for`` a GraphLoop on the CPU,
    ``drive`` the while-graph route with the stand-in of its library ->
    the stand-in."""
    from .test_torch_grow_loop import FakeWhileLib
    from .test_torch_solve_loop import _StandIn

    fake = _StandIn()
    monkeypatch.setattr(grow_loop, "torch", types.SimpleNamespace(
        cuda=fake, int32=torch.int32,
        empty=lambda *a, pin_memory=False, **k: torch.empty(*a, **k)))
    lib = FakeWhileLib(fake.graphs.__getitem__)
    monkeypatch.setattr(graph_while, "_lib", lambda: lib)
    monkeypatch.setattr(grow_loop, "loop_for",
                        lambda device, counters=(), watch=None, keep=False:
                        grow_loop.GraphLoop(device, counters, watch, keep))
    monkeypatch.setattr(grow_loop, "drive", grow_loop.graph_loop)
    return fake


def _loop_counts(loop):
    """(steps run, captures, replays) of the last call."""
    if loop == "distribute":
        f = pd.distribute_flow
        return f.steps, f.captures, f.replays
    if loop == "cc":
        f = tcc.connected_components
        return f.rounds, f.captures, f.replays
    f = tt.skeletonize if loop == "thin" else sharded.skeletonize
    return f.wave_passes + f.final_passes, f.captures, f.replays


@pytest.mark.parametrize("loop", ["distribute", "thin", "sharded_thin",
                                  "cc"])
def test_warm_graphs_replay_every_step(request, monkeypatch, loop):
    _fixtures(request, loop)
    fresh = {n: _fresh(loop, n) for n in "AB"}
    fake = _stand_in(monkeypatch)
    for i, name in enumerate("ABA"):
        out = _call(loop, _inputs(loop, name))
        assert _bits(loop, out) == fresh[name]
        steps, captures, replays = _loop_counts(loop)
        assert steps > 1
        if i == 0:
            assert captures > 0 and replays == steps - captures
        else:
            assert (captures, replays) == (0, steps)
    # every capture made in the cold call, into the one pool
    assert len(fake.modes) == {"distribute": 1, "cc": 1}.get(loop, 2)


def _capturable_sweep(seg, idx, sign_words, valid_yx=None, window=None,
                      *, out, dh):
    from .test_torch_sharded_loop import _capturable_sweep as sweep

    return sweep(seg, idx, sign_words, valid_yx, window, out=out, dh=dh)


def test_warm_grows_launch_the_kept_while_graph(graph_route, monkeypatch):
    """The sharded grower (its sweep made capturable, as
    tests/test_torch_sharded_loop.py does): the cold grow captures both
    steps and builds the while graph, the warm ones capture nothing, run
    sweep 1 eagerly and launch the same while graph, with min(sweeps, 2)
    + 1 reads."""
    monkeypatch.setattr(sharded, "fused_sweep_counts", _capturable_sweep)
    fresh = {n: _fresh("sharded_grow", n) for n in "AB"}
    fake = _stand_in(monkeypatch)
    lib = graph_while._lib()
    for i, name in enumerate("ABA"):
        c0 = (grow_loop.graph_loop.captures, grow_loop.graph_loop.replays,
              grow_loop.graph_loop.launches, grow_loop.read_stop.reads)
        out = _call("sharded_grow", _inputs("sharded_grow", name))
        assert _bits("sharded_grow", out) == fresh[name]
        sweeps = int(out.iterations) + (int(out.stop_reason) == 0)
        assert sweeps > 2
        captures, replays, launches, reads = (
            n - n0 for n, n0 in zip((
                grow_loop.graph_loop.captures, grow_loop.graph_loop.replays,
                grow_loop.graph_loop.launches, grow_loop.read_stop.reads),
                c0))
        assert (captures, replays, launches, reads) == (
            2 if i == 0 else 0, sweeps - 1, 1, 3)
    assert len(lib.execs) == 1 and not lib.destroyed
    assert len(fake.modes) == 2
    # traced: a while graph of its own, destroyed after the grow
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = _call("sharded_grow", _inputs("sharded_grow", "A"))
    assert _bits("sharded_grow", out) == fresh["A"]
    assert len(lib.execs) == 2 and len(lib.destroyed) == 1
    out = _call("sharded_grow", _inputs("sharded_grow", "B"))
    assert _bits("sharded_grow", out) == fresh["B"]
    assert len(lib.execs) == 2 and len(fake.modes) == 2
    _clear()
    assert len(lib.destroyed) == 2


@pytest.mark.parametrize("loop", ["thin", "cc"])
def test_failed_capture_drops_the_entry(request, monkeypatch, loop):
    """A step that reads the device on the host cannot be captured: the
    call raises and its entry goes."""
    _fixtures(request, loop)
    module, name = {"thin": (tt, "neighborhood_codes"),
                    "cc": (tcc, "_axis_min3")}[loop]
    real = getattr(module, name)

    def reads(x, *args):
        int(x.sum())
        return real(x, *args)

    _stand_in(monkeypatch)
    monkeypatch.setattr(module, name, reads)
    with pytest.raises(RuntimeError, match="capturing"):
        _call(loop, _inputs(loop, "A"))
    assert _info(loop)["entries"] == {"cpu": 0}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _eager_loop(monkeypatch):
    """The loops' eager route on the card: ``loop_for`` a HostLoop,
    ``drive`` the host loop (keys of their own in the caches)."""
    monkeypatch.setattr(grow_loop, "loop_for",
                        lambda *args, **kw: grow_loop.HostLoop())
    monkeypatch.setattr(grow_loop, "drive", grow_loop.host_loop)


@pytest.mark.gpu
@pytest.mark.parametrize("loop", LOOPS)
def test_warm_graphs_on_card_match_eager_loop(cuda, monkeypatch, loop):
    if loop in ("sharded_thin", "sharded_grow"):
        def inputs(name):
            a = _inputs(loop, name)
            m = make_volume_mesh([cuda] * 4)
            if loop == "sharded_thin":
                return shard_volume(a.gather(), m)
            return tuple(shard_volume(x.gather(), m) for x in a)
    else:
        def inputs(name):
            return _inputs(loop, name, cuda)
    with monkeypatch.context() as m:
        _eager_loop(m)
        eager = {n: _bits(loop, _call(loop, inputs(n))) for n in "AB"}
    _clear()
    first = None
    for i, name in enumerate("ABA"):
        before = _info(loop)
        gl = (grow_loop.graph_loop.captures, grow_loop.graph_loop.launches)
        out = _call(loop, inputs(name))
        torch.cuda.synchronize()
        if first is None:
            first, first_bits = out, _bits(loop, out)
        assert _bits(loop, out) == eager[name], (i, name)
        info = _info(loop)
        assert info["hits"] - before["hits"] == (i > 0)
        if loop in ("distribute", "thin", "sharded_thin", "cc"):
            steps, captures, replays = _loop_counts(loop)
            if i:
                assert (captures, replays) == (0, steps)
            else:
                assert captures > 0
        elif i:
            assert grow_loop.graph_loop.captures == gl[0]
            assert grow_loop.graph_loop.launches == gl[1] + 1
    assert _bits(loop, first) == first_bits


@pytest.mark.gpu
def test_captures_work_after_a_failed_capture(cuda):
    """A capture that fails (a host read in the step) leaves the graph
    pool usable: the next loop's captures and replays still give the
    eager loop's bits."""
    stop = torch.full((), -1, dtype=torch.int32, device=cuda)

    def step():
        int(stop + 0)                  # a host read: refused in capture

    with pytest.raises(RuntimeError):
        grow_loop.graph_loop([step, step], stop)
    mask = _inputs("cc", "A", cuda)
    out = _bits("cc", tcc.connected_components(mask))
    assert tcc.connected_components.captures == 1
    with pytest.MonkeyPatch.context() as m:
        _eager_loop(m)
        assert _bits("cc", tcc.connected_components(mask)) == out
