"""The device thinning's and the components' loops (ops/thinning.py and
ops/cc.py on ops/grow_loop.py) on the CPU.

``skeletonize`` writes each pass (8 subfields) of its two loops, the
distance waves and the cleanup passes, and ``connected_components``
each labelling round, as a step that updates buffers made before the
loop in place, and runs them through ``grow_loop.loop_for``: replayed
from captured CUDA graphs on a card (the thinning's "lut" route), eagerly
here.  Held here:

  * bit for bit to the loops the port ran before (a copy below,
    ``_old_*``: host loops that bind new tensors every pass and read a
    (deleted, max d2) pair per pass, or a flag per round): skeletons,
    labels, the passes of each thinning loop, the rounds, and the host
    reads (thinning: 1 + wave passes + final passes; components: one per
    round).  Thinning on an empty mask, one voxel, a random blob, a tube
    and the packed volume of tests/test_torch_thinning.py, both
    predicates, ``preserve_endpoints`` True and False, ``max_waves`` 0, 1,
    2 and 64 (the blob's and the tube's wave loops end on ``stalled ==
    max_waves`` at 1, with voxels left at deeper levels); components on
    an empty volume, a random one and a serpentine that takes 92 rounds,
    connectivity 1 and 3, ``max_rounds`` 0, 1, 2, 64 and 4096
    (convergence);
  * to the JAX package's ``skeletonize`` (one compile: the blob,
    ``max_waves`` 1; tests/test_torch_thinning.py holds 64 waves on the
    packed volume) and ``connected_components`` (every case), exactly;
  * the device wave bound ``f32(level)^2 + 0.5`` equal to the host value
    the loop used before, and compared with d2 as it was; the parity
    subfields, made on the device, equal to the host array uploaded
    before;
  * driven by ``GraphLoop`` through the stand-in of
    tests/test_torch_solve_loop.py (aten ops recorded in a capture and
    replayed, a host read refused): the eager bits, with each key's
    first pass eager, its second captured and later ones replayed, and
    exact read, capture and replay counts; a lut-route step that reads
    the device and a table built inside a capture raise; the labels
    route runs eagerly (``torch.nonzero``), whatever loop_for gives;
  * neither function writes into the caller's tensor.

The CUDA graphs themselves need a card: the ``gpu`` tests in
tests/test_torch_kernels.py hold the graph-driven loops to the eager
loop there.
"""

import types

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import cc as tcc
from arterynetwork_tpu_torch.ops import grow_loop
from arterynetwork_tpu_torch.ops import simple_point as tsp
from arterynetwork_tpu_torch.ops import thinning as tt
from arterynetwork_tpu_torch.ops.edt import edt_squared
from arterynetwork_tpu_torch.ops.region_grow import (_as_device,
                                                     _resolve_device)
from arterynetwork_tpu_torch.ops.simple_point import neighborhood_codes

from .test_torch_solve_loop import _StandIn
from .test_torch_thinning import _native_table, _packed

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# the loops before they wrote in place (ops/thinning.py, ops/cc.py)
# ----------------------------------------------------------------------
def _old_subfield_index(shape, origin=(0, 0, 0)):
    z = (np.arange(shape[0]) + origin[0]) % 2
    y = (np.arange(shape[1]) + origin[1]) % 2
    x = (np.arange(shape[2]) + origin[2]) % 2
    return (z[:, None, None] * 4 + y[None, :, None] * 2
            + x[None, None, :]).astype(np.int8)


def _old_skeletonize(mask, max_waves=64, preserve_endpoints=True,
                     device=None, predicate="auto"):
    """-> (skeleton, {"wave", "final", "reads", "stalled_out"})."""
    counts = {"wave": 0, "final": 0, "reads": 0, "stalled_out": False}
    device = _resolve_device(mask, device)
    full = _as_device(mask, device) != 0
    if predicate == "auto":
        predicate = "lut" if device.type == "cuda" else "labels"
    box = tt._crop_box(full)
    if box is None:
        return full, counts
    fg = full[box].contiguous()
    origin = tuple(s.start for s in box)
    d2 = edt_squared(fg, band=32)
    subfield = torch.from_numpy(_old_subfield_index(fg.shape, origin)).to(
        device)
    sub_masks = [subfield == sf for sf in range(8)]
    lut = tt._device_lut(device) if predicate == "lut" else None

    def delete_pass(fg, level2):
        at_level = d2 <= level2
        deleted = torch.zeros((), dtype=torch.bool, device=device)
        for sf in range(8):
            cand = tt._subfield_deletions(fg, neighborhood_codes(fg),
                                          at_level & sub_masks[sf],
                                          preserve_endpoints, lut)
            fg = fg & ~cand
            deleted |= cand.any()
        return fg, deleted

    def read(deleted, fg):
        counts["reads"] += 1
        max_d2 = torch.where(fg, d2, 0.0).max()
        pair = torch.stack([deleted.to(torch.float32), max_d2]).cpu()
        return bool(pair[0]), np.float32(pair[1])

    _, max_d2 = read(torch.zeros((), dtype=torch.bool, device=device), fg)
    level, stalled = 1, 0
    while (np.float32(level) ** 2 <= max_d2 + np.float32(2.0)
           and stalled < max_waves):
        level2 = float(np.float32(level) ** 2 + np.float32(0.5))
        fg, deleted = delete_pass(fg, level2)
        deleted, max_d2 = read(deleted, fg)
        counts["wave"] += 1
        level, stalled = (level, 0) if deleted else (level + 1, stalled + 1)
    counts["stalled_out"] = bool(
        np.float32(level) ** 2 <= max_d2 + np.float32(2.0))

    deleted, it = True, 0
    while deleted and it < max_waves:
        fg, deleted = delete_pass(fg, 1e12)
        deleted, _ = read(deleted, fg)
        it += 1
    counts["final"] = it
    out = torch.zeros_like(full)
    out[box] = fg
    return out, counts


def _old_connected_components(mask, connectivity=3, max_rounds=64):
    """-> (labels, rounds, host reads)."""
    fg = torch.as_tensor(mask) != 0
    shape = fg.shape
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int32).reshape(shape)
    big = torch.tensor(n, dtype=torch.int32)
    labels = torch.where(fg, idx, big)

    def propagate(lab):
        best = lab
        for axis in range(lab.dim()):
            if connectivity == 1:
                best = torch.minimum(best, tcc._axis_min3(lab, axis))
            else:
                best = tcc._axis_min3(best, axis)
        return torch.where(fg, torch.minimum(lab, best), big)

    def jump(lab):
        flat = lab.reshape(-1)
        padded = torch.cat([flat, big.reshape(1)])
        return padded[torch.clamp_max(flat, n)].reshape(shape)

    rounds = reads = 0
    while rounds < max_rounds:
        new = jump(jump(propagate(labels)))
        changed = bool(torch.any(new != labels))
        reads += 1
        labels = new
        rounds += 1
        if not changed:
            break
    return torch.where(fg, labels + 1, 0).to(torch.int32), rounds, reads


# ----------------------------------------------------------------------
# volumes
# ----------------------------------------------------------------------
def _blob():
    rng = np.random.default_rng(0)
    return (rng.random((12, 14, 16)) < 0.6).astype(np.uint8)


def _tube():
    z, y, x = np.mgrid[:14, :16, :30]
    return (((z - 7) ** 2 + (y - 8) ** 2 <= 9)
            & (x >= 3) & (x < 27)).astype(np.uint8)


def _one_voxel():
    vol = np.zeros((5, 6, 7), np.uint8)
    vol[2, 3, 4] = 1
    return vol


def _serpentine():
    """One 26- and 6-connected path of ~2,000 voxels winding through
    (3, 45, 90): 92 rounds with connectivity 1, 91 with 3."""
    vol = np.zeros((3, 45, 90), np.uint8)
    vol[1, ::2, :] = 1
    for k, y in enumerate(range(1, 45, 2)):
        vol[1, y, 89 if k % 2 == 0 else 0] = 1
    return vol


THIN_VOLUMES = {"empty": lambda: np.zeros((6, 7, 8), np.uint8),
                "one_voxel": _one_voxel, "blob": _blob, "tube": _tube,
                "packed": lambda: _packed()[0]}
CC_VOLUMES = {"empty": lambda: np.zeros((6, 7, 8), np.uint8),
              "random": lambda: (np.random.default_rng(1).random(
                  (20, 24, 28)) < 0.5).astype(np.uint8),
              "serpentine": _serpentine}
THIN_CASES = ([(v, w) for v in ("empty", "one_voxel", "blob", "tube")
               for w in (0, 1, 2, 64)] + [("packed", 64)])
CC_CASES = [(v, c, r) for v in CC_VOLUMES for c in (1, 3)
            for r in (0, 1, 2, 64, 4096)]


@pytest.fixture(scope="module")
def native_lut(tmp_path_factory):
    """The lut route on the CPU: the native library's table in the
    cache (tests/test_torch_thinning.py does the same)."""
    tmp = tmp_path_factory.mktemp("simple_point")
    np.save(tmp / tsp._CACHE_NAME, _native_table())
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsp, "_CACHE_DIR", str(tmp))
        tt._device_lut.cache_clear()
        yield
        tt._device_lut.cache_clear()


def _counts():
    f = tt.skeletonize
    return {"wave": f.wave_passes, "final": f.final_passes,
            "reads": f.reads, "captures": f.captures,
            "replays": f.replays}


def _cc_counts():
    f = tcc.connected_components
    return {"rounds": f.rounds, "reads": f.reads, "captures": f.captures,
            "replays": f.replays}


# ----------------------------------------------------------------------
# the in-place loops against the loops before, and JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("predicate", ["labels", "lut"])
@pytest.mark.parametrize("pe", [True, False], ids=["endpoints",
                                                   "no_endpoints"])
@pytest.mark.parametrize("vol,max_waves", THIN_CASES,
                         ids=[f"{v}-{w}" for v, w in THIN_CASES])
def test_in_place_thinning_matches_old_loop(vol, max_waves, pe, predicate,
                                            native_lut):
    mask = torch.from_numpy(THIN_VOLUMES[vol]())
    old, oc = _old_skeletonize(mask, max_waves, pe, predicate=predicate)
    new = tt.skeletonize(mask, max_waves, pe, predicate=predicate)
    assert new.dtype == torch.bool and torch.equal(new, old)
    c = _counts()
    assert (c["wave"], c["final"], c["reads"]) == (
        oc["wave"], oc["final"], oc["reads"])
    if vol != "empty":
        assert c["reads"] == 1 + c["wave"] + c["final"]
    assert c["captures"] == c["replays"] == 0
    if vol in ("blob", "tube") and max_waves == 1:
        assert oc["stalled_out"]        # ended on stalled == max_waves
    if vol == "packed":
        assert int(new.sum()) > 100 and c["wave"] > 2


def test_thinning_matches_jax(native_lut):
    from arterynetwork_tpu.ops import thinning as jt

    vol = _blob()
    ref = np.asarray(jt.skeletonize(vol, max_waves=1))
    assert 0 < ref.sum() < vol.sum()
    for predicate in ("labels", "lut"):
        out = tt.skeletonize(torch.from_numpy(vol), max_waves=1,
                             predicate=predicate)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_level2_matches_the_host_value():
    """f32(level)^2 + 0.5 on the device equals the loop's old host value
    at every level up to 2^12 (past it numpy's power and an f32 product
    may round a tie apart; the loop never gets there), and d2 <= it
    compares as d2 <= the old Python float did."""
    levels = np.arange(0, (1 << 12) + 1)
    dev = tt._level2(torch.from_numpy(levels.astype(np.int32)))
    host = np.array([np.float32(lv) ** 2 + np.float32(0.5)
                     for lv in levels], np.float32)
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)
    # the wave loop goes on while level^2 <= max d2 + 2, and band 32
    # clamps d2 at 3 * 32^2: no pass runs past level 55
    assert np.float32(55) ** 2 <= np.float32(3 * 32 ** 2) + np.float32(2)
    assert np.float32(56) ** 2 > np.float32(3 * 32 ** 2) + np.float32(2)
    for lv in (1, 2, 7, 55, 56, 57, 1 << 12):
        b = host[lv]
        d2 = torch.tensor([np.nextafter(b, np.float32(0)), b,
                           np.nextafter(b, np.float32(np.inf)),
                           np.float32(lv) ** 2], dtype=torch.float32)
        assert torch.equal(d2 <= dev[lv], d2 <= float(b))


@pytest.mark.parametrize("origin", [(0, 0, 0), (1, 0, 1), (3, 258, 7)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 4, 5), (7, 2, 9)])
def test_subfield_index_matches_the_host_index(shape, origin):
    """The parity subfields, made on the device since the loops were,
    equal the host array the loop uploaded before."""
    sub = tt._subfield_index(shape, origin, "cpu")
    assert sub.dtype == torch.int8
    np.testing.assert_array_equal(sub.numpy(),
                                  _old_subfield_index(shape, origin))


@pytest.mark.parametrize("vol,conn,max_rounds", CC_CASES,
                         ids=[f"{v}-c{c}-r{r}" for v, c, r in CC_CASES])
def test_in_place_components_match_old_loop_and_jax(vol, conn, max_rounds):
    from arterynetwork_tpu.ops import cc as jcc

    mask = CC_VOLUMES[vol]()
    old, rounds, reads = _old_connected_components(
        torch.from_numpy(mask), conn, max_rounds)
    new = tcc.connected_components(torch.from_numpy(mask), conn,
                                   max_rounds)
    assert new.dtype == torch.int32 and torch.equal(new, old)
    assert _cc_counts() == {"rounds": rounds, "reads": reads,
                            "captures": 0, "replays": 0}
    assert reads == rounds
    if vol == "serpentine":
        assert rounds == min(max_rounds, 92 if conn == 1 else 91)
    ref = np.asarray(jcc.connected_components(mask, connectivity=conn,
                                              max_rounds=max_rounds))
    np.testing.assert_array_equal(new.numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_inputs_are_not_written(dtype, native_lut):
    """The crop box covers the whole volume (the mask touches every
    face), so the box is no copy of its own."""
    mask = torch.from_numpy(_blob()).to(dtype)
    mask[0], mask[-1], mask[:, 0], mask[:, :, -1] = 1, 1, 1, 1
    keep = mask.clone()
    for predicate in ("labels", "lut"):
        tt.skeletonize(mask, predicate=predicate)
        assert torch.equal(mask, keep)
    tcc.connected_components(mask)
    assert torch.equal(mask, keep)


# ----------------------------------------------------------------------
# GraphLoop with the stand-in for torch.cuda's graph calls
# ----------------------------------------------------------------------
def _stand_in(monkeypatch):
    """``grow_loop.loop_for`` gives a GraphLoop on the stand-in, on the
    CPU; the loops made are collected."""
    fake = _StandIn()
    monkeypatch.setattr(grow_loop, "torch", types.SimpleNamespace(
        cuda=fake, int32=torch.int32,
        empty=lambda *a, pin_memory=False, **k: torch.empty(*a, **k)))
    made = []

    def loop_for(device, counters=(), watch=None, keep=False):
        made.append(grow_loop.GraphLoop(device, counters, watch, keep))
        return made[-1]

    monkeypatch.setattr(grow_loop, "loop_for", loop_for)
    return fake, made


def _graph_counts(*passes):
    """A cold call's GraphLoop counts (a new cache entry) for keys run
    ``passes`` times each: the first eager, the second captured (and
    replayed), the rest replayed; a key run once is captured at the
    call's end."""
    return (sum(n >= 1 for n in passes), sum(max(n - 1, 0) for n in passes))


GRAPH_THIN = [("blob", 1, True), ("blob", 2, True), ("blob", 64, True),
              ("blob", 64, False), ("one_voxel", 64, True),
              ("tube", 64, True), ("packed", 64, False)]


@pytest.mark.parametrize("vol,max_waves,pe", GRAPH_THIN,
                         ids=[f"{v}-{w}-{'endpoints' if p else 'none'}"
                              for v, w, p in GRAPH_THIN])
def test_graph_driven_thinning_matches_eager(monkeypatch, vol, max_waves,
                                             pe, native_lut):
    mask = torch.from_numpy(THIN_VOLUMES[vol]())
    eager = tt.skeletonize(mask, max_waves, pe, predicate="lut")
    ec = _counts()
    fake, made = _stand_in(monkeypatch)
    graph = tt.skeletonize(mask, max_waves, pe, predicate="lut")
    c = _counts()
    assert torch.equal(graph, eager)
    assert len(made) == 1 and isinstance(made[0], grow_loop.GraphLoop)
    assert made[0].runs == {k: v for k, v in (("wave", c["wave"]),
                                              ("final", c["final"])) if v}
    assert (c["wave"], c["final"], c["reads"]) == (
        ec["wave"], ec["final"], ec["reads"])
    assert c["reads"] == 1 + c["wave"] + c["final"]
    captures, replays = _graph_counts(c["wave"], c["final"])
    assert (c["captures"], c["replays"]) == (captures, replays)
    assert fake.modes == [("pool", "thread_local")] * captures
    if vol != "one_voxel" and max_waves > 1:
        assert c["replays"] > 0


def test_labels_route_runs_eagerly_in_any_loop(monkeypatch):
    """``torch.nonzero`` cannot be captured: the labels route takes a
    HostLoop whatever ``loop_for`` would give."""
    mask = torch.from_numpy(_blob())
    eager = tt.skeletonize(mask, predicate="labels")
    ec = _counts()
    _, made = _stand_in(monkeypatch)
    assert torch.equal(tt.skeletonize(mask, predicate="labels"), eager)
    assert not made and _counts() == ec


@pytest.mark.parametrize("vol,conn,max_rounds",
                         [("random", 3, 64), ("random", 1, 2),
                          ("serpentine", 1, 64), ("serpentine", 3, 4096),
                          ("empty", 3, 64), ("random", 3, 1)])
def test_graph_driven_components_match_eager(monkeypatch, vol, conn,
                                             max_rounds):
    mask = torch.from_numpy(CC_VOLUMES[vol]())
    eager = tcc.connected_components(mask, conn, max_rounds)
    ec = _cc_counts()
    fake, made = _stand_in(monkeypatch)
    graph = tcc.connected_components(mask, conn, max_rounds)
    c = _cc_counts()
    assert torch.equal(graph, eager) and len(made) == 1
    assert (c["rounds"], c["reads"]) == (ec["rounds"], ec["reads"])
    assert c["reads"] == c["rounds"]
    captures, replays = _graph_counts(c["rounds"])
    assert (c["captures"], c["replays"]) == (captures, replays)
    assert fake.modes == [("pool", "thread_local")] * captures


def test_graph_driven_thinning_raises_when_a_step_reads_the_device(
        monkeypatch, native_lut):
    """No fallback: a pass that reads the device on the host cannot be
    captured (the eager loop takes it)."""
    real = tt.neighborhood_codes

    def reads(fg):
        float(fg.sum())
        return real(fg)

    monkeypatch.setattr(tt, "neighborhood_codes", reads)
    mask = torch.from_numpy(_blob())
    eager = tt.skeletonize(mask, predicate="lut")
    assert tt.skeletonize.wave_passes > 1
    _stand_in(monkeypatch)
    with pytest.raises(RuntimeError, match="capturing"):
        tt.skeletonize(mask, predicate="lut")
    monkeypatch.setattr(tt, "neighborhood_codes", real)
    assert torch.equal(tt.skeletonize(mask, predicate="lut"), eager)


def test_graph_driven_thinning_raises_when_the_table_is_built_in_capture(
        monkeypatch, native_lut):
    """A table built while a pass is captured would hold memory that no
    kernel wrote: one dropped from the cache after the eager pass and
    built again in the capture raises."""
    real = tt._subfield_deletions
    calls = []

    def rebuilt(fg, code, eligible, preserve_endpoints, lut):
        calls.append(1)
        if len(calls) == 9:             # the capture's first subfield
            tt._device_lut.cache_clear()
            lut = tt._device_lut(fg.device)
        return real(fg, code, eligible, preserve_endpoints, lut)

    monkeypatch.setattr(tt, "_subfield_deletions", rebuilt)
    _stand_in(monkeypatch)
    with pytest.raises(RuntimeError, match="cache changed"):
        tt.skeletonize(torch.from_numpy(_blob()), predicate="lut")
    assert len(calls) == 16
