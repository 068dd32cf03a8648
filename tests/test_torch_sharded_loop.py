"""The sharded grower's and the sharded thinning's loops
(parallel/sharded.py) and ``distribute_flow``'s Gauss-Newton loop
(flow/distribute.py) on ops/grow_loop.py, on the CPU.

Each loop writes its iteration once, as steps that update buffers made
before the loop in place (the grower two, A -> B and B -> A over its
two halo-padded copies; the thinning a wave pass and a final pass; the
fit one Gauss-Newton step), and runs them through ``ops/grow_loop``:
replayed from captured CUDA graphs when every block (or the system)
lies on one card, eagerly here.  Held here:

  * bit for bit to the loops the port ran before (a copy below,
    ``_old_*``: host loops that rebind every block and scalar each
    iteration; the thinning's reads a (deleted, max d2) pair per pass),
    with the same host reads: the grower's mask, iterations, count and
    stop reason, sweeps + 1 reads; the skeleton, 1 + wave passes + final
    passes reads; the fit's fractions, edge flows, pressures, RMS
    mismatch, iterations and theta, no read in the loop.  On meshes of
    1, 2x2 and 1x3 CPU slots, a tube and a volume of boxes, the grower
    with ``iter_max`` 0, 1, 2 and 60 (and a seed already at the size
    cap: no sweep), the thinning with ``max_waves`` 0, 1, 2 and 64 on
    the table route (the native table served on the CPU) and on the
    labels route, and an empty mask (one read, no pass); the fit at
    depths 3-6 with ``max_iter`` 0, 1, 2 and 40 and from an
    ``init_theta``, which it leaves as it was;
  * driven by ``GraphLoop`` through the stand-in of
    tests/test_torch_solve_loop.py (aten ops recorded in a capture and
    replayed, a host read refused): the eager bits with exact read,
    capture and replay counts (the grower: both steps captured after
    sweep 1 and run by one launch of the while graph, through the
    stand-in of its library in tests/test_torch_grow_loop.py,
    min(sweeps, 2) + 1 reads, a step run from a graph a sweep after the
    first, K2 counted once a block and sweep; the thinning: each key's first pass eager, its second
    captured; the fit: 1 capture, ``max_iter`` - 1 replays);
  * the route: "graph" only for blocks all on one CUDA device, "host"
    for CPU blocks and for blocks on two cards.

JAX parity of the sharded stages stays in tests/test_torch_parallel.py
and the fit's in tests/test_torch_distribute.py.  The CUDA graphs
themselves need a card: the ``gpu`` tests in tests/test_torch_kernels.py
hold the graph-driven loops to the eager loop there.
"""

import types

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.flow import distribute as pd
from arterynetwork_tpu_torch.graphs import (generate_tree,
                                            set_network_properties)
from arterynetwork_tpu_torch.ops import graph_while, grow_loop
from arterynetwork_tpu_torch.ops import region_grow_fused as rfu
from arterynetwork_tpu_torch.ops import thinning as tt
from arterynetwork_tpu_torch.ops.histogram_kernels import masked_histogram1
from arterynetwork_tpu_torch.ops.region_grow import (
    DEFAULT_H, RegionGrowResult, _decision_table, _gaussian_kernel,
    _stop_code)
from arterynetwork_tpu_torch.ops.region_grow_fused import (
    NUM_BINS, fused_sweep_counts, pack_sign_words)
from arterynetwork_tpu_torch.ops.simple_point import neighborhood_codes
from arterynetwork_tpu_torch.ops.stencil import dilate26
from arterynetwork_tpu_torch.ops.thinning import (_subfield_deletions,
                                                  _subfield_index)
from arterynetwork_tpu_torch.parallel import sharded
from arterynetwork_tpu_torch.parallel.halo import (Padded, VolumeMesh,
                                                   halo_faces,
                                                   make_volume_mesh,
                                                   pad_halos, refresh_halos,
                                                   shard_volume)
from arterynetwork_tpu_torch.parallel.sharded import (_first, _reduce,
                                                      histogram_inputs,
                                                      quantized_bins)

from .test_torch_grow_loop import FakeWhileLib
from .test_torch_solve_loop import _StandIn
from .test_torch_thin_loop import native_lut  # noqa: F401  (a fixture)

torch.set_num_threads(1)

SHAPE = (12, 18, 20)          # divides over 2x2 and 1x3 meshes
MESHES = {"1": 1, "2x2": 4, "1x3": 3}


# ----------------------------------------------------------------------
# the loops before they wrote in place (parallel/sharded.py,
# flow/distribute.py), each read of the host counted
# ----------------------------------------------------------------------
class _Reads:
    n = 0


def _read_int(t):
    _Reads.n += 1
    return int(t)


def _old_region_grow(data, seed_mask, max_segment_size, iter_max):
    data = data.map(lambda b: b.to(torch.float32))
    idxs = data.indices()
    dev0 = _first(data).device
    bins_pad, values = quantized_bins(data)
    K = _gaussian_kernel(values, DEFAULT_H, torch.float32)
    seg = seed_mask.map(lambda b: (b != 0).to(torch.uint8))
    all_parts, inner_parts = [], []
    for flat, own, inner in histogram_inputs(bins_pad, seg).values():
        all_parts.append(masked_histogram1(flat, own, NUM_BINS,
                                           torch.int32))
        inner_parts.append(masked_histogram1(flat, inner, NUM_BINS,
                                             torch.int32))
    hist_all = _reduce(all_parts, torch.sum, dev0).to(torch.float32)
    inner = _reduce(inner_parts, torch.sum, dev0).to(torch.int32)
    count = _reduce([torch.sum(seg.blocks[i], dtype=torch.int32)
                     for i in idxs], torch.sum, dev0).to(torch.int32)
    src = pad_halos(seg, 1)
    dst = Padded(np.empty(seg.grid, dtype=object), src.lo, src.hi,
                 src.source)
    by_dev = {}
    for i in idxs:
        dst.blocks[i] = src.blocks[i].clone()
        by_dev.setdefault(src.blocks[i].device, []).append(i)
    dh_buf = {d: torch.zeros((len(ix), 2, NUM_BINS), dtype=torch.int32,
                             device=d) for d, ix in by_dev.items()}
    dh_of = {i: dh_buf[d][k] for d, ix in by_dev.items()
             for k, i in enumerate(ix)}
    windows = {i: src.window(i) for i in idxs}
    src_faces, dst_faces = halo_faces(src), halo_faces(dst)
    it = torch.zeros((), dtype=torch.int32, device=dev0)
    stop = torch.where(count >= max_segment_size, 1, -1).to(torch.int32)
    while _read_int(stop) < 0:
        inner_f = inner.to(torch.float32)
        words = pack_sign_words(_decision_table(K, inner_f,
                                                hist_all - inner_f))
        words_on = {d: words.to(d) for d in dh_buf}
        for buf in dh_buf.values():
            buf.zero_()
        for i in idxs:
            t = src.blocks[i]
            fused_sweep_counts(t, bins_pad.blocks[i], words_on[t.device],
                               window=windows[i], out=dst.blocks[i],
                               dh=dh_of[i])
        refresh_halos(dst, dst_faces)
        src, dst = dst, src
        src_faces, dst_faces = dst_faces, src_faces
        parts = [buf.sum(dim=0) for buf in dh_buf.values()]
        dh = parts[0] if len(parts) == 1 else _reduce(parts, torch.sum,
                                                      dev0)
        n_pos, n_neg = dh.sum(dim=1, dtype=torch.int32)
        converged = (n_pos + n_neg) == 0
        inner = inner + dh[0] - dh[1]
        count = count + n_pos - n_neg
        it = it + (~converged).to(torch.int32)
        stop = _stop_code(converged, count >= max_segment_size, it,
                          iter_max)
    return RegionGrowResult(segmented_map=src.crop().map(lambda b: b != 0),
                            active_map=None, iterations=it,
                            segmented_count=count, stop_reason=stop)


def _old_lut_for(device):
    """The copy's simple-point route (inline in the loop before): the
    table on a CUDA device; the tests swap this to run the table on the
    CPU."""
    return tt._device_lut(device) if device.type == "cuda" else None


def _old_skeletonize(mask, max_waves=64):
    """-> (skeleton, {"wave", "final", "reads"})."""
    counts = {"wave": 0, "final": 0, "reads": 0}
    fg = mask.map(lambda b: b != 0)
    idxs = fg.indices()
    dev0 = _first(fg).device
    d2 = sharded.edt_squared(fg, band=32)
    sub_masks, luts = {}, {}
    for i in idxs:
        dev = fg.blocks[i].device
        sub = _subfield_index(fg.blocks[i].shape, fg.offset(i), dev)
        sub_masks[i] = [sub == sf for sf in range(8)]
        luts[i] = _old_lut_for(dev)

    def delete_pass(level2):
        at_level = {i: d2.blocks[i] <= level2 for i in idxs}
        deleted = []
        for sf in range(8):
            pad = pad_halos(fg, 1)
            for i in idxs:
                own = fg.blocks[i]
                cand = _subfield_deletions(
                    own, neighborhood_codes(pad.blocks[i])[pad.box(i)],
                    at_level[i] & sub_masks[i][sf], True, luts[i])
                fg.blocks[i] = own & ~cand
                deleted.append(cand.any())
        return _reduce(deleted, torch.any, dev0)

    def read(deleted):
        counts["reads"] += 1
        max_d2 = _reduce([torch.where(fg.blocks[i], d2.blocks[i],
                                      0.0).max() for i in idxs],
                         torch.max, dev0).values
        pair = torch.stack([deleted.to(torch.float32), max_d2]).cpu()
        return bool(pair[0]), np.float32(pair[1])

    _, max_d2 = read(torch.zeros((), dtype=torch.bool, device=dev0))
    if max_d2 == 0:
        return fg, counts
    level, stalled = 1, 0
    while (np.float32(level) ** 2 <= max_d2 + np.float32(2.0)
           and stalled < max_waves):
        level2 = float(np.float32(level) ** 2 + np.float32(0.5))
        deleted, max_d2 = read(delete_pass(level2))
        counts["wave"] += 1
        level, stalled = (level, 0) if deleted else (level + 1, stalled + 1)
    deleted, it = True, 0
    while deleted and it < max_waves:
        deleted, _ = read(delete_pass(1e12))
        it += 1
    counts["final"] = it
    return fg, counts


def _old_distribute_flow(system, max_iter=40, init_theta=None):
    E = system.num_edges
    dtype = system.dp_coeff.dtype
    device = system.dp_coeff.device
    theta = (torch.zeros(E, dtype=dtype, device=device) if init_theta is None
             else torch.as_tensor(init_theta, dtype=dtype, device=device))

    def res_fn(th):
        return pd.residuals(th, system)

    jac_fn = torch.func.jacfwd(res_fn)
    eye = torch.eye(E, dtype=dtype, device=device)
    lam = torch.tensor(1e-3, dtype=dtype, device=device)
    for _ in range(max_iter):
        r = res_fn(theta)
        J = jac_fn(theta)
        g = J.T @ r
        H = J.T @ J

        def try_lambda(lam):
            delta = torch.linalg.solve_ex(H + lam * eye, -g)[0]
            r_new = res_fn(theta + delta)
            return delta, torch.sum(r_new ** 2)

        cost = torch.sum(r ** 2)
        d1, c1 = try_lambda(lam)
        d2, c2 = try_lambda(lam * 10.0)
        use1 = c1 <= c2
        delta = torch.where(use1, d1, d2)
        new_cost = torch.where(use1, c1, c2)
        accept = new_cost <= cost
        theta = torch.where(accept, theta + delta, theta)
        lam = torch.where(accept,
                          torch.where(use1, lam * 0.3, lam * 3.0),
                          lam * 10.0)
        lam = torch.clamp(lam, 1e-12, 1e8)
    pressure, _, eflow, _ = pd.propagate(theta, system)
    r_term = (pressure[system.terminal_nodes]
              - system.desired_pressure) / pd._MMHG
    return pd.DistributeResult(
        fractions=pd.split_fractions(theta, system), edge_flow=eflow,
        node_pressure=pressure,
        residual_norm=torch.sqrt(torch.mean(r_term ** 2)),
        iterations=torch.tensor(max_iter), theta=theta)


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
def _grow_tube():
    """A bright tube along x through every block, its seed at the
    middle."""
    rng = np.random.default_rng(11)
    vol = rng.normal(0.1, 0.05, SHAPE).astype(np.float32)
    vol[4:8, 7:11, 2:-2] = 1.0
    seed = np.zeros(SHAPE, bool)
    seed[6, 9, 9:12] = True
    return vol, seed


def _grow_boxes():
    """Bright boxes of two intensities that touch across the blocks'
    faces, seeded in one of them."""
    rng = np.random.default_rng(12)
    vol = rng.normal(0.1, 0.05, SHAPE).astype(np.float32)
    vol[1:7, 2:10, 1:9] = 0.9
    vol[5:11, 8:16, 7:15] = 1.0
    vol[2:10, 12:17, 13:19] = 0.8
    seed = np.zeros(SHAPE, bool)
    seed[3:5, 4:6, 3:5] = True
    return vol, seed


def _thin_tube():
    z, y, x = np.mgrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    return (((z - 6) ** 2 + (y - 9) ** 2 <= 9) & (x >= 2)
            & (x < 18)).astype(np.uint8)


def _thin_boxes():
    vol = np.zeros(SHAPE, np.uint8)
    vol[1:7, 2:10, 1:9] = 1
    vol[5:11, 8:16, 7:15] = 1
    vol[2:10, 12:17, 13:19] = 1
    return vol


GROW = {"tube": _grow_tube, "boxes": _grow_boxes}
THIN = {"tube": _thin_tube, "boxes": _thin_boxes,
        "empty": lambda: np.zeros(SHAPE, np.uint8)}


def _mesh(name):
    return make_volume_mesh(["cpu"] * MESHES[name])


def _grow(fn, mesh, vol, seed, **kw):
    """-> (result as numpy, host reads of stop)."""
    r0, _Reads.n = grow_loop.read_stop.reads, 0
    res = fn(shard_volume(vol, mesh), shard_volume(seed, mesh), **kw)
    reads = grow_loop.read_stop.reads - r0 + _Reads.n
    return ((res.segmented_map.gather().numpy(), int(res.iterations),
             int(res.segmented_count), int(res.stop_reason)), reads)


def _same_grow(a, b):
    return np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def _thin_counts():
    f = sharded.skeletonize
    return {"wave": f.wave_passes, "final": f.final_passes,
            "reads": f.reads, "captures": f.captures,
            "replays": f.replays, "route": f.route}


@pytest.fixture
def table_on_cpu(native_lut, monkeypatch):   # noqa: F811
    """The table route on CPU blocks, for the loop and its copy."""
    monkeypatch.setattr(sharded, "_lut_for", tt._device_lut)
    monkeypatch.setitem(globals(), "_old_lut_for", tt._device_lut)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for depth in (3, 4, 5, 6):
        rng = np.random.default_rng(depth)
        net = set_network_properties(generate_tree(max_depth=depth,
                                                   rng=rng), rng=rng)
        out[depth] = pd.build_distribute_system(
            net, inlet_flow=1e-5, inlet_pressure=13000.0,
            desired_terminating_pressure=9000.0, device="cpu")
    return out


def _fit_bits(res):
    return [np.asarray(x).tobytes() for x in res]


# ----------------------------------------------------------------------
# the in-place loops against the loops before
# ----------------------------------------------------------------------
GROW_CASES = [(m, v, i) for m in MESHES for v in GROW
              for i in (0, 1, 2, 60)]


@pytest.mark.parametrize("mesh_name,vol,iter_max", GROW_CASES,
                         ids=[f"{m}-{v}-{i}" for m, v, i in GROW_CASES])
def test_in_place_grower_matches_old_loop(mesh_name, vol, iter_max):
    m = _mesh(mesh_name)
    data, seed = GROW[vol]()
    new, reads = _grow(sharded.region_grow, m, data, seed,
                       max_segment_size=10 ** 7, iter_max=iter_max)
    old, old_reads = _grow(_old_region_grow, m, data, seed,
                           max_segment_size=10 ** 7, iter_max=iter_max)
    assert _same_grow(new, old)
    sweeps = new[1] + (new[3] == 0)
    assert reads == old_reads == sweeps + 1
    assert sharded.region_grow.route == "host"
    if iter_max == 60:
        assert new[3] == 0 and new[2] > int(seed.sum())


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_in_place_grower_with_the_seed_at_the_cap(mesh_name):
    """No sweep: one read, the seed back."""
    m = _mesh(mesh_name)
    data, seed = _grow_tube()
    new, reads = _grow(sharded.region_grow, m, data, seed,
                       max_segment_size=int(seed.sum()), iter_max=60)
    old, _ = _grow(_old_region_grow, m, data, seed,
                   max_segment_size=int(seed.sum()), iter_max=60)
    assert _same_grow(new, old) and reads == 1
    assert new[1:] == (0, int(seed.sum()), 1)
    assert np.array_equal(new[0], seed)


THIN_CASES = [(m, v, w) for m in MESHES for v in ("tube", "boxes")
              for w in (0, 1, 2, 64)] + [(m, "empty", 64) for m in MESHES]


@pytest.mark.parametrize("mesh_name,vol,max_waves", THIN_CASES,
                         ids=[f"{m}-{v}-{w}" for m, v, w in THIN_CASES])
def test_in_place_thinning_matches_old_loop(mesh_name, vol, max_waves,
                                            table_on_cpu):
    m = _mesh(mesh_name)
    mask = THIN[vol]()
    new = sharded.skeletonize(shard_volume(mask, m), max_waves).gather()
    c = _thin_counts()
    old, oc = _old_skeletonize(shard_volume(mask, m), max_waves)
    assert new.dtype == torch.bool and torch.equal(new, old.gather())
    assert (c["wave"], c["final"], c["reads"]) == (oc["wave"], oc["final"],
                                                   oc["reads"])
    assert c["reads"] == 1 + c["wave"] + c["final"]
    assert (c["captures"], c["replays"], c["route"]) == (0, 0, "host")
    if vol == "empty":
        assert c["reads"] == 1 and not new.any()
    if max_waves == 0:
        assert c["wave"] == c["final"] == 0
    if max_waves == 64 and vol != "empty":
        assert c["wave"] > 2 and 0 < int(new.sum()) < int(mask.sum())


@pytest.mark.parametrize("mesh_name,max_waves", [("2x2", 1), ("1x3", 64)])
def test_labels_route_thinning_matches_old_loop(mesh_name, max_waves):
    """CPU blocks' own route (label propagation), as the pipeline runs
    it here."""
    m = _mesh(mesh_name)
    mask = _thin_tube()
    new = sharded.skeletonize(shard_volume(mask, m), max_waves).gather()
    c = _thin_counts()
    old, oc = _old_skeletonize(shard_volume(mask, m), max_waves)
    assert torch.equal(new, old.gather())
    assert (c["wave"], c["final"], c["reads"]) == (oc["wave"], oc["final"],
                                                   oc["reads"])
    # and the table route's skeleton
    assert torch.equal(new, tt.skeletonize(torch.from_numpy(mask),
                                           max_waves, device="cpu"))


FIT_CASES = [(d, i) for d in (3, 4, 5, 6) for i in (0, 1, 2, 40)]


@pytest.mark.parametrize("depth,max_iter", FIT_CASES,
                         ids=[f"d{d}-{i}" for d, i in FIT_CASES])
def test_in_place_fit_matches_old_loop(nets, depth, max_iter, monkeypatch):
    system = nets[depth]
    reads = []
    real = grow_loop.HostLoop.read
    monkeypatch.setattr(grow_loop.HostLoop, "read",
                        lambda self, stop: reads.append(1) or real(self,
                                                                   stop))
    new = pd.distribute_flow(system, max_iter=max_iter)
    old = _old_distribute_flow(system, max_iter=max_iter)
    assert _fit_bits(new) == _fit_bits(old)
    assert not reads
    assert pd.distribute_flow.steps == max_iter
    assert pd.distribute_flow.captures == pd.distribute_flow.replays == 0


@pytest.mark.parametrize("depth", [4, 6])
def test_in_place_fit_from_an_init_theta(nets, depth):
    system = nets[depth]
    theta0 = torch.from_numpy(np.random.default_rng(depth).normal(
        0.0, 0.3, system.num_edges))
    keep = theta0.clone()
    new = pd.distribute_flow(system, max_iter=7, init_theta=theta0)
    old = _old_distribute_flow(system, max_iter=7, init_theta=keep.clone())
    assert _fit_bits(new) == _fit_bits(old)
    assert torch.equal(theta0, keep)            # the caller's, untouched
    zero = pd.distribute_flow(system, max_iter=0, init_theta=theta0)
    assert torch.equal(zero.theta, keep) and zero.theta is not theta0


# ----------------------------------------------------------------------
# the route
# ----------------------------------------------------------------------
def test_loop_route_by_the_mesh_devices():
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert sharded.loop_route([cuda0] * 4) == "graph"
    assert sharded.loop_route(["cuda:0", "cuda:0"]) == "graph"
    assert sharded.loop_route(["cpu"] * 4) == "host"
    assert sharded.loop_route([cuda0, cuda1, cuda0, cuda1]) == "host"
    two = VolumeMesh([[cuda0, cuda1], [cuda0, cuda1]], ("sx", "sy"))
    assert sharded.loop_route(two.distinct_devices()) == "host"
    one = VolumeMesh([[cuda0, cuda0], [cuda0, cuda0]], ("sx", "sy"))
    assert sharded.loop_route(one.distinct_devices()) == "graph"


# ----------------------------------------------------------------------
# GraphLoop with the stand-in for torch.cuda's graph calls
# ----------------------------------------------------------------------
def _stand_in(monkeypatch):
    """``grow_loop``'s torch.cuda calls on the stand-in and its while
    graphs on the stand-in of their library; ``drive`` takes
    ``graph_loop`` and ``loop_for`` a GraphLoop on the CPU, and the
    sharded stages the "graph" route; the GraphLoops made are
    collected."""
    fake = _StandIn()
    monkeypatch.setattr(grow_loop, "torch", types.SimpleNamespace(
        cuda=fake, int32=torch.int32,
        empty=lambda *a, pin_memory=False, **k: torch.empty(*a, **k)))
    lib = FakeWhileLib(fake.graphs.__getitem__)
    monkeypatch.setattr(graph_while, "_lib", lambda: lib)
    made = []

    def loop_for(device, counters=(), watch=None):
        made.append(grow_loop.GraphLoop(device, counters, watch))
        return made[-1]

    monkeypatch.setattr(grow_loop, "loop_for", loop_for)
    monkeypatch.setattr(grow_loop, "drive", grow_loop.graph_loop)
    monkeypatch.setattr(sharded, "loop_route", lambda devices: "graph")
    return fake, made


def _capturable_sweep(seg, idx, sign_words, valid_yx=None, window=None,
                      *, out, dh):
    """``fused_sweep_plain`` into ``out`` and ``dh``, its counts by
    ``index_add_`` (boolean indexing sizes its result on the host, which
    a capture refuses); a launch counted as K2's wrapper counts it."""
    fused_sweep_counts.launches += 1
    s = seg != 0
    flips = (dilate26(s) & dilate26(~s)
             & (s ^ rfu._unpack_bits(sign_words, idx))
             & rfu._window_mask(s.shape, window, s.device))
    b = idx.reshape(-1).to(torch.int64)
    for row, m in enumerate((flips & ~s, flips & s)):
        dh[row].index_add_(0, b, m.reshape(-1).to(torch.int32))
    rows = tuple(slice(lo, hi) for lo, hi in window[:2])
    out[rows] = (s ^ flips)[rows]
    return out, dh


GRAPH_GROW = [("2x2", "tube", 60), ("1", "boxes", 60), ("1x3", "boxes", 60),
              ("2x2", "tube", 1), ("2x2", "boxes", 2)]


@pytest.mark.parametrize("mesh_name,vol,iter_max", GRAPH_GROW,
                         ids=[f"{m}-{v}-{i}" for m, v, i in GRAPH_GROW])
def test_graph_driven_grower_matches_eager(monkeypatch, mesh_name, vol,
                                           iter_max):
    m = _mesh(mesh_name)
    data, seed = GROW[vol]()
    kw = {"max_segment_size": 10 ** 7, "iter_max": iter_max}
    old, old_reads = _grow(_old_region_grow, m, data, seed, **kw)
    monkeypatch.setattr(sharded, "fused_sweep_counts", _capturable_sweep)
    eager, eager_reads = _grow(sharded.region_grow, m, data, seed, **kw)
    assert _same_grow(eager, old) and eager_reads == old_reads
    fake, made = _stand_in(monkeypatch)
    grow_loop.graph_loop.captures = grow_loop.graph_loop.replays = 0
    k2 = fused_sweep_counts.launches
    graph, reads = _grow(sharded.region_grow, m, data, seed, **kw)
    assert sharded.region_grow.route == "graph" and not made
    assert _same_grow(graph, old)
    sweeps = graph[1] + (graph[3] == 0)
    assert eager_reads == sweeps + 1
    assert reads == min(sweeps, 2) + 1
    captures = 2 if sweeps > 1 else 0
    assert grow_loop.graph_loop.captures == captures
    assert grow_loop.graph_loop.replays == max(sweeps - 1, 0)
    assert fake.modes == [("pool", "thread_local")] * captures
    assert fused_sweep_counts.launches - k2 == MESHES[mesh_name] * sweeps


GRAPH_THIN = [("2x2", "tube", 64), ("1", "boxes", 64), ("1x3", "tube", 2),
              ("2x2", "boxes", 1), ("2x2", "empty", 64), ("1x3", "tube", 0)]


@pytest.mark.parametrize("mesh_name,vol,max_waves", GRAPH_THIN,
                         ids=[f"{m}-{v}-{w}" for m, v, w in GRAPH_THIN])
def test_graph_driven_thinning_matches_eager(monkeypatch, mesh_name, vol,
                                             max_waves, table_on_cpu):
    m = _mesh(mesh_name)
    mask = THIN[vol]()
    eager = sharded.skeletonize(shard_volume(mask, m), max_waves).gather()
    ec = _thin_counts()
    fake, made = _stand_in(monkeypatch)
    graph = sharded.skeletonize(shard_volume(mask, m), max_waves).gather()
    c = _thin_counts()
    assert torch.equal(graph, eager)
    assert len(made) == 1 and c["route"] == "graph"
    assert made[0].runs == {k: v for k, v in (("wave", c["wave"]),
                                              ("final", c["final"])) if v}
    assert (c["wave"], c["final"], c["reads"]) == (ec["wave"], ec["final"],
                                                   ec["reads"])
    assert c["reads"] == 1 + c["wave"] + c["final"]
    captures = (c["wave"] >= 2) + (c["final"] >= 2)
    replays = max(c["wave"] - 1, 0) + max(c["final"] - 1, 0)
    assert (c["captures"], c["replays"]) == (captures, replays)
    assert fake.modes == [("pool", "thread_local")] * captures
    if max_waves == 64 and vol != "empty":
        assert c["replays"] > 0


def test_graph_driven_thinning_raises_when_the_table_is_built_in_capture(
        monkeypatch, table_on_cpu):
    """The table is watched as on one device: one built while a pass is
    captured would hold memory that no kernel wrote."""
    real = sharded._subfield_deletions
    calls = []

    def rebuilt(fg, code, eligible, preserve_endpoints, lut):
        calls.append(1)
        if len(calls) == 8 * 4 + 1:     # the capture's first subfield
            tt._device_lut.cache_clear()
            lut = tt._device_lut(fg.device)
        return real(fg, code, eligible, preserve_endpoints, lut)

    monkeypatch.setattr(sharded, "_subfield_deletions", rebuilt)
    _stand_in(monkeypatch)
    with pytest.raises(RuntimeError, match="cache changed"):
        sharded.skeletonize(shard_volume(_thin_tube(), _mesh("2x2")))


@pytest.mark.parametrize("depth,max_iter", [(3, 40), (5, 2), (6, 3),
                                            (4, 1), (4, 0)])
def test_graph_driven_fit_matches_eager(monkeypatch, nets, depth,
                                        max_iter):
    system = nets[depth]
    eager = pd.distribute_flow(system, max_iter=max_iter)
    fake, made = _stand_in(monkeypatch)
    graph = pd.distribute_flow(system, max_iter=max_iter)
    assert _fit_bits(graph) == _fit_bits(eager)
    assert len(made) == 1 and made[0].reads == 0
    assert made[0].runs == ({"gn": max_iter} if max_iter else {})
    captures = int(max_iter >= 2)
    assert (pd.distribute_flow.steps, pd.distribute_flow.captures,
            pd.distribute_flow.replays) == (max_iter, captures,
                                            max(max_iter - 1, 0))
    assert fake.modes == [("pool", "thread_local")] * captures
