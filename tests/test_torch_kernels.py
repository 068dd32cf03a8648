"""The hand-written kernels of the PyTorch port and their wrappers: K1
(Frangi response), K6a/K6b (masked histograms), K2 (full-grid region-grow
sweep, also under the banded entries) and K5 (frontier tiles).

Tests marked ``gpu`` build the CUDA kernels and hold each to its plain
PyTorch version on a CUDA device; they skip where there is none.  K1 is
compiled with -fmad=false and follows the twin's operation order, so its
tolerance is 1e-6 absolute on responses in [0, 1] (measured on an H100:
0, the two are bit-identical).  The region-growing kernels count
integers and take the same decision words, so they must agree exactly.
Then tests pin which grower ``region_grow`` takes: f64 data stays on
the f64 full-grid path, on the card too, equal to the CPU's result.  The
last ones hold the growers' graph-driven loop on the card (each
iteration a captured CUDA graph, all run by one launch of a graph with
a conditional WHILE node) to the eager loop, bit for bit, with the
launches one pass makes and min(passes, 2) + 1 stop reads, and the
flow solver's graph-driven loops (each Newton step, CG block and
refinement step a captured graph) likewise, with its host reads, and
the device thinning's (a wave and a final pass) and the components'
(a labelling round) likewise, with their passes and host reads, and on
a 2x2 mesh of one card's slots the sharded grower's (two sweeps) and
the sharded thinning's loops likewise, and distribute's Gauss-Newton
steps within 1e-9 of the eager loop (its merge sums use atomics).  This
file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import graph_while, grow_loop
from arterynetwork_tpu_torch.ops import region_grow_fused as rgx
from arterynetwork_tpu_torch.ops.histogram_kernels import (
    masked_histogram1, masked_histograms2, masked_histograms_plain)
from arterynetwork_tpu_torch.ops.region_grow import (_bin_ids, _quantize,
                                                     _use_fused, region_grow)
from arterynetwork_tpu_torch.ops.lookup_kernels import sign_lookup
from arterynetwork_tpu_torch.ops.region_grow_frontier import (
    _compact, _tile_grid, frontier_step, frontier_step_plain,
    region_grow_frontier)
from arterynetwork_tpu_torch.ops.vesselness import _smooth
from arterynetwork_tpu_torch.ops.vesselness_fused import (
    frangi_response_max_, frangi_response_plain_)
from arterynetwork_tpu_torch.utils.phantoms import tube_phantom

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _smoothed(shape, sigma, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    zc, yc = shape[0] // 2, shape[1] // 2
    vol[zc - 1:zc + 2, yc - 1:yc + 2, 2:shape[2] - 2] += 1.0
    vol[2:shape[0] - 2, 1:4, shape[2] // 2:shape[2] // 2 + 3] += 0.7
    return _smooth(torch.from_numpy(vol).to(device), sigma)


def _g(sm):
    return (sm.abs().max() * 0.5).reshape(())


def _bowl(shape, sign):
    """``sign`` x a paraboloid bowl, steep in z and shallow in y and x, so
    that qm has the bowl's sign at every voxel of rows [1, Z - 1), the
    replicated y/x faces included: +1 gates every voxel of a bright call
    and none of a dark one, -1 the other way round."""
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                          indexing="ij")
    vol = ((z - shape[0] / 2) ** 2 + (y - shape[1] / 2) ** 2 / shape[1]
           + 0.5 * (x - shape[2] / 2) ** 2 / shape[2])
    return torch.from_numpy((sign * vol).astype(np.float32))


def _k1_against_twin(sm, z_lo, zr, best_z0, sigma, g, bright):
    """K1 and its twin on one call into a random ``best``; the kernel must
    leave the rows outside [best_z0, best_z0 + zr) alone and agree within
    1e-6 (on the card the two are bit-identical)."""
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.uniform(0, 0.05, (zr + best_z0 + 2,)
                                        + tuple(sm.shape[1:])).astype(
                                            np.float32)).to(sm.device)
    ref, out = init.clone(), init.clone()
    frangi_response_plain_(ref, best_z0, sm, z_lo, zr, sigma, g,
                           bright=bright)
    n0 = frangi_response_max_.launches
    frangi_response_max_(out, best_z0, sm, z_lo, zr, sigma, g, bright=bright)
    torch.cuda.synchronize()
    assert frangi_response_max_.launches == n0 + 1
    assert torch.equal(out[:best_z0], init[:best_z0])
    assert torch.equal(out[best_z0 + zr:], init[best_z0 + zr:])
    assert float((out - ref).abs().max()) <= 1e-6
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("shape,z_lo,zr,best_z0", [
    ((36, 64, 96), 10, 16, 4),     # block-aligned y/x, interior rows
    ((21, 37, 53), 0, 21, 0),      # ragged y/x, z edge-replicated at ends
    ((30, 19, 170), 5, 20, 3),     # the pipeline's x extent
    ((1, 17, 33), 0, 1, 0),        # one plane: z replicated on both sides
    ((1, 3, 170), 0, 1, 2),
    ((9, 17, 513), 8, 1, 5),       # one row, at the last plane
] + [((6, y, x), 1, 4, 2) for y in (1, 3, 17)
     for x in (1, 2, 33, 167, 170, 513)])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("sigma", [0.75, 2.0])
def test_kernel_matches_twin(cuda, shape, z_lo, zr, best_z0, bright,
                             sigma):
    sm = _smoothed(shape, sigma, device=cuda)
    _k1_against_twin(sm, z_lo, zr, best_z0, sigma, _g(sm), bright)


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("bright", [True, False])
def test_kernel_matches_twin_all_or_none_gated(cuda, sign, bright):
    sm = _bowl((20, 37, 170), sign).to(cuda)
    g = torch.ones((), device=cuda)      # ~ half the Hessian's norm
    _k1_against_twin(sm, 1, 18, 3, 1.0, g, bright)
    v = torch.zeros((18,) + tuple(sm.shape[1:]), device=cuda)
    frangi_response_plain_(v, 0, sm, 1, 18, 1.0, g, bright=bright)
    if (sign > 0) == bright:             # every voxel gated
        assert not v.any()
    else:                                # none gated: most respond
        assert float((v > 1e-4).float().mean()) > 0.9


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    sm = _smoothed((8, 16, 32), 1.0, device=cuda)
    with pytest.raises(ValueError):
        frangi_response_max_(torch.zeros((4, 16, 32)), 0, sm, 2, 4, 1.0,
                             _g(sm))


def test_cpu_takes_twin_and_counts_no_launch():
    sm = _smoothed((12, 16, 20), 1.0)
    a, b = torch.zeros((6, 16, 20)), torch.zeros((6, 16, 20))
    n0 = frangi_response_max_.launches
    frangi_response_max_(a, 0, sm, 3, 6, 1.0, _g(sm))
    frangi_response_plain_(b, 0, sm, 3, 6, 1.0, _g(sm))
    assert frangi_response_max_.launches == n0
    assert torch.equal(a, b) and float(a.max()) > 0.1


@pytest.mark.parametrize("case", ["dtype", "layout", "yx", "rows", "g"])
def test_wrapper_rejects_bad_arguments(case):
    sm = _smoothed((12, 16, 20), 1.0)
    best = torch.zeros((6, 16, 20))
    g = _g(sm)
    args = dict(best=best, best_z0=0, sm=sm, z_lo=3, zr=6, g=g)
    if case == "dtype":
        args["sm"] = sm.double()
    elif case == "layout":
        args["sm"] = sm.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "yx":
        args["best"] = torch.zeros((6, 16, 21))
    elif case == "rows":
        args["z_lo"] = 8
    else:
        args["g"] = torch.ones(2)
    with pytest.raises(ValueError):
        frangi_response_max_(args["best"], args["best_z0"], args["sm"],
                             args["z_lo"], args["zr"], 1.0, args["g"])


# ----------------------------------------------------------------------
# region growing: K6a, K6b, K2 (and its banded entries), K5
# ----------------------------------------------------------------------
def _grow_state(shape=(40, 36, 50), iters=6, device="cpu"):
    """bins, seg and decision words of the tube phantom after ``iters``
    full-grid iterations (a front with flips in both directions)."""
    vol, seed = tube_phantom(shape, seed=2)
    res = region_grow(vol, seed, backend="xla", iter_max=iters,
                      max_segment_size=10 ** 6, device="cpu")
    idx, _ = _quantize(torch.from_numpy(vol), 256)
    bins = _bin_ids(idx, 256).contiguous()
    seg = res.segmented_map
    rng = np.random.default_rng(iters)
    table = torch.from_numpy(rng.normal(0, 1, 256).astype(np.float32))
    words = rgx.pack_sign_words(table)
    return bins.to(device), seg.to(device), words.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 4099, 200_000])
def test_histogram_kernels_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    bins = rng.integers(0, 256, n).astype(np.uint8)
    bins[: n // 2] = 7
    masks = torch.from_numpy(rng.random((2, n)) < 0.3).to(cuda)
    b = torch.from_numpy(bins).to(cuda)
    ref = masked_histograms_plain(b, masks, 256)
    n1, n2 = masked_histogram1.launches, masked_histograms2.launches
    assert torch.equal(masked_histogram1(b, masks[0]), ref[0])
    assert torch.equal(masked_histograms2(b, masks), ref)
    # unaligned views take the byte path
    assert torch.equal(masked_histogram1(b[1:], masks[1, 1:].contiguous()),
                       masked_histograms_plain(b[1:], masks[1:, 1:], 256)[0])
    torch.cuda.synchronize()
    assert (masked_histogram1.launches, masked_histograms2.launches) == \
        (n1 + 2, n2 + 1)


def _random_state(shape, kind, n_words=8, seed=0, device="cpu"):
    """bins, uint8 seg and decision words of a state the path does not
    reach: Bernoulli(0.5) ("half"; almost every voxel on the boundary,
    many flips, every bin), all segmented ("all") or none ("none"), with
    random words."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 32 * n_words, shape).astype(np.uint8)
    seg = {"half": rng.random(shape) < 0.5, "all": np.ones(shape, bool),
           "none": np.zeros(shape, bool)}[kind]
    words = rng.integers(-2 ** 31, 2 ** 31, n_words).astype(np.int32)
    return (torch.from_numpy(bins).to(device),
            torch.from_numpy(seg.astype(np.uint8)).to(device),
            torch.from_numpy(words).to(device))


_RAGGED = [(z, y, x) for z in (1, 2, 17) for y in (1, 3, 17)
           for x in (1, 31, 33, 170, 513)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", [((40, 36, 50), "grow")]
                         + [((17, 17, 170), k) for k in ("half", "all",
                                                         "none")]
                         + [(s, "half") for s in _RAGGED]
                         + [((18, 17, 170), "view")])
def test_sweep_kernel_matches_plain(cuda, shape, kind):
    if kind == "grow":
        bins, seg, words = _grow_state(shape, device=cuda)
        seg = seg.to(torch.uint8)
    elif kind == "view":       # data not on a 16-byte boundary
        bins, seg, words = _random_state(shape, "half", device=cuda)
        bins, seg = bins[1:], seg[1:]
        assert seg.data_ptr() % 16
    else:
        bins, seg, words = _random_state(shape, kind, seed=sum(shape),
                                         device=cuda)
    ref = rgx.fused_sweep_plain(seg, bins, words)
    n0 = rgx.fused_sweep_counts.launches
    out = rgx.fused_sweep_counts(seg, bins, words)
    torch.cuda.synchronize()
    assert rgx.fused_sweep_counts.launches == n0 + 1
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    if kind != "all" and kind != "none" and seg.numel() > 1000:
        assert int(ref[1].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["fused_sweep", "fused_sweep_banded",
                                   "fused_sweep_banded_dma"])
@pytest.mark.parametrize("kind,valid,padded", [
    ("grow", None, (48, 64)),
    ("half", (17, 33), (32, 128)),
    ("half", (20, 1), (48, 128)),
    ("half", (100, 170), (112, 256))])
def test_padded_sweep_entries_match_plain(cuda, entry, kind, valid, padded):
    if kind == "grow":
        bins, seg, words = _grow_state(device=cuda)
        seg = seg.to(torch.uint8)
    else:
        bins, seg, words = _random_state((5,) + valid, kind, device=cuda)
    Z, Y0, X0 = seg.shape
    pad = (0, padded[1] - X0, 0, padded[0] - Y0)
    seg_p = torch.nn.functional.pad(seg, pad).contiguous()
    bins_p = torch.nn.functional.pad(bins, pad).contiguous()
    kw = {"band": 16} if entry != "fused_sweep" else {}
    out = getattr(rgx, entry)(seg_p, bins_p, words, valid_yx=(Y0, X0),
                              **kw)
    ref = rgx.fused_sweep_plain(seg_p, bins_p, words, valid_yx=(Y0, X0))
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0])
    hp, hn = rgx._hist16(ref[1])
    assert torch.equal(out[1], hp) and torch.equal(out[2], hn)


def _window_swept(seg, bins, words, window, valid=None):
    """K2 over ``window`` into caller buffers, against the plain version:
    the window's rows of its planes over the valid x and the counts added
    into ``dh`` exactly, nothing written outside those rows, and their
    padding past the valid x zero or untouched.  Returns the number of
    the window's flips."""
    Z, Y, X = seg.shape
    valid = valid or (Y, X)
    window = window or ((0, Z), (0, valid[0]), (0, valid[1]))
    ref, ref_dh = rgx.fused_sweep_plain(seg, bins, words, valid, window)
    out = torch.full_like(seg, 7)
    dh = torch.ones((2, 256), dtype=torch.int32, device=seg.device)
    rgx.fused_sweep_counts(seg, bins, words, valid, window, out=out, dh=dh)
    torch.cuda.synchronize()
    rows = tuple(slice(lo, hi) for lo, hi in window[:2])
    assert torch.equal(out[rows][..., :valid[1]], ref[rows][..., :valid[1]])
    assert torch.equal(dh, ref_dh + 1)
    pad = out[rows][..., valid[1]:]
    assert ((pad == 0) | (pad == 7)).all()
    written = torch.zeros_like(seg, dtype=torch.bool)
    written[rows] = True
    assert (out[~written] == 7).all()
    return int(ref_dh.sum())


_BLOCK = (258, 258, 170)        # a 2x2 block of 512x512x170 with its halo
_BLOCK_WIN = ((1, 257), (1, 257), (0, 170))


# The launcher's tiling (csrc/region_grow_sweep.cu): the fewest strips of
# equal height of at most min(64, 2 * 256 / words per row - 2, 16384 /
# row bytes - 2) rows, then z-runs that fill one wave of the card.
@pytest.mark.gpu
@pytest.mark.parametrize("shape,window", [
    # windows of fewer than 8 planes, and windows short enough for z-runs
    # of one plane
    ((40, 100, 170), ((3, 8), (1, 99), (0, 170))),
    ((9, 100, 170), ((1, 8), (0, 100), (0, 170))),
    ((6, 9, 33), ((1, 5), (1, 8), (0, 33))),
    # window heights that are no multiple of the strip height: 257 rows
    # (5 strips of 52, the last 49), 253 (4 of 64, the last 61), 33 rows
    # of 513 (2 of 17, the last 16)
    ((20, _BLOCK[1], 170), ((1, 19), (0, 257), (0, 170))),
    ((20, _BLOCK[1], 170), ((1, 19), (2, 255), (0, 170))),
    ((20, 33, 513), ((0, 20), (0, 33), (0, 513))),
    # one plane, one row, one voxel
    ((17, 17, 170), ((8, 9), (0, 17), (0, 170))),
    ((17, 17, 170), ((0, 17), (5, 6), (0, 170))),
    ((17, 17, 170), ((16, 17), (16, 17), (169, 170))),
    ((3, 3, 33), ((1, 2), (1, 2), (1, 32))),
    # a window touching each face of its region
    ((12, 40, 170), ((0, 5), (1, 39), (1, 169))),
    ((12, 40, 170), ((7, 12), (1, 39), (1, 169))),
    ((12, 40, 170), ((1, 11), (0, 9), (1, 169))),
    ((12, 40, 170), ((1, 11), (30, 40), (1, 169))),
    ((12, 40, 170), ((1, 11), (1, 39), (0, 17))),
    ((12, 40, 170), ((1, 11), (1, 39), (150, 170))),
    # the sharded grower's 258x258x170 block
    (_BLOCK, _BLOCK_WIN),
    # the full grid: 512 rows of 170 (8 strips of 64), 89 rows of 640
    # (4 strips of 23, the last 20)
    ((64, 512, 170), None),
    ((31, 89, 640), None),
])
@pytest.mark.parametrize("kind", ["half", "all", "none"])
def test_sweep_windows_match_plain(cuda, shape, window, kind):
    bins, seg, words = _random_state(shape, kind, seed=sum(shape),
                                     device=cuda)
    flips = _window_swept(seg, bins, words, window)
    size = np.prod([hi - lo for lo, hi in window or ((0, n) for n in shape)])
    if kind == "half" and size > 1000:
        assert flips > 0


@pytest.mark.gpu
def test_sweep_windows_on_views_and_padded_regions(cuda):
    """An unaligned view (data 1 byte past a 16-byte boundary) and a
    padded region (valid_yx), each under a window."""
    bins, seg, words = _random_state((18, 41, 170), "half", device=cuda)
    assert seg[1:].data_ptr() % 16
    _window_swept(seg[1:], bins[1:], words, ((1, 16), (1, 40), (0, 170)))
    pad = (0, 86, 0, 7)
    seg_p = torch.nn.functional.pad(seg, pad).contiguous()
    bins_p = torch.nn.functional.pad(bins, pad).contiguous()
    _window_swept(seg_p, bins_p, words, ((1, 17), (2, 38), (3, 160)),
                  valid=(41, 170))


@pytest.mark.gpu
def test_sweep_into_caller_buffers_on_card(cuda):
    """out=/dh= on the card equals the allocating form on the sharded
    grower's block, on the path's state: no allocation, counts added."""
    bins, seg, words = _grow_state(_BLOCK, iters=8, device=cuda)
    seg = seg.to(torch.uint8)
    ref, ref_dh = rgx.fused_sweep_counts(seg, bins, words, window=_BLOCK_WIN)
    out = torch.zeros_like(seg)
    dh = torch.full((2, 256), 3, dtype=torch.int32, device=cuda)
    n0 = rgx.fused_sweep_counts.launches
    got = rgx.fused_sweep_counts(seg, bins, words, window=_BLOCK_WIN,
                                 out=out, dh=dh)
    torch.cuda.synchronize()
    assert got[0] is out and got[1] is dh
    assert rgx.fused_sweep_counts.launches == n0 + 1
    box = tuple(slice(lo, hi) for lo, hi in _BLOCK_WIN)
    assert torch.equal(out[box], ref[box]) and torch.equal(dh, ref_dh + 3)
    assert int(ref_dh.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k_max,nb", [(64, 1), (5, 1), (64, 3)])
def test_frontier_kernel_matches_plain(cuda, k_max, nb):
    bins, seg, words = _grow_state(device=cuda)
    tile = (8, 16)
    ntz, nty = _tile_grid(seg.shape, tile)
    active = torch.ones(ntz * nty, dtype=torch.bool, device=cuda)
    active[::3] = False
    ids = _compact(active, k_max)
    nact = torch.minimum(active.sum(), torch.tensor(k_max, device=cuda))
    nact = nact.to(torch.int32).reshape(1)
    a, b = seg.to(torch.uint8), seg.to(torch.uint8)
    ref = frontier_step_plain(a, bins, ids, nact, words, tile, nb)
    n0 = frontier_step.launches
    out = frontier_step(b, bins, ids, nact, words, tile, nb)
    torch.cuda.synchronize()
    assert frontier_step.launches == n0 + 1
    assert torch.equal(a, b)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert int(ref[1][:, 0].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,n_words", [
    ((20, 45, 170), "half", 8),        # ragged last tiles in z and y
    ((17, 37, 513), "half", 8),
    ((9, 17, 33), "half", 2),          # 64 bins
    ((12, 33, 31), "all", 8),
    ((12, 33, 31), "none", 8)])
@pytest.mark.parametrize("slots", ["all", "fewer", "one", "none"])
@pytest.mark.parametrize("nb", [1, 3])
def test_frontier_kernel_matches_plain_on_hard_states(cuda, shape, kind,
                                                      n_words, slots, nb):
    bins, seg, words = _random_state(shape, kind, n_words, seed=nb,
                                     device=cuda)
    tile = (8, 16)
    ntz, nty = _tile_grid(shape, tile)
    nt = ntz * nty
    k_pad, nact = {"all": (nt, nt), "fewer": (nt + 5, nt - 1),
                   "one": (max(nt // 2, 1), 1), "none": (nt, 0)}[slots]
    perm = np.random.default_rng(nt).permutation(nt)[:k_pad]
    ids = torch.zeros(k_pad, dtype=torch.int32)
    ids[:len(perm)] = torch.from_numpy(perm.astype(np.int32))
    ids = ids.to(cuda)
    na = torch.tensor([nact], dtype=torch.int32, device=cuda)
    a, b = seg.clone(), seg.clone()
    ref = frontier_step_plain(a, bins, ids, na, words, tile, nb)
    out = frontier_step(b, bins, ids, na, words, tile, nb)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_region_grow_wrappers_take_plain_on_cpu():
    bins, seg, words = _grow_state()
    counts = (masked_histogram1.launches, masked_histograms2.launches,
              rgx.fused_sweep_counts.launches, frontier_step.launches)
    masks = torch.stack([seg.reshape(-1), ~seg.reshape(-1)])
    flat = bins.reshape(-1)
    assert torch.equal(masked_histograms2(flat, masks),
                       masked_histograms_plain(flat, masks))
    s8 = seg.to(torch.uint8)
    out = rgx.fused_sweep_counts(s8, bins, words)
    ref = rgx.fused_sweep_plain(s8, bins, words)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    ids = torch.arange(4, dtype=torch.int32)
    nact = torch.tensor([4], dtype=torch.int32)
    a, b = s8.clone(), s8.clone()
    out = frontier_step(a, bins, ids, nact, words, (8, 16))
    ref = frontier_step_plain(b, bins, ids, nact, words, (8, 16))
    assert torch.equal(a, b) and torch.equal(out[1], ref[1])
    assert counts == (masked_histogram1.launches,
                      masked_histograms2.launches,
                      rgx.fused_sweep_counts.launches,
                      frontier_step.launches)


@pytest.mark.parametrize("case", ["hist_mask_dtype", "hist_shape",
                                  "hist_three", "sweep_dtype",
                                  "sweep_shape", "sweep_words",
                                  "frontier_ids"])
def test_region_grow_wrappers_reject_bad_arguments(case):
    bins = torch.zeros((4, 16, 8), dtype=torch.uint8)
    seg = torch.zeros_like(bins)
    words = torch.zeros(8, dtype=torch.int32)
    flat = bins.reshape(-1)
    m = torch.zeros(flat.shape[0], dtype=torch.bool)
    calls = {
        "hist_mask_dtype": lambda: masked_histogram1(flat, m.to(
            torch.uint8)),
        "hist_shape": lambda: masked_histogram1(flat, m[1:]),
        "hist_three": lambda: masked_histograms2(flat, torch.stack([m] * 3)),
        "sweep_dtype": lambda: rgx.fused_sweep_counts(seg.bool(), bins,
                                                      words),
        "sweep_shape": lambda: rgx.fused_sweep_counts(seg[:, 1:], bins,
                                                      words),
        "sweep_words": lambda: rgx.fused_sweep_counts(seg, bins, words[:4]),
        "frontier_ids": lambda: frontier_step(
            seg, bins, torch.zeros(2, dtype=torch.int64),
            torch.tensor([1], dtype=torch.int32), words, (8, 16)),
    }
    with pytest.raises(ValueError):
        calls[case]()


# ----------------------------------------------------------------------
# which grower region_grow takes: f64 data stays on the f64 full-grid path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend,dtype,device,excluded,num_bins,fused", [
    ("auto", torch.float32, "cuda", False, 256, True),
    ("auto", torch.float64, "cuda", False, 256, False),
    ("auto", torch.float32, "cpu", False, 256, False),
    ("auto", torch.float64, "cpu", False, 256, False),
    ("auto", torch.float32, "cuda", True, 256, False),
    ("auto", torch.float32, "cuda", False, 512, False),
    ("xla", torch.float32, "cuda", False, 256, False),
    ("fused", torch.float32, "cpu", False, 256, True),
    ("fused", torch.float64, "cuda", False, 256, True),   # computes in f32
])
def test_grower_dispatch(backend, dtype, device, excluded, num_bins, fused):
    data = torch.zeros((2, 3, 4), dtype=dtype)
    exc = torch.zeros((2, 3, 4), dtype=torch.bool) if excluded else None
    assert _use_fused(backend, data, exc, num_bins,
                      torch.device(device)) is fused


def test_grower_dispatch_auto_needs_a_volume():
    assert not _use_fused("auto", torch.zeros((3, 4)), None, 256,
                          torch.device("cuda"))


def _f64_tube(shape=(48, 48, 96)):
    """The tube phantom with f64 noise added: values f32 cannot hold."""
    vol, seed = tube_phantom(shape, seed=2)
    rng = np.random.default_rng(3)
    return vol.astype(np.float64) + rng.normal(0, 1e-3, shape), seed


@pytest.mark.gpu
def test_f64_auto_on_card_matches_cpu_full_grid(cuda):
    vol, seed = _f64_tube()
    kw = {"max_segment_size": 10 ** 6, "iter_max": 300}
    ref = region_grow(vol, seed, backend="xla", device="cpu", **kw)
    n0 = rgx.fused_sweep_counts.launches
    out = region_grow(vol, seed, device=cuda, **kw)
    torch.cuda.synchronize()
    assert rgx.fused_sweep_counts.launches == n0
    assert torch.equal(out.segmented_map.cpu(), ref.segmented_map)
    assert torch.equal(out.active_map.cpu(), ref.active_map)
    assert (int(out.iterations), int(out.segmented_count),
            int(out.stop_reason)) == (int(ref.iterations),
                                      int(ref.segmented_count),
                                      int(ref.stop_reason))


@pytest.mark.gpu
@pytest.mark.parametrize("z_lo,z_hi", [(0, None), (3, 33), (17, 18)])
def test_response_fused_kernel_matches_twin(cuda, z_lo, z_hi):
    """``frangi_response_fused`` (the functional form) launches K1 once
    per call on a card and stays within 1e-6 of the twin on the same
    card (the CPU's libm differs from the card's in the last bits)."""
    from arterynetwork_tpu_torch.ops import frangi_response_fused

    sm = _smoothed((36, 40, 53), 1.0, device=cuda)
    g = _g(sm)
    zr = (z_hi or sm.shape[0]) - z_lo
    ref = torch.full((zr,) + tuple(sm.shape[1:]), -float("inf"),
                     device=cuda)
    frangi_response_plain_(ref, 0, sm, z_lo, zr, 1.0, g)
    n0 = frangi_response_max_.launches
    out = frangi_response_fused(sm, 1.0, g, z_lo=z_lo, z_hi=z_hi)
    assert frangi_response_max_.launches == n0 + 1
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_flow_sums_and_solves_repeat_on_the_card(cuda):
    """Two calls on the card give the same bits: a fixed-order segment
    sum with heavy repeats, and f32 CG and tree solves on a tree with
    merge loops; the card's solve agrees with the CPU's within f32."""
    from arterynetwork_tpu_torch.flow import (build_system,
                                              create_ground_truth,
                                              segment_sum)
    from arterynetwork_tpu_torch.flow.solvers import solve_pressure_newton
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    def bits(t):
        return t.cpu().numpy().tobytes()

    rng = np.random.default_rng(3)
    K, S = 4096, 64
    plan = segment_sum.plan_segment_sum(rng.integers(0, S, K),
                                        np.arange(K), S, K, device=cuda)
    src = torch.as_tensor(rng.standard_normal((21, K)) * 10.0 **
                          rng.integers(-8, 8, (21, K)),
                          dtype=torch.float32, device=cuda)
    assert bits(segment_sum.segment_sum(plan, src)) == \
        bits(segment_sum.segment_sum(plan, src))
    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(max_depth=7,
                                               allow_merge=True, rng=rng),
                                 k_value=1.852, rng=rng)
    gt = create_ground_truth(net, option=2, rng=np.random.default_rng(7))
    for dev in ("cpu", cuda):
        system = build_system(net, boundary_pressure=gt.pressure,
                              dtype=torch.float32, device=dev)
        tree = plan_elimination(system)
        assert tree.core_size > 0
        for kw in (dict(linear_solver="cg"),
                   dict(linear_solver="tree", plan=tree)):
            a, b = (solve_pressure_newton(system, **kw) for _ in range(2))
            assert bits(a.pressure) == bits(b.pressure)
            assert bits(a.flow) == bits(b.flow)
            rel = float((a.pressure.double().cpu() - torch.as_tensor(
                gt.pressure)).abs().max() / abs(gt.pressure).max())
            assert rel <= 1e-5


# ----------------------------------------------------------------------
# the growers' loop on the card: captured CUDA graphs, replayed
# ----------------------------------------------------------------------
GROW_KW = {"max_segment_size": 10 ** 6, "iter_max": 300}
# launches per pass and before the loop, by kernel counter
PER_PASS = {"fused": ({"region_grow_sweep": 1}, {"masked_histogram1": 2}),
            "frontier": ({"region_grow_frontier": 1},
                         {"masked_histogram1": 2}),
            "xla": ({"masked_histogram1": 1, "sign_lookup": 1},
                    {"masked_histogram1": 1}),
            "xla_excluded": ({"masked_histograms2": 1, "sign_lookup": 1},
                             {})}


def _growers(shape, device):
    """The four grower cases on bench.py's tube phantom, the excluded
    slab across the tube."""
    vol, seed = tube_phantom(shape)
    data = torch.from_numpy(vol).to(device)
    sd = torch.from_numpy(seed).to(device)
    ex = torch.zeros_like(sd)
    ex[:, :, shape[2] // 2 + 6:shape[2] // 2 + 10] = True
    return {
        "fused": lambda: rgx.region_grow_fused(data, sd, **GROW_KW),
        "frontier": lambda: region_grow_frontier(data, sd, **GROW_KW),
        "xla": lambda: region_grow(data, sd, backend="xla", **GROW_KW),
        "xla_excluded": lambda: region_grow(data, sd, ex, backend="xla",
                                            **GROW_KW)}


def _grow_key(r):
    return [t.cpu() for t in (r.segmented_map, r.active_map, r.iterations,
                              r.segmented_count, r.stop_reason)]


def _launch_counts():
    return {"masked_histogram1": masked_histogram1.launches,
            "masked_histograms2": masked_histograms2.launches,
            "region_grow_sweep": rgx.fused_sweep_counts.launches,
            "region_grow_frontier": frontier_step.launches,
            "sign_lookup": sign_lookup.launches}


def _loop_counts():
    return (grow_loop.read_stop.reads, grow_loop.graph_loop.captures,
            grow_loop.graph_loop.replays)


def _while_counts():
    """While graphs launched, and their two kernels' launches as the
    kernels counted them on the device (set_while, count_step)."""
    return (grow_loop.graph_loop.launches, graph_while.set_while.launches,
            graph_while.count_step.launches)


def _clear_loop_caches():
    """Empty every device loop's cache: the next call of each is cold
    (a miss that captures)."""
    grow_loop.clear_loop_caches()


def _while_want(passes, n_steps):
    """_while_counts' deltas for a grow of ``passes`` passes of
    ``n_steps`` steps: one launch for 2+ passes, set_while once before
    the WHILE node and once per iteration of it, count_step once per
    pass after the first."""
    if passes < 2:
        return (0, 0, 0)
    return (1, 1 + -(-(passes - 1) // n_steps), passes - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(48, 48, 48), (40, 37, 45)],
                         ids=["48", "ragged"])
@pytest.mark.parametrize("grower", list(PER_PASS))
def test_graph_driven_growers_match_eager_loop(cuda, grower, shape,
                                               monkeypatch):
    """Graph-driven and eager loops give the same bits; the graph run
    counts passes x kernels per pass (plus the launches before the
    loop), reads stop min(passes, 2) + 1 times (once before the loop,
    once after the eager pass, once after the one while-graph launch)
    and runs a captured graph for every pass after the first, in one
    while-graph launch whose two kernels counted themselves on the
    device as often as the passes say (``_while_want``); a second call
    (a hit in the grower's cache) captures nothing, launches the same
    while graph again and gives the same result with the same work."""
    fn = _growers(shape, cuda)[grower]
    _clear_loop_caches()
    runs = []
    for _ in range(2):
        n0, l0, w0 = _launch_counts(), _loop_counts(), _while_counts()
        res = fn()
        torch.cuda.synchronize()
        runs.append((_grow_key(res), {k: v - n0[k] for k, v in
                                      _launch_counts().items()},
                     [a - b for a, b in zip(_loop_counts(), l0)],
                     tuple(a - b for a, b in zip(_while_counts(), w0))))
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "drive", grow_loop.host_loop)
        eager = _grow_key(fn())
    key, launched, (reads, captures, replays), whiles = runs[0]
    assert all(torch.equal(a, b) for a, b in zip(key, eager))
    assert all(torch.equal(a, b) for a, b in zip(key, runs[1][0]))
    _, w_launched, (w_reads, w_captures, w_replays), w_whiles = runs[1]
    assert (w_launched, w_reads, w_replays, w_whiles) == (
        launched, reads, replays, whiles)      # the same work, warm
    assert w_captures == 0
    it, stop = int(key[2]), int(key[4])
    passes = it + (stop == 0)
    assert passes > 1
    per_pass, before = PER_PASS[grower]
    want = {k: passes * per_pass.get(k, 0) + before.get(k, 0)
            for k in launched}
    assert launched == want
    assert (reads, replays) == (min(passes, 2) + 1, passes - 1)
    n_steps = 2 if grower == "fused" else 1
    assert captures == n_steps
    assert whiles == _while_want(passes, n_steps)


@pytest.mark.gpu
def test_graph_driven_grower_stops_before_capture(cuda):
    """A seed at the size cap reads stop once and captures nothing; an
    iteration cap of 1 runs the eager iteration alone."""
    vol, seed = tube_phantom((48, 48, 48))
    for kw, reads in (({"max_segment_size": 27}, 1), ({"iter_max": 1}, 2)):
        l0 = _loop_counts()
        res = rgx.region_grow_fused(torch.from_numpy(vol).to(cuda),
                                    torch.from_numpy(seed).to(cuda), **kw)
        assert int(res.iterations) == reads - 1
        assert [a - b for a, b in zip(_loop_counts(), l0)] == [reads, 0, 0]


@pytest.mark.gpu
def test_graph_loop_raises_when_a_step_cannot_be_captured(cuda):
    """No fallback to the eager loop: a step that reads the device on the
    host cannot be captured, and the loop raises."""
    stop = torch.full((), -1, dtype=torch.int32, device=cuda)

    def step():
        int(stop + 0)                  # a host read: refused in capture

    with pytest.raises(RuntimeError):
        grow_loop.graph_loop([step], stop)


# ----------------------------------------------------------------------
# the flow solver's loops on the card: captured CUDA graphs, replayed
# ----------------------------------------------------------------------
def _flow_rows(depth, T, dtype, device, allow_merge=True):
    """T rows on one graph (a merge-loop tree when ``allow_merge``): the
    network, a Poiseuille (k = 1) copy, the network with other boundary
    pressures -> (system, elimination plan); one row is unbatched."""
    import dataclasses

    from arterynetwork_tpu_torch.flow import (build_system,
                                              create_ground_truth)
    from arterynetwork_tpu_torch.flow.physics import poiseuille_equivalent_c
    from arterynetwork_tpu_torch.flow.tree_solver import plan_elimination
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(
        max_depth=depth, allow_merge=allow_merge, rng=rng), k_value=1.852,
        rng=rng)
    rng = np.random.default_rng(9)
    rows = []
    for t in range(T):
        n = net
        if t == 1:
            n = net.replace(c=poiseuille_equivalent_c(net.radius_m()),
                            k=np.ones(net.num_edges))
        gt = create_ground_truth(n, option=2, rng=np.random.default_rng(7))
        bp = gt.pressure * (1.0 + 0.02 * t * rng.random(net.num_nodes))
        rows.append(build_system(n, boundary_pressure=bp, dtype=dtype,
                                 device=device))
    plan = plan_elimination(rows[0])
    if T == 1:
        return rows[0], plan
    stack = {f: torch.stack([getattr(s, f) for s in rows])
             for f in ("radius_m", "c", "k", "node_fixed_pressure")}
    return dataclasses.replace(rows[0], **stack), plan


def _flow_solve(system, plan, solver):
    from arterynetwork_tpu_torch.flow.solvers import (
        SolveStats, solve_pressure_newton, solve_pressure_newton_batch)

    stats = SolveStats()
    kw = dict(linear_solver=solver, plan=plan if solver == "tree" else None,
              stats=stats)
    if system.node_fixed_pressure.dim() == 2:
        sol = solve_pressure_newton_batch(system, **kw)
    else:
        sol = solve_pressure_newton(system, **kw)
    torch.cuda.synchronize()
    bits = [(t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t))
            .tobytes() for t in (sol.pressure, sol.flow, sol.velocity,
                                 sol.residual_norm, sol.iterations)]
    return bits, stats


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("solver", ["dense", "tree", "cg"])
def test_graph_driven_solves_match_eager_loop(cuda, solver, dtype, T,
                                              monkeypatch):
    """Graph-driven and eager loops give the same bits (pressures, flows,
    velocities, residuals, iterations) with the same host reads, linear
    solves and CG steps; the graph run replays captured graphs, and a
    second call replays the first call's (the cache of solves), captures
    none and gives the same bits."""
    from arterynetwork_tpu_torch.flow.solvers import clear_solve_cache

    system, plan = _flow_rows(7, T, dtype, cuda)
    clear_solve_cache()
    (a, sa), (b, sb) = (_flow_solve(system, plan, solver) for _ in range(2))
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "loop_for",
                  lambda *args, **kw: grow_loop.HostLoop())
        eager, se = _flow_solve(system, plan, solver)
    assert a == eager and b == a
    for s in (sa, sb):
        assert (s.host_reads, s.linear_solves) == (se.host_reads,
                                                   se.linear_solves)
        assert (s.cg_steps is None) == (se.cg_steps is None)
        if s.cg_steps is not None:
            assert torch.equal(s.cg_steps, se.cg_steps)
        assert s.replays > 0
    assert sa.captures > 0 and (sa.hits, sa.misses) == (0, 1)
    assert sb.captures == 0 and (sb.hits, sb.misses) == (1, 0)
    assert sb.replays >= sum(sb.runs.values())
    assert se.captures == se.replays == 0


@pytest.mark.gpu
def test_graph_driven_batch_with_a_large_lu(cuda, monkeypatch):
    """A batch's dense LU of ~1,000 unknowns (MAGMA's, which capture
    refuses) runs between the two graphs of each Newton step: the same
    bits and reads as the eager loop, two graphs per captured step."""
    from arterynetwork_tpu_torch.flow.solvers import clear_solve_cache

    system, plan = _flow_rows(10, 3, torch.float64, cuda, allow_merge=False)
    assert system.num_unknown_pressures > 512
    clear_solve_cache()
    graph, sg = _flow_solve(system, plan, "dense")
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "loop_for",
                  lambda *args, **kw: grow_loop.HostLoop())
        eager, se = _flow_solve(system, plan, "dense")
    assert graph == eager
    assert sg.host_reads == se.host_reads
    assert sg.captures == 2 and sg.replays % 2 == 0 and sg.replays > 0


# ----------------------------------------------------------------------
# the device thinning's and the components' loops on the card
# ----------------------------------------------------------------------
def _loop_counts_of(fn, keys):
    return {k: getattr(fn, k) for k in keys + ("reads", "captures",
                                               "replays")}


def _graph_vs_eager(fn, counts, monkeypatch):
    """``fn()`` twice driven by graphs, the caches emptied before (a cold
    call, then a hit that captures nothing and replays every pass), and
    once in the eager loop -> (graph result, eager result, counts of the
    cold run and of the eager one)."""
    _clear_loop_caches()
    runs = []
    for _ in range(2):
        out = fn()
        torch.cuda.synchronize()
        runs.append((out.cpu(), counts()))
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "loop_for",
                  lambda *args, **kw: grow_loop.HostLoop())
        eager = fn().cpu()
        ec = counts()
    (a, ca), (b, cb) = runs
    assert torch.equal(b, a)
    passes = {k: v for k, v in ca.items() if k.endswith(("passes",
                                                          "rounds"))}
    assert {k: cb[k] for k in passes} == passes
    assert (cb["reads"], cb["captures"], cb["replays"]) == (
        ca["reads"], 0, sum(passes.values()))   # warm: every pass replayed
    assert ec["captures"] == ec["replays"] == 0
    return a, eager, ca, ec


def _thin_volume(name):
    from arterynetwork_tpu_torch.utils.phantoms import vascular_tree_phantom

    if name == "blob":
        return np.random.default_rng(0).random((12, 14, 16)) < 0.6
    return vascular_tree_phantom((40, 64, 96), n_branches=12,
                                 root_radius=3.0, branch_length=(12, 25),
                                 seed=1)["mask"]


@pytest.mark.gpu
@pytest.mark.parametrize("max_waves", [1, 64])
@pytest.mark.parametrize("pe", [True, False], ids=["endpoints", "none"])
@pytest.mark.parametrize("vol", ["phantom", "blob"])
def test_graph_driven_thinning_matches_eager_loop(cuda, vol, pe, max_waves,
                                                  monkeypatch):
    """The LUT thinning, each wave and final pass replayed from a
    captured graph, equals the eager loop bit for bit with the same
    passes and 1 + passes host reads; one graph per loop that ran twice,
    a replay per later pass; the mask is left as it was."""
    from arterynetwork_tpu_torch.ops import thinning as tt

    mask = torch.from_numpy(np.asarray(_thin_volume(vol))).to(cuda)
    keep = mask.clone()
    graph, eager, c, ec = _graph_vs_eager(
        lambda: tt.skeletonize(mask, max_waves, pe),
        lambda: _loop_counts_of(tt.skeletonize,
                                ("wave_passes", "final_passes")),
        monkeypatch)
    assert torch.equal(graph, eager) and torch.equal(mask, keep)
    w, f = c["wave_passes"], c["final_passes"]
    assert (w, f, c["reads"]) == (ec["wave_passes"], ec["final_passes"],
                                  ec["reads"])
    assert c["reads"] == 1 + w + f and w > 1
    # cold: each key captured on its second pass, or at the call's end
    assert (c["captures"], c["replays"]) == (
        (w >= 1) + (f >= 1), max(w - 1, 0) + max(f - 1, 0))


def _serpentine():
    """One path of ~2,000 voxels winding through (3, 45, 90): 92 rounds
    with connectivity 1, 91 with 3."""
    vol = np.zeros((3, 45, 90), np.uint8)
    vol[1, ::2, :] = 1
    for k, y in enumerate(range(1, 45, 2)):
        vol[1, y, 89 if k % 2 == 0 else 0] = 1
    return vol


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [1, 2, 64, 4096])
@pytest.mark.parametrize("connectivity", [1, 3])
@pytest.mark.parametrize("vol", ["serpentine", "random"])
def test_graph_driven_components_match_eager_loop(cuda, vol, connectivity,
                                                  max_rounds, monkeypatch):
    """Each labelling round replayed from one captured graph: the eager
    loop's labels and rounds, one host read per round; the input is left
    as it was."""
    from arterynetwork_tpu_torch.ops import cc

    arr = (_serpentine() if vol == "serpentine" else
           np.random.default_rng(1).random((20, 24, 28)) < 0.5)
    mask = torch.from_numpy(arr).to(cuda)
    keep = mask.clone()
    graph, eager, c, ec = _graph_vs_eager(
        lambda: cc.connected_components(mask, connectivity, max_rounds),
        lambda: _loop_counts_of(cc.connected_components, ("rounds",)),
        monkeypatch)
    assert torch.equal(graph, eager) and torch.equal(mask, keep)
    r = c["rounds"]
    assert (r, c["reads"]) == (ec["rounds"], ec["reads"])
    assert c["reads"] == r
    if vol == "serpentine":
        assert r == min(max_rounds, 92 if connectivity == 1 else 91)
    assert (c["captures"], c["replays"]) == (int(r >= 1), max(r - 1, 0))


@pytest.mark.gpu
def test_level2_on_card_matches_host_value(cuda):
    """The wave bound f32(level)^2 + 0.5 computed on the card equals the
    host value the loop used before, at every level up to 2^12."""
    from arterynetwork_tpu_torch.ops import thinning as tt

    levels = np.arange(0, (1 << 12) + 1)
    dev = tt._level2(torch.from_numpy(levels.astype(np.int32)).to(cuda))
    host = np.array([np.float32(lv) ** 2 + np.float32(0.5)
                     for lv in levels], np.float32)
    np.testing.assert_array_equal(dev.cpu().numpy(), host)


@pytest.mark.gpu
def test_subfield_index_on_card_matches_cpu(cuda):
    """The thinning's parity subfields made on the card equal the CPU's,
    at odd shapes and offsets."""
    from arterynetwork_tpu_torch.ops.thinning import _subfield_index

    for shape, origin in (((7, 2, 9), (0, 0, 0)), ((5, 6, 3), (3, 258, 7))):
        assert torch.equal(_subfield_index(shape, origin, cuda).cpu(),
                           _subfield_index(shape, origin))


# ----------------------------------------------------------------------
# the sharded grower's and thinning's loops and distribute's fit on the
# card, on a 2x2 mesh whose slots repeat one card
# ----------------------------------------------------------------------
def _mesh_2x2(cuda):
    from arterynetwork_tpu_torch.parallel.halo import make_volume_mesh

    return make_volume_mesh([torch.device(cuda.type, 0)] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("iter_max", [1, 2, 3, 300])
def test_graph_driven_sharded_grower_matches_eager_loop(cuda, iter_max,
                                                        monkeypatch):
    """The sharded grower's two sweeps (A -> B, B -> A), each a captured
    graph run by one launch of the while graph, equal the eager loop bit
    for bit (mask, iterations, count, stop reason) with the same
    launches (K2 once a block and sweep, K6b twice a block);
    min(sweeps, 2) + 1 stop reads against the eager loop's sweeps +
    1; the while graph's kernels counted on the device as often as the
    eager loop's sweeps say they ran (``_while_want``)."""
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import shard_volume

    vol, seed = tube_phantom((48, 48, 48))
    mesh = _mesh_2x2(cuda)
    _clear_loop_caches()

    def run():
        n0, l0, w0 = _launch_counts(), _loop_counts(), _while_counts()
        res = sharded.region_grow(shard_volume(vol, mesh),
                                  shard_volume(seed, mesh),
                                  max_segment_size=10 ** 6,
                                  iter_max=iter_max)
        torch.cuda.synchronize()
        key = [t.cpu() for t in (res.segmented_map.gather(), res.iterations,
                                 res.segmented_count, res.stop_reason)]
        return (key, {k: v - n0[k] for k, v in _launch_counts().items()},
                [a - b for a, b in zip(_loop_counts(), l0)],
                tuple(a - b for a, b in zip(_while_counts(), w0)),
                sharded.region_grow.route)

    key, launched, (reads, captures, replays), whiles, route = run()
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "drive", grow_loop.host_loop)
        eager = run()
    e_key, e_launched, (e_reads, e_captures, e_replays), e_whiles, _ = eager
    assert route == "graph"
    assert all(torch.equal(a, b) for a, b in zip(key, e_key))
    passes = int(key[1]) + (int(key[3]) == 0)
    want = {k: 0 for k in launched}
    want.update(region_grow_sweep=4 * passes, masked_histogram1=8)
    assert launched == e_launched == want
    assert e_reads == passes + 1 and reads == min(passes, 2) + 1
    assert (captures, replays) == (2 if passes > 1 else 0,
                                   max(passes - 1, 0))
    assert e_captures == e_replays == 0
    assert whiles == _while_want(passes, 2) and e_whiles == (0, 0, 0)
    if iter_max == 300:
        assert int(key[3]) == 0 and passes > 2


@pytest.mark.gpu
@pytest.mark.parametrize("max_waves", [1, 64])
@pytest.mark.parametrize("vol", ["phantom", "blob"])
def test_graph_driven_sharded_thinning_matches_eager_loop(cuda, vol,
                                                          max_waves,
                                                          monkeypatch):
    """The sharded thinning's wave and final passes (8 halo exchanges
    and subfields each), replayed from captured graphs, equal the eager
    loop and the single-device thinning bit for bit, with the same
    passes, 1 + passes host reads and a replay per pass after each key's
    second."""
    from arterynetwork_tpu_torch.ops import thinning as tt
    from arterynetwork_tpu_torch.parallel import sharded
    from arterynetwork_tpu_torch.parallel.halo import shard_volume

    mask = torch.from_numpy(np.asarray(_thin_volume(vol))).to(cuda)
    mesh = _mesh_2x2(cuda)
    graph, eager, c, ec = _graph_vs_eager(
        lambda: sharded.skeletonize(shard_volume(mask, mesh),
                                    max_waves).gather(),
        lambda: _loop_counts_of(sharded.skeletonize,
                                ("wave_passes", "final_passes", "route")),
        monkeypatch)
    assert torch.equal(graph, eager)
    assert torch.equal(graph, tt.skeletonize(mask, max_waves).cpu())
    assert c["route"] == "graph"
    w, f = c["wave_passes"], c["final_passes"]
    assert (w, f, c["reads"]) == (ec["wave_passes"], ec["final_passes"],
                                  ec["reads"])
    assert c["reads"] == 1 + w + f and w >= 1
    assert (c["captures"], c["replays"]) == (
        (w >= 1) + (f >= 1), max(w - 1, 0) + max(f - 1, 0))


@pytest.mark.gpu
def test_graph_driven_fit_matches_eager_loop(cuda, monkeypatch):
    """distribute's Gauss-Newton steps at depth 8, step 1 eager, step 2
    captured, 3-40 replayed: within 1e-9 (relative to the largest
    magnitude) of the eager loop, whose merge sums use atomics too."""
    from arterynetwork_tpu_torch.flow import distribute as pd
    from arterynetwork_tpu_torch.graphs import (generate_tree,
                                                set_network_properties)

    rng = np.random.default_rng(0)
    net = set_network_properties(generate_tree(max_depth=8, rng=rng),
                                 rng=rng)
    system = pd.build_distribute_system(net, 1e-5, 13000.0, device=cuda)
    _clear_loop_caches()
    graph = pd.distribute_flow(system, max_iter=40)
    counts = (pd.distribute_flow.steps, pd.distribute_flow.captures,
              pd.distribute_flow.replays)
    with monkeypatch.context() as m:
        m.setattr(grow_loop, "loop_for",
                  lambda *args, **kw: grow_loop.HostLoop())
        eager = pd.distribute_flow(system, max_iter=40)
    assert counts == (40, 1, 39)
    assert pd.distribute_flow.captures == pd.distribute_flow.replays == 0
    for a, b in zip(graph, eager):
        a, b = a.cpu().double(), b.cpu().double()
        assert torch.all(torch.isfinite(a))
        assert float((a - b).abs().max()) <= 1e-9 * max(
            float(b.abs().max()), 1e-300)
