"""The hand-written kernels of the PyTorch port and their wrappers: K1
(Frangi response), K6a/K6b (masked histograms), K2 (full-grid region-grow
sweep, also under the banded entries) and K5 (frontier tiles).

Tests marked ``gpu`` build the CUDA kernels and hold each to its plain
PyTorch version on a CUDA device; they skip where there is none.  K1 is
compiled with -fmad=false and follows the twin's operation order, so its
tolerance is 1e-6 absolute on responses in [0, 1] (measured on an H100:
0, the two are bit-identical).  The region-growing kernels count
integers and take the same decision words, so they must agree exactly.
The last tests pin which grower ``region_grow`` takes: f64 data stays on
the f64 full-grid path, on the card too, equal to the CPU's result.
This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops import region_grow_fused as rgx
from arterynetwork_tpu_torch.ops.histogram_kernels import (
    masked_histogram1, masked_histograms2, masked_histograms_plain)
from arterynetwork_tpu_torch.ops.region_grow import (_bin_ids, _quantize,
                                                     _use_fused, region_grow)
from arterynetwork_tpu_torch.ops.region_grow_frontier import (
    _compact, _tile_grid, frontier_step, frontier_step_plain)
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
