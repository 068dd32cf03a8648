"""The hand-written kernels of the PyTorch port and their wrappers: K1
(Frangi response), K6a/K6b (masked histograms), K2 (full-grid region-grow
sweep, also under the banded entries) and K5 (frontier tiles).

Tests marked ``gpu`` build the CUDA kernels and hold each to its plain
PyTorch version on a CUDA device; they skip where there is none.  K1 is
compiled with -fmad=false and follows the twin's operation order, so its
tolerance is 1e-6 absolute on responses in [0, 1] (measured on an H100:
0, the two are bit-identical).  The region-growing kernels count
integers and take the same decision words, so they must agree exactly.
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
                                                     region_grow)
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,z_lo,zr,best_z0", [
    ((36, 64, 96), 10, 16, 4),     # block-aligned y/x, interior rows
    ((21, 37, 53), 0, 21, 0),      # ragged y/x, z edge-replicated at ends
    ((30, 19, 170), 5, 20, 3),     # the pipeline's x extent
])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("sigma", [0.75, 2.0])
def test_kernel_matches_twin(cuda, shape, z_lo, zr, best_z0, bright,
                             sigma):
    sm = _smoothed(shape, sigma, device=cuda)
    g = _g(sm)
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.uniform(0, 0.05, (zr + best_z0 + 2,)
                                        + shape[1:]).astype(np.float32))
    ref, out = init.to(cuda), init.to(cuda)
    frangi_response_plain_(ref, best_z0, sm, z_lo, zr, sigma, g,
                           bright=bright)
    n0 = frangi_response_max_.launches
    frangi_response_max_(out, best_z0, sm, z_lo, zr, sigma, g, bright=bright)
    torch.cuda.synchronize()
    assert frangi_response_max_.launches == n0 + 1
    assert torch.equal(out[:best_z0], init[:best_z0].to(cuda))
    assert float((out - ref).abs().max()) <= 1e-6


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


@pytest.mark.gpu
def test_sweep_kernel_matches_plain(cuda):
    bins, seg, words = _grow_state(device=cuda)
    seg = seg.to(torch.uint8)
    ref = rgx.fused_sweep_plain(seg, bins, words)
    n0 = rgx.fused_sweep_counts.launches
    out = rgx.fused_sweep_counts(seg, bins, words)
    torch.cuda.synchronize()
    assert rgx.fused_sweep_counts.launches == n0 + 1
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert int(ref[1].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["fused_sweep", "fused_sweep_banded",
                                   "fused_sweep_banded_dma"])
def test_padded_sweep_entries_match_plain(cuda, entry):
    bins, seg, words = _grow_state(device=cuda)
    Z, Y0, X0 = seg.shape
    pad = (0, 64 - X0, 0, 48 - Y0)
    seg_p = torch.nn.functional.pad(seg.to(torch.uint8), pad).contiguous()
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
