"""The port's parallel path against the JAX package's, on the CPU.

JAX sees 8 CPU devices (tests/conftest.py) and shards over its 2x4 mesh,
where GSPMD inserts the halo collectives; the port meshes 8 CPU slots
(2x4) and exchanges every halo itself (parallel/halo.py,
parallel/sharded.py).  Inputs are the shapes of tests/test_parallel.py,
made with numpy from seeds.  Tolerances:

  * dilation, EDT, region growing (mask, iterations, count), thinning,
    the sharded pipeline's mask and skeleton, the windowed sweeps, the
    dp rows against the unsharded batch: exact;
  * sharded vesselness: bit-equal to the port's single-device
    ``frangi_vesselness``; within 1e-5 + 1e-4 |ref| of JAX's sharded
    result (tests/test_parallel.py's bound; the two packages' eigenvalue
    arithmetic differs in the last bits);
  * pressures (f32 CG, with the refinement) against JAX's: 1e-5
    relative, the bound tests/test_torch_flow_studies.py holds the f32
    CG flagship entry to.

JAX's sharded ``skeletonize`` takes ~50 s to compile on the CPU for each
call site, and two tests need it (the thinning and the pipeline), so
this file takes ~2 min.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from arterynetwork_tpu.ops import vesselness as J_V
from arterynetwork_tpu.ops.edt import edt as j_edt
from arterynetwork_tpu.ops.region_grow import region_grow as j_region_grow
from arterynetwork_tpu.ops.thinning import skeletonize as j_skeletonize
from arterynetwork_tpu.ops.vesselness import \
    frangi_vesselness as j_frangi_vesselness
from arterynetwork_tpu.parallel.halo import \
    make_volume_mesh as j_make_volume_mesh
from arterynetwork_tpu.parallel.halo import shard_volume as j_shard_volume
from arterynetwork_tpu.parallel.halo import \
    sharded_dilate26 as j_sharded_dilate26
from arterynetwork_tpu.parallel.pipeline_sharded import \
    mini_pipeline_sharded as j_mini_pipeline_sharded
from arterynetwork_tpu_torch import flagship
from arterynetwork_tpu_torch.ops import region_grow_fused as tfused
from arterynetwork_tpu_torch.ops.edt import edt_squared
from arterynetwork_tpu_torch.ops.region_grow import region_grow
from arterynetwork_tpu_torch.ops.stencil import dilate26
from arterynetwork_tpu_torch.ops.thinning import skeletonize
from arterynetwork_tpu_torch.ops.vesselness import frangi_vesselness
from arterynetwork_tpu_torch.parallel import sharded
from arterynetwork_tpu_torch.parallel.distributed import (
    global_volume_mesh, initialize_distributed, solve_batch_dp)
from arterynetwork_tpu_torch.parallel.halo import (halo_exchange,
                                                   make_volume_mesh,
                                                   pad_halos, refresh_halos,
                                                   shard_volume,
                                                   sharded_dilate26)
from arterynetwork_tpu_torch.parallel.pipeline_sharded import \
    mini_pipeline_sharded

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return make_volume_mesh(["cpu"] * 8)


def _jsh(x):
    """``x`` sharded P("sx", "sy", None) over JAX's default 2x4 mesh."""
    return jax.device_put(jnp.asarray(x), NamedSharding(
        j_make_volume_mesh(), P("sx", "sy", None)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _pipeline_raw():
    """tests/test_parallel.py's raw volume: two bright tubes in noise."""
    rng = np.random.default_rng(5)
    raw = rng.normal(100.0, 3.0, (48, 48, 32)).astype(np.float32)
    z, y = np.mgrid[:48, :48]
    raw[((z - 16) ** 2 + (y - 16) ** 2 <= 9)] += 80.0
    raw[((z - 32) ** 2 + (y - 30) ** 2 <= 4)] += 80.0
    return raw


@pytest.fixture(scope="module")
def jax_pipeline():
    return j_mini_pipeline_sharded(_pipeline_raw(), sigmas=(1.5,),
                                   max_waves=12, region_grow_iters=40)


def test_mesh_layout_and_halo_exchange(mesh):
    jm = j_make_volume_mesh()
    assert mesh.shape == dict(zip(jm.axis_names, jm.devices.shape))
    assert mesh.distinct_devices() == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_volume_mesh()
    # every padded block is the global box around it, corners included,
    # also where a halo spans several blocks; face blocks get no halo
    # (fill=None) or ``fill`` planes
    x = torch.arange(32 * 32 * 3).reshape(32, 32, 3)
    sv = shard_volume(x, mesh)
    for halo in (1, 11):
        pad = pad_halos(sv, halo)
        for idx in sv.indices():
            (z0, _), (y0, _), _ = pad.window(idx)
            oz, oy, _ = sv.offset(idx)
            t = pad.blocks[idx]
            assert torch.equal(t, x[oz - z0:oz - z0 + t.shape[0],
                                    oy - y0:oy - y0 + t.shape[1]])
            assert torch.equal(pad.interior(idx), sv.blocks[idx])
        assert torch.equal(pad.crop().gather(), x)
    out, lo, hi = halo_exchange(sv.blocks, 1, 2, fill=-1)
    assert (lo == 2).all() and (hi == 2).all()
    assert (out[0, 0][:, :2] == -1).all() and (out[0, 3][:, -2:] == -1).all()
    # along one dim, a halo spanning two blocks of 8 rows
    out, lo, hi = halo_exchange(sv.blocks, 1, 11)
    for idx in sv.indices():
        oz, oy, _ = sv.offset(idx)
        assert torch.equal(out[idx], x[oz:oz + 16, oy - lo[idx]:oy + 8 +
                                       hi[idx]])
    assert torch.equal(sv.gather(), x)


@pytest.mark.parametrize("devices,shape,halo,fill", [
    (4, (8, 12, 5), 1, None),
    (8, (2, 4, 7), 1, None),          # blocks one plane and one row thick
    (8, (4, 8, 3), 3, None),          # a halo spanning two blocks
    (4, (6, 6, 4), 2, -1)])           # face slots of a fill stay
def test_refresh_halos_equals_pad_halos(devices, shape, halo, fill):
    """Halo slots overwritten (all but a ``fill``'s face slots, which no
    update touches), then refreshed from the blocks' own voxels: each
    padded block equals pad_halos', corners included; without a fill the
    copies count exactly the halo slots."""
    m = make_volume_mesh(["cpu"] * devices)
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    sv = shard_volume(x, m)
    pad = pad_halos(sv, halo, fill)
    ref = {i: pad.blocks[i].clone() for i in sv.indices()}
    # pad_halos' blocks: the global box around each, ``fill`` past the
    # volume's faces
    h = 0 if fill is None else halo
    xp = torch.full((shape[0] + 2 * h, shape[1] + 2 * h, shape[2]),
                    0 if fill is None else fill, dtype=x.dtype)
    xp[h:h + shape[0], h:h + shape[1]] = x
    for i in sv.indices():
        (z0, _), (y0, _), _ = pad.window(i)
        oz, oy, _ = sv.offset(i)
        t = ref[i]
        assert torch.equal(t, xp[oz + h - z0:oz + h - z0 + t.shape[0],
                                 oy + h - y0:oy + h - y0 + t.shape[1]])
    for i in sv.indices():
        halo_slots = torch.ones(ref[i].shape, dtype=torch.bool)
        halo_slots[pad.box(i)] = False
        pad.blocks[i][halo_slots & (ref[i] != fill)] = -7
    n = refresh_halos(pad)
    for i in sv.indices():
        assert torch.equal(pad.blocks[i], ref[i])
    if fill is None:
        assert n == sum(t.numel() for t in ref.values()) - x.numel()


def test_sharded_dilate26_exact(mesh):
    rng = np.random.default_rng(0)
    mask = rng.random((32, 32, 24)) > 0.95
    ref = np.asarray(j_sharded_dilate26(j_shard_volume(
        jnp.asarray(mask), j_make_volume_mesh()), j_make_volume_mesh()))
    out = sharded_dilate26(mask, mesh).gather().numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, dilate26(torch.from_numpy(mask)))


def _tube_volume():
    rng = np.random.default_rng(1)
    vol = rng.normal(0.1, 0.02, (32, 32, 24)).astype(np.float32)
    x, y = np.mgrid[:32, :32]
    vol[(x - 16) ** 2 + (y - 16) ** 2 <= 9] = 1.0
    return vol


def _blocked_volume():
    """An axis length that takes the JAX package's block-banded
    contraction (y >= _BLOCKED_MIN_N)."""
    rng = np.random.default_rng(7)
    vol = rng.normal(0.1, 0.02, (8, J_V._BLOCKED_MIN_N, 24)) \
        .astype(np.float32)
    vol[3:6, 180:200, 8:16] = 1.0
    return vol


@pytest.mark.parametrize("make,sigmas", [(_tube_volume, (2.0,)),
                                         (_tube_volume, (1.0, 2.0)),
                                         (_blocked_volume, (2.0,))])
def test_sharded_vesselness(mesh, make, sigmas):
    vol = make()
    out = sharded.frangi_vesselness(shard_volume(vol, mesh),
                                    sigmas=sigmas).gather()
    single = frangi_vesselness(torch.from_numpy(vol), sigmas=sigmas,
                               device="cpu")
    assert torch.equal(out, single)
    ref = np.asarray(j_frangi_vesselness(_jsh(vol), sigmas=sigmas))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("band", [8, 32])
def test_sharded_edt_exact(mesh, band):
    rng = np.random.default_rng(2)
    mask = (rng.random((32, 32, 24)) < 0.7).astype(np.uint8)
    d2 = sharded.edt_squared(shard_volume(mask, mesh), band=band).gather()
    assert torch.equal(d2, edt_squared(torch.from_numpy(mask), band=band,
                                       device="cpu"))
    ref = np.asarray(j_edt(_jsh(mask), band=band))
    np.testing.assert_array_equal(torch.sqrt(d2).numpy(), ref)


def test_sharded_region_grow_matches_gspmd(mesh):
    volume = np.zeros((32, 32, 64), dtype=np.float32)
    volume[14:18, 14:18, 8:56] = 1.0
    seed = np.zeros(volume.shape, bool)
    seed[15:17, 15:17, 30:33] = True
    ref = j_region_grow(_jsh(volume), _jsh(seed))
    out = sharded.region_grow(shard_volume(volume, mesh),
                              shard_volume(seed, mesh))
    np.testing.assert_array_equal(out.segmented_map.gather().numpy(),
                                  np.asarray(ref.segmented_map))
    assert int(out.iterations) == int(ref.iterations)
    assert int(out.segmented_count) == int(ref.segmented_count)
    assert int(out.stop_reason) == int(ref.stop_reason)
    single = region_grow(torch.from_numpy(volume), torch.from_numpy(seed),
                         device="cpu")
    assert int(single.stop_reason) == int(out.stop_reason)


def _grow_tube(shape):
    rng = np.random.default_rng(11)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    c0, c1 = shape[0] // 2, shape[1] // 2
    vol[max(c0 - 2, 0):c0 + 2, max(c1 - 2, 0):c1 + 2, 2:-2] = 1.0
    seed = np.zeros(shape, bool)
    seed[c0, c1, shape[2] // 2 - 1:shape[2] // 2 + 2] = True
    return vol, seed


@pytest.mark.parametrize("devices,shape", [
    (4, (32, 32, 24)),                # 2x2 of 16x16 blocks
    (8, (32, 32, 24)),                # 2x4 of 16x8 blocks
    (8, (2, 12, 40)),                 # 2x4, blocks one plane thick
    (4, (2, 2, 33))])                 # 2x2, blocks one plane and one row
def test_sharded_region_grow_matches_single_device(devices, shape,
                                                   monkeypatch):
    """The grower on two persistent padded copies equals the
    single-device grower (mask, iterations, count, stop reason), and
    after every sweep each block's refreshed halo equals pad_halos of
    the swept blocks' own voxels, corners included."""
    vol, seed = _grow_tube(shape)
    refreshes = []

    def checked(pad, faces):
        n = refresh_halos(pad, faces)
        fresh = pad_halos(pad.crop(), 1)
        for i in pad.source.indices():
            assert torch.equal(pad.blocks[i], fresh.blocks[i])
        refreshes.append(n)
        return n

    monkeypatch.setattr(sharded, "refresh_halos", checked)
    m = make_volume_mesh(["cpu"] * devices)
    out = sharded.region_grow(shard_volume(vol, m), shard_volume(seed, m),
                              max_segment_size=10 ** 7, iter_max=30)
    single = region_grow(torch.from_numpy(vol), torch.from_numpy(seed),
                         max_segment_size=10 ** 7, iter_max=30,
                         device="cpu")
    assert torch.equal(out.segmented_map.gather(), single.segmented_map)
    for name in ("iterations", "segmented_count", "stop_reason"):
        assert int(getattr(out, name)) == int(getattr(single, name)), name
    sweeps = int(single.iterations) + (int(single.stop_reason) == 0)
    assert len(refreshes) == sweeps and int(single.segmented_count) > 3
    # only halo faces are copied: the padded blocks' halo slots, each once
    pad = pad_halos(shard_volume(np.zeros(shape, np.uint8), m), 1)
    halo = sum(pad.blocks[i].numel() for i in pad.source.indices()) \
        - int(np.prod(shape))
    assert set(refreshes) == {halo}


def test_sharded_thinning_matches_jax(mesh):
    vol = np.zeros((48, 48, 32), bool)
    z, y = np.mgrid[:48, :48]
    vol[(z - 20) ** 2 + (y - 20) ** 2 <= 12] = True
    vol[:, 22:26, 10:14] = True
    ref = np.asarray(j_skeletonize(_jsh(vol), max_waves=24))
    out = sharded.skeletonize(shard_volume(vol, mesh),
                              max_waves=24).gather()
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(out, skeletonize(torch.from_numpy(vol),
                                        max_waves=24, device="cpu"))
    assert 0 < int(out.sum()) < int(vol.sum())


def test_mini_pipeline_sharded_matches_jax(mesh, jax_pipeline):
    raw = _pipeline_raw()
    out = mini_pipeline_sharded(raw, mesh=mesh, sigmas=(1.5,),
                                max_waves=12, region_grow_iters=40)
    ref = jax_pipeline
    np.testing.assert_array_equal(out["mask"], ref["mask"])
    np.testing.assert_array_equal(out["skeleton"], ref["skeleton"])
    assert out["segments"], "no segments extracted"
    assert len(out["segments"]) == len(ref["segments"])
    for a, b in zip(out["segments"], ref["segments"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert out["pressure_batch"].shape == ref["pressure_batch"].shape
    assert out["pressure_batch"].shape[0] == 8
    assert _rel(out["pressure_batch"], ref["pressure_batch"]) <= 1e-5
    # the single-device composition of the port (test_parallel.py's)
    v1 = frangi_vesselness(torch.from_numpy(raw), sigmas=(1.5,),
                           device="cpu")
    np.testing.assert_array_equal(out["vesselness"], v1.numpy())
    vmin, vmax = float(v1.min()), float(v1.max())
    seeds = v1.numpy() > vmin + 0.5 * (vmax - vmin)
    grown = region_grow(v1, torch.from_numpy(seeds),
                        max_segment_size=10 ** 7, iter_max=40)
    mask1 = grown.segmented_map
    np.testing.assert_array_equal(out["mask"], mask1.numpy())
    np.testing.assert_array_equal(
        out["skeleton"], skeletonize(mask1, max_waves=12).numpy())
    assert set(out["timings"]) >= {"vesselness", "region_grow",
                                   "thinning", "graph", "flow"}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("T", [8, 5])
def test_dp_batch_rows_equal_unsharded(mesh, T, split):
    """The dp rows equal the unsharded batch's.  ``split``: the slots
    name two distinct devices ("cpu" and "cpu:0" compare unequal), so
    the rows are solved as two batches and concatenated; otherwise the
    8 slots repeat one device and share one batch."""
    from arterynetwork_tpu_torch.flow.solvers import \
        solve_pressure_newton_batch
    from arterynetwork_tpu_torch.parallel.distributed import _device_shares

    system, _ = flagship.flagship_system(max_depth=6, device="cpu")
    scale = 1.0 + 0.01 * torch.arange(T, dtype=torch.float32)
    fixed = system.node_fixed_pressure[None, :] * scale[:, None]
    slots = [torch.device("cpu"), torch.device("cpu", 0)] * 2 if split \
        else mesh
    assert len(_device_shares(slots, system.device)) == (2 if split else 1)
    out = solve_batch_dp(system, fixed, slots=slots, max_iter=30,
                         linear_solver="cg")
    one = solve_pressure_newton_batch(
        dataclasses.replace(system, node_fixed_pressure=fixed),
        max_iter=30, linear_solver="cg")
    for name in ("pressure", "flow", "velocity", "residual_norm",
                 "iterations"):
        assert torch.equal(getattr(out, name), getattr(one, name)), name
    # one process: the group is not joined and dp spans the slots
    assert initialize_distributed(devices=["cpu"] * 4) == 4
    gm = global_volume_mesh(dp=2, devices=["cpu"] * 8)
    assert gm.shape == {"dp": 2, "sx": 2, "sy": 2}


def _sweep_state(shape, seed):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8))
    bins = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 8)
                             .astype(np.int32))
    return seg, bins, words


@pytest.mark.parametrize("devices,shape", [(4, (12, 20, 37)),
                                           (8, (10, 24, 170))])
def test_windowed_sweeps_reassemble_whole_volume(devices, shape):
    """Each halo-padded shard swept over its own window: the interiors
    reassemble the whole volume's sweep and the deltas sum to its."""
    seg, bins, words = _sweep_state(shape, devices)
    whole, dh = tfused.fused_sweep_plain(seg, bins, words)
    m = make_volume_mesh(["cpu"] * devices)
    seg_p = pad_halos(shard_volume(seg, m), 1)
    bins_p = pad_halos(shard_volume(bins, m), 1)
    total = torch.zeros_like(dh)
    for idx in seg_p.source.indices():
        out, dh_i = tfused.fused_sweep_counts(
            seg_p.blocks[idx], bins_p.blocks[idx], words,
            window=seg_p.window(idx))
        seg_p.blocks[idx] = out
        total += dh_i
    assert torch.equal(seg_p.crop().gather(), whole)
    assert torch.equal(total, dh)


@pytest.mark.parametrize("window", [
    ((0, 12), (0, 20), (0, 37)),      # the whole region
    ((5, 6), (0, 20), (0, 37)),       # one plane
    ((0, 12), (7, 8), (0, 37)),       # one row
    ((0, 1), (19, 20), (36, 37)),     # one voxel at a corner
    ((3, 12), (0, 9), (0, 37)),       # touching one z and one y face
    ((2, 9), (4, 15), (5, 30)),       # inside, x cut too
])
@pytest.mark.parametrize("padded", [False, True])
def test_windowed_sweep_plain(window, padded):
    """Only window voxels flip and count; the rule reads the whole
    region (so the window's voxels are the whole sweep's there); the
    rest of the result is unspecified."""
    seg, bins, words = _sweep_state((12, 20, 37), 3)
    valid = None
    if padded:
        seg = torch.nn.functional.pad(seg, (0, 11, 0, 4))
        bins = torch.nn.functional.pad(bins, (0, 11, 0, 4))
        valid = (20, 37)
    whole, _ = tfused.fused_sweep_plain(seg, bins, words, valid)
    out, dh = tfused.fused_sweep_counts(seg, bins, words, valid, window)
    inside = tfused._window_mask(seg.shape, window, seg.device)
    box = tuple(slice(lo, hi) for lo, hi in window)
    assert torch.equal(out[box], whole[box])
    flips = inside & (whole != (seg != 0).to(torch.uint8))
    s = seg != 0
    b = bins.long()
    ref = torch.stack([torch.bincount(b[flips & ~s], minlength=256),
                       torch.bincount(b[flips & s], minlength=256)])
    assert torch.equal(dh, ref.to(torch.int32))
    with pytest.raises(ValueError, match="window"):
        tfused.fused_sweep_counts(seg, bins, words, valid,
                                  ((0, 13), (0, 20), (0, 37)))


@pytest.mark.parametrize("window", [
    None,                             # the whole region
    ((5, 6), (0, 20), (0, 37)),       # one plane
    ((0, 1), (19, 20), (36, 37)),     # one voxel at a corner
    ((2, 9), (4, 15), (5, 30)),       # inside, x cut too
])
@pytest.mark.parametrize("padded", [False, True])
def test_sweep_into_caller_buffers_plain(window, padded):
    """The wrapper's out=/dh= form (through the plain version here)
    equals the allocating form: the window's rows of its planes written
    (over the valid x) and nothing else of ``out``, the counts added into
    ``dh``; both buffers are returned as they are."""
    seg, bins, words = _sweep_state((12, 20, 37), 6)
    valid = None
    if padded:
        seg = torch.nn.functional.pad(seg, (0, 11, 0, 4))
        bins = torch.nn.functional.pad(bins, (0, 11, 0, 4))
        valid = (20, 37)
    ref, ref_dh = tfused.fused_sweep_counts(seg, bins, words, valid, window)
    out = torch.full_like(seg, 7)
    dh = torch.arange(512, dtype=torch.int32).reshape(2, 256)
    got, got_dh = tfused.fused_sweep_counts(seg, bins, words, valid, window,
                                            out=out, dh=dh)
    assert got is out and got_dh is dh
    (z0, z1), (y0, y1) = (window or ((0, 12), (0, 20)))[:2]
    written = torch.zeros(seg.shape, dtype=torch.bool)
    written[z0:z1, y0:y1, :37] = True
    assert torch.equal(out[written], ref[written])
    assert (out[~written] == 7).all()
    assert torch.equal(dh, ref_dh + torch.arange(512, dtype=torch.int32)
                       .reshape(2, 256))
    for bad in ({"out": seg}, {"out": out[:, 1:]},
                {"out": out.to(torch.int32)},
                {"dh": dh.to(torch.int64)}, {"dh": dh[:, :128]}):
        with pytest.raises(ValueError):
            tfused.fused_sweep_counts(seg, bins, words, valid, window, **bad)


def test_dryrun_multichip_cpu():
    """The dry run on 8 CPU slots: its region count equals JAX's grower
    on the same tube and its dp pressures JAX's vmapped f32 CG solve."""
    import __graft_entry__ as graft
    from arterynetwork_tpu.flow.solvers import solve_pressure_newton

    out = flagship.dryrun_multichip(8, device="cpu")
    shape = (32, 32, 24)                    # 16 sx x 16 sy x 24, 2x2x2
    vol = np.zeros(shape, np.float32)
    vol[14:18, 14:18, 4:20] = 1.0
    seed = np.zeros(shape, bool)
    seed[15:17, 15:17, 10:13] = True
    ref = j_region_grow(jnp.asarray(vol), jnp.asarray(seed), iter_max=20,
                        max_segment_size=100000)
    assert out["segmented_count"] == int(ref.segmented_count)
    np.testing.assert_array_equal(
        out["grown"].segmented_map.gather().numpy(),
        np.asarray(ref.segmented_map))

    system, _ = graft._flagship_system(max_depth=6, dtype=jnp.float32)
    base = jnp.asarray(system.node_fixed_pressure, jnp.float32)
    batch = base[None, :] * (1.0 + 0.01 * jnp.arange(2, dtype=jnp.float32)
                             )[:, None]

    def one(fp):
        return solve_pressure_newton(
            dataclasses.replace(system, node_fixed_pressure=fp),
            max_iter=20, linear_solver="cg").pressure

    p_ref = np.asarray(jax.vmap(one)(batch))
    assert _rel(out["pressures"].numpy(), p_ref) <= 1e-5
    assert out["pipeline"]["pressure_batch"].shape[0] == 8
    assert out["distinct_devices"] == 1
