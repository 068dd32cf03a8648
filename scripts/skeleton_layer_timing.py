"""Times the EDT-and-thinning layer's host passes (csrc/skeleton_layer.cpp).

Two parts, written as one JSON object to ``--out`` (and printed):

split      the passes run_pipeline's native route ran before the layer
           (a numpy bounding box and crop, ``edt3d_sq_masked``,
           ``thin_volume``, ``np.sqrt``, a full-frame ``np.zeros`` with the
           box scattered in) against the layer's, as run_pipeline calls
           them, on rough tree-phantom masks in the mra_512 cell's frame
           (512x512x170, 400 branches, root radius 6); every array compared,
           medians in ms over rounds.
crossover  each of the layer's passes on its serial and on its threaded
           route, on rough tree masks whose frame holds 2^14 to 2^24
           voxels, in one process on a quiet host and then in
           ``--copies`` processes at once (a host whose cores other work
           shares, as test workers share them); where the threaded route
           starts to pay is what ``ops/native._THREADED_VOXELS`` is set
           from.

The masks are the benchmark's tree phantom (``benchmark/frozen/phantom``)
with a rough surface like the hysteresis's: part of the one-voxel shell
around the tree added, part of its own surface taken away.

Usage: python scripts/skeleton_layer_timing.py [--rounds 7] [--masks 3]
       [--copies 4] [--device cuda] [--small]
       [--out build/layer_timing.json]
(``--small``: a 256x256x170 frame and frames up to 2^20 voxels, for a CPU try.)
"""

import argparse
import ctypes
import json
import multiprocessing
import os
import statistics
import sys
import time

import numpy as np
import scipy.ndimage as ndi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from arterynetwork_tpu_torch.ops import native  # noqa: E402
from frozen.phantom import grow_tree, rasterise  # noqa: E402

U8 = ctypes.POINTER(ctypes.c_uint8)
F32 = ctypes.POINTER(ctypes.c_float)
PASSES = ("box", "crop", "edt", "thin", "sqrt", "frame")


def rough_tree(shape, n_branches, root_radius, seed, device):
    rng = np.random.default_rng([seed])
    lines, radii, _ = grow_tree(shape, n_branches=n_branches,
                                root_radius=root_radius, rng=rng)
    mask = rasterise(shape, lines, radii, device).cpu().numpy()
    shell = ndi.binary_dilation(mask) & ~mask
    surface = mask & ~ndi.binary_erosion(mask)
    mask = ((mask & ~(surface & (rng.random(shape) < 0.15)))
            | (shell & (rng.random(shape) < 0.35)))
    return mask.astype(np.uint8)


def numpy_box(mask, margin=2):
    """The bounding box as run_pipeline took it before the layer."""
    def _sl(profile, axis):
        nz = np.nonzero(profile)[0]
        return slice(max(int(nz[0]) - margin, 0),
                     min(int(nz[-1]) + margin + 1, mask.shape[axis]))

    proj_zy = mask.any(axis=2)
    return (_sl(proj_zy.any(axis=1), 0), _sl(proj_zy.any(axis=0), 1),
            _sl(mask.any(axis=(0, 1)), 2))


class Clock:
    def __init__(self):
        self.ms = {}
        self.t = time.perf_counter()

    def lap(self, name):
        t = time.perf_counter()
        self.ms[name] = (t - self.t) * 1e3
        self.t = t


def before(mask, lib):
    """The passes before the layer, timed; their arrays."""
    c = Clock()
    box = numpy_box(mask)
    c.lap("box")
    mb = np.array(mask[box], dtype=np.uint8, order="C")
    c.lap("crop")
    d2 = np.empty(mb.shape, np.float32)
    if lib.edt3d_sq_masked(mb.ctypes.data_as(U8), *mb.shape, 16,
                           d2.ctypes.data_as(F32)):
        d2 = native.edt_native(mb, squared=True)
    c.lap("edt")
    lib.thin_volume(mb.ctypes.data_as(U8), *mb.shape,
                    d2.ctypes.data_as(F32), 1)
    c.lap("thin")
    dt = np.sqrt(d2, out=d2)
    c.lap("sqrt")
    full = np.zeros(mask.shape, bool)
    full[box] = mb
    c.lap("frame")
    return c.ms, (box, dt, mb, full)


def layer(mask):
    """The layer's passes as run_pipeline calls them, timed; their arrays."""
    c = Clock()
    box = native.bounding_box(mask, margin=2)
    c.lap("box")
    mb = native.crop_box(mask, box)
    c.lap("crop")
    rows = np.empty(mb.shape[:2], np.uint8)
    d2 = native.edt_masked_native(mb, squared=True, rows=rows)
    c.lap("edt")
    sk = native.skeletonize_native_cropped(mb, d2, preserve_endpoints=True,
                                           clobber=True)
    c.lap("thin")
    dt = native.sqrt_rows(d2, rows)
    c.lap("sqrt")
    full = native.skeleton_frame(sk, box, mask.shape)
    c.lap("frame")
    return c.ms, (box, dt, sk, full)


def routed(mask, lib, threaded):
    """Each layer pass called with ``threaded`` forced, timed."""
    c = Clock()
    ext = np.empty(6, np.int64)
    lib.sl_bounding_box(mask.ctypes.data_as(U8), *mask.shape, threaded,
                        ext.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    c.lap("box")
    lo = [max(int(ext[2 * a]) - 2, 0) for a in range(3)]
    size = [min(int(ext[2 * a + 1]) + 3, mask.shape[a]) - lo[a]
            for a in range(3)]
    mb = np.empty(size, np.uint8)
    lib.sl_crop(mask.ctypes.data_as(U8), *mask.shape, *lo, *size,
                mb.ctypes.data_as(U8), threaded)
    c.lap("crop")
    d2 = np.empty(mb.shape, np.float32)
    rows = np.empty(mb.shape[:2], np.uint8)
    assert not lib.sl_edt_sq_masked(mb.ctypes.data_as(U8), *mb.shape, 16,
                                    d2.ctypes.data_as(F32),
                                    rows.ctypes.data_as(U8), threaded)
    c.lap("edt")
    stats = (ctypes.c_long * 2)()
    lib.sl_thin(mb.ctypes.data_as(U8), *mb.shape, d2.ctypes.data_as(F32), 1,
                threaded, stats)
    c.lap("thin")
    lib.sl_sqrt_rows(d2.ctypes.data_as(F32), *d2.shape,
                     rows.ctypes.data_as(U8), threaded)
    c.lap("sqrt")
    full = np.empty(mask.shape, np.uint8)
    lib.sl_frame(mb.ctypes.data_as(U8), *mb.shape, *lo,
                 full.ctypes.data_as(U8), *mask.shape, threaded)
    c.lap("frame")
    return c.ms, (d2, mb, full), mb.size


def medians(runs):
    return {p: round(statistics.median(r[p] for r in runs), 3)
            for p in PASSES}


def split(args, lib):
    shape = (256, 256, 170) if args.small else (512, 512, 170)
    n = 100 if args.small else 400
    masks = [rough_tree(shape, n, 6.0, 2_600_000_000 + i, args.device)
             for i in range(args.masks)]
    old, new, counts = [], [], []
    for r in range(args.rounds):
        for mask in masks:
            ms_old, want = before(mask, lib)
            native.reset_layer_counts()
            ms_new, got = layer(mask)
            counts.append(dict(native.LAYER_COUNTS))
            assert got[0] == want[0]
            for a, b in zip(got[1:], want[1:]):
                assert np.array_equal(a, b)
            old.append(ms_old)
            new.append(ms_new)
    out = {"frame": list(shape), "vessel_voxels":
           [int(m.sum()) for m in masks],
           "before_ms": medians(old), "layer_ms": medians(new),
           "counts": counts[:args.masks]}
    out["before_ms"]["all"] = round(sum(out["before_ms"][p] for p in PASSES), 3)
    out["layer_ms"]["all"] = round(sum(out["layer_ms"][p] for p in PASSES), 3)
    return out


def pays_from(rows):
    """Per pass, the smallest frame from which the threaded route is the
    faster at that size and at every larger one (None: not at the
    largest)."""
    out = {}
    for p in PASSES:
        out[p] = None
        for row in reversed(rows):
            if row["threaded_ms"][p] >= row["serial_ms"][p]:
                break
            out[p] = row["frame_voxels"]
    return out


def crossover(args, lib, barrier=None):
    shapes = [(16, 32, 32), (32, 32, 32), (32, 64, 32), (32, 64, 64),
              (64, 64, 64), (64, 128, 64), (64, 128, 128), (128, 128, 128),
              (128, 256, 128), (128, 256, 256), (256, 256, 256)]
    if args.small:
        shapes = shapes[:7]
    rows = []
    for shape in shapes:
        voxels = int(np.prod(shape))
        masks = [rough_tree(shape, max(4, voxels >> 14), 3.0,
                            2_700_000_000 + i, "cpu")
                 for i in range(args.masks)]
        if barrier is not None:
            barrier.wait(timeout=600)
        serial, threaded, boxes = [], [], []
        for r in range(args.rounds):
            for mask in masks:
                ms0, arr0, box_voxels = routed(mask, lib, 0)
                ms1, arr1, _ = routed(mask, lib, 1)
                for a, b in zip(arr0, arr1):
                    assert np.array_equal(a, b)
                serial.append(ms0)
                threaded.append(ms1)
                boxes.append(box_voxels)
        rows.append({"frame": list(shape), "frame_voxels": voxels,
                     "box_voxels": int(statistics.median(boxes)),
                     "serial_ms": medians(serial),
                     "threaded_ms": medians(threaded)})
    return {"rows": rows, "threaded_pays_from": pays_from(rows)}


def _crossover_copy(args, barrier, queue):
    queue.put(crossover(args, native.get_lib(), barrier))


def crossover_shared(args, lib):
    """The crossover run by ``args.copies`` processes at once, each with
    its OpenMP team, as when test workers or other programs share the
    host's cores; per pass and size the median over the copies."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(args.copies)
    queue = ctx.Queue()
    procs = [ctx.Process(target=_crossover_copy,
                         args=(args, barrier, queue))
             for _ in range(args.copies - 1)]
    for proc in procs:
        proc.start()
    runs = [crossover(args, lib, barrier)]
    runs += [queue.get(timeout=1800) for _ in procs]
    for proc in procs:
        proc.join()
    rows = []
    for i, row in enumerate(runs[0]["rows"]):
        rows.append(dict(row, **{
            key: {p: round(statistics.median(
                run["rows"][i][key][p] for run in runs), 3)
                for p in PASSES}
            for key in ("serial_ms", "threaded_ms")}))
    return {"copies": args.copies, "rows": rows,
            "threaded_pays_from": pays_from(rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--masks", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    lib = native.get_lib()
    res = {"threads": os.cpu_count(),
           "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
           "threaded_voxels": native._THREADED_VOXELS,
           "crossover": crossover(args, lib),
           "crossover_shared": crossover_shared(args, lib),
           "split": split(args, lib)}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
