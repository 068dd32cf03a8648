# Copy of arterynetwork_tpu/ops/native.py; builds into build/native/, its distance-ordered thinning takes the port's ops/edt.py on a torch device, and the EDT-and-thinning passes are the port's own (csrc/skeleton_layer.cpp).
"""ctypes binding for the native (C++) kernels.

The shared library is built on demand from ``native/thinning.cpp`` with
g++ (no pybind11 in this environment; plain C ABI + ctypes).  The native
thinning is the sequential gold reference for the parallel TPU kernel and
the fast host path for very large volumes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
# native/*.cpp are the JAX package's sources too; the port's own passes
# live in csrc/ (skeleton_layer.cpp: the pipeline's EDT-and-thinning
# layer, whose oracles thin_volume and edt3d_sq_masked stay in the build)
_SRCS = [os.path.join(_NATIVE_DIR, "thinning.cpp"),
         os.path.join(_NATIVE_DIR, "volume_ops.cpp"),
         os.path.join(_NATIVE_DIR, "graph_ops.cpp"),
         os.path.join(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))), "csrc", "skeleton_layer.cpp")]
# the port builds the shared sources into its own directory: the JAX
# package's loader writes native/libnative.so, and two packages sharing
# one output file would race under parallel test workers
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_SO = os.path.join(_BUILD_DIR, "libnative.so")

_lib = None

# the EDT-and-thinning layer's passes use the OpenMP team from this many
# voxels up (the box's, or the frame's for the box search and the frame
# skeleton); below it a pass runs on the calling thread.  On the H100
# host's 8 cores the team wins a layer call from 2^18 voxels, alone and
# with four processes sharing the cores, and ties or loses below it
# (scripts/skeleton_layer_timing.py)
_THREADED_VOXELS = 1 << 18

# counts over the process (reset_layer_counts() zeroes them): calls of
# the layer's native passes, calls on the threaded route, masked EDTs
# that fell back to the full transform (a voxel more than r_max from
# background), and the thinning's simple-point tests and deletions
LAYER_COUNTS = {"calls": 0, "threaded": 0, "edt_fallbacks": 0,
                "simple_tests": 0, "deletions": 0}


def reset_layer_counts():
    for key in LAYER_COUNTS:
        LAYER_COUNTS[key] = 0


def _layer_call(voxels: int) -> int:
    """Counts a call of the layer's passes; 1 if it takes the threaded
    route (``voxels`` at or past ``_THREADED_VOXELS``)."""
    threaded = int(voxels >= _THREADED_VOXELS)
    LAYER_COUNTS["calls"] += 1
    LAYER_COUNTS["threaded"] += threaded
    return threaded


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _mask_bytes(a):
    """A 3-D mask as C-contiguous uint8 bytes, nonzero = foreground: a
    C-contiguous uint8 or bool array as its own bytes (no copy), any
    other as ``a != 0``."""
    a = np.asarray(a)
    if a.ndim != 3:
        raise ValueError(f"a 3-D mask, not {a.shape}")
    if (a.dtype not in (np.dtype(np.uint8), np.dtype(bool))
            or not a.flags['C_CONTIGUOUS']):
        a = np.ascontiguousarray(a != 0)
    return a.view(np.uint8)


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a private name and rename into place, so a concurrent
    # loader never maps a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # toolchains without OpenMP still get the (serial) kernels
        cmd = [c for c in cmd if c != "-fopenmp"]
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < max(os.path.getmtime(s)
                                           for s in _SRCS)):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.thin_volume.restype = ctypes.c_long
    lib.thin_volume.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.simple_point_code.restype = ctypes.c_int
    lib.simple_point_code.argtypes = [ctypes.c_uint32]
    lib.edt3d_sq.restype = None
    lib.edt3d_sq.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.edt3d_sq_masked.restype = ctypes.c_long
    lib.edt3d_sq_masked.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.label_components_26.restype = ctypes.c_long
    lib.label_components_26.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.drop_small_components_26.restype = ctypes.c_long
    lib.drop_small_components_26.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long,
    ]
    lib.hysteresis_components_26.restype = ctypes.c_long
    lib.hysteresis_components_26.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long,
    ]
    lib.hysteresis_components_ds2_26.restype = ctypes.c_long
    lib.hysteresis_components_ds2_26.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long,
    ]
    lib.hysteresis_components_ds2_packed_26.restype = ctypes.c_long
    lib.hysteresis_components_ds2_packed_26.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.nonzero_indices_u8.restype = ctypes.c_long
    lib.nonzero_indices_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long,
    ]
    lib.simplify_chains_native.restype = ctypes.c_long
    lib.simplify_chains_native.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_int,
        ctypes.c_long, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
    ]
    lib.chains_from_edges_native.restype = ctypes.c_long
    lib.chains_from_edges_native.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
    ]
    lib.bqn_pack_f32.restype = None
    lib.bqn_pack_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.bqn_row_stats_f32.restype = None
    lib.bqn_row_stats_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.bqn_pack_rows_f32.restype = None
    lib.bqn_pack_rows_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.ensure_simple_lut.restype = ctypes.c_int
    lib.ensure_simple_lut.argtypes = [ctypes.c_char_p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    lib.sl_ensure_simple_lut.restype = ctypes.c_int
    lib.sl_ensure_simple_lut.argtypes = [ctypes.c_char_p]
    lib.sl_bounding_box.restype = ctypes.c_int
    lib.sl_bounding_box.argtypes = [u8p, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.sl_crop.restype = None
    lib.sl_crop.argtypes = [u8p, i, i, i, i, i, i, i, i, i, u8p, i]
    lib.sl_edt_sq_masked.restype = ctypes.c_long
    lib.sl_edt_sq_masked.argtypes = [u8p, i, i, i, i, f32p, u8p, i]
    lib.sl_thin.restype = ctypes.c_long
    lib.sl_thin.argtypes = [u8p, i, i, i, f32p, i, i,
                            ctypes.POINTER(ctypes.c_long)]
    lib.sl_sqrt_rows.restype = None
    lib.sl_sqrt_rows.argtypes = [f32p, i, i, i, u8p, i]
    lib.sl_frame.restype = None
    lib.sl_frame.argtypes = [u8p, i, i, i, i, i, i, u8p, i, i, i, i]
    # one 8 MiB bit table answers the simple-point test in a load
    # (generated once, ~seconds; later processes read the disk cache).
    # The oracle's copy (native/thinning.cpp) loads it first, so a fresh
    # build's file is the oracle's, and the layer's thinning reads that
    # file (tests/test_torch_skeleton_layer.py holds the layer's own
    # generator to it)
    lut = os.path.join(_BUILD_DIR, "simple26.lut").encode()
    lib.ensure_simple_lut(lut)
    lib.sl_ensure_simple_lut(lut)
    _lib = lib
    return lib


def edt_native(mask, squared: bool = False) -> np.ndarray:
    """Exact 3D Euclidean distance transform (distance to nearest
    background) of a binary mask, computed natively on the host
    (Felzenszwalb separable passes, OpenMP across rows).

    Native counterpart of scipy ``distance_transform_edt`` as used by the
    reference (generateVesselVolume.py:183, manualCorrectionGUI.py:243-249)
    and of the device kernel in ops/edt.py — no accelerator round trip.
    """
    m = np.asarray(mask)
    if m.dtype != np.uint8 or not m.flags['C_CONTIGUOUS']:
        # the kernel reads the mask by truthiness, so any contiguous
        # uint8 volume (0/1 or 0/255) goes straight through copy-free
        m = np.ascontiguousarray(m != 0, dtype=np.uint8)
    nz, ny, nx = m.shape
    out = np.empty(m.shape, np.float32)
    get_lib().edt3d_sq(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       nz, ny, nx,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if squared else np.sqrt(out, out=out)


def edt_masked_native(mask, r_max: int = 16,
                      squared: bool = False, out=None,
                      rows=None) -> np.ndarray:
    """Exact EDT evaluated at foreground voxels only (banded
    sorted-offset scan, native).

    Identical values to ``edt_native`` on the foreground when every
    foreground voxel is within ``r_max`` of background (true for vessel
    masks: the bound is the largest vessel radius); falls back to the
    full Felzenszwalb transform otherwise.  The pipeline's consumers
    (thinning order, centerline radius recovery) only read the transform
    at vessel voxels, so this replaces three full-volume envelope passes
    with ~(4/3)*pi*d^3 probes per vessel voxel.

    The layer's pass (csrc/skeleton_layer.cpp ``sl_edt_sq_masked``)
    writes every element once, on the threaded route from
    ``_THREADED_VOXELS`` voxels; the values are ``edt3d_sq_masked``'s.
    ``rows``, a C-contiguous uint8 (nz, ny) array, gets 1 for each row
    holding foreground (``sqrt_rows`` takes it).
    """
    m = np.asarray(mask)
    if m.dtype != np.uint8 or not m.flags['C_CONTIGUOUS']:
        # truthiness semantics in the kernel: contiguous uint8 is
        # accepted as-is (copy-free; the pipeline fast path's case)
        m = np.ascontiguousarray(m != 0, dtype=np.uint8)
    nz, ny, nx = m.shape
    if (out is None or out.shape != m.shape or out.dtype != np.float32
            or not out.flags['C_CONTIGUOUS']):
        out = np.empty(m.shape, np.float32)
    if rows is None:
        rows = np.empty((nz, ny), np.uint8)
    elif (rows.shape != (nz, ny) or rows.dtype != np.uint8
            or not rows.flags['C_CONTIGUOUS']):
        raise ValueError(f"rows must be C-contiguous uint8 {(nz, ny)}")
    unresolved = get_lib().sl_edt_sq_masked(
        _u8(m), nz, ny, nx, int(r_max),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8(rows),
        _layer_call(m.size))
    if unresolved:
        LAYER_COUNTS["edt_fallbacks"] += 1
        return edt_native(m, squared=squared)
    return out if squared else sqrt_rows(out, rows)


def sqrt_rows(d2, rows) -> np.ndarray:
    """``np.sqrt(d2, out=d2)`` for a C-contiguous float32 (nz, ny, nx)
    array that is 0 outside the rows ``rows`` flags (``edt_masked_native``'s
    output): only those rows are touched.  Returns ``d2``."""
    nz, ny, nx = d2.shape
    get_lib().sl_sqrt_rows(
        d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nz, ny, nx,
        _u8(np.ascontiguousarray(rows, np.uint8)), _layer_call(d2.size))
    return d2


def label_components_native(mask) -> "tuple[np.ndarray, int]":
    """26-connectivity component labels (int32, 0 = background, 1..K in
    scan order) via native flood fill.  Returns (labels, K)."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    nz, ny, nx = m.shape
    labels = np.zeros(m.shape, np.int32)
    k = get_lib().label_components_26(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nz, ny, nx,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(k)


def hysteresis_components_native(weak, strong, min_size: int = 0) -> np.ndarray:
    """Keep 26-connected components of ``weak`` that contain a ``strong``
    voxel and exceed ``min_size`` voxels (native seeded flood fill; only
    kept components are ever visited).

    The segmentation-stage counterpart of the reference's strong
    threshold + growing design (generateVesselVolume.py:186-199 +
    variationalRegionGrowing.py:10): a low floor keeps thin vessels
    connected, strong seeds reject isolated noise components.
    """
    w = np.ascontiguousarray(np.asarray(weak) != 0, dtype=np.uint8)
    s = np.ascontiguousarray(np.asarray(strong) != 0, dtype=np.uint8)
    if w.shape != s.shape:
        raise ValueError(f"shape mismatch: {w.shape} vs {s.shape}")
    nz, ny, nx = w.shape
    get_lib().hysteresis_components_26(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nz, ny, nx, int(min_size))
    return w


def hysteresis_components_ds2_native(weak, strong_ds,
                                     min_size: int = 0) -> np.ndarray:
    """``hysteresis_components_native`` seeded from a 2x any-pooled
    strong mask (shape = ceil(weak.shape / 2)).

    Exact: all voxels of a 2x2x2 block are mutually 26-adjacent, so any
    weak voxel in a block containing a strong voxel is in that voxel's
    component — while the strong mask crosses the wire at 1/8 the bits.
    """
    w = np.ascontiguousarray(np.asarray(weak) != 0, dtype=np.uint8)
    s = np.ascontiguousarray(np.asarray(strong_ds) != 0, dtype=np.uint8)
    nz, ny, nx = w.shape
    expect = ((nz + 1) // 2, (ny + 1) // 2, (nx + 1) // 2)
    if s.shape != expect:
        raise ValueError(f"strong_ds shape {s.shape} != {expect}")
    get_lib().hysteresis_components_ds2_26(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nz, ny, nx, int(min_size))
    return w


def hysteresis_components_ds2_packed_native(weak_packed, shape,
                                            strong_ds_packed,
                                            min_size: int = 0,
                                            out=None) -> np.ndarray:
    """``hysteresis_components_ds2_native`` fed directly from the packed-
    bit wire format (utils/transfer.pack_mask): both masks arrive as flat
    MSB-first packed bits and the weak mask is unpacked once, natively,
    into ``out`` — skipping the host-side unpackbits -> bool -> uint8
    copy chain (three full-volume host passes over the weak mask).

    ``shape`` is the (nz, ny, nx) shape of the weak mask;
    ``strong_ds_packed`` packs the 2x any-pooled strong mask of shape
    ``ceil(shape / 2)``.  ``out``, when given, must be a C-contiguous
    uint8 array of ``shape`` (reallocated otherwise); it becomes the
    result mask in place — callers reusing a scratch buffer across runs
    get the same aliasing caveat as pipeline._edt_scratch.
    """
    wp = np.ascontiguousarray(np.asarray(weak_packed).reshape(-1),
                              dtype=np.uint8)
    sp = np.ascontiguousarray(np.asarray(strong_ds_packed).reshape(-1),
                              dtype=np.uint8)
    nz, ny, nx = (int(s) for s in shape)
    total = nz * ny * nx
    if wp.size != (total + 7) // 8:
        raise ValueError(f"weak_packed has {wp.size} bytes, "
                         f"expected {(total + 7) // 8} for shape {shape}")
    stotal = ((nz + 1) // 2) * ((ny + 1) // 2) * ((nx + 1) // 2)
    if sp.size != (stotal + 7) // 8:
        raise ValueError(f"strong_ds_packed has {sp.size} bytes, "
                         f"expected {(stotal + 7) // 8}")
    if (out is None or out.shape != (nz, ny, nx) or out.dtype != np.uint8
            or not out.flags['C_CONTIGUOUS']):
        out = np.empty((nz, ny, nx), np.uint8)
    get_lib().hysteresis_components_ds2_packed_26(
        wp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nz, ny, nx, int(min_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def drop_small_components_native(mask, threshold: int) -> np.ndarray:
    """Zero 26-connected components with <= threshold voxels (native,
    in one pass; reference main(), generateVesselVolume.py:195-199)."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    nz, ny, nx = m.shape
    get_lib().drop_small_components_26(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nz, ny, nx,
        int(threshold))
    return m


def bounding_box(mask, margin: int = 1):
    """Slices of the foreground box of a 3-D mask (with margin, clipped).

    Nonzero = foreground for any numeric dtype.  Searched natively (all-zero
    words skipped, planes over threads from ``_THREADED_VOXELS`` voxels);
    a mask that is not C-contiguous uint8 or bool is searched as
    ``mask != 0``.  An empty mask gives ``slice(0, 1)`` on every axis."""
    view = _mask_bytes(mask)
    ext = np.empty(6, np.int64)
    if not view.size or not get_lib().sl_bounding_box(
            _u8(view), *view.shape, _layer_call(view.size),
            ext.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))):
        return (slice(0, 1),) * 3
    return tuple(slice(max(int(ext[2 * a]) - margin, 0),
                       min(int(ext[2 * a + 1]) + margin + 1, view.shape[a]))
                 for a in range(3))


def crop_box(mask, box) -> np.ndarray:
    """``np.array(mask[box], dtype=np.uint8, order="C")`` for a C-contiguous
    3-D uint8 or bool mask and a box of ``bounding_box``'s: a new uint8
    array, copied natively (rows over threads).  Any other mask is
    cropped as ``mask != 0``."""
    view = _mask_bytes(mask)
    z, y, x = (sl.indices(n)[:2] for sl, n in zip(box, view.shape))
    bz, by, bx = (max(hi - lo, 0) for lo, hi in (z, y, x))
    out = np.empty((bz, by, bx), np.uint8)
    if out.size:
        get_lib().sl_crop(_u8(view), *view.shape, z[0], y[0], x[0],
                          bz, by, bx, _u8(out), _layer_call(out.size))
    return out


def skeleton_frame(skel_box, box, shape) -> np.ndarray:
    """The full-frame bool skeleton: ``np.zeros(shape, bool)`` with
    ``[box] = skel_box`` (nonzero = on the skeleton), written natively in
    one pass (planes over threads from ``_THREADED_VOXELS`` voxels)."""
    view = _mask_bytes(skel_box)
    frame = np.empty(tuple(int(n) for n in shape), bool)
    z0, y0, x0 = (int(sl.start) for sl in box)
    if any(o < 0 or o + b > n for o, b, n in zip(
            (z0, y0, x0), view.shape, frame.shape)):
        raise ValueError(f"box skeleton {view.shape} at {(z0, y0, x0)} "
                         f"is not inside {frame.shape}")
    get_lib().sl_frame(_u8(view), *view.shape, z0, y0, x0,
                       _u8(frame.view(np.uint8)), *frame.shape,
                       _layer_call(frame.size))
    return frame


def _thin(vol, d2, preserve_endpoints) -> int:
    """The layer's thinning of a C-contiguous uint8 ``vol`` in place
    (csrc/skeleton_layer.cpp ``sl_thin``: ``thin_volume``'s deletions in
    its order); ``d2`` squared distances or None.  Returns deletions."""
    nz, ny, nx = vol.shape
    stats = (ctypes.c_long * 2)()
    d2_ptr = (ctypes.POINTER(ctypes.c_float)() if d2 is None
              else d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    deleted = get_lib().sl_thin(_u8(vol), nz, ny, nx, d2_ptr,
                                int(preserve_endpoints),
                                _layer_call(vol.size), stats)
    LAYER_COUNTS["simple_tests"] += stats[0]
    LAYER_COUNTS["deletions"] += stats[1]
    return int(deleted)


def skeletonize_native(mask, distance_ordered: bool = True,
                       preserve_endpoints: bool = True,
                       distance_transform=None,
                       device="cuda") -> np.ndarray:
    """Sequential distance-ordered thinning (C++).

    The volume is cropped to the foreground bounding box first: vessels
    occupy a small fraction of an MRA volume and the sequential passes
    scan the whole array.  ``distance_transform`` (unsquared EDT of the
    full mask) may be shared from the pipeline to avoid recomputation;
    without it the distance order comes from the banded EDT of
    ops/edt.py on the cropped box, computed on ``device``."""
    full = np.asarray(mask) != 0
    box = bounding_box(full, margin=2)
    vol = crop_box(full, box)
    if distance_transform is not None:
        d2 = np.ascontiguousarray(
            np.asarray(distance_transform)[box] ** 2, dtype=np.float32)
    elif distance_ordered:
        from .edt import edt_squared
        d2 = edt_squared(vol, band=32, device=device).cpu().numpy()
    else:
        d2 = None
    _thin(vol, d2, preserve_endpoints)
    return skeleton_frame(vol, box, full.shape)


def skeletonize_native_cropped(mask_box, d2_box,
                               preserve_endpoints: bool = True,
                               clobber: bool = False) -> np.ndarray:
    """Thinning on an already-cropped volume with a precomputed SQUARED
    distance transform — the pipeline's box-coordinate fast path (no
    re-bboxing, no full-frame copies, no sqrt->square round trip).

    ``clobber=True`` thins a C-contiguous uint8 ``mask_box`` IN PLACE
    and returns it (uint8 0/1, the same buffer) — two fewer box-sized
    copies for callers that are done with the mask crop."""
    vol = np.asarray(mask_box)
    if not (clobber and vol.dtype == np.uint8
            and vol.flags['C_CONTIGUOUS']):
        vol = np.ascontiguousarray(vol != 0, dtype=np.uint8)
    d2 = np.ascontiguousarray(d2_box, dtype=np.float32)
    _thin(vol, d2, preserve_endpoints)
    return vol if clobber else vol.astype(bool)


def nonzero_flat_native(vol, expect: int = 0) -> np.ndarray:
    """Flat indices (int64, scan order) of nonzero bytes in a bool/uint8
    volume — the native replacement for ``np.flatnonzero`` on very sparse
    volumes: all-zero 8-byte words are skipped, so the scan runs at
    the rate memory can be read at.

    ``expect`` sizes the first output buffer (0 -> 1M); if the true count
    exceeds it the scan is repeated once with the exact size.
    """
    m = np.asarray(vol)
    flat = m.reshape(-1)
    if (flat.dtype not in (np.dtype(np.uint8), np.dtype(bool))
            or not flat.flags['C_CONTIGUOUS']):
        flat = np.ascontiguousarray(flat != 0)
    if flat.dtype == np.dtype(bool):
        flat = flat.view(np.uint8)  # no copy: same buffer, truthy bytes
    lib = get_lib()
    cap = int(expect) if expect > 0 else (1 << 20)
    out = np.empty(cap, np.int64)
    n = flat.size
    ptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    count = lib.nonzero_indices_u8(
        ptr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if count > cap:
        out = np.empty(count, np.int64)
        lib.nonzero_indices_u8(
            ptr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            count)
        return out
    return out[:count]


def simple_point_native(code: int) -> bool:
    """Simple-point oracle for a 26-bit neighborhood code."""
    return bool(get_lib().simple_point_code(ctypes.c_uint32(code)))


def _unpack_chains(flat, offsets, count):
    off_l = offsets[:count + 1].tolist()
    # only the used prefix: the buffer is over-allocated (4E + 16)
    flat_l = flat[:off_l[count]].tolist()
    return [flat_l[off_l[i]:off_l[i + 1]] for i in range(count)]


def simplify_chains_native(a, b, n, radius, coords=None, min_length=3,
                           collapse=True, radius_factor=2.5,
                           cycle_tight_ratio=16.0, rounds=3,
                           bridge_max_len=13, cover_tol=4.0,
                           cover_radius_factor=1.0):
    """Native chain walk + full simplification (graphs/segments.py's
    simplify_chains, bit-exact — every ordering/tie-break mirrored).
    ``a``/``b``: int64 edge vertex indices in [0, n); ``radius``: f32
    per vertex; ``coords``: int32 (n, 3) voxel coords (enables the
    bridge audit's coverage gate).  Returns chains as lists of ints."""
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    radius = np.ascontiguousarray(radius, np.float32)
    E = len(a)
    flat = np.empty(max(4 * E + 16, 64), np.int64)
    offsets = np.empty(E + 2, np.int64)
    cptr = ctypes.POINTER(ctypes.c_int32)()
    if coords is not None:
        coords = np.ascontiguousarray(coords, np.int32)
        cptr = coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    count = get_lib().simplify_chains_native(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        E, int(n),
        radius.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cptr,
        int(min_length), int(bool(collapse)), float(radius_factor),
        float(cycle_tight_ratio), int(rounds),
        int(bridge_max_len), float(cover_tol),
        float(cover_radius_factor),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(flat),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets))
    if count < 0:
        raise RuntimeError("simplify_chains_native: buffer overflow")
    return _unpack_chains(flat, offsets, count)


def chains_from_edges_native(a, b, n):
    """Native plain chain walk (no simplification)."""
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    E = len(a)
    flat = np.empty(max(4 * E + 16, 64), np.int64)
    offsets = np.empty(E + 2, np.int64)
    count = get_lib().chains_from_edges_native(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        E, int(n),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(flat),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets))
    if count < 0:
        raise RuntimeError("chains_from_edges_native: buffer overflow")
    return _unpack_chains(flat, offsets, count)


def bq_pack_native(slab: np.ndarray, bits: int = 4):
    """Row-adaptive low-bit quantize + pack of a float32 slab
    (rows, ny, nx) for the "bq4"/"bq3"/"bq2" upload formats — one pass
    over memory (each x-row's second read comes from L1).  Returns
    ``(packed u8 (rows, ny, nx*bits//8), row_scale f32, row_min f32)``,
    bit-exact with the numpy fallbacks in ``ops/vesselness.py``.
    ``nx`` must be a multiple of 8//gcd(bits,8) (2/8/4 for bits 4/3/2)
    and the slab C-contiguous float32.
    """
    need = {4: 2, 3: 8, 2: 4}[bits]
    if slab.dtype != np.float32 or not slab.flags['C_CONTIGUOUS'] \
            or slab.shape[-1] % need:
        raise ValueError("bq_pack_native needs contiguous f32, "
                         f"nx % {need} == 0")
    rows, ny, nx = slab.shape
    packed = np.empty((rows, ny, nx * bits // 8), np.uint8)
    row_scale = np.empty((rows, ny), np.float32)
    row_min = np.empty((rows, ny), np.float32)
    get_lib().bqn_pack_f32(
        slab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows * ny, nx, bits,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        row_scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        row_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return packed, row_scale, row_min


def bq4_pack_native(slab: np.ndarray):
    """Row-adaptive 4-bit pack (see ``bq_pack_native``)."""
    return bq_pack_native(slab, bits=4)


def bq_row_stats_native(slab: np.ndarray):
    """Per-(z,y)-row min/max of a contiguous f32 slab (rows, ny, nx) —
    the keep/skip decision pass of the occupancy-skipped upload.  Scan
    order matches ``bq_pack_native``, so derived scale/min sidebands are
    bit-identical to the full pack's."""
    if slab.dtype != np.float32 or not slab.flags['C_CONTIGUOUS']:
        raise ValueError("bq_row_stats_native needs contiguous f32")
    rows, ny, nx = slab.shape
    row_min = np.empty((rows, ny), np.float32)
    row_max = np.empty((rows, ny), np.float32)
    get_lib().bqn_row_stats_f32(
        slab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows * ny, nx,
        row_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        row_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return row_min, row_max


def bq_pack_rows_native(slab: np.ndarray, rows_sel: np.ndarray,
                        bits: int = 4):
    """Quantize+pack only the selected flattened (z,y) rows of ``slab``
    (contiguous f32 (rows, ny, nx)); output row j is input row
    ``rows_sel[j]``, bit-identical to the same row of
    ``bq_pack_native``.  Returns packed u8 (k, nx*bits//8)."""
    need = {4: 2, 3: 8, 2: 4}[bits]
    if slab.dtype != np.float32 or not slab.flags['C_CONTIGUOUS'] \
            or slab.shape[-1] % need:
        raise ValueError("bq_pack_rows_native needs contiguous f32, "
                         f"nx % {need} == 0")
    nx = slab.shape[-1]
    rows_sel = np.ascontiguousarray(rows_sel, np.int64)
    k = rows_sel.shape[0]
    packed = np.empty((k, nx * bits // 8), np.uint8)
    get_lib().bqn_pack_rows_f32(
        slab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, bits,
        rows_sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), k,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return packed
