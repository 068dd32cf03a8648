# Copy of arterynetwork_tpu/io/nifti.py, unchanged.
"""Minimal NIfTI-1 volume I/O in pure NumPy.

Replaces the reference's nibabel load/save pair
(generateVesselVolume.py:15-84, duplicated skeletonization.py:19-65) with
a dependency-free reader/writer for the .nii / .nii.gz files the pipeline
exchanges.  Supports the subset the pipeline produces and consumes:
single-file NIfTI-1, scalar volumes, common dtypes, gzip transparently.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_HDR_SIZE = 348
_MAGIC = b"n+1\x00"

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path, mode):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_volume(path):
    """Load a NIfTI-1 volume.  Returns (volume, affine).

    API parity with the reference's ``loadVolume``
    (generateVesselVolume.py:15-52)."""
    with _open(path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        byteorder = "<"
        if sizeof_hdr != _HDR_SIZE:
            sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
            if sizeof_hdr != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            byteorder = ">"

        dim = struct.unpack_from(byteorder + "8h", hdr, 40)
        ndim = dim[0]
        shape = tuple(dim[1:1 + ndim])
        datatype = struct.unpack_from(byteorder + "h", hdr, 70)[0]
        vox_offset = int(struct.unpack_from(byteorder + "f", hdr, 108)[0])
        scl_slope = struct.unpack_from(byteorder + "f", hdr, 112)[0]
        scl_inter = struct.unpack_from(byteorder + "f", hdr, 116)[0]
        srow = np.array(struct.unpack_from(byteorder + "12f", hdr, 280),
                        dtype=np.float64).reshape(3, 4)
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(byteorder)

        f.seek(vox_offset)
        raw = f.read()
    # trailing singleton dims are common in the wild (e.g. dim0=4 with
    # nt=1); the pipeline consumes scalar 3D volumes
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    count = int(np.prod(shape))
    volume = np.frombuffer(raw, dtype=dtype, count=count)
    volume = volume.reshape(shape, order="F").copy()
    # some tools write scl_slope = NaN or 0 for "no scaling"
    if np.isnan(scl_slope):
        scl_slope = 0.0
    if np.isnan(scl_inter):
        scl_inter = 0.0
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        volume = volume * slope + scl_inter

    affine = np.eye(4)
    affine[:3, :] = srow
    if not np.any(srow):
        # fall back to pixdim scaling when sform is absent
        pixdim = struct.unpack_from(byteorder + "8f", hdr, 76)
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
    return volume, affine


def save_volume(volume, affine, path, astype=None):
    """Save a NIfTI-1 volume (API parity with the reference's
    ``saveVolume``, generateVesselVolume.py:54-84: default dtype uint8)."""
    if astype is None:
        astype = np.uint8
    volume = np.asarray(volume).astype(astype)
    if volume.ndim != 3:
        raise ValueError("expected a 3D volume")
    dt = np.dtype(astype)
    code = _CODES.get(dt.newbyteorder("="))
    if code is None:
        raise ValueError(f"unsupported dtype {dt}")
    affine = np.asarray(affine, dtype=np.float64)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, *volume.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)                 # datatype
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)      # bitpix
    # pixdim from affine column norms
    pix = [float(np.linalg.norm(affine[:3, i])) or 1.0 for i in range(3)]
    struct.pack_into("<8f", hdr, 76, 1.0, *pix, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)               # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                 # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                   # qform_code
    struct.pack_into("<h", hdr, 254, 1)                   # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1))
    hdr[344:348] = _MAGIC

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(volume).tobytes(order="F"))


def mask_volume(volume, mask):
    """Zero the volume outside the mask (maskVolume,
    generateVesselVolume.py:86-105)."""
    volume = np.asarray(volume)
    out = volume.copy()
    out[np.asarray(mask) == 0] = 0
    return out


def refine_brain_mask(brain_mask, cow_box=((150, 350), (150, 350), (0, 120))):
    """Binarize a brain mask and force-include the Circle-of-Willis box
    (refineBrainVolumeMask, generateVesselVolume.py:42-63: the
    reference hard-codes [150:350, 150:350, 0:120] for its scans; the
    box is a parameter here, clipped to the volume)."""
    out = (np.asarray(brain_mask) != 0).astype(np.uint8)
    (x0, x1), (y0, y1), (z0, z1) = cow_box
    out[x0:x1, y0:y1, z0:z1] = 1
    return out
