"""Halo exchange for sharded volumetric stencils.

Port of the JAX package's parallel/halo.py.  There, a volume sharded over
a device mesh runs the voxel kernels unchanged: GSPMD inserts the
collective-permutes for the shifts (the implicit path), and
``halo_exchange`` under ``shard_map`` is the explicit one.  PyTorch has
no partitioner, so every halo here is explicit:

* ``VolumeMesh`` is a single-process mesh: an ndarray of
  ``torch.device`` slots and its axis names, as JAX's single-controller
  ``Mesh`` is.  A slot may repeat a device: ``[cuda:0] * 4`` is a 2x2
  mesh on one card, whose blocks then run one after another, and
  ``["cpu"] * 8`` the tests' 2x4 mesh.
* ``ShardedVolume`` is a grid of blocks, each on its slot's device, with
  the global shape; its leading dims are split evenly over the mesh
  axes.
* ``halo_exchange`` pads every block along one dim with its neighbours'
  faces (``Tensor.copy_``/``to`` across devices: a peer copy between two
  cards, a plain copy on one).  Corners travel because the dims are
  exchanged one after the other.  At the volume's faces JAX's exchange
  fills zeros; here ``fill=None`` adds no halo there, which is what the
  edge-replicated differences of the vesselness and the region-growing
  rule (a voxel outside the volume is neither segmented nor unsegmented)
  need, and a number fills the face halo as JAX does.
* ``pad_halos`` pads every block on every sharded dim (corners
  included) into a ``Padded``, which knows where each block's own voxels
  lie; the iterated stencils (region growing, thinning) pad again after
  each update.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


class VolumeMesh:
    """Named axes over an ndarray of ``torch.device`` slots."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        devs = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            devs[idx] = torch.device(arr[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {axis_names}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self):
        """The devices the slots use, each once, in slot order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))

    def slot(self, axes, idx):
        """The device of the slot at ``idx`` along ``axes``, index 0 along
        every other axis (a volume is held once, not replicated)."""
        full = tuple(idx[axes.index(a)] if a in axes else 0
                     for a in self.axis_names)
        return self.devices[full]

    def __repr__(self):
        return f"VolumeMesh({self.shape}, {self.distinct_devices()})"


def _cuda_devices():
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def grid_2d(n: int):
    """(a, n // a) with a the largest divisor of n at most sqrt(n): 8
    slots are 2x4, as the JAX package's mesh."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def make_volume_mesh(devices=None, axis_names=("sx", "sy")) -> VolumeMesh:
    """A mesh for spatial volume sharding over ``devices`` (default: the
    visible CUDA devices; a slot may repeat a device).  With 8 slots and
    two axes the shape is 2x4, as the JAX package's."""
    if devices is None:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError("make_volume_mesh: no CUDA device is "
                               "visible; pass devices=[...] to mesh "
                               "other slots (e.g. ['cpu'] * 8)")
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    elif len(axis_names) == 2:
        shape = grid_2d(n)
    else:
        raise ValueError("make_volume_mesh takes one or two axis names")
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    return VolumeMesh(devs.reshape(shape), axis_names)


@dataclasses.dataclass
class ShardedVolume:
    """A volume split into a grid of blocks over mesh axes: block ``idx``
    holds the global box starting at ``offset(idx)`` and lives on the
    device of its mesh slot."""

    blocks: np.ndarray          # object grid of tensors
    shape: tuple                # global shape
    mesh: VolumeMesh
    axes: tuple                 # mesh axis of each sharded leading dim

    @property
    def grid(self):
        return self.blocks.shape

    def offset(self, idx):
        """Global start of block ``idx`` on every dim."""
        return tuple(i * (n // g) for i, n, g in
                     zip(idx, self.shape, self.grid)) \
            + (0,) * (len(self.shape) - len(self.grid))

    def indices(self):
        return list(np.ndindex(self.grid))

    def map(self, fn):
        """``fn``, which keeps a block's shape, applied to each block."""
        out = np.empty(self.grid, dtype=object)
        for idx in self.indices():
            out[idx] = fn(self.blocks[idx])
        return dataclasses.replace(self, blocks=out)

    def gather(self, device=None):
        """The whole volume, on ``device`` (default: block 0's)."""
        device = device or self.blocks[(0,) * len(self.grid)].device

        def cat(arr, d):
            if arr.ndim == 1:
                return torch.cat([b.to(device) for b in arr], dim=d)
            return torch.cat([cat(arr[i], d + 1)
                              for i in range(arr.shape[0])], dim=d)

        return cat(self.blocks, 0)


def shard_volume(volume, mesh: VolumeMesh, axes=("sx", "sy")):
    """Split a volume's leading dims evenly over the mesh ``axes``: a
    ``ShardedVolume`` whose blocks (copies) lie on their slots' devices.
    Host arrays and tensors alike; each dim must divide by its axis
    size."""
    vol = volume if torch.is_tensor(volume) else \
        torch.from_numpy(np.ascontiguousarray(volume))
    axes = tuple(axes)
    grid = tuple(mesh.shape[a] for a in axes)
    for d, g in enumerate(grid):
        if vol.shape[d] % g:
            raise ValueError(f"dim {d} of {tuple(vol.shape)} does not "
                             f"divide over {g} slots of axis {axes[d]!r}")
    blocks = np.empty(grid, dtype=object)
    for idx in np.ndindex(grid):
        sl = tuple(slice(i * (n // g), (i + 1) * (n // g))
                   for i, n, g in zip(idx, vol.shape, grid))
        blocks[idx] = vol[sl].to(mesh.slot(axes, idx), copy=True) \
            .contiguous()
    return ShardedVolume(blocks, tuple(vol.shape), mesh, axes)


def _along(idx, axis, j):
    return idx[:axis] + (j,) + idx[axis + 1:]


def halo_exchange(blocks, axis: int, halo: int = 1, fill=None):
    """Pad every block of the grid ``blocks`` along ``axis`` with up to
    ``halo`` planes from its neighbours (from several blocks when one is
    thinner than the halo), each block on its own device.

    At the volume's faces ``fill=None`` adds no plane and a number adds
    ``halo`` planes of it (the JAX package's zeros).  Returns (padded
    grid, lo, hi): ``lo``/``hi`` are int grids of the planes added
    before and after each block."""
    grid = blocks.shape
    out = np.empty(grid, dtype=object)
    lo = np.zeros(grid, dtype=np.int64)
    hi = np.zeros(grid, dtype=np.int64)
    for idx in np.ndindex(grid):
        b = blocks[idx]
        parts_lo, parts_hi = [], []
        need, j = halo, idx[axis] - 1
        while need and j >= 0:
            nb = blocks[_along(idx, axis, j)]
            take = min(need, nb.shape[axis])
            parts_lo.insert(0, nb.narrow(axis, nb.shape[axis] - take,
                                         take).to(b.device))
            need, j = need - take, j - 1
        if need and fill is not None:
            parts_lo.insert(0, _planes(b, axis, need, fill))
        need, j = halo, idx[axis] + 1
        while need and j < grid[axis]:
            nb = blocks[_along(idx, axis, j)]
            take = min(need, nb.shape[axis])
            parts_hi.append(nb.narrow(axis, 0, take).to(b.device))
            need, j = need - take, j + 1
        if need and fill is not None:
            parts_hi.append(_planes(b, axis, need, fill))
        lo[idx] = sum(p.shape[axis] for p in parts_lo)
        hi[idx] = sum(p.shape[axis] for p in parts_hi)
        out[idx] = torch.cat(parts_lo + [b] + parts_hi, dim=axis)
    return out, lo, hi


def _planes(b, axis, n, fill):
    shape = list(b.shape)
    shape[axis] = n
    return b.new_full(shape, fill)


@dataclasses.dataclass
class Padded:
    """Each block of a ``ShardedVolume`` with halo slots around it on the
    sharded dims: ``lo[idx][d]`` / ``hi[idx][d]`` planes before / after
    the block's own voxels on dim ``d``."""

    blocks: np.ndarray
    lo: np.ndarray              # int (grid + (k,))
    hi: np.ndarray
    source: ShardedVolume

    def box(self, idx):
        """Slices of block ``idx``'s own voxels in its padded tensor."""
        own = self.source.blocks[idx].shape
        return tuple(slice(int(self.lo[idx][d]), int(self.lo[idx][d])
                           + own[d]) for d in range(len(self.source.grid)))

    def interior(self, idx):
        return self.blocks[idx][self.box(idx)]

    def window(self, idx):
        """((lo, hi) per dim) of the block's own voxels, all dims."""
        t = self.blocks[idx]
        return tuple((s.start, s.stop) for s in self.box(idx)) \
            + tuple((0, n) for n in t.shape[len(self.source.grid):])

    def crop(self):
        """The blocks' own voxels, as a ``ShardedVolume``."""
        out = np.empty(self.source.grid, dtype=object)
        for idx in self.source.indices():
            out[idx] = self.interior(idx)
        return dataclasses.replace(self.source, blocks=out)


def pad_halos(vol: ShardedVolume, halo: int, fill=None) -> Padded:
    """Every block of ``vol`` with ``halo`` planes of its neighbours on
    each sharded dim, corners included (``halo_exchange`` dim after
    dim); ``fill`` as there."""
    blocks = vol.blocks
    k = len(vol.grid)
    lo = np.zeros(vol.grid + (k,), dtype=np.int64)
    hi = np.zeros(vol.grid + (k,), dtype=np.int64)
    for d in range(k):
        blocks, l, h = halo_exchange(blocks, d, halo, fill)
        lo[..., d], hi[..., d] = l, h
    for idx in np.ndindex(vol.grid):
        blocks[idx] = blocks[idx].contiguous()
    return Padded(blocks, lo, hi, vol)


def sharded_dilate26(mask, mesh: VolumeMesh, axes=("sx", "sy")):
    """Dilation by the 3x3x3 cube of a sharded mask (a ``ShardedVolume``,
    or a volume to shard over ``mesh``) through an explicit halo-1
    exchange (zero-filled at the faces, as the JAX package's: for a
    dilation that equals the volume's own padding).  Returns a
    ``ShardedVolume``, equal to ``ops/stencil.dilate26`` of the whole."""
    from ..ops.stencil import dilate26

    sh = mask if isinstance(mask, ShardedVolume) else \
        shard_volume(mask, mesh, axes)
    pad = pad_halos(sh, 1, fill=False)
    out = np.empty(sh.grid, dtype=object)
    for idx in sh.indices():
        out[idx] = dilate26(pad.blocks[idx])[pad.box(idx)]
    return dataclasses.replace(sh, blocks=out)
