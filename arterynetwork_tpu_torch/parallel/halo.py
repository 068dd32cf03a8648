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
  faces (``Tensor.copy_`` across devices: a peer copy between two
  cards, a plain copy on one).  Corners travel because the dims are
  exchanged one after the other.  At the volume's faces JAX's exchange
  fills zeros; here ``fill=None`` adds no halo there, which is what the
  edge-replicated differences of the vesselness and the region-growing
  rule (a voxel outside the volume is neither segmented nor unsegmented)
  need, and a number fills the face halo as JAX does.
* ``pad_halos`` pads every block on every sharded dim (corners
  included) into a ``Padded``, which knows where each block's own voxels
  lie.  ``refresh_halos`` brings a ``Padded``'s halo slots up to date
  from its blocks' own voxels in place, face by face (``halo_faces``):
  ``pad_halos`` fills a new ``Padded`` so, and an iterated stencil that
  keeps its blocks padded (the region grower) copies only the halo after
  each update, not every block.  One walk (``_halo_runs``) says where
  each halo slot's planes come from, for all three.
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


def _extent(sizes, i, halo, fill):
    """(slots before, slots after) block ``i`` of a row of blocks of
    ``sizes`` planes along one dim: ``halo`` each where a ``fill`` makes
    up the volume's faces, else as many as its neighbours hold."""
    if fill is not None:
        return halo, halo
    return min(halo, sum(sizes[:i])), min(halo, sum(sizes[i + 1:]))


def _halo_runs(sizes, i, lo, hi):
    """Where the ``lo`` halo slots before block ``i`` of a row of blocks
    of ``sizes`` planes and the ``hi`` slots after it come from: runs
    (first slot in the padded block, planes, neighbour j, its first own
    plane), nearest neighbour first, from several neighbours where one is
    thinner than the halo.  Slots past the row's ends are in no run (they
    keep the fill).  The one walk of this module: ``halo_exchange``,
    ``pad_halos`` and ``halo_faces`` all take their copies from it."""
    runs = []
    at, j = lo, i - 1
    while at > 0 and j >= 0:
        take = min(at, sizes[j])
        runs.append((at - take, take, j, sizes[j] - take))
        at, j = at - take, j - 1
    at, end, j = lo + sizes[i], lo + sizes[i] + hi, i + 1
    while at < end and j < len(sizes):
        take = min(end - at, sizes[j])
        runs.append((at, take, j, 0))
        at, j = at + take, j + 1
    return runs


def _padded_block(b, lo, hi, fill):
    """A new tensor of ``b`` with ``lo[d]``/``hi[d]`` slots before/after it
    on its leading dims, ``b`` copied into its place; the slots hold
    ``fill``, or nothing yet where it is None."""
    shape = [n + int(l) + int(h) for n, l, h in zip(b.shape, lo, hi)] \
        + list(b.shape[len(lo):])
    t = b.new_empty(shape) if fill is None else b.new_full(shape, fill)
    t[tuple(slice(int(l), int(l) + n) for l, n in zip(lo, b.shape))] \
        .copy_(b)
    return t


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
        sizes = [blocks[_along(idx, axis, j)].shape[axis]
                 for j in range(grid[axis])]
        l, h = _extent(sizes, idx[axis], halo, fill)
        lo[idx], hi[idx] = l, h
        t = _padded_block(b, [0] * axis + [l], [0] * axis + [h], fill)
        for at, n, j, src in _halo_runs(sizes, idx[axis], l, h):
            t.narrow(axis, at, n).copy_(
                blocks[_along(idx, axis, j)].narrow(axis, src, n))
        out[idx] = t
    return out, lo, hi


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
    each sharded dim, corners included (as ``halo_exchange`` dim after
    dim gives); ``fill`` as there.  Each padded block is made once, its
    own voxels copied in, and ``refresh_halos`` fills its halo slots."""
    k = len(vol.grid)
    lo = np.zeros(vol.grid + (k,), dtype=np.int64)
    hi = np.zeros(vol.grid + (k,), dtype=np.int64)
    blocks = np.empty(vol.grid, dtype=object)
    for idx in np.ndindex(vol.grid):
        for d in range(k):
            sizes = [vol.blocks[_along(idx, d, j)].shape[d]
                     for j in range(vol.grid[d])]
            lo[idx][d], hi[idx][d] = _extent(sizes, idx[d], halo, fill)
        blocks[idx] = _padded_block(vol.blocks[idx], lo[idx], hi[idx], fill)
    pad = Padded(blocks, lo, hi, vol)
    refresh_halos(pad)
    return pad


def halo_faces(pad: Padded):
    """The copies that bring ``pad``'s halo slots up to date from its
    blocks' own voxels, as (halo slots, neighbour's voxels) pairs of
    views of the padded tensors, in the order to make them: dim after
    dim, so that a dim's copies span the halo slots of the dims before
    it and corners travel.  The views live as long as ``pad``'s tensors:
    a caller that keeps them computes this once."""
    grid = pad.source.grid
    faces = []
    for d in range(len(grid)):
        for idx in np.ndindex(grid):
            t, box = pad.blocks[idx], pad.box(idx)
            sizes = [pad.source.blocks[_along(idx, d, j)].shape[d]
                     for j in range(grid[d])]

            def span(start, n):
                # dims before d: whole (their halos are fresh); after: own
                return tuple(slice(None) if e < d else
                             slice(start, start + n) if e == d else box[e]
                             for e in range(len(grid)))

            for at, n, j, src in _halo_runs(sizes, idx[d],
                                            int(pad.lo[idx][d]),
                                            int(pad.hi[idx][d])):
                nb = _along(idx, d, j)
                faces.append((t[span(at, n)], pad.blocks[nb][
                    span(int(pad.lo[nb][d]) + src, n)]))
    return faces


def refresh_halos(pad: Padded, faces=None) -> int:
    """Copy into every block's halo slots of ``pad`` its neighbours' own
    voxels, in place, from the same padded tensors: afterwards each block
    holds the volume's voxels around its own as far as its halo slots
    reach, corners included (the face slots of a ``fill`` stay as they
    are).  One ``Tensor.copy_`` per face
    of ``faces`` (default ``halo_faces(pad)``; a peer copy between two
    cards).  Returns the number of elements copied."""
    n = 0
    for dst, src in (halo_faces(pad) if faces is None else faces):
        dst.copy_(src)
        n += dst.numel()
    return n


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
