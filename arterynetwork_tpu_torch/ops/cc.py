"""Connected-component labeling as iterated label propagation.

Port of the JAX package's ops/cc.py (the reference's
``skimage.measure.label``, generateVesselVolume.py:107-136 and
skeletonization.py:108).  Every foreground voxel starts with its flat
index as a label; each round takes the min label over the neighborhood
(restricted to foreground), then pointer-jumps ``label <- label[label]``
twice.  The rounds stop when nothing changes or at ``max_rounds``, as in
the JAX package's ``lax.while_loop`` (arterynetwork_tpu/ops/cc.py:80), so
even an unconverged result equals its; on a card each round is replayed
from a captured CUDA graph (``ops/grow_loop``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import grow_loop
from .region_grow import _as_device, _resolve_device

# The labels are int32: each voxel's flat index, the background sentinel n
# and n + 1 must fit, so a volume holds at most 2^31 - 2 voxels.
MAX_VOXELS = 2 ** 31 - 2


def _axis_min3(x, axis):
    """Min over the 3-window along ``axis`` (nothing outside)."""
    n = x.shape[axis]
    out = x.clone()
    if n > 1:
        lo, hi = x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)
        o = out.narrow(axis, 1, n - 1)
        torch.minimum(o, lo, out=o)
        o = out.narrow(axis, 0, n - 1)
        torch.minimum(o, hi, out=o)
    return out


def check_voxel_count(shape):
    """Raise ValueError when a volume of ``shape`` has more voxels than
    int32 labels can index (``MAX_VOXELS``)."""
    n = int(np.prod(shape, dtype=np.int64))
    if n > MAX_VOXELS:
        raise ValueError(
            f"connected_components labels with int32 flat indices: a volume "
            f"of shape {tuple(shape)} has {n} voxels, at most {MAX_VOXELS} "
            f"(2^31 - 2) are allowed")


# the components' cache: per device and thread, at most this many
# entries; an entry holds five int32 or bool volumes of the mask's shape
# (at Speck scale several GB) between calls, so one
_CACHE_SIZE = 1
_cache = grow_loop.LoopCache(_CACHE_SIZE)


def clear_components_cache(device=None):
    """Drop this thread's cached labellings on ``device`` (or on every
    device)."""
    _cache.clear(device)


def components_cache_info():
    """The components' cache: hits, misses, evictions, entries by
    device."""
    return _cache.info()


class _Labelling(grow_loop.CachedLoop):
    """A cached labelling, the counterpart of one executable in the JAX
    jit's cache: the foreground ``fg``, the flat indices ``idx``, the
    background sentinel ``big`` (n), the labels, the pointer-jump table
    ``padded`` (n + 1 entries, the last n), ``changed``, the round count,
    ``stop``, and the round, which reads nothing else, under the key
    "round".  Its key: the shape (n), ``connectivity`` and
    ``max_rounds`` (the round takes all three as constants)."""

    def __init__(self, shape, device, connectivity, max_rounds):
        super().__init__(device)
        n = int(np.prod(shape))
        self.shape, self.n = shape, n
        self.connectivity, self.max_rounds = connectivity, max_rounds
        self.fg = torch.empty(shape, dtype=torch.bool, device=device)
        self.idx = torch.arange(n, dtype=torch.int32,
                                device=device).reshape(shape)
        self.big = torch.tensor(n, dtype=torch.int32, device=device)
        self.labels = torch.empty(shape, dtype=torch.int32, device=device)
        self.padded = torch.full((n + 1,), n, dtype=torch.int32,
                                 device=device)
        self.changed = torch.zeros((), dtype=torch.bool, device=device)
        self.rounds, self.stop = (torch.zeros((), dtype=torch.int32,
                                              device=device)
                                  for _ in range(2))

    def load(self, fg):
        """Copy a call's foreground in, rebuild the labels from it and
        reset the scalars."""
        self.fg.copy_(fg)
        torch.where(self.fg, self.idx, self.big, out=self.labels)
        for t in (self.changed, self.rounds, self.stop):
            t.zero_()

    def propagate(self, lab):
        best = lab
        for axis in range(lab.dim()):
            if self.connectivity == 1:
                best = torch.minimum(best, _axis_min3(lab, axis))
            else:
                best = _axis_min3(best, axis)
        return torch.where(self.fg, torch.minimum(lab, best), self.big)

    def jump(self, lab):
        flat = lab.reshape(-1)
        self.padded[:self.n].copy_(flat)
        return self.padded[torch.clamp_max(flat, self.n)].reshape(
            self.shape)

    def step(self):
        labels = self.labels
        new = self.jump(self.jump(self.propagate(labels)))
        self.changed.copy_(torch.any(new != labels))
        labels.copy_(new)
        self.rounds.add_(1)
        self.stop.copy_(torch.where(self.changed
                                    & (self.rounds < self.max_rounds),
                                    -1, 0))


@grow_loop.frees_loop_caches
def connected_components(mask, connectivity: int = 3, max_rounds: int = 64,
                         device=None):
    """Label 26-connected (connectivity=3) or 6-connected (connectivity=1)
    components on ``device`` (by default the device of a ``mask`` tensor;
    host arrays go to the card).  Returns int32 labels: 0 = background,
    components numbered by the flat index of their smallest voxel + 1
    (relabel to compact ids with ``compact_labels``).

    ``connectivity`` follows skimage: 1 = faces only, 2 = faces+edges,
    3 = faces+edges+corners (2 is approximated as 3, as in the JAX
    package; the reference always uses maxHop=3).  Each round updates
    the labels, a round count and ``stop`` in place and runs in
    ``grow_loop.loop_for(device)``: on a CUDA device a ``GraphLoop``
    (the first round eager, the second captured as a CUDA graph, later
    ones replayed).  The host reads ``stop`` once per round (the first
    round's condition is known on the host).

    As ``jax.jit`` compiles the loop once per shape and static
    arguments, the round and every tensor it reads lie in a cached entry
    (``_Labelling``; its docstring lists what it holds and its key); a
    call copies its foreground in and rebuilds the labels there, and on
    a hit every round is a replay and nothing is captured (a miss
    captures as above and, after one round, at the call's end).  The
    result is a new tensor.  The last call's counts are
    ``connected_components.rounds``, ``.reads``, ``.captures``,
    ``.replays``, ``.capture_s`` and ``.hit``.  A volume of 2^31 - 1
    voxels or more raises ValueError before anything is allocated
    (``check_voxel_count``).
    """
    check_voxel_count(mask.shape if hasattr(mask, "shape")
                      else np.shape(mask))
    device = _resolve_device(mask, device)
    fg = _as_device(mask, device) != 0
    shape = tuple(fg.shape)
    with _cache.use(device, (shape, connectivity, max_rounds),
                    lambda: _Labelling(shape, device, connectivity,
                                       max_rounds)) as (lab, hit):
        lab.load(fg)
        loop = lab.loop
        with loop.stream():
            if max_rounds > 0:
                loop.run("round", lab.step)
                while loop.read(lab.stop) < 0:
                    loop.run("round", lab.step)
            loop.capture_pending()
        out = torch.where(lab.fg, lab.labels + 1, 0).to(torch.int32)
    _count(loop, hit)
    return out


def _count(loop, hit=False):
    """``connected_components``'s counts from the loop its rounds ran
    in."""
    connected_components.hit = hit
    connected_components.rounds = loop.runs.get("round", 0)
    connected_components.reads = loop.reads
    connected_components.captures = loop.captures
    connected_components.replays = loop.replays
    connected_components.capture_s = loop.capture_s


_count(grow_loop.HostLoop())


def compact_labels(labels):
    """Host-side: renumber labels to 1..K and return (labels, sizes).

    sizes is ``[(label, voxel_count), ...]`` like the reference's
    ``labelResult`` (generateVesselVolume.py:125-132, background included
    as label 0).
    """
    labels = labels.cpu().numpy() if torch.is_tensor(labels) \
        else np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    compact = inv.reshape(labels.shape).astype(np.int32)
    if uniq[0] != 0:
        compact = compact + 1  # no background present
    counts = np.bincount(compact.ravel())
    label_result = list(zip(np.arange(len(counts)), counts))
    return compact, label_result


def label_volume(volume, min_size: int = 1, connectivity: int = 3,
                 backend: str = "auto", device=None):
    """API parity with the reference ``labelVolume``
    (generateVesselVolume.py:107-136 / skeletonization.py:67-95): label the
    volume, return (labeled, labelResult) with components smaller than
    ``min_size`` excluded from labelResult.

    backend="host" uses the native C++ flood fill (ops/native.py, or
    scipy for connectivity 1); "device" and "auto" run
    ``connected_components`` on ``device`` (the JAX package takes the host
    only on a TPU, where gathers are slow).
    """
    if backend == "host":
        if connectivity >= 2:
            from .native import label_components_native
            labeled, _ = label_components_native(volume)
        else:
            from scipy import ndimage
            structure = ndimage.generate_binary_structure(3, 1)
            labeled, _ = ndimage.label(np.asarray(volume) != 0,
                                       structure=structure)
            labeled = labeled.astype(np.int32)
        counts = np.bincount(labeled.ravel())
        label_result = [(int(l), int(c)) for l, c in enumerate(counts)]
    else:
        raw = connected_components(volume, connectivity=connectivity,
                                   device=device)
        labeled, label_result = compact_labels(raw)
    filtered = [(int(l), int(s)) for l, s in label_result if s >= min_size]
    return labeled, filtered


def drop_small_components(volume, threshold: int = 150,
                          connectivity: int = 3, device=None):
    """Zero out connected components with <= threshold voxels (reference
    main(), generateVesselVolume.py:195-199).  Host array in and out."""
    vol = np.asarray(volume)
    if (connectivity >= 2 and vol.dtype in (np.bool_, np.uint8)
            and vol.max() <= 1):
        # binary volume: single fused native pass (label + sizes + zero)
        from .native import drop_small_components_native
        return drop_small_components_native(vol, threshold).astype(vol.dtype)
    labeled, label_result = label_volume(vol, connectivity=connectivity,
                                         device=device)
    sizes = np.zeros(max(l for l, _ in label_result) + 1, np.int64)
    for lab, size in label_result:
        sizes[lab] = size
    keep = sizes > threshold
    keep[0] = False
    out = vol.copy()
    out[~keep[labeled]] = 0
    return out
