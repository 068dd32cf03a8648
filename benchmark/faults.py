"""Faults planted in the program underneath a run, to show that the
comparison which decides ``correct`` fails them.  Each takes a
``setattr`` (pytest's ``monkeypatch.setattr``, or the builtin) and
replaces one function of the program by a broken wrapper of it.

    python3 benchmark/readings.py --workload <cell> --seeds ... \
        --fault <name>

reads them at a cell's own size; ``benchmark/tests/test_bench_faults.py``
plants them under whole runs of tiny cells.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi


def thinning_stops_early(setattr_):
    """The thinning ends one pass short in the far half of its box: there
    the mask's voxels that touch the skeleton by a face are left on it."""
    from arterynetwork_tpu_torch.ops import native

    thin = native.skeletonize_native_cropped

    def early(mask_box, d2_box, *a, **kw):
        mask = np.asarray(mask_box) != 0
        skel = thin(mask_box, d2_box, *a, **kw)
        shell = ndi.binary_dilation(skel != 0) & mask
        shell[:shell.shape[0] // 2] = False
        skel[shell] = 1
        return skel

    setattr_(native, "skeletonize_native_cropped", early)


def dropped_branch(setattr_):
    """The branch extraction loses its longest branch with a free end."""
    from arterynetwork_tpu_torch.graphs import segments as seg_mod

    cut = seg_mod.skeleton_to_segments

    def dropped(*a, **kw):
        g, segs = cut(*a, **kw)
        ends = {}
        for s in segs:
            for v in (tuple(s[0]), tuple(s[-1])):
                ends[v] = ends.get(v, 0) + 1
        free = [i for i, s in enumerate(segs)
                if ends[tuple(s[0])] == 1 or ends[tuple(s[-1])] == 1]
        if free:
            segs = list(segs)
            del segs[max(free, key=lambda i: len(segs[i]))]
        return g, segs

    setattr_(seg_mod, "skeleton_to_segments", dropped)


def boundary_split_by_count(setattr_):
    """The ground-truth sweep splits a node's flow among its branches by
    their number (option 1) and not by their cross-sections."""
    from arterynetwork_tpu_torch.flow import ground_truth

    make = ground_truth.create_ground_truth

    def by_count(net, *a, **kw):
        kw["option"] = 1
        return make(net, *a, **kw)

    setattr_(ground_truth, "create_ground_truth", by_count)


FAULTS = {f.__name__: f for f in (thinning_stops_early, dropped_branch,
                                  boundary_split_by_count)}
