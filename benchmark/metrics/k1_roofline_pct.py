"""k1_roofline_pct: K1's launches in the traced window, the sum of each
launch's frozen bound (frozen/rooflines.py) over the sum of their device
time, in percent of the H100's data-sheet peak."""

from frozen.rooflines import K1_KERNEL, bound_s, k1_launch


def read(run):
    if run.trace is None or "volume_shape" not in run.readings:
        return None
    hits = [(c, t) for name, (c, t) in run.trace["kernels"].items()
            if K1_KERNEL in name]
    n = sum(c for c, _ in hits)
    dev = sum(t for _, t in hits)
    if not n or dev <= 0:
        return None
    nbytes, ops = k1_launch(run.readings["volume_shape"],
                            run.readings["sigmas"],
                            run.readings.get("chunk_z", 48))
    return 100.0 * n * bound_s(nbytes, ops) / dev
