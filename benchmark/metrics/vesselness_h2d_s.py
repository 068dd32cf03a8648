"""vesselness_h2d_s: the program's ``vesselness_h2d`` span (each slab's
host-to-device copies on the host's clock, waits for earlier work on
the stream included; inside ``vesselness_upload``), mean seconds per
volume of the window; none where the program has no such span."""


def read(run):
    t = run.readings.get("timings")
    if not t or not any("vesselness_h2d" in x for x in t):
        return None
    return sum(x.get("vesselness_h2d", 0.0) for x in t) / len(t)
