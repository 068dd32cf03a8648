"""vesselness_pack_s: the program's ``vesselness_pack`` span (the host's
bq pack and compaction of each slab, inside ``vesselness_upload``),
mean seconds per volume of the window; none where the program has no
such span."""


def read(run):
    t = run.readings.get("timings")
    if not t or not any("vesselness_pack" in x for x in t):
        return None
    return sum(x.get("vesselness_pack", 0.0) for x in t) / len(t)
