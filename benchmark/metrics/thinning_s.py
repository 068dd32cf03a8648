"""thinning_s: the program's ``thinning`` span (the native thinning
call alone, inside ``skeletonization``), mean seconds per volume of the
window; none where the program has no such span."""


def read(run):
    t = run.readings.get("timings")
    if not t or not any("thinning" in x for x in t):
        return None
    return sum(x.get("thinning", 0.0) for x in t) / len(t)
