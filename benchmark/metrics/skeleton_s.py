"""skeleton_s: the pipeline's ``edt`` and ``skeletonization`` stage
timers together (native EDT and thinning), mean seconds per volume."""


def read(run):
    t = run.readings.get("timings")
    if not t:
        return None
    return sum(x.get("edt", 0.0) + x.get("skeletonization", 0.0)
               for x in t) / len(t)
