"""graph_segments_s: the program's ``graph_segments`` span (chain
extraction from the skeleton, inside ``graph``), mean seconds per
volume of the window; none where the program has no such span."""


def read(run):
    t = run.readings.get("timings")
    if not t or not any("graph_segments" in x for x in t):
        return None
    return sum(x.get("graph_segments", 0.0) for x in t) / len(t)
