"""graph_capture_s: the program's ``graph_capture`` span (CUDA graph
captures and while-graph builds, inside ``flow_solve`` on this cell),
mean seconds per volume of the window, a volume that captured nothing
counted as 0; none where the program has no such span."""


def read(run):
    t = run.readings.get("timings")
    if not t or not any("graph_capture" in x for x in t):
        return None
    return sum(x.get("graph_capture", 0.0) for x in t) / len(t)
