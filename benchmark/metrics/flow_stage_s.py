"""flow_stage_s: the pipeline's ``flow`` stage timer (the network built
from the branches, its boundary values and the Newton solve), mean
seconds per volume of the window."""


def read(run):
    t = run.readings.get("timings")
    return (sum(x.get("flow", 0.0) for x in t) / len(t)) if t else None
