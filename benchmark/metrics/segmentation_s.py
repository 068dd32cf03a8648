"""segmentation_s: the pipeline's own ``segmentation`` stage timer
(``run_pipeline``'s ``timings``), mean seconds per volume of the
window."""


def read(run):
    t = run.readings.get("timings")
    return (sum(x.get("segmentation", 0.0) for x in t) / len(t)) if t else None
