"""vesselness_upload_s: the pipeline's own ``vesselness_upload`` stage timer
(``run_pipeline``'s ``timings``), mean seconds per volume of the
window."""


def read(run):
    t = run.readings.get("timings")
    return (sum(x.get("vesselness_upload", 0.0) for x in t) / len(t)) if t else None
