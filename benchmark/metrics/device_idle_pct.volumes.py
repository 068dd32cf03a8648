"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card (the union of their intervals, from the
profiler's trace of the same window), in percent."""


def read(run):
    if (run.trace is None or run.trace["window_s"] <= 0
            or run.trace["busy_s"] <= 0):       # no device in the trace
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
