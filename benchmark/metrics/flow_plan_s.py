"""flow_plan_s: the program's ``flow_network``, ``flow_boundary`` and
``flow_system`` spans together (the host's planning of the solve:
network, boundary pressures, system and elimination plan, inside
``flow``), mean seconds per volume of the window; none where the
program has no such span."""

KEYS = ("flow_network", "flow_boundary", "flow_system")


def read(run):
    t = run.readings.get("timings")
    if not t or not any(k in x for x in t for k in KEYS):
        return None
    return sum(x.get(k, 0.0) for x in t for k in KEYS) / len(t)
