"""The readings that the limits of ``correct`` are set from: for each
seed, one cell's program judged as a run judges it and, with
``--control``, the control put in the program's place and judged the
same way against the same reference; with ``--fault <name>``, the
program with that fault of ``faults.py`` planted underneath.

    python3 benchmark/readings.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control] [--fault <name>] [--all]

The control is the plain reference computed one precision below the
configuration's (float32): the vesselness in bfloat16 before the same
thresholds and components, the distances and lengths rounded to
bfloat16, and the flow solve with its pressures and flows rounded to
bfloat16 after every step.  ``--all`` judges every volume served, not
the run's sample.  One JSON line per seed.  Not run by ``run.py``.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import faults  # noqa: E402
import harness  # noqa: E402


def bf16(x):
    import torch

    return (torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16)
            .to(torch.float64).numpy())


def control_volume(state, picks, device):
    """(worst program numbers, worst control numbers) over the patients
    ``picks``."""
    import torch

    from drivers.pipeline_volumes import reference_settings
    from reference import judge_volume

    settings = reference_settings(state["config"])
    worst_p, worst_c = {}, {}
    slot = {v["patient"]: j for j, v in enumerate(state["volumes"])}
    for j in (slot[p] for p in picks):
        raw, out = state["volumes"][j]["raw"], state["outputs"][j]
        nums, ref = judge_volume.judge(raw, out, settings, device)
        ctrl = dict(out)
        ctrl["mask"] = judge_volume.reference_mask(raw, settings, device,
                                                   dtype=torch.bfloat16)
        r, length = judge_volume.reference_branches(
            out["segments"], ref["dist_of"], edt_round=bf16)
        r, length = bf16(r), bf16(length)
        p, q = judge_volume.reference_flow(ref["net"], r, length, settings,
                                           dtype=np.float32,
                                           round_state=bf16)
        _, nodes, edges, sign = judge_volume.match(out, ref["net"])
        si = np.asarray(out["network"]["edge_segment_index"], np.int64)
        ctrl["network"] = dict(out["network"], radius=r[si],
                               length=length[si], node_pressure=p[nodes],
                               edge_flow=q[edges] * sign)
        cn, _ = judge_volume.judge(raw, ctrl, settings, device, ref=ref)
        for w, n in ((worst_p, nums), (worst_c, cn)):
            for k, v in n.items():
                w[k] = max(w.get(k, v), v)
    return worst_p, worst_c


def judge_all(state, device):
    """(worst numbers, {"judged": patients, "per_volume": numbers}) over
    every volume served."""
    from drivers.pipeline_volumes import reference_settings
    from reference import judge_volume

    settings = reference_settings(state["config"])
    worst, per = {}, {}
    for j in sorted(state["outputs"]):
        nums, _ = judge_volume.judge(state["volumes"][j]["raw"],
                                     state["outputs"][j], settings, device)
        per[state["volumes"][j]["patient"]] = nums
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, {"judged": sorted(per), "per_volume": per}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    cell = harness.load_cell(args.workload)
    driver = cell.driver()
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = driver.setup(cell.config, cell.traffic, seed, args.device)
        run = harness.Run()
        harness.closed_loop(driver, state, args.seconds, run)
        driver.release(state)
        gc.collect()
        t1 = time.perf_counter()
        try:
            if args.all:
                numbers, info = judge_all(state, args.device)
            else:
                numbers, info = driver.judge(state, seed, args.device)
        except Exception as exc:    # an answer the reference cannot read
            numbers, info = {"judge_failed": float("inf")}, {
                "error": repr(exc)}
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "program": numbers,
                "completed": run.attempted - run.failed,
                "failed": run.failed, "judge_s": time.perf_counter() - t1,
                **info}
        if args.control:
            _, line["control"] = control_volume(state, info["judged"],
                                                args.device)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del state
        gc.collect()


if __name__ == "__main__":
    main()
