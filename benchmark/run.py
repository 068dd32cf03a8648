"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs from the seed and warms the program up;
the window then serves requests back to back for ``--seconds``; after it
the reference judges a sample of the answers.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number judged, with its limit.  The same
numbers end standard error.  Exits non-zero with no result line when
there is no CUDA device (or fewer than the cell asks for), when the
program is missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "arterynetwork_tpu_torch"

# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402


def fail(msg, code=3):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def guard(where):
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        fail(f"{where}: forbidden modules loaded: {', '.join(bad)}", 4)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None, base=HERE):
    """``base``: the benchmark's folder (the CPU tests point it at a
    copy that holds cells of their own)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the CPU tests alone: the benchmark proper runs on "cuda"
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload, base)
    root = os.path.dirname(base)
    if not os.path.isdir(os.path.join(root, PROGRAM)):
        fail(f"the program ({PROGRAM}) is not in {root}")
    import torch

    t_torch = time.perf_counter() - T_START
    chips = int(cell.entry["chips"])
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < chips):
        fail(f"needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " available")
    driver = cell.driver()
    state = driver.setup(cell.config, cell.traffic, args.seed, args.device)
    if cuda:
        torch.cuda.synchronize()
    guard("after set-up")
    run = harness.Run()
    run.setup_s = time.perf_counter() - T_START

    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                harness.closed_loop(driver, state, args.seconds, run,
                                    span=record_function)
            if cuda:
                torch.cuda.synchronize()
    else:
        harness.closed_loop(driver, state, args.seconds, run)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(chips))
            if cuda else 0)
    run.readings = driver.readings(state)
    if args.trace:
        events = harness.profiler_events(prof)
        del prof
        spans = None
        stages = driver.stage_spans(state)
        if stages:
            starts = sorted(s for n, dev, s, d in events
                            if not dev and n == driver.SPAN)
            spans = []
            for s0, parts in zip(starts, stages):
                t = s0
                for label, sec in parts:
                    spans.append((label, t, t + int(sec * 1e9)))
                    t += int(sec * 1e9)
        run.trace = harness.reduce_trace(events, "bench.window", spans)
        del events

    driver.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    try:
        numbers, info = driver.judge(state, args.seed, args.device)
    except Exception as exc:      # an answer the reference cannot read
        import traceback
        traceback.print_exc()
        numbers, info = {"judge_failed": float("inf")}, {"error": str(exc)}
    t_judge = time.perf_counter() - t_judge
    limits = cell.limits["limits"]
    compared = {k: {"value": v, "limit": limits.get(k, 0.0)}
                for k, v in numbers.items()}
    within = all(c["value"] <= c["limit"] for c in compared.values())
    correct = bool(within and run.failed == 0 and run.attempted > 0)

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = cell.reader(m).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else args.device,
              "kind": torch.cuda.get_device_name(0) if cuda else args.device,
              "count": chips, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["card"] = power_limit() if cuda else None
    result["window"] = {"seconds": run.window_s, "completed":
                        run.attempted - run.failed, **info}
    result["compared"] = compared
    guard("after the window")
    print("latencies_s " + " ".join(f"{x:.6f}" for x in run.latencies),
          file=sys.stderr)
    print(f"full_gc_in_window {len(run.gc_full)} collections "
          f"{sum(run.gc_full):.6f} s", file=sys.stderr)
    parts = " ".join(f"{k} {v:.3f}" for k, v in
                     state.get("setup_parts", {}).items())
    print(f"setup_parts to_torch_s {t_torch:.3f} {parts}", file=sys.stderr)
    print(f"judge_s {t_judge:.3f}", file=sys.stderr)
    for k, c in compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
