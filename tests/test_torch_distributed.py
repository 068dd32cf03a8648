"""The port's multi-process dp path (parallel/distributed.py).

Runs ``python -m arterynetwork_tpu_torch.parallel.dcn_smoke``, which
starts TWO local processes joined in a gloo process group on a free port,
each with 4 CPU slots, builds the cross-process dp mesh and runs one
batched f64 CG flow solve split over it, as tests/test_distributed.py
runs the JAX package's scripts/dcn_smoke.py.  Both children must report
the same rows (checksum), residuals below 1e-9 m^3/s, and rows equal to
the same batch solved in one process.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dp_solve():
    out = subprocess.run(
        [sys.executable, "-m", "arterynetwork_tpu_torch.parallel.dcn_smoke",
         "--port", str(_free_port())],
        capture_output=True, text=True, timeout=420, cwd=REPO)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines, (out.stdout[-500:], out.stderr[-500:])
    rec = json.loads(lines[-1])
    assert rec["ok"], rec
    c0, c1 = rec["children"]
    assert c0["process_count"] == 2 and c0["global_devices"] == 8
    assert c0["mesh"] == {"dp": 2, "sx": 2, "sy": 2}
    assert c0["pressure_checksum"] == c1["pressure_checksum"]
    assert c0["max_residual"] < 1e-9
    assert c0["rows_equal_one_process"] and c1["rows_equal_one_process"]
