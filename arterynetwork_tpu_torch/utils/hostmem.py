# Copy of arterynetwork_tpu/utils/hostmem.py; its docstring describes the port.
"""Host allocator configuration for volume-scale numpy work.

A 512x512x170 MRA stage allocates and frees several 100-200 MB arrays
per call.  glibc malloc serves blocks above M_MMAP_THRESHOLD (128 KB
default) with fresh anonymous mmaps and returns them to the kernel on
free, so *every* pipeline invocation pays demand-zero page faults for
every large temporary; where first-touch faults are slow, a short pass
over a fresh array costs mostly its faults.  Raising the mmap/trim
thresholds keeps large blocks on the heap where they are reused across
calls: the first (warm-up) run faults the pages once and steady-state
runs are pure compute.

``mallopt`` is callable at runtime (the env tunables are read only at
process start), so this works regardless of how Python was launched.
Safe no-op on non-glibc platforms.
"""

from __future__ import annotations

import ctypes

_configured = False

_M_TRIM_THRESHOLD = -1
_M_TOP_PAD = -2
_M_MMAP_THRESHOLD = -3


def configure_host_allocator(threshold_bytes: int = (1 << 31) - 1) -> bool:
    # INT_MAX: mallopt takes a C int, and Speck-scale stages allocate
    # ~2 GB temporaries that must stay heap-resident too
    """Keep large malloc blocks heap-resident and reusable.  Idempotent.
    Returns True if mallopt was applied."""
    global _configured
    if _configured:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes) == 1)
        libc.mallopt(_M_TOP_PAD, 64 << 20)
        _configured = bool(ok)
    except OSError:
        _configured = False
    return _configured
