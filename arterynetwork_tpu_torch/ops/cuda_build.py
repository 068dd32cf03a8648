"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by nvcc for sm_90a into a
shared library with a plain C interface, ``build/kernels/<name>.so``, at
first use (or ahead of time with ``build``), and loaded with ``ctypes``.
A library older than its source or than any ``csrc/*.cuh`` header is
rebuilt.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = ("frangi_response", "histogram", "region_grow_sweep",
           "region_grow_frontier")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def _paths(name):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"{name}.so"))


def build(names=KERNELS):
    """Compile the named sources in parallel (one nvcc each, all started
    together) and return ``{name: (seconds, compiler output)}``.  Each
    library is written under a private name and renamed into place, so a
    concurrent loader never maps a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (tmp, so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (tmp, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, so)
        out[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _stale(name):
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def load(name, **signatures):
    """The loaded library of ``csrc/<name>.cu``, built first if stale.
    ``signatures`` maps each C function to its argument types; every one
    returns an int (a CUDA error code, 0 = launched)."""
    if name not in _libs:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


def check(rc, what):
    """Raise if a launcher returned a CUDA error code."""
    if rc:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
