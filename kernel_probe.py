"""The shared parts of the kernel probes (k1_breakdown.py,
k2_breakdown.py, k7_breakdown.py) and of chip_smoke.py's bare-launch
timing:

* ``variants``: CUDA sources made from one by substitution;
* ``build_all``: CUDA sources built like the port's kernels (the nvcc and
  flags of ``arterynetwork_tpu_torch/ops/cuda_build.py``), every nvcc
  started together, into build/<subdir>/<name>.so, with ptxas's lines;
* ``ptxas_lines``, ``demangle``: ptxas's register, spill and stack-frame
  lines of a build log, with readable kernel names;
* ``events_ms``: device ms per call, from CUDA events around back-to-back
  calls.

torch and the port are imported inside the functions, so that importing
this module needs neither a card nor a CUDA toolkit.
"""

import ctypes
import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln
            or "spill" in ln or "stack frame" in ln]


def demangle(lines):
    from arterynetwork_tpu_torch.ops import cuda_build

    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        return lines
    out = subprocess.run([tool], input="\n".join(lines), capture_output=True,
                         text=True, timeout=60).stdout
    return out.splitlines() or lines


def variants(text, subs):
    """{name: ``text`` with each (old, new) pair of ``subs[name]`` (a flat
    tuple old, new, old, new, ...) replaced once}; a variant whose old
    text is not in ``text`` is reported and left out."""
    out = {}
    for name, pairs in subs.items():
        v = text
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in v:
                print(f"{name}: not in the port's source, skipped",
                      flush=True)
                break
            v = v.replace(old, new, 1)
        else:
            out[name] = v
    return out


def build_all(sources, subdir):
    """{name: (ctypes library, ptxas lines, .so path)} of {name: CUDA
    source text}, every nvcc process started together, into
    build/<subdir>/<name>.so; a build that fails is reported and left
    out.  The caller sets each entry point's argument types."""
    from arterynetwork_tpu_torch.ops import cuda_build

    out_dir = os.path.join(ROOT, "build", subdir)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, so = (os.path.join(out_dir, f"{name}.cu"),
                   os.path.join(out_dir, f"{name}.so"))
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", so, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed, left out:\n{log}", flush=True)
            continue
        libs[name] = (ctypes.CDLL(so), ptxas_lines(log), so)
    return libs


def events_ms(fn, n=20, warmup=3):
    """Device ms per call: CUDA events around ``n`` back-to-back calls of
    ``fn``, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n
