"""Frangi-response kernel (K1): Hessian + eigenvalues + tubularity + scale
max in one pass over the smoothed field.

Counterpart of the JAX package's Pallas kernel ``_response_kernel`` in
ops/vesselness_fused.py.  ``frangi_response_max_`` is the one entry:

  * for CUDA tensors it launches the hand-written kernel of
    ``csrc/frangi_response.cu`` (built with nvcc for sm_90a at first use,
    into ``build/kernels/``) on the current stream, or raises;
  * for CPU tensors it runs ``frangi_response_plain_``, the plain PyTorch
    twin with the same signature (the JAX package's XLA apply math).

``frangi_response_max_.launches`` counts kernel launches (twin calls do
not count), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from .vesselness import _hessian_from_smoothed, _response_from_hessian

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "frangi_response.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_SO = os.path.join(_BUILD_DIR, "frangi_response.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def build_kernel():
    """Compile ``csrc/frangi_response.cu`` into ``build/kernels/`` and
    return ``(seconds, compiler output)``.  The library is written under
    a private name and renamed into place, so concurrent loaders never map
    a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _kernel_lib():
    global _lib
    if _lib is None:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            build_kernel()
        lib = ctypes.CDLL(_SO)
        lib.frangi_response_max.restype = ctypes.c_int
        lib.frangi_response_max.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def frangi_response_plain_(best, best_z0, sm, z_lo, zr, sigma, g,
                           alpha=0.5, beta=0.5, bright=True):
    """Plain PyTorch twin of the kernel (same signature and semantics):
    the Hessian, eigenvalues and response of ``sm`` rows
    [z_lo, z_lo + zr), reading one real z row on each side (edge
    replicated only at the ends of ``sm``), folded into
    ``best[best_z0:best_z0 + zr]`` by an in-place max."""
    lo = max(z_lo - 1, 0)
    hi = min(z_lo + zr + 1, sm.shape[0])
    hs = _hessian_from_smoothed(sm[lo:hi], sigma)
    v = _response_from_hessian(hs, alpha, beta, g.reshape(()), bright)
    dst = best[best_z0:best_z0 + zr]
    torch.maximum(dst, v[z_lo - lo:z_lo - lo + zr], out=dst)


def _check(best, best_z0, sm, z_lo, zr, g):
    for name, t in (("sm", sm), ("best", best)):
        if t.dtype != torch.float32 or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if tuple(best.shape[1:]) != tuple(sm.shape[1:]):
        raise ValueError(f"best {tuple(best.shape)} and sm "
                         f"{tuple(sm.shape)} differ in (Y, X)")
    if zr < 0 or not (0 <= z_lo and z_lo + zr <= sm.shape[0]) \
            or not (0 <= best_z0 and best_z0 + zr <= best.shape[0]):
        raise ValueError(f"rows out of range: sm[{z_lo}:{z_lo + zr}] of "
                         f"{sm.shape[0]}, best[{best_z0}:{best_z0 + zr}] "
                         f"of {best.shape[0]}")
    if g.dtype != torch.float32 or g.numel() != 1:
        raise ValueError("g must be a one-element float32 tensor")
    if not (sm.device == best.device == g.device):
        raise ValueError(f"sm, best and g on different devices: "
                         f"{sm.device}, {best.device}, {g.device}")


def frangi_response_max_(best, best_z0, sm, z_lo, zr, sigma, g,
                         alpha=0.5, beta=0.5, bright=True):
    """``best[best_z0 + i] = max(best[best_z0 + i], response(sm, z_lo + i))``
    for i in [0, zr), in place.

    ``sm``: smoothed field (Zs, Y, X) f32; ``best``: running max
    (Zb, Y, X) f32; ``g``: one-element f32 tensor, the scale weight from
    the S-max pass (read on the device, no host synchronisation).
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    _check(best, best_z0, sm, z_lo, zr, g)
    if sm.device.type == "cpu":
        frangi_response_plain_(best, best_z0, sm, z_lo, zr, sigma, g,
                               alpha, beta, bright)
        return
    if sm.device.type != "cuda":
        raise ValueError(f"no Frangi-response kernel for {sm.device}")
    lib = _kernel_lib()
    s2 = np.float32(sigma * sigma)
    one = np.float32(1.0)
    with torch.cuda.device(sm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.frangi_response_max(
            sm.data_ptr(), sm.shape[0], sm.shape[1], sm.shape[2],
            int(z_lo), int(zr), best.data_ptr(), int(best_z0),
            g.data_ptr(), float(s2), float(np.float32(0.25) * s2),
            float(one / np.float32(2 * alpha ** 2)),
            float(one / np.float32(2 * beta ** 2)), int(bool(bright)),
            stream)
    if rc:
        raise RuntimeError(f"frangi_response_max launch failed: CUDA "
                           f"error {rc}")
    frangi_response_max_.launches += 1


frangi_response_max_.launches = 0
