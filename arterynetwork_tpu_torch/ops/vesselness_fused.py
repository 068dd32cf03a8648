"""Frangi-response kernel (K1): Hessian + eigenvalues + tubularity + scale
max in one pass over the smoothed field.

Counterpart of the JAX package's Pallas kernel ``_response_kernel`` in
ops/vesselness_fused.py.  ``frangi_response_max_`` is the one entry
(``frangi_response_fused``, the JAX package's functional form, calls it):

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

import numpy as np
import torch

from . import cuda_build
from .vesselness import _hessian_from_smoothed, _response_from_hessian


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel_lib():
    return cuda_build.load("frangi_response", frangi_response_max=[
        _P, _I, _I, _I, _I, _I, _P, _I, _P, _F, _F, _F, _F, _I, _P])


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
    cuda_build.check(rc, "frangi_response_max")
    frangi_response_max_.launches += 1


frangi_response_max_.launches = 0


def frangi_response_fused(sm, sigma, g, alpha=0.5, beta=0.5, bright=True,
                          z_lo=0, z_hi=None):
    """Frangi response of ``sm`` rows [z_lo, z_hi): a (z_hi - z_lo, Y, X)
    f32 tensor on ``sm``'s device (the JAX package's
    ``frangi_response_fused``).

    ``sm``: smoothed field (Zs, Y, X) f32.  Rows outside the output range
    serve as real z-halos where ``sm`` has them; otherwise, and on the y/x
    faces, the field is edge-replicated.  ``g``: the scale weight from the
    S-max pass, a number or a one-element tensor.  CUDA tensors run K1
    (``frangi_response_max_`` into a running max filled with -inf, one
    launch counted there), CPU tensors its twin; any other device raises.

    The JAX function's ``tile`` and ``interpret`` are TPU knobs (a VMEM
    tiling, the Pallas interpreter) and have no counterpart here; nor do
    its VMEM guards ``fused_response_supported``,
    ``response_range_dynamic`` and ``region_grow_fused.fused_tile_fits``:
    K1 takes every shape."""
    if z_hi is None:
        z_hi = sm.shape[0]
    g = torch.as_tensor(g, dtype=torch.float32, device=sm.device).reshape(1)
    out = torch.full((z_hi - z_lo,) + tuple(sm.shape[1:]), -float("inf"),
                     dtype=torch.float32, device=sm.device)
    frangi_response_max_(out, 0, sm, z_lo, z_hi - z_lo, sigma, g, alpha,
                         beta, bright)
    return out
