"""Table-lookup kernel (K7): ``table[bins]`` per voxel, as values or signs.

Counterpart of the JAX package's Pallas kernel ``_lookup_kernel``
(``table_lookup_pallas``) in ops/pallas_kernels.py.  Both entries share one
CUDA source, ``csrc/table_lookup.cu``:

  * for CUDA tensors they launch the hand-written kernel (built with nvcc
    for sm_90a at first use, into ``build/kernels/``) on the current
    stream, or raise;
  * for CPU tensors they run the plain PyTorch versions
    ``table_lookup_plain`` and ``sign_lookup_plain`` (a gather).

``bins`` is uint8 or int32 of any shape; ``table`` is a 1-D f32 or f64
tensor.  A bin outside ``[0, len(table))`` is outside the contract: the
kernel writes 0 (False) there, the plain versions raise.
``table_lookup.launches`` and ``sign_lookup.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BIN_DTYPES = (torch.uint8, torch.int32)
TABLE_DTYPES = (torch.float32, torch.float64)


def _kernel_lib():
    return cuda_build.load("table_lookup", table_lookup=[
        _P, _I, _P, _I, _I, _P, _I, _LL, _I, _P])


def table_lookup_plain(bins, table):
    """``table[bins]`` elementwise (``.long()``: uint8 indices would be
    read as a mask)."""
    return table[bins.long()]


def sign_lookup_plain(bins, table):
    """``table[bins] >= 0`` elementwise."""
    return table_lookup_plain(bins, table) >= 0


def _check(bins, table):
    if table.dim() != 1 or table.numel() == 0:
        raise ValueError(f"table must be a non-empty 1-D tensor, got "
                         f"{tuple(table.shape)}")
    if bins.dtype not in BIN_DTYPES or table.dtype not in TABLE_DTYPES:
        raise ValueError(f"bins must be uint8 or int32 and table float32 "
                         f"or float64, got {bins.dtype}, {table.dtype}")
    if bins.device != table.device:
        raise ValueError(f"bins on {bins.device}, table on {table.device}")
    if bins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup kernel for {bins.device}")
    if not (bins.is_contiguous() and table.is_contiguous()):
        raise ValueError("bins and table must be contiguous")


def _launch(bins, table, sign):
    out = torch.empty(bins.shape, device=bins.device,
                      dtype=torch.bool if sign else table.dtype)
    n = bins.numel()
    if not n:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(bins.device):
        n_sm = torch.cuda.get_device_properties(
            bins.device).multi_processor_count
        rc = lib.table_lookup(
            bins.data_ptr(), bins.element_size(), table.data_ptr(),
            table.element_size(), table.numel(), out.data_ptr(), int(sign),
            n, n_sm, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "table_lookup")
    return out


def table_lookup(bins, table):
    """K7, values mode: ``table[bins]`` in the table's dtype, of ``bins``'s
    shape."""
    _check(bins, table)
    if bins.device.type == "cpu":
        return table_lookup_plain(bins, table)
    out = _launch(bins, table, sign=False)
    table_lookup.launches += bool(bins.numel())
    return out


def sign_lookup(bins, table):
    """K7, sign mode: ``table[bins] >= 0`` as a bool tensor of ``bins``'s
    shape (NaN gives False, -0.0 True)."""
    _check(bins, table)
    if bins.device.type == "cpu":
        return sign_lookup_plain(bins, table)
    out = _launch(bins, table, sign=True)
    sign_lookup.launches += bool(bins.numel())
    return out


table_lookup.launches = 0
sign_lookup.launches = 0
