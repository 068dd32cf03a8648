"""The Frangi-response kernel (K1) of the PyTorch port and its wrapper.

Tests marked ``gpu`` build the CUDA kernel and hold it to its plain
PyTorch twin on a CUDA device; they skip where there is none.  The
kernel is compiled with -fmad=false and follows the twin's operation
order, so the tolerance is 1e-6 absolute on responses in [0, 1] (measured
on an H100: 0, the two are bit-identical).  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from arterynetwork_tpu_torch.ops.vesselness import _smooth
from arterynetwork_tpu_torch.ops.vesselness_fused import (
    frangi_response_max_, frangi_response_plain_)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _smoothed(shape, sigma, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.05, shape).astype(np.float32)
    zc, yc = shape[0] // 2, shape[1] // 2
    vol[zc - 1:zc + 2, yc - 1:yc + 2, 2:shape[2] - 2] += 1.0
    vol[2:shape[0] - 2, 1:4, shape[2] // 2:shape[2] // 2 + 3] += 0.7
    return _smooth(torch.from_numpy(vol).to(device), sigma)


def _g(sm):
    return (sm.abs().max() * 0.5).reshape(())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,z_lo,zr,best_z0", [
    ((36, 64, 96), 10, 16, 4),     # block-aligned y/x, interior rows
    ((21, 37, 53), 0, 21, 0),      # ragged y/x, z edge-replicated at ends
    ((30, 19, 170), 5, 20, 3),     # the pipeline's x extent
])
@pytest.mark.parametrize("bright", [True, False])
@pytest.mark.parametrize("sigma", [0.75, 2.0])
def test_kernel_matches_twin(cuda, shape, z_lo, zr, best_z0, bright,
                             sigma):
    sm = _smoothed(shape, sigma, device=cuda)
    g = _g(sm)
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.uniform(0, 0.05, (zr + best_z0 + 2,)
                                        + shape[1:]).astype(np.float32))
    ref, out = init.to(cuda), init.to(cuda)
    frangi_response_plain_(ref, best_z0, sm, z_lo, zr, sigma, g,
                           bright=bright)
    n0 = frangi_response_max_.launches
    frangi_response_max_(out, best_z0, sm, z_lo, zr, sigma, g, bright=bright)
    torch.cuda.synchronize()
    assert frangi_response_max_.launches == n0 + 1
    assert torch.equal(out[:best_z0], init[:best_z0].to(cuda))
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    sm = _smoothed((8, 16, 32), 1.0, device=cuda)
    with pytest.raises(ValueError):
        frangi_response_max_(torch.zeros((4, 16, 32)), 0, sm, 2, 4, 1.0,
                             _g(sm))


def test_cpu_takes_twin_and_counts_no_launch():
    sm = _smoothed((12, 16, 20), 1.0)
    a, b = torch.zeros((6, 16, 20)), torch.zeros((6, 16, 20))
    n0 = frangi_response_max_.launches
    frangi_response_max_(a, 0, sm, 3, 6, 1.0, _g(sm))
    frangi_response_plain_(b, 0, sm, 3, 6, 1.0, _g(sm))
    assert frangi_response_max_.launches == n0
    assert torch.equal(a, b) and float(a.max()) > 0.1


@pytest.mark.parametrize("case", ["dtype", "layout", "yx", "rows", "g"])
def test_wrapper_rejects_bad_arguments(case):
    sm = _smoothed((12, 16, 20), 1.0)
    best = torch.zeros((6, 16, 20))
    g = _g(sm)
    args = dict(best=best, best_z0=0, sm=sm, z_lo=3, zr=6, g=g)
    if case == "dtype":
        args["sm"] = sm.double()
    elif case == "layout":
        args["sm"] = sm.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "yx":
        args["best"] = torch.zeros((6, 16, 21))
    elif case == "rows":
        args["z_lo"] = 8
    else:
        args["g"] = torch.ones(2)
    with pytest.raises(ValueError):
        frangi_response_max_(args["best"], args["best_z0"], args["sm"],
                             args["z_lo"], args["zr"], 1.0, args["g"])
