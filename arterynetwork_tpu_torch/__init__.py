"""arterynetwork_tpu_torch — the raw-MRA -> flow pipeline in PyTorch.

The PyTorch and CUDA counterpart of the JAX package that sits beside it,
for NVIDIA Hopper cards.  It mirrors the JAX package's layout and names,
so each module's counterpart is easy to find, and imports neither JAX nor
the JAX package: the numpy host modules it needs are carried as copies.

Subpackages
-----------
ops     vesselness (with the hand-written CUDA Frangi-response kernel),
        the native C++ voxel kernels (ctypes)
graphs  segments, branch attributes, the struct-of-arrays flow network
flow    Hazen-Williams physics, assembly, tree elimination, Newton solver
utils   packed-bit mask transfer, synthetic phantoms

Entry point: ``pipeline.run_pipeline(raw_volume=..., device="cuda")``.
"""

__version__ = "0.1.0"
