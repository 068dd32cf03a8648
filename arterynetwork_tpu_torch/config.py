# Copy of arterynetwork_tpu/config.py; its comments describe the port.
"""Typed pipeline configuration.

The reference has no config system: constants are hard-coded at use sites
(spacing fluidSimulation.py:67, thresholds generateVesselVolume.py:186-199,
inlet conditions :565-567) and behavior switches are integer ``option=N``
arguments.  Here every stage reads one typed config object; the reference
values are the defaults, with SURVEY.md file:line provenance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

from .constants import DEFAULT_SPACING, INLET_FLOW, INLET_PRESSURE


@dataclasses.dataclass
class VesselnessConfig:
    """Frangi filter (replaces the reference's external SlicerVMTK step,
    README.md:37-65)."""
    # add a 0.75 scale when radius-1 tips matter: the JAX package's
    # phantom study (TIPRECALL_r05.jsonl) recovered more thin tips with
    # it at held centerline precision.  In the port each scale adds one
    # gamma pass and one K1 launch per slab of the streamed driver.
    sigmas: Tuple[float, ...] = (1.0, 2.0, 3.0)
    alpha: float = 0.5
    beta: float = 0.5
    gamma: Optional[float] = None
    bright: bool = True
    # raw-volume wire format to the accelerator: "u12" (packed 12-bit
    # fixed point, full MRA acquisition precision at 1.5 B/voxel),
    # "u8", "bq4"/"bq3"/"bq2" (row-adaptive 4/3/2-bit: per-(z,y)-row
    # min/scale sideband at 0.5/0.375/0.25 B/voxel — a row's
    # quantization step is its own range/(2^bits-1), so flat rows are
    # near-exact; bq4's step stays below image noise on MRA-like data,
    # and on the bench phantom even bq2 measures fidelity-neutral
    # across seeds because the Frangi smoothing absorbs it — verify on
    # your own acquisitions before dropping below bq4), or "f16"
    # (utils/transfer.upload_quantized)
    upload_format: str = "u12"
    # the JAX package's switch between its fused Pallas response kernel
    # and its XLA apply path.  The port keeps the field so that a JAX
    # configuration converts, and does not read it: its slab drivers
    # always fold the response (Hessian + eigenvalues + tubularity from
    # the smoothed field) through K1 (ops/vesselness_fused.py) on a CUDA
    # device, and through K1's plain PyTorch twin on the CPU.
    fused_response: Union[bool, str] = "auto"
    # Occupancy-skipped upload for the bq formats: (z,y)-row chunks whose
    # intensity range is below 25% of the slab range (pure background on
    # MRA-like data — vessel contrast >> noise) ship no payload bytes and
    # dequantize to their row midpoint; kept chunks decode bit-exactly
    # (one index_copy_, ops/vesselness._upload_slab_bq_sparse).  Most
    # rows of the bench phantoms are background, so this cuts the bytes
    # the upload sends by the skipped share.  The JAX package's phantom
    # study (UPLOADSKIP_r05.jsonl) found every tree metric equal with
    # and without it.  Flip off for acquisitions where sub-noise
    # background detail matters.
    upload_skip: bool = True


@dataclasses.dataclass
class SegmentationConfig:
    """Mask generation + region growing (C2/C3)."""
    boundary_distance_voxels: float = 10.0   # generateVesselVolume.py:188
    near_boundary_fraction: float = 0.8      # :188
    global_threshold_fraction: float = 0.7   # :190
    min_component_size: int = 150            # :198
    # Hysteresis mask (when set): weak floor at this fraction of the
    # vesselness range; components of the weak mask are kept only when
    # they contain a voxel above ``global_threshold_fraction`` (the
    # strong seeds).  The capability analog of the reference's strong
    # threshold + variational growing (generateVesselVolume.py:186-199 +
    # variationalRegionGrowing.py:10): the low floor keeps thin vessels
    # connected, strong seeds reject isolated noise.  None = plain
    # single-threshold mask (exact reference semantics).
    weak_threshold_fraction: Optional[float] = None
    # Axial tip extension (thin-tip recall): before component
    # selection, grow the weak mask into voxels above this (lower)
    # fraction of the vesselness range, but only where the candidate
    # touches <= tip_neighbor_max mask voxels (an axial continuation
    # beyond a tube end, not a lateral halo), for tip_iters steps.
    # None = off.  See pipeline._tip_extended_weak.
    tip_fraction: Optional[float] = None
    tip_iters: int = 3
    tip_neighbor_max: int = 4
    # Zero the response within this many voxels of the volume faces:
    # the filter's boundary band is unreliable (the reference suppresses
    # near-boundary responses the same way via the brain-mask distance,
    # generateVesselVolume.py:186-191).  0 = off.
    border_margin_voxels: int = 0
    H: float = 2.25                          # variationalRegionGrowing.py:10
    max_segment_size: int = 5000             # :10
    iter_max: int = 200                      # :56
    time_cap_s: Optional[float] = 120.0      # :97 (host-loop option)
    num_bins: int = 256


@dataclasses.dataclass
class SkeletonConfig:
    """Thinning + segment extraction (C4/C5)."""
    max_waves: int = 64
    preserve_endpoints: bool = True
    prune_min_length: int = 2   # manualCorrectionGUIDetail.py:1571 (2-voxel)
    backend: str = "auto"       # "jax" | "native" | "auto"
    # Skeleton-graph simplification (graphs/segments.simplify_chains).
    # The reference leaves these artifacts to the manual-correction GUI
    # (checkCycle + human edits, manualCorrectionGUIDetail.py:642-684);
    # the automated pipeline cleans them structurally:
    #   collapse_junctions  — contract 26-adjacent clusters of junction
    #                         voxels to their most-interior member
    #   prune_radius_factor — drop terminal branches shorter than
    #                         factor * junction radius (thinning spurs)
    #   cycle_tight_ratio   — cut cycles with total length <= ratio *
    #                         max arc radius (intra-vessel meshes); long
    #                         loops (e.g. Circle of Willis) are kept
    #   bridge_max_len      — junction audit: cut junction-junction
    #                         arcs <= this many voxels whose removal
    #                         keeps the endpoints connected (same-branch
    #                         thinning loops, kissing-vessel merges);
    #                         the automated remove+merge edit.  0 = off;
    #                         true short collaterals cut by it are
    #                         restorable with graphs/editing.py, as the
    #                         reference resolves these manually
    simplify: bool = True       # master switch for the passes below
    collapse_junctions: bool = True
    prune_radius_factor: float = 2.5
    cycle_tight_ratio: float = 16.0
    simplify_rounds: int = 3
    bridge_max_len: int = 13


@dataclasses.dataclass
class FlowConfig:
    """Network solve (C13-C18)."""
    spacing: float = DEFAULT_SPACING         # fluidSimulation.py:67
    inlet_pressure: float = INLET_PRESSURE   # :565
    inlet_flow: float = INLET_FLOW           # :567
    hw_k: float = 1.852
    max_iter: int = 60
    tol: float = 1e-14
    # multi-start escape when the primary solve stalls above tol (the
    # reference's basinhopping robustness slot); free when converged
    restarts: int = 2
    linear_solver: str = "dense"             # "dense" | "cg"
    dtype: str = "float64"                   # "float32" on TPU
    # "soa": segments+attrs -> FlowNetwork directly (graphs/soa_path.py);
    # "nx": via the voxel-level networkx graph (needed for graphml
    # artifacts / editing; always used when a store is given for those)
    graph_path: str = "soa"


@dataclasses.dataclass
class PartitionConfig:
    """Compartment topology (C9/C20).  The reference hard-codes the CoW
    ids at >=6 call sites (fluidSimulation.py:822-823 etc.)."""
    partitions: Dict[str, dict] = dataclasses.field(
        default_factory=lambda: {
            "LMCA": {"start_nodes": [4], "boundary_nodes": [10]},
            "RMCA": {"start_nodes": [5], "boundary_nodes": [10]},
            "LPCA": {"start_nodes": [6], "boundary_nodes": []},
            "RPCA": {"start_nodes": [7], "boundary_nodes": []},
            "ACA": {"start_nodes": [10], "boundary_nodes": []},
        })


@dataclasses.dataclass
class PipelineConfig:
    vesselness: VesselnessConfig = dataclasses.field(
        default_factory=VesselnessConfig)
    segmentation: SegmentationConfig = dataclasses.field(
        default_factory=SegmentationConfig)
    skeleton: SkeletonConfig = dataclasses.field(
        default_factory=SkeletonConfig)
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    partition: PartitionConfig = dataclasses.field(
        default_factory=PartitionConfig)
