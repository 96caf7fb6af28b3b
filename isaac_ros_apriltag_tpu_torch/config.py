"""Detector configuration + backend registry + eager validation.

The same fields, defaults and constructor-time checks as
``isaac_ros_apriltag_tpu/config.py``, so a configuration carries across the
two packages field for field (see ``convert.config_from_reference``), plus
``ccl_flow``: the reference picks its CCL flow by backend ('xla' runs the
single-phase flow with jumps), the port by this field, since its backends
only choose kernels or their twins.

Backends (mirroring the reference package's ``xla|pallas|interpret``):
  - 'cuda'  the hand-written Hopper kernels on the hot stages (threshold and
            the CCL scan rounds); needs a CUDA device and raises otherwise.
  - 'torch' plain PyTorch twins of those kernels, on any device.
"""

from __future__ import annotations

import dataclasses

from .models.families import FAMILY_SPECS, family_names

BACKENDS = ("torch", "cuda")
CCL_FLOWS = ("scan", "jumps")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static detector parameters (field meanings as in the JAX package)."""

    tag_family: str = "tag36h11"
    max_tags: int = 64
    tag_size: float = 0.22          # edge length of the border square, meters
    tile_size: int = 4              # adaptive-threshold tile edge, pixels
    backend: str = "cuda"

    quad_decimate: int = 2          # segmentation runs on the d x d pooled image

    max_edge_points: int = 1 << 19   # cap on compacted boundary points
    max_clusters: int = 128          # candidate boundary clusters kept
    max_cluster_points: int = 1024   # points retained per cluster
    # Which CCL flow the detector runs:
    #   'scan'  the two-phase scan flow (or with ccl_phase2_rounds=0 one scan
    #           phase and the flat-label resolve), the reference's
    #           pallas|interpret flow;
    #   'jumps' the single-phase flow with pointer jumps, the reference's
    #           'xla' oracle: ccl_rounds scan rounds with ccl_jumps jumps
    #           every ccl_jump_every rounds, then the flat-label resolve.
    ccl_flow: str = "scan"
    # The 'jumps' flow. ccl_rounds is also the scan rounds of each outer
    # round of the row-sharded front (parallel/spatial.py), which never jumps.
    ccl_rounds: int = 8
    ccl_jumps: int = 2
    ccl_jump_every: int = 4
    # The 'scan' flow: phase-1 rounds, rank-space chain contraction,
    # phase-2 rounds; then the final resolve (ops/resolve.py).
    ccl_scan_rounds: int = 8
    ccl_phase2_rounds: int = 6       # 0 = no contraction / second phase
    ccl_contraction_steps: int = 5
    ccl_resolve_steps: int = 3
    max_components: int = 1 << 16    # distinct-label capacity in resolve

    min_white_black_diff: int = 5
    min_cluster_pixels: int = 24
    min_component_pixels: int = 25

    max_hamming: int = 2
    decode_sharpening: float = 0.25
    min_decision_margin: float = 10.0

    def effective_capacities(self, seg_h: int, seg_w: int) -> tuple[int, int]:
        """(edge_points, components) for a seg_h x seg_w segmentation image:
        3/4 boundary pairs and 1/8 distinct labels per pixel, capped by the
        config fields."""
        hw = seg_h * seg_w
        return (min(self.max_edge_points, max((3 * hw) // 4, 1024)),
                min(self.max_components, max(hw // 8, 256)))

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"Invalid backend {self.backend!r}; expected one of {BACKENDS}")
        if self.tag_family not in FAMILY_SPECS:
            raise ValueError(
                f"Invalid tag family {self.tag_family!r}; expected one of {family_names()}")
        if self.max_tags <= 0 or self.max_tags > self.max_clusters:
            raise ValueError("max_tags must be in (0, max_clusters]")
        if self.max_clusters > 128:
            raise ValueError("max_clusters must be <= 128 "
                             "(8-bit slot packing in the cluster broadcast)")
        if self.tile_size < 2:
            raise ValueError("tile_size must be >= 2")
        if self.tile_size not in (2, 4, 8, 16, 32):
            raise ValueError(
                f"tile_size={self.tile_size} unsupported by the {self.backend!r} "
                "backend (threshold kernel requires tile_size in {2,4,8,16,32})")
        if self.quad_decimate < 1:
            raise ValueError("quad_decimate must be >= 1")
        if self.ccl_jump_every < 1:
            raise ValueError("ccl_jump_every must be >= 1")
        if self.ccl_scan_rounds < 1:
            raise ValueError("ccl_scan_rounds must be >= 1")
        if self.ccl_phase2_rounds < 0:
            raise ValueError("ccl_phase2_rounds must be >= 0")
        if self.ccl_resolve_steps < 1:
            raise ValueError("ccl_resolve_steps must be >= 1")
        if self.max_components < 1:
            raise ValueError("max_components must be >= 1")
        if self.max_components > (1 << 16):
            raise ValueError("max_components must be <= 65536 "
                             "(resolve packs group ranks into 16 bits)")
        if self.ccl_rounds < 1:
            raise ValueError("ccl_rounds must be >= 1")
        if self.ccl_flow not in CCL_FLOWS:
            raise ValueError(f"Invalid ccl_flow {self.ccl_flow!r}; expected one of {CCL_FLOWS}")
        if self.ccl_jumps < 0:
            raise ValueError("ccl_jumps must be >= 0")
        fam_h = FAMILY_SPECS[self.tag_family][1]
        if self.max_hamming > (fam_h - 1) // 2:
            raise ValueError(
                f"max_hamming={self.max_hamming} too large for {self.tag_family} "
                f"(min distance {fam_h})")
