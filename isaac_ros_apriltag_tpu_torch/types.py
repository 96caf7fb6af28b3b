"""Result containers: fixed-capacity detection tensors.

Same fields and conventions as ``isaac_ros_apriltag_tpu/types.py``: every
tensor has a leading dim of max_tags and ``valid`` masks the real rows.
Corner k corresponds to tag-frame point ((-,-), (+,-), (+,+), (-,+)) *
tag_size/2; pose is T_camera_tag with quaternion (w, x, y, z).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Detections:
    """Fixed-capacity detections for one frame (leading dim max_tags)."""

    valid: torch.Tensor            # (T,) bool
    id: torch.Tensor               # (T,) int32
    hamming: torch.Tensor          # (T,) int32 — bit errors corrected
    decision_margin: torch.Tensor  # (T,) float32 — decode confidence
    center: torch.Tensor           # (T, 2) float32 pixels (x, y)
    corners: torch.Tensor          # (T, 4, 2) float32 pixels
    translation: torch.Tensor      # (T, 3) float32 meters, camera frame
    quaternion: torch.Tensor       # (T, 4) float32 (w, x, y, z)
    rotation: torch.Tensor         # (T, 3, 3) float32 R_camera_tag

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()

    @staticmethod
    def empty(max_tags: int, device: torch.device | str = "cpu") -> "Detections":
        T = max_tags
        f32 = dict(dtype=torch.float32, device=device)
        return Detections(
            valid=torch.zeros((T,), dtype=torch.bool, device=device),
            id=torch.full((T,), -1, dtype=torch.int32, device=device),
            hamming=torch.zeros((T,), dtype=torch.int32, device=device),
            decision_margin=torch.zeros((T,), **f32),
            center=torch.zeros((T, 2), **f32),
            corners=torch.zeros((T, 4, 2), **f32),
            translation=torch.zeros((T, 3), **f32),
            quaternion=torch.zeros((T, 4), **f32),
            rotation=torch.eye(3, **f32).expand(T, 3, 3).clone(),
        )

    def frame_ids(self, family: str) -> list[str]:
        """TF child frame names "<family>:<id>" for the valid detections."""
        valid = self.valid.cpu().numpy()
        ids = self.id.cpu().numpy()
        return [f"{family}:{int(ids[i])}" for i in np.nonzero(valid)[0]]

    def to_list(self) -> list[dict]:
        """Host-side: unpack valid rows into python dicts."""
        h = {f.name: getattr(self, f.name).cpu().numpy()
             for f in dataclasses.fields(self)}
        return [dict(id=int(h["id"][i]),
                     hamming=int(h["hamming"][i]),
                     decision_margin=float(h["decision_margin"][i]),
                     center=h["center"][i].tolist(),
                     corners=h["corners"][i].tolist(),
                     translation=h["translation"][i].tolist(),
                     quaternion=h["quaternion"][i].tolist())
                for i in np.nonzero(h["valid"])[0]]


@dataclasses.dataclass(frozen=True)
class FrameStats:
    """Per-frame pipeline statistics (0-dim tensors)."""

    num_edge_points: torch.Tensor   # int32 — boundary points before capacity cap
    num_clusters: torch.Tensor      # int32 — candidate clusters before cap
    num_quads: torch.Tensor         # int32 — quads that passed geometric filters
    num_detections: torch.Tensor    # int32 — final decoded detections
    edge_stride: torch.Tensor       # int32 — boundary decimation applied (1 = none)
    ccl_converged: torch.Tensor     # bool — the last CCL round changed nothing
    overflow: torch.Tensor          # bool — a capacity was exceeded
