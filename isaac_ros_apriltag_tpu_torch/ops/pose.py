"""6-DoF tag pose from corners + intrinsics (batched homography decomposition).

Counterpart of ``isaac_ros_apriltag_tpu/ops/pose.py``: a 4-point homography
from the tag plane to the corners, K^-1 normalization, and a Newton polar
projection onto SO(3). Detection corner k is tag-frame point TAG_CORNERS[k]
* tag_size/2; a fronto-parallel upright tag gives R = diag(-1, -1, 1).

``estimate_poses`` is the plain version of csrc/tail.cu's pose_kernel, bit
for bit: every float step is elementwise and in the kernel's order (the
homography's explicit elimination, K^-1 H, the column norms and the
quaternion of utils/geometry.py written out; no einsum or vector_norm).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.geometry import (homography_from_correspondences, inverse3x3, matmul3,
                              orthonormalize_rotation, quat_from_rotmat)
from ..utils.render import TAG_CORNERS


class Poses(NamedTuple):
    rotation: torch.Tensor      # (..., C, 3, 3) R_camera_tag
    translation: torch.Tensor   # (C, 3) meters
    quaternion: torch.Tensor    # (C, 4) (w, x, y, z)


@functools.lru_cache(maxsize=None)
def _tag_corners(device: torch.device) -> torch.Tensor:
    """TAG_CORNERS on `device`, uploaded once: a copy from numpy memory at
    every call would make the host wait for the device's queue."""
    return torch.as_tensor(TAG_CORNERS, device=device)


def estimate_poses(corners: torch.Tensor, K: torch.Tensor, tag_size: float) -> Poses:
    """corners: (..., C, 4, 2) rotation-corrected detection corners
    (pixels). K: (3, 3), one for all of them, or (B, 3, 3), one per frame of
    corners (B, C, 4, 2) (a rig whose cameras have their own intrinsics)."""
    obj = _tag_corners(corners.device) * (tag_size * 0.5)
    H = homography_from_correspondences(obj.expand(corners.shape), corners)
    Kinv = inverse3x3(K.to(torch.float32))
    if K.ndim == 3:
        Kinv = Kinv.reshape(Kinv.shape[0], *[1] * (H.ndim - 3), 3, 3)
    M = matmul3(Kinv, H)
    m1, m2, m3 = M[..., 0], M[..., 1], M[..., 2]
    scale = torch.reciprocal(torch.clamp(_norm3(m1) + _norm3(m2), min=1e-12)) * 2.0
    z = m3[..., 2]
    scale = scale * ((z > 0).to(torch.float32) - (z < 0).to(torch.float32))  # positive depth
    r1 = m1 * scale[..., None]
    r2 = m2 * scale[..., None]
    t = m3 * scale[..., None]
    r3 = torch.stack([r1[..., 1] * r2[..., 2] - r1[..., 2] * r2[..., 1],
                      r1[..., 2] * r2[..., 0] - r1[..., 0] * r2[..., 2],
                      r1[..., 0] * r2[..., 1] - r1[..., 1] * r2[..., 0]], -1)
    R = orthonormalize_rotation(torch.stack([r1, r2, r3], -1))
    return Poses(rotation=R, translation=t, quaternion=quat_from_rotmat(R))


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of (..., 3) vectors, summed in index order."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])
