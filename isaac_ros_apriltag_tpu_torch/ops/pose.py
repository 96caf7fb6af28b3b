"""6-DoF tag pose from corners + intrinsics (batched homography decomposition).

Counterpart of ``isaac_ros_apriltag_tpu/ops/pose.py``: a 4-point homography
from the tag plane to the corners, K^-1 normalization, and a Newton polar
projection onto SO(3). Detection corner k is tag-frame point TAG_CORNERS[k]
* tag_size/2; a fronto-parallel upright tag gives R = diag(-1, -1, 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.geometry import (homography_from_correspondences, inverse3x3,
                              orthonormalize_rotation, quat_from_rotmat)
from ..utils.render import TAG_CORNERS


class Poses(NamedTuple):
    rotation: torch.Tensor      # (..., C, 3, 3) R_camera_tag
    translation: torch.Tensor   # (C, 3) meters
    quaternion: torch.Tensor    # (C, 4) (w, x, y, z)


def estimate_poses(corners: torch.Tensor, K: torch.Tensor, tag_size: float) -> Poses:
    """corners: (..., C, 4, 2) rotation-corrected detection corners
    (pixels); one K for all of them."""
    obj = torch.as_tensor(TAG_CORNERS, device=corners.device) * (tag_size * 0.5)
    H = homography_from_correspondences(obj.expand(corners.shape), corners)
    Kinv = inverse3x3(K.to(torch.float32))
    M = torch.einsum("ij,...jk->...ik", Kinv, H)
    m1, m2, m3 = M[..., 0], M[..., 1], M[..., 2]
    n1 = torch.linalg.vector_norm(m1, dim=-1)
    n2 = torch.linalg.vector_norm(m2, dim=-1)
    scale = 2.0 / torch.clamp(n1 + n2, min=1e-12)
    scale = scale * torch.sign(m3[..., 2])     # positive depth
    r1 = m1 * scale[..., None]
    r2 = m2 * scale[..., None]
    t = m3 * scale[..., None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = orthonormalize_rotation(torch.stack([r1, r2, r3], -1))
    return Poses(rotation=R, translation=t, quaternion=quat_from_rotmat(R))
