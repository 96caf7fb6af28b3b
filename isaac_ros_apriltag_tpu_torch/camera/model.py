"""Camera model: pinhole intrinsics + plumb_bob distortion coefficients.

The port's counterpart of ``isaac_ros_apriltag_tpu/camera/model.py``. K and
the distortion coefficients are float32 tensors; width and height are plain
ints. The rectify map and ``scaled`` are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Pinhole camera. K: (3, 3); dist: (5,) = (k1, k2, p1, p2, k3)."""

    K: torch.Tensor
    dist: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, width, height, dist=None) -> "CameraModel":
        K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                         dtype=torch.float32)
        d = (torch.zeros(5, dtype=torch.float32) if dist is None
             else torch.as_tensor(np.asarray(dist, np.float32)))
        return CameraModel(K=K, dist=d, width=int(width), height=int(height))

    @staticmethod
    def from_camera_info(info: dict) -> "CameraModel":
        """Build from a ROS CameraInfo-style dict (keys: K or k, D or d,
        width, height)."""
        K = np.asarray(info.get("K", info.get("k")), np.float32).reshape(3, 3)
        D = np.asarray(info.get("D", info.get("d", [0.0] * 5)), np.float32)
        D = np.pad(D, (0, max(0, 5 - D.size)))[:5]
        return CameraModel(K=torch.from_numpy(K.copy()), dist=torch.from_numpy(D.copy()),
                           width=int(info["width"]), height=int(info["height"]))

    def to(self, device) -> "CameraModel":
        return dataclasses.replace(self, K=self.K.to(device), dist=self.dist.to(device))

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    def has_distortion(self) -> bool:
        return bool((self.dist != 0.0).any())
