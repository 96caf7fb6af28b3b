"""Camera model: pinhole intrinsics + plumb_bob distortion + rectify maps.

The port's counterpart of ``isaac_ros_apriltag_tpu/camera/model.py``. K and
the distortion coefficients are float32 tensors; width and height are plain
ints. The rectification map is computed once, in numpy, exactly as the
reference computes it; the per-frame remap is in ops/remap.py.
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

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Apply plumb_bob distortion to normalized coords (..., 2)."""
        k1, k2, p1, p2, k3 = [self.dist[i] for i in range(5)]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], -1)

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        """Project camera-frame 3D points (..., 3) to pixels (..., 2)."""
        xy = pts_cam[..., :2] / pts_cam[..., 2:3]
        xyd = self.distort_normalized(xy)
        return torch.stack([self.fx * xyd[..., 0] + self.cx,
                            self.fy * xyd[..., 1] + self.cy], -1)

    def rectify_map(self, scale: float = 1.0) -> np.ndarray:
        """Precompute the undistortion remap grid.

        Returns (H', W', 2) float32 of source pixel coords (x, y) for every
        rectified output pixel, where (H', W') = scale * (height, width).
        Rectified pixels reuse this camera's K (scaled); forward distortion
        is applied per output pixel (the initUndistortRectifyMap recipe), in
        numpy f64, once at setup.
        """
        H = int(round(self.height * scale))
        W = int(round(self.width * scale))
        K = self.K.detach().cpu().numpy().astype(np.float64)
        fx, fy = K[0, 0] * scale, K[1, 1] * scale
        cx, cy = K[0, 2] * scale, K[1, 2] * scale
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        x = (u - cx) / fx
        y = (v - cy) / fy
        k1, k2, p1, p2, k3 = self.dist.detach().cpu().numpy().astype(np.float64)
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        src_u = K[0, 0] * xd + K[0, 2]
        src_v = K[1, 1] * yd + K[1, 2]
        return np.stack([src_u, src_v], -1).astype(np.float32)

    def scaled(self, scale: float) -> "CameraModel":
        """Camera for a resized image (intrinsics scaled, distortion kept)."""
        K = self.K * torch.tensor([[scale], [scale], [1.0]], dtype=torch.float32,
                                  device=self.K.device)
        return CameraModel(K=K, dist=self.dist,
                           width=int(round(self.width * scale)),
                           height=int(round(self.height * scale)))
