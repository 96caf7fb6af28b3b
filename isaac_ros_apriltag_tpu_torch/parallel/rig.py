"""Multi-camera rig detection on one device.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/rig.py``. The reference
shards a rig's frames over a device mesh and vmaps the detector; on one card
the rig is one batched detect call over the (n_cameras, H, W) frames, so a
16-camera rig makes the kernel launches of one frame (K1 once, K2 and K3
once per scan round). Cameras may share intrinsics (one `camera`) or carry
their own (`cameras`): corners are image-space measurements, so only the
pose stage needs a camera's K, and a per-camera rig skips the shared-K pose
and poses every camera's corners with its own K in one batched call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera.model import CameraModel
from ..config import DetectorConfig
from ..detector import build_batched_detect_fn, device_for, to_device
from ..ops.pose import estimate_poses
from ..types import Detections, FrameStats


class RigDetector:
    """Detect over a batch of frames, one per camera, on `device` (default:
    the card; pass device='cpu' to run backend 'torch' on the CPU). Frame
    geometry (H, W) is the same for every camera."""

    def __init__(self, config: DetectorConfig, camera: CameraModel, n_cameras: int,
                 device: torch.device | str | None = None, encoding: str = "mono8",
                 cameras: list[CameraModel] | None = None):
        self.config = config
        self.n_cameras = int(n_cameras)
        if cameras is not None and len(cameras) != self.n_cameras:
            raise ValueError(f"{len(cameras)} cameras for {self.n_cameras}-camera rig")
        self.device = device_for(config, device)
        self.camera = camera.to(self.device)
        self._fn = build_batched_detect_fn(config, self.camera, encoding,
                                           with_pose=cameras is None)
        # (n, 3, 3) per-camera intrinsics, or None for a shared K.
        self._K = (None if cameras is None
                   else torch.stack([c.K.to(self.device, torch.float32) for c in cameras]))

    def detect(self, frames) -> tuple[Detections, FrameStats]:
        """frames: (n_cameras, H, W) uint8 (mono) or (..., C) per encoding, a
        numpy array or a tensor. Returns results with a leading n_cameras."""
        frames = to_device(frames, self.device)
        if frames.shape[0] != self.n_cameras:
            raise ValueError(f"{frames.shape[0]} frames for {self.n_cameras}-camera rig")
        det, stats = self._fn(frames)
        if self._K is not None:
            poses = estimate_poses(det.corners, self._K, self.config.tag_size)
            det = dataclasses.replace(det, translation=poses.translation,
                                      quaternion=poses.quaternion, rotation=poses.rotation)
        return det, stats
