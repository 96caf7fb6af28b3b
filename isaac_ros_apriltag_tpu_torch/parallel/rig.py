"""Multi-camera rig detection, on one device or split over a process group.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/rig.py``. The reference
shards a rig's frames over the 'cam' axis of a device mesh and vmaps the
detector; here each device runs one batched detect call over its cameras'
(n, H, W) frames, so a 16-camera rig on one card makes the kernel launches
of one frame (K1 once, K2 and K3 once per scan round). With a
``torch.distributed`` group (``parallel/mesh.py``: ``make_mesh(n_cam,
n_map).get_group("cam")``) rank r of the group takes the r-th block of
n / size cameras, the block layout of the reference's ``P("cam")``, and the
ranks' results are all-gathered so that every rank holds the whole rig's,
in camera order, as the reference's output is the whole global array.
Cameras may share intrinsics (one `camera`) or carry their own (`cameras`):
corners are image-space measurements, so only the pose stage needs a
camera's K, and a per-camera rig skips the shared-K pose and poses every
camera's corners with its own K in one batched call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..camera.model import CameraModel
from ..config import DetectorConfig
from ..detector import build_batched_detect_fn, device_for, to_device
from ..ops.cuda import pose as pose_kernel
from ..ops.pose import estimate_poses
from ..types import Detections, FrameStats
from . import mesh


class RigDetector:
    """Detect over a batch of frames, one per camera, on `device` (default:
    the card; pass device='cpu' to run backend 'torch' on the CPU). Frame
    geometry (H, W) is the same for every camera.

    group: None (every camera on this device) or a torch.distributed group
    whose size divides n_cameras; each rank then detects its own block of
    cameras and returns, like every other rank, the whole rig's results."""

    def __init__(self, config: DetectorConfig, camera: CameraModel, n_cameras: int,
                 device: torch.device | str | None = None, encoding: str = "mono8",
                 cameras: list[CameraModel] | None = None, group=None):
        self.config = config
        self.n_cameras = int(n_cameras)
        if cameras is not None and len(cameras) != self.n_cameras:
            raise ValueError(f"{len(cameras)} cameras for {self.n_cameras}-camera rig")
        self.group = group
        size = 1 if group is None else dist.get_world_size(group)
        if self.n_cameras % size:
            raise ValueError(f"a {self.n_cameras}-camera rig does not split over the "
                             f"{size} ranks of the group")
        n_local = self.n_cameras // size
        rank = 0 if group is None else dist.get_rank(group)
        # This rank's cameras: [lo, hi).
        self._lo, self._hi = rank * n_local, (rank + 1) * n_local
        self.device = device_for(config, device)
        self.camera = camera.to(self.device)
        self._fn = build_batched_detect_fn(config, self.camera, encoding,
                                           with_pose=cameras is None)
        # (n_local, 3, 3) intrinsics of this rank's cameras, or None for a shared K.
        self._K = (None if cameras is None
                   else torch.stack([c.K.to(self.device, torch.float32)
                                     for c in cameras[self._lo:self._hi]]))

    def detect(self, frames) -> tuple[Detections, FrameStats]:
        """frames: the whole rig's (n_cameras, H, W) uint8 (mono) or (..., C)
        per encoding, a numpy array or a tensor. Returns results with a
        leading n_cameras, in camera order."""
        if frames.shape[0] != self.n_cameras:
            raise ValueError(f"{frames.shape[0]} frames for {self.n_cameras}-camera rig")
        det, stats = self._fn(to_device(frames[self._lo:self._hi], self.device))
        if self._K is not None:
            pose = (pose_kernel.estimate_poses if self.config.backend == "cuda"
                    else estimate_poses)
            poses = pose(det.corners, self._K, self.config.tag_size)
            det = dataclasses.replace(det, translation=poses.translation,
                                      quaternion=poses.quaternion, rotation=poses.rotation)
        if self.group is not None:
            det, stats = _all_gather(det, self.group), _all_gather(stats, self.group)
        return det, stats


def _all_gather(result, group):
    """Every rank's `result` (Detections or FrameStats, each field with a
    leading n_local) as one with a leading size * n_local, in rank order.
    The fields travel as the bytes of one (n_local, bytes) uint8 tensor, so
    the rig makes one collective for each and bool needs no backend support."""
    fields = [getattr(result, f.name) for f in dataclasses.fields(result)]
    n_local = fields[0].shape[0]
    packed = torch.cat([t.contiguous().view(torch.uint8).reshape(n_local, -1)
                        for t in fields], 1)
    gathered = mesh.all_gather_bands(packed, group)
    out, at = {}, 0
    for f, t in zip(dataclasses.fields(result), fields):
        nbytes = t[:1].numel() * t.element_size()
        out[f.name] = (gathered[:, at:at + nbytes].contiguous().view(t.dtype)
                       .reshape(-1, *t.shape[1:]))
        at += nbytes
    return dataclasses.replace(result, **out)
