"""Composable perception pipeline: rectify -> resize -> detect, batched.

Counterpart of ``isaac_ros_apriltag_tpu/pipeline.py``: the reference's
launch-file node graph (camera -> RectifyNode -> ResizeNode -> AprilTagNode)
as one function of a batch of frames. ``batched_detect_fn`` is the
counterpart of ``jax.vmap`` of the detect function, and
``GraphPipeline.batched`` that of ``jax.vmap(gp.fn_with_plan)``: a leading
batch dimension runs through every stage, and the rectify map or plan is
shared by the batch.
"""

from __future__ import annotations

import torch

from .camera.model import CameraModel
from .config import DetectorConfig
from .detector import build_batched_detect_fn, device_for, to_device
from .ops.grayscale import grayscale
from .ops.remap import SeparableRectify, remap_bilinear, resize_area
from .types import Detections, FrameStats


def batched_detect_fn(config: DetectorConfig, camera: CameraModel,
                      encoding: str = "mono8"):
    """Detect over a leading batch axis: (B, H, W[, C]) frames on the
    camera's device -> (Detections, FrameStats) with a leading B."""
    return build_batched_detect_fn(config, camera, encoding)


class GraphPipeline:
    """rectify (undistort) -> optional integer downscale -> detect.

    Rectification uses the banded separable warp by default
    (ops/remap.py::SeparableRectify); `exact_remap=True` takes the gather
    form (`remap_bilinear`) instead. A camera without distortion is not
    rectified. Detection runs on `detect_camera`, the camera scaled by
    1/downscale. Backend 'cuda' needs a CUDA device and raises otherwise.
    """

    def __init__(self, config: DetectorConfig, camera: CameraModel,
                 downscale: int = 1, encoding: str = "rgb8",
                 exact_remap: bool = False, device: torch.device | str | None = None):
        self.config = config
        self.device = device_for(config, device)
        self.camera = camera.to(self.device)
        self.downscale = int(downscale)
        self.encoding = encoding
        self._grid = None
        self._rectify = None
        if camera.has_distortion():
            grid = camera.rectify_map()
            if exact_remap:
                self._grid = torch.from_numpy(grid).to(self.device)
            else:
                self._rectify = SeparableRectify.from_grid(grid).to(self.device)
        self.detect_camera = (self.camera.scaled(1.0 / self.downscale)
                              if self.downscale > 1 else self.camera)
        self._detect = build_batched_detect_fn(config, self.detect_camera, "mono8")

    def batched(self, images) -> tuple[Detections, FrameStats]:
        """(B, H, W[, C]) frames -> (Detections, FrameStats) with a leading B."""
        gray = grayscale(to_device(images, self.device), self.encoding, batched=True)
        if self._rectify is not None:
            gray = self._rectify(gray)
        elif self._grid is not None:
            gray = remap_bilinear(gray, self._grid)
        if self.downscale > 1:
            gray = resize_area(gray, self.downscale)
        return self._detect(gray.to(torch.float32).contiguous())

    def __call__(self, image) -> tuple[Detections, FrameStats]:
        """One (H, W[, C]) frame -> its Detections and FrameStats."""
        det, stats = self.batched(to_device(image, self.device)[None])
        return det.frame(0), stats.frame(0)
