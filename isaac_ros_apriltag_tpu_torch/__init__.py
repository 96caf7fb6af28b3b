"""isaac_ros_apriltag_tpu_torch — the AprilTag detector in PyTorch + CUDA.

A port of ``isaac_ros_apriltag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The detector runs end to end on one frame (``Detector``) or on a batch
(``pipeline.batched_detect_fn``), and behind the rectify -> resize graph
(``pipeline.GraphPipeline``); its three hot kernels
(adaptive threshold and the two CCL scan kernels) are hand-written CUDA in
``csrc/``, built with nvcc at first use. Backend 'torch' runs plain PyTorch
twins of those kernels on any device. This package never imports jax.
"""

from .camera.model import CameraModel
from .config import BACKENDS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .pipeline import GraphPipeline, batched_detect_fn
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "CameraModel", "Detections", "Detector", "DetectorConfig",
    "FrameStats", "GraphPipeline", "TagFamily", "batched_detect_fn", "build_detect_fn",
    "family_names", "get_family", "register_family", "__version__",
]
