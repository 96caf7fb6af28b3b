"""isaac_ros_apriltag_tpu_torch — the AprilTag detector in PyTorch + CUDA.

A port of ``isaac_ros_apriltag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The single-frame detector runs end to end; its three hot kernels
(adaptive threshold and the two CCL scan kernels) are hand-written CUDA in
``csrc/``, built with nvcc at first use. Backend 'torch' runs plain PyTorch
twins of those kernels on any device. This package never imports jax.
"""

from .camera.model import CameraModel
from .config import BACKENDS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "CameraModel", "Detections", "Detector", "DetectorConfig",
    "FrameStats", "TagFamily", "build_detect_fn", "family_names",
    "get_family", "register_family", "__version__",
]
