"""isaac_ros_apriltag_tpu_torch — the AprilTag detector in PyTorch + CUDA.

A port of ``isaac_ros_apriltag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The detector runs end to end on one frame (``Detector``, with
``detect_checked`` for its output invariants) or on a batch
(``pipeline.batched_detect_fn``), behind the rectify -> resize graph
(``pipeline.GraphPipeline``), over a multi-camera rig with shared or
per-camera intrinsics (``RigDetector``, one batched call on one card), over a
timestamp-aligned set of camera streams (``TimestampAligner``) and over a
stream of host frames with uploads overlapped with compute
(``StreamingRunner``); ``python -m isaac_ros_apriltag_tpu_torch detect|bench``
is its command line. Its three hot kernels (adaptive threshold and the two
CCL scan kernels) are hand-written CUDA in ``csrc/``, built with nvcc at
first use. Backend 'torch' runs plain PyTorch twins of those kernels on any
device. This package never imports jax.
"""

from .camera.model import CameraModel
from .config import BACKENDS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .parallel.rig import RigDetector
from .pipeline import GraphPipeline, batched_detect_fn
from .streaming import StreamingRunner, run_stream
from .sync import TimestampAligner
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "CameraModel", "Detections", "Detector", "DetectorConfig",
    "FrameStats", "GraphPipeline", "RigDetector", "StreamingRunner", "TagFamily",
    "TimestampAligner", "batched_detect_fn", "build_detect_fn", "family_names",
    "get_family", "register_family", "run_stream", "__version__",
]
