"""isaac_ros_apriltag_tpu_torch — the AprilTag detector in PyTorch + CUDA.

A port of ``isaac_ros_apriltag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The detector runs end to end on one frame (``Detector``, with
``detect_checked`` for its output invariants) or on a batch
(``pipeline.batched_detect_fn``), behind the rectify -> resize graph
(``pipeline.GraphPipeline``), over a multi-camera rig with shared or
per-camera intrinsics (``RigDetector``, one batched call on one card), over a
timestamp-aligned set of camera streams (``TimestampAligner``), over a
stream of host frames with uploads overlapped with compute
(``StreamingRunner``), and on one large frame cut into bands of rows
(``SpatialDetector``: the bands as a batch on one card, or one band on each
rank of a ``torch.distributed`` group, see ``make_mesh``);
``python -m isaac_ros_apriltag_tpu_torch detect|bench``
is its command line. Its three hot kernels (adaptive threshold and the two
CCL scan kernels) are hand-written CUDA in ``csrc/``, built with nvcc at
first use. Backend 'torch' runs plain PyTorch twins of those kernels on any
device. This package never imports jax.
"""

from .camera.model import CameraModel
from .config import BACKENDS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .parallel.mesh import make_mesh
from .parallel.rig import RigDetector
from .parallel.spatial import SpatialDetector, build_spatial_front_fn
from .pipeline import GraphPipeline, batched_detect_fn
from .streaming import StreamingRunner, run_stream
from .sync import TimestampAligner
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "CameraModel", "Detections", "Detector", "DetectorConfig",
    "FrameStats", "GraphPipeline", "RigDetector", "SpatialDetector", "StreamingRunner",
    "TagFamily", "TimestampAligner", "batched_detect_fn", "build_detect_fn",
    "build_spatial_front_fn", "family_names", "get_family", "make_mesh",
    "register_family", "run_stream", "__version__",
]
