"""isaac_ros_apriltag_tpu_torch — the AprilTag detector in PyTorch + CUDA.

A port of ``isaac_ros_apriltag_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The detector runs end to end on one frame (``Detector``, with
``detect_checked`` for its output invariants) or on a batch
(``pipeline.batched_detect_fn``), behind the rectify -> resize graph
(``pipeline.GraphPipeline``), over a multi-camera rig with shared or
per-camera intrinsics (``RigDetector``: one batched call on one card, or
with ``group=`` its cameras split over the ranks of a ``torch.distributed``
group and the results gathered in camera order), over a
timestamp-aligned set of camera streams (``TimestampAligner``), over a
stream of host frames with uploads overlapped with compute
(``StreamingRunner``), and on one large frame cut into bands of rows
(``SpatialDetector``: the bands as a batch on one card, or one band on each
rank of a ``torch.distributed`` group, see ``make_mesh``). Its CCL runs the
two-phase scan flow or, with ``ccl_flow='jumps'``, the reference's
single-phase flow with pointer jumps (``connected_components``). The SLAM
layer maps detections into a tag map (``TagMapper``) and optimizes it by
bundle adjustment (``ba_solve``; landmark-sharded:
``make_distributed_solver``) or a pose graph (``pose_graph_solve``).
``python -m isaac_ros_apriltag_tpu_torch detect|bench|slam``
is its command line. Its three hot kernels (adaptive threshold and the two
CCL scan kernels) are hand-written CUDA in ``csrc/``, built with nvcc at
first use. Backend 'torch' runs plain PyTorch twins of those kernels on any
device. This package never imports jax.
"""

from .camera.model import CameraModel
from .config import BACKENDS, CCL_FLOWS, DetectorConfig
from .detector import Detector, build_detect_fn
from .models.families import TagFamily, family_names, get_family, register_family
from .ops.ccl import connected_components
from .parallel.mesh import make_mesh
from .parallel.rig import RigDetector
from .parallel.slam.ba import BAProblem
from .parallel.slam.ba import solve as ba_solve
from .parallel.slam.dba import make_distributed_solver, partition_problem
from .parallel.slam.map import TagMapper, ate_rmse
from .parallel.slam.posegraph import PoseGraph
from .parallel.slam.posegraph import solve as pose_graph_solve
from .parallel.spatial import SpatialDetector, build_spatial_front_fn
from .pipeline import GraphPipeline, batched_detect_fn
from .streaming import StreamingRunner, run_stream
from .sync import TimestampAligner
from .types import Detections, FrameStats

__version__ = "0.1.0"

__all__ = [
    "BACKENDS", "BAProblem", "CCL_FLOWS", "CameraModel", "Detections", "Detector",
    "DetectorConfig", "FrameStats", "GraphPipeline", "PoseGraph", "RigDetector",
    "SpatialDetector", "StreamingRunner", "TagFamily", "TagMapper", "TimestampAligner",
    "ate_rmse", "ba_solve", "batched_detect_fn", "build_detect_fn", "build_spatial_front_fn",
    "connected_components", "family_names", "get_family", "make_distributed_solver",
    "make_mesh", "partition_problem", "pose_graph_solve", "register_family", "run_stream",
    "__version__",
]
