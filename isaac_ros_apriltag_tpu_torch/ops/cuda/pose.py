"""Wrapper of the pose kernel (csrc/tail.cu::pose_kernel).

``estimate_poses`` checks its input, then on CPU tensors runs the plain
version (ops/pose.py::estimate_poses); on CUDA tensors it launches the
kernel or raises and adds one to ``launches``. One launch poses every tag
of the call, on the current stream, into outputs allocated here by
torch.empty, with no host sync, so a detect call that runs it can be
captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import pose as plain
from ..pose import Poses
from . import _lib

launches = 0    # pose_kernel launches made by estimate_poses


def estimate_poses(corners: torch.Tensor, K: torch.Tensor, tag_size: float) -> Poses:
    """The plain version's signature and results, bit for bit: corners
    (..., C, 4, 2) float32, contiguous; K (3, 3) float32 shared, or
    (B, 3, 3) one per frame of corners (B, C, 4, 2)."""
    global launches
    if corners.dtype != torch.float32 or K.dtype != torch.float32:
        raise ValueError(f"corners and K must be float32, got {corners.dtype} and {K.dtype}")
    if corners.ndim < 3 or corners.shape[-2:] != (4, 2):
        raise ValueError(f"corners must be (..., C, 4, 2), got {tuple(corners.shape)}")
    if K.shape[-2:] != (3, 3) or K.ndim not in (2, 3) or (
            K.ndim == 3 and (corners.ndim < 4 or K.shape[0] != corners.shape[0])):
        raise ValueError(f"K must be (3, 3), or (B, 3, 3) with corners (B, C, 4, 2); got "
                         f"{tuple(K.shape)} and corners {tuple(corners.shape)}")
    if not (corners.is_contiguous() and K.is_contiguous()):
        raise ValueError("corners and K must be contiguous")
    if corners.device != K.device:
        raise ValueError(f"corners on {corners.device}, K on {K.device}")
    N = corners.numel() // 8
    if not 1 <= N < 2 ** 31:
        raise ValueError(f"the kernel takes 1 to 2^31 - 1 tags, got {N}")
    if corners.device.type == "cpu":
        return plain.estimate_poses(corners, K, tag_size)
    if corners.device.type != "cuda":
        raise ValueError(f"unsupported device {corners.device}")
    lead = corners.shape[:-2]
    dev = corners.device
    out = Poses(rotation=torch.empty((*lead, 3, 3), dtype=torch.float32, device=dev),
                translation=torch.empty((*lead, 3), dtype=torch.float32, device=dev),
                quaternion=torch.empty((*lead, 4), dtype=torch.float32, device=dev))
    batched = K.ndim == 3
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_pose(
            corners.data_ptr(), K.data_ptr(), *(t.data_ptr() for t in out), N,
            N // K.shape[0] if batched else N, int(batched), _lib.float_bits(tag_size * 0.5),
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_pose")
    launches += 1
    return out
