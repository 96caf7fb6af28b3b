"""Wrapper of the pose kernel (csrc/tail.cu::pose_kernel).

``estimate_poses`` checks its input, then on CPU tensors runs the plain
version (ops/pose.py::estimate_poses); on CUDA tensors it launches the
kernel or raises and adds one to ``launches``. One launch poses every tag
of the call, on the current stream, into outputs allocated here by
torch.empty, with no host sync, so a detect call that runs it can be
captured in a CUDA graph. The detect path poses its tags in the finish's
launch instead (ops/cuda/tail.py::finish_and_pose); this launch serves the
other callers (a rig whose cameras have their own K).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import pose as plain
from ..pose import Poses
from . import _lib

launches = 0    # pose_kernel launches made by estimate_poses

# The structural pivots of columns 0-5 of a tag-plane homography's system
# (csrc/tail.cu::solve8): rows 0-2, then each of the next three columns'
# pivot one row down, so the rows go u0, u1, u2, v0, v1, v2, u3, v3.
STANDARD_PIVOTS = (0, 1, 2, 4, 5, 6)
PIVOT_ROWS = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (0, 3), (1, 3))   # (v row, corner)


@functools.lru_cache(maxsize=64)
def standard_pivots(half: float) -> bool:
    """Whether the tag-plane homography's elimination (utils/geometry.py::
    solve_pivoted, first largest |pivot|) takes STANDARD_PIVOTS in columns
    0-5 for the tag's half size, rounded to float32 as the kernels take it.
    Those columns hold only the tag's own corners (+-half, 0, 1), so their
    pivots are the same for every tag of a call: their elimination is run
    here in float32, as the kernel runs it."""
    A = _tag_rows(half, [(v, k) for v in (0, 1) for k in range(4)])
    with np.errstate(all="ignore"):
        for k, want in enumerate(STANDARD_PIVOTS):
            p, top = k, abs(A[k][k])
            for i in range(k + 1, 8):
                if abs(A[i][k]) > top:
                    p, top = i, abs(A[i][k])
            if p != want:
                return False
            A[k], A[p] = A[p], A[k]
            for i in range(k + 1, 8):
                f = A[i][k] / A[k][k]
                for j in range(k + 1, 6):
                    A[i][j] = A[i][j] - f * A[k][j]
    return True


def _tag_rows(half: float, rows) -> list:
    """Columns 0-5 of the system's rows (v row, corner) of the tag's
    corners at its half size, float32 as the kernels build them."""
    h = np.float32(half)
    sx = (np.float32(-1.0) * h, np.float32(1.0) * h, np.float32(1.0) * h, np.float32(-1.0) * h)
    sy = (np.float32(-1.0) * h, np.float32(-1.0) * h, np.float32(1.0) * h, np.float32(1.0) * h)
    one, zero = np.float32(1.0), np.float32(0.0)
    return [[zero, zero, zero, sx[k], sy[k], one] if v else [sx[k], sy[k], one, zero, zero, zero]
            for v, k in rows]


@functools.lru_cache(maxsize=64)
def pose_constants(half: float) -> np.ndarray | None:
    """csrc/tail.cu::PoseConsts of the tag's half size (float32 as the
    kernels take it): the elimination of columns 0-5 of the tag-plane
    homography's system, which hold only the tag's corners, run here in
    float32 as solve8 runs it (rows in PIVOT_ROWS' order, the pivots it
    takes there): the 27 multipliers f (k < 6, i > k) and the 21 reduced
    row entries u (k <= j < 6). None unless the pivots are STANDARD_PIVOTS
    and the size is a normal float32 (a subnormal, 0, inf or NaN size takes
    the kernels' full elimination)."""
    h = np.float32(half)
    if not (np.isfinite(h) and abs(h) >= np.finfo(np.float32).tiny and standard_pivots(half)):
        return None
    A = _tag_rows(half, PIVOT_ROWS)
    f, u = [], []
    with np.errstate(all="ignore"):
        for k in range(6):
            u += A[k][k:]
            for i in range(k + 1, 8):
                m = A[i][k] / A[k][k]
                f.append(m)
                for j in range(k + 1, 6):
                    A[i][j] = A[i][j] - m * A[k][j]
    return np.array(f + u, np.float32)


def _consts_ptr(half: float) -> int | None:
    """The host address of pose_constants(half) (kept alive by its cache),
    or None: the pose kernels' consts argument."""
    c = pose_constants(half)
    return None if c is None else c.ctypes.data


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
            corners.data_ptr(), K.data_ptr(), *(t.data_ptr() for t in out),
            _consts_ptr(tag_size * 0.5), N, N // K.shape[0] if batched else N, int(batched),
            _lib.float_bits(tag_size * 0.5), torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_pose")
    launches += 1
    return out
