"""Wrappers of the detector's per-frame finish (csrc/tail.cu:
tail_finish_kernel and finish_pose_kernel), one block a frame each. The top-2T
pick runs inside refine's launch (ops/cuda/refine.py::select_and_refine).

``finish_detections`` and ``finish_and_pose`` (the finish, then the pose of
its top-T tags, in one launch: the detect path's) check their input, then
on CPU tensors run the plain versions (ops/tail.py, ops/pose.py); on CUDA
tensors they launch their kernel or raise and add one to
``finish_launches`` or ``finish_pose_launches``. Each launches on the current stream, into
outputs allocated here by torch.empty, with no host sync, so a detect call
that runs them can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import pose as plain_pose
from .. import tail as plain
from ..decode import DecodeResult
from ..pose import Poses
from ..tail import Selection
from . import _lib
from .pose import _consts_ptr

finish_launches = 0    # tail_finish_kernel launches made by finish_detections
finish_pose_launches = 0   # finish_pose_kernel launches made by finish_and_pose

MAX_QUADS = 128        # a frame's quads a block takes (DetectorConfig's max_clusters cap)


def _check(tensors: dict, B: int, N: int, what: str) -> torch.device:
    """Each of `tensors` (name -> (tensor, dtype, trailing shape)) has that
    dtype and shape (B, N, *trailing), is contiguous and lies on the first
    one's device; 1 <= N <= MAX_QUADS. Returns the device."""
    dev = next(iter(tensors.values()))[0].device
    for name, (t, dtype, trail) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != (B, N, *trail):
            raise ValueError(f"{what}: {name} must be {dtype} {(B, N, *trail)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, not {dev}")
    if not (1 <= B <= _lib.MAX_BATCH and 1 <= N <= MAX_QUADS):
        raise ValueError(f"{what}: the kernel takes 1 to {_lib.MAX_BATCH} frames of 1 to "
                         f"{MAX_QUADS} quads, got {B} of {N}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_finish(dec: DecodeResult, pre_valid: torch.Tensor, num_quads: torch.Tensor,
                  overflow: torch.Tensor, k: int) -> tuple[int, int, torch.device]:
    """Raise on what the finish kernels do not take; return (B, N, device)."""
    if pre_valid.ndim != 2:
        raise ValueError(f"pre_valid must be (B, N), got {tuple(pre_valid.shape)}")
    B, N = pre_valid.shape
    dev = _check({"pre_valid": (pre_valid, torch.bool, ()), "valid": (dec.valid, torch.bool, ()),
                  "id": (dec.id, torch.int32, ()), "hamming": (dec.hamming, torch.int32, ()),
                  "margin": (dec.margin, torch.float32, ()),
                  "corners": (dec.corners, torch.float32, (4, 2))}, B, N, "finish_detections")
    for name, t, dtype in (("num_quads", num_quads, torch.int32),
                           ("overflow", overflow, torch.bool)):
        if t.dtype != dtype or tuple(t.shape) != (B,) or t.device != dev:
            raise ValueError(f"finish_detections: {name} must be {dtype} ({B},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if k < 1:
        raise ValueError(f"finish_detections: k must be >= 1, got {k}")
    return B, N, dev


def _selection(B: int, T: int, dev: torch.device) -> Selection:
    return Selection(valid=torch.empty((B, T), dtype=torch.bool, device=dev),
                     id=torch.empty((B, T), dtype=torch.int32, device=dev),
                     hamming=torch.empty((B, T), dtype=torch.int32, device=dev),
                     margin=torch.empty((B, T), dtype=torch.float32, device=dev),
                     center=torch.empty((B, T, 2), dtype=torch.float32, device=dev),
                     corners=torch.empty((B, T, 4, 2), dtype=torch.float32, device=dev),
                     num_detections=torch.empty(B, dtype=torch.int32, device=dev),
                     overflow=torch.empty(B, dtype=torch.bool, device=dev))


def _finish_ptrs(dec: DecodeResult, pre_valid, num_quads, overflow, out: Selection) -> list:
    return [dec.valid.data_ptr(), dec.id.data_ptr(), dec.hamming.data_ptr(),
            dec.margin.data_ptr(), dec.corners.data_ptr(), pre_valid.data_ptr(),
            num_quads.data_ptr(), overflow.data_ptr(), *(t.data_ptr() for t in out)]


def finish_detections(dec: DecodeResult, pre_valid: torch.Tensor, num_quads: torch.Tensor,
                      overflow: torch.Tensor, *, k: int,
                      min_decision_margin: float) -> Selection:
    """The plain version's signature and results, bit for bit: the (B, N)
    DecodeResult (bool valid, int32 id and hamming, float32 margin and
    (B, N, 4, 2) corners), (B, N) bool pre_valid, (B,) int32 num_quads and
    bool overflow; k >= 1 (min(k, N) tags a frame)."""
    global finish_launches
    B, N, dev = _check_finish(dec, pre_valid, num_quads, overflow, k)
    if dev.type == "cpu":
        return plain.finish_detections(dec, pre_valid, num_quads, overflow, k=k,
                                       min_decision_margin=min_decision_margin)
    out = _selection(B, min(k, N), dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_tail_finish(
            *_finish_ptrs(dec, pre_valid, num_quads, overflow, out), B, N, min(k, N),
            _lib.float_bits(min_decision_margin), torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_tail_finish")
    finish_launches += 1
    return out


def finish_and_pose(dec: DecodeResult, pre_valid: torch.Tensor, num_quads: torch.Tensor,
                    overflow: torch.Tensor, K: torch.Tensor, tag_size: float, *, k: int,
                    min_decision_margin: float) -> tuple[Selection, Poses]:
    """finish_detections, then estimate_poses(selection.corners, K,
    tag_size) (K (3, 3), or (B, 3, 3) one a frame), bit for bit the plain
    versions', in one launch on the card: each top-T slot's thread poses the
    tag it writes."""
    global finish_pose_launches
    B, N, dev = _check_finish(dec, pre_valid, num_quads, overflow, k)
    T = min(k, N)
    if (K.dtype != torch.float32 or not K.is_contiguous() or K.device != dev
            or tuple(K.shape) not in ((3, 3), (B, 3, 3))):
        raise ValueError(f"K must be a contiguous float32 (3, 3) or ({B}, 3, 3) tensor on "
                         f"{dev}, got {K.dtype} {tuple(K.shape)} on {K.device}")
    if dev.type == "cpu":
        sel = plain.finish_detections(dec, pre_valid, num_quads, overflow, k=k,
                                      min_decision_margin=min_decision_margin)
        return sel, plain_pose.estimate_poses(sel.corners, K, tag_size)
    out = _selection(B, T, dev)
    poses = Poses(rotation=torch.empty((B, T, 3, 3), dtype=torch.float32, device=dev),
                  translation=torch.empty((B, T, 3), dtype=torch.float32, device=dev),
                  quaternion=torch.empty((B, T, 4), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_tail_finish_pose(
            *_finish_ptrs(dec, pre_valid, num_quads, overflow, out), K.data_ptr(),
            *(t.data_ptr() for t in poses), _consts_ptr(tag_size * 0.5), B, N, T,
            _lib.float_bits(min_decision_margin), int(K.ndim == 3),
            _lib.float_bits(tag_size * 0.5), torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_tail_finish_pose")
    finish_pose_launches += 1
    return out, poses
