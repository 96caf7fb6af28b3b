"""Wrapper of the adaptive-threshold kernel (csrc/threshold.cu).

A CUDA tensor launches the kernel on the current stream; a CPU tensor runs
the plain version (ops/threshold.py). Anything else raises. A contiguous
view that starts off a 16-byte boundary, or a width that is not a multiple
of 4, is taken by the kernel's own scalar path (csrc/threshold.cu).
"""

from __future__ import annotations

import torch

from ..threshold import adaptive_threshold as adaptive_threshold_plain
from . import _lib

TILE_SIZES = (2, 4, 8, 16, 32)

launches = 0   # kernel launches made by this wrapper


def adaptive_threshold(gray: torch.Tensor, tile_size: int = 4,
                       min_white_black_diff: int = 5) -> torch.Tensor:
    """(B, H, W) or (H, W) float32 -> uint8 trinary of the same shape, one
    launch for the whole batch; bit-exact with the plain version. H and W
    must be multiples of tile_size."""
    global launches
    if gray.device.type == "cpu":
        return adaptive_threshold_plain(gray, tile_size, min_white_black_diff)
    if gray.device.type != "cuda":
        raise ValueError(f"unsupported device {gray.device}")
    if gray.dtype != torch.float32 or gray.ndim not in (2, 3) or not gray.is_contiguous():
        raise ValueError("gray must be a contiguous (B, H, W) or (H, W) float32 tensor")
    B, H, W = gray.shape if gray.ndim == 3 else (1, *gray.shape)
    if tile_size not in TILE_SIZES or H % tile_size or W % tile_size or gray.numel() == 0:
        raise ValueError(f"tile_size={tile_size} must be in {TILE_SIZES} and divide {H}x{W}")
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {_lib.MAX_BATCH} frames")
    out = torch.empty(gray.shape, dtype=torch.uint8, device=gray.device)
    with torch.cuda.device(gray.device):
        status = _lib.library().apriltag_threshold(
            gray.data_ptr(), out.data_ptr(), B, H, W, tile_size, int(min_white_black_diff),
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_threshold")
    launches += 1
    return out
