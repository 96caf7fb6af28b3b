"""Wrapper of the adaptive-threshold kernel (csrc/threshold.cu).

A CUDA tensor launches the kernel on the current stream; a CPU tensor runs
the plain version (ops/threshold.py). Anything else raises.
"""

from __future__ import annotations

import torch

from ..threshold import adaptive_threshold as adaptive_threshold_plain
from . import _lib

TILE_SIZES = (2, 4, 8, 16, 32)

launches = 0   # kernel launches made by this wrapper


def adaptive_threshold(gray: torch.Tensor, tile_size: int = 4,
                       min_white_black_diff: int = 5) -> torch.Tensor:
    """(H, W) float32 -> (H, W) uint8 trinary; bit-exact with the plain
    version. H and W must be multiples of tile_size."""
    global launches
    if gray.device.type == "cpu":
        return adaptive_threshold_plain(gray, tile_size, min_white_black_diff)
    if gray.device.type != "cuda":
        raise ValueError(f"unsupported device {gray.device}")
    if gray.dtype != torch.float32 or gray.ndim != 2 or not gray.is_contiguous():
        raise ValueError("gray must be a contiguous (H, W) float32 tensor")
    H, W = gray.shape
    if tile_size not in TILE_SIZES or H % tile_size or W % tile_size or H == 0 or W == 0:
        raise ValueError(f"tile_size={tile_size} must be in {TILE_SIZES} and divide {H}x{W}")
    out = torch.empty((H, W), dtype=torch.uint8, device=gray.device)
    with torch.cuda.device(gray.device):
        status = _lib.library().apriltag_threshold(
            gray.data_ptr(), out.data_ptr(), H, W, tile_size, int(min_white_black_diff),
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_threshold")
    launches += 1
    return out
