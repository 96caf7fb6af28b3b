"""Adaptive thresholding: tile min/max -> trinary image {0, 127, 255}.

The plain PyTorch version (the twin of the CUDA kernel in
ops/cuda/threshold.py), bit-exact with ``isaac_ros_apriltag_tpu/ops/
threshold.py``:
  1. min/max per tile_size x tile_size tile;
  2. dilate both over the 3x3 tile neighbourhood (edge-clamped);
  3. 127 where max - min < min_white_black_diff, else threshold at
     min + (max - min) * 0.5.
"""

from __future__ import annotations

import torch


def _dilate3x3(x: torch.Tensor, op) -> torch.Tensor:
    """3x3 neighbourhood reduce of a 2D tensor, edge-clamped."""
    p = torch.cat([x[:1], x, x[-1:]], 0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], 1)
    H, W = x.shape
    out = x
    for dy in range(3):
        for dx in range(3):
            out = op(out, p[dy:dy + H, dx:dx + W])
    return out


def adaptive_threshold(gray: torch.Tensor, tile_size: int = 4,
                       min_white_black_diff: int = 5) -> torch.Tensor:
    """(H, W) float32 grayscale -> (H, W) uint8 trinary {0, 127, 255}.
    H and W must be multiples of tile_size."""
    H, W = gray.shape
    ts = tile_size
    if H % ts or W % ts:
        raise ValueError(f"image {H}x{W} is not a multiple of tile_size={ts}")
    tiles = gray.reshape(H // ts, ts, W // ts, ts)
    tmin = _dilate3x3(tiles.amin(dim=(1, 3)), torch.minimum)
    tmax = _dilate3x3(tiles.amax(dim=(1, 3)), torch.maximum)
    contrast = tmax - tmin
    thresh = tmin + contrast * 0.5
    low = contrast < min_white_black_diff
    thresh_px = thresh.repeat_interleave(ts, 0).repeat_interleave(ts, 1)
    low_px = low.repeat_interleave(ts, 0).repeat_interleave(ts, 1)
    out = torch.where(gray > thresh_px, 255, 0).to(torch.uint8)
    return torch.where(low_px, torch.full_like(out, 127), out)
