"""Image warping ops: rectification remap + resize, on (..., H, W) images.

Counterpart of ``isaac_ros_apriltag_tpu/ops/remap.py``, the stages that the
graph pipeline (pipeline.py) runs ahead of the detector. Plain PyTorch; each
works on one grayscale frame, (H, W), or on a batch, (B, H, W), with one map
or plan for every frame.

  - `remap_bilinear`: the direct gather form of the rectify warp (the
    reference's correctness oracle).
  - `SeparableRectify`: the reference's production path. The rectify warp
    factors into a horizontal then a vertical 1-D resample (Catmull-Smith
    two-pass); each 1-D bilinear resample with bounded displacement becomes
    a banded sum over static shifts, out = sum_d hat(src - (dst + d)) *
    shift(in, d). The plan is built in numpy f64 exactly as the reference
    builds it, and the passes take the same f32 multiply-adds in the same
    order.
  - `resize_area`: integer-factor box downsample.
  - `resize_bilinear`: ``jax.image.resize(method="bilinear")``, which
    antialiases when it downsamples; ``F.interpolate(antialias=True)``
    computes the same triangle filter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


def remap_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `image` (..., H, W) at source coords `grid` (H', W', 2), (x, y).

    Out-of-range samples clamp to the border. Returns float32 (..., H', W').
    """
    *lead, H, W = image.shape
    flat = image.to(torch.float32).reshape(-1, H * W)
    x = torch.clamp(grid[..., 0], 0.0, W - 1.001)
    y = torch.clamp(grid[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0

    def tap(yi, xi):
        return flat[:, (yi * W + xi).reshape(-1)].reshape(*lead, *grid.shape[:2])

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _band_resample_1d(img: torch.Tensor, src: torch.Tensor, axis: int,
                      dmin: int, dmax: int) -> torch.Tensor:
    """1-D bilinear resample of (..., H, W) along `axis` (-1 or -2) as a
    banded shift-multiply-accumulate.

    src: (H, W) per-OUTPUT-pixel source coordinate along `axis`, with
    src - dst_index inside [dmin, dmax]. The two bilinear taps at floor(src)
    and floor(src) + 1 are exactly the offsets d where hat(src - (dst + d))
    = max(0, 1 - |.|) is nonzero, so the hat-weighted static shifts over d in
    [dmin, dmax + 1] reproduce the gather to float rounding. Zero padding is
    safe: taps outside the band get zero weight.
    """
    n = img.shape[axis]
    pad_lo, pad_hi = max(-dmin, 0), max(dmax + 1, 0)
    padded = F.pad(img, (pad_lo, pad_hi) if axis == -1 else (0, 0, pad_lo, pad_hi))
    dst = torch.arange(n, dtype=torch.float32, device=img.device)
    rel = src - (dst if axis == -1 else dst[:, None])
    acc = torch.zeros(torch.broadcast_shapes(img.shape, src.shape), dtype=torch.float32,
                      device=img.device)
    for d in range(dmin, dmax + 2):
        w = torch.clamp(1.0 - torch.abs(rel - d), min=0.0)
        acc.addcmul_(w, padded.narrow(axis, pad_lo + d, n))
    return acc


@dataclasses.dataclass(frozen=True)
class SeparableRectify:
    """Precomputed two-pass (horizontal then vertical) rectification plan.

    Built once per camera from the (H, W, 2) rectify grid. The intermediate
    horizontal map sx2 is the x-map composed with the inverse of the
    vertical warp per column (Catmull-Smith), so pass2(pass1(img)) matches
    remap_bilinear(img, grid) up to the separability error (sub-0.05 px for
    plumb_bob-scale distortion).
    """

    sx2: torch.Tensor   # (H, W) float32 horizontal source x at intermediate rows
    sy2: torch.Tensor   # (H, W) float32 vertical source y per output pixel
    dx_range: tuple     # (dmin, dmax) of the horizontal band
    dy_range: tuple

    @staticmethod
    def from_grid(grid: np.ndarray) -> "SeparableRectify":
        """The reference's plan, in numpy f64: the same sx2, sy2 and ranges."""
        grid = np.asarray(grid, np.float64)
        H, W = grid.shape[:2]
        sx = grid[..., 0]
        sy = grid[..., 1]
        # Invert the vertical warp per column: sx2(y, x') = sx(y'(y), x')
        # where y'(y) solves sy(y', x') = y (sy is monotone in y' for
        # physical rectification maps; checked below). Inversion runs on the
        # raw map (clamping creates flat runs); outputs clamp after.
        ys = np.arange(H, dtype=np.float64)
        sx2 = np.empty_like(sx)
        for x in range(W):
            col = sy[:, x]
            if not np.all(np.diff(col) > 0):
                raise ValueError(
                    "vertical rectify map is not monotone per column; "
                    "use remap_bilinear for this camera")
            yprime = np.interp(ys, col, ys)
            sx2[:, x] = np.interp(yprime, ys, sx[:, x])
        sx2 = np.clip(sx2, 0.0, W - 1.001)
        sy = np.clip(sy, 0.0, H - 1.001)
        xs = np.arange(W, dtype=np.float64)[None, :]
        dxr = (int(np.floor((sx2 - xs).min())), int(np.ceil((sx2 - xs).max())))
        dyr = (int(np.floor((sy - ys[:, None]).min())),
               int(np.ceil((sy - ys[:, None]).max())))
        return SeparableRectify(sx2=torch.from_numpy(sx2.astype(np.float32)),
                                sy2=torch.from_numpy(sy.astype(np.float32)),
                                dx_range=dxr, dy_range=dyr)

    def to(self, device) -> "SeparableRectify":
        return dataclasses.replace(self, sx2=self.sx2.to(device), sy2=self.sy2.to(device))

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """(..., H, W) -> rectified float32 (..., H, W)."""
        img = image.to(torch.float32)
        tmp = _band_resample_1d(img, self.sx2, -1, *self.dx_range)
        return _band_resample_1d(tmp, self.sy2, -2, *self.dy_range)


def resize_area(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor area downsample, (..., H, W) -> (..., H/f, W/f)."""
    f = int(factor)
    *lead, H, W = image.shape
    if H % f or W % f:
        raise ValueError(f"image {H}x{W} is not a multiple of factor {f}")
    return image.to(torch.float32).reshape(*lead, H // f, f, W // f, f).mean((-3, -1))


def resize_bilinear(image: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to (..., H', W'), antialiased when it
    downsamples, as ``jax.image.resize(..., method="bilinear")`` (half-pixel
    centres, a triangle filter widened by the downsampling factor)."""
    *lead, H, W = image.shape
    x = image.to(torch.float32).reshape(-1, 1, H, W)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.reshape(*lead, *out.shape[-2:])
