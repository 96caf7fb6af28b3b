"""Subpixel edge refinement: gradient-weighted line snap for quad edges.

Counterpart of ``isaac_ros_apriltag_tpu/ops/refine.py`` (AprilTag 3's
refine_edges): one intensity profile per sample point along each edge's
normal, gradient-weighted offsets, a weighted line fit per edge, corners
from adjacent-edge intersections, and a fallback to the input corner.

Works on one frame's quads, (C, 4, 2) against an (H, W) image, or on a
batch, (B, C, 4, 2) against (B, H, W): every image read is a gather within
the quad's own frame.

``refine_edges`` is the plain version of csrc/tail.cu's refine_kernel past
its top-2T pick, bit for bit: every float step is elementwise and in the kernel's order. The
profiles are sampled at once, and only their sums are written out: a point's
offset sums run over its profile in order (the kernel streams the profile
through a ring of five samples); a sum over an edge's 12 points is
the kernel's half-warp sum (``_point_sum``: padded with zeros to 16, then
halves added pairwise); norms are sqrt(x*x + y*y); the point fractions and
profile offsets are float32 tables made on the host (``_tables``), as the
kernel computes them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.geometry import line_intersection

_NSAMPLES = 12      # points sampled along each edge
_STEP = 0.5         # offset step, px (profile resolution)
_GRANGE = 1.0       # gradient baseline half-distance, px (= 2 profile steps)
_PAD = 2            # profile steps in _GRANGE
_SUM_WIDTH = 16     # a point sum's width: the kernel's half warp


def tap_indices(H: int, W: int, x: torch.Tensor, y: torch.Tensor):
    """Clamp (x, y) to an (H, W) image, then return the rows and columns of
    its four taps and its fractions: (y0, x0, y1, x1, fx, fy).

    Coordinates are clamped to [0, W - 1.001] x [0, H - 1.001] as in the
    reference. Non-finite coordinates (invalid quad lanes) take index 0,
    which is what the reference's float-to-int conversion gives them, and
    every index is clamped to the image, as the reference's gathers do, so
    no lane can read out of bounds."""
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0f = torch.nan_to_num(torch.floor(x), nan=0.0)
    y0f = torch.nan_to_num(torch.floor(y), nan=0.0)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int64).clamp(0, W - 1)
    y0 = y0f.to(torch.int64).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    return y0, x0, y1, x1, fx, fy


def bilinear_taps(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The taps at (x, y) (``tap_indices``) and the fractions:
    (v00, v01, v10, v11, fx, fy).

    img is one frame, (H, W), with coordinates of any shape, or a batch,
    (B, H, W), with coordinates of shape (B, ...) that read frame b's pixels."""
    H, W = img.shape[-2:]
    y0, x0, y1, x1, fx, fy = tap_indices(H, W, x, y)
    flat = img.reshape(-1, H * W)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(flat.shape[0], -1)
        return torch.gather(flat, 1, idx).reshape(xi.shape)

    return tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1), fx, fy


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample, associated as in refine.py (decode.py differs)."""
    v00, v01, v10, v11, fx, fy = bilinear_taps(img, x, y)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def profile(search_range: float) -> tuple[float, int]:
    """(first offset, number of samples) of a point's intensity profile:
    the offsets -search_range - 1, then steps of 0.5 up to search_range + 1
    (torch.arange's count, 4 search_range + 5 for an integer range)."""
    lo, hi = -search_range - _GRANGE, search_range + _GRANGE + _STEP / 2
    return float(np.float32(lo)), max(math.ceil((hi - lo) / _STEP), 0)


class _Tables(NamedTuple):
    alphas: torch.Tensor     # (12,) float32: (s + 1) / 13, a point's place on its edge
    offs: torch.Tensor       # (P,) float32: first + 0.5 k, the profile's offsets


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, search_range: float) -> _Tables:
    """The point fractions and profile offsets on `device`, made once in
    float32 on the host as the kernel makes them (a division by the scalar
    13 on the card would multiply by its reciprocal)."""
    first, P = profile(search_range)
    s = np.arange(1, _NSAMPLES + 1, dtype=np.float32)
    alphas = s / np.float32(_NSAMPLES + 1)
    offs = np.float32(first) + np.float32(_STEP) * np.arange(P, dtype=np.float32)
    return _Tables(torch.as_tensor(alphas, device=device), torch.as_tensor(offs, device=device))


def _point_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (an edge's 12 points) in the kernel's order:
    padded with zeros to 16, then x[:8] + x[8:], and so on down to one."""
    x = torch.nn.functional.pad(x, (0, _SUM_WIDTH - x.shape[-1]))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


class _Edges(NamedTuple):
    ux: torch.Tensor   # (..., 4): edge k's unit direction, corner k to k + 1
    uy: torch.Tensor
    mx: torch.Tensor   # (..., 4): its midpoint
    my: torch.Tensor
    nx: torch.Tensor   # (..., 4): its normal, pointing into the quad
    ny: torch.Tensor
    px: torch.Tensor   # (..., 4, 12): its sample points
    py: torch.Tensor


def _edges(corners: torch.Tensor, tab: _Tables) -> _Edges:
    x0, y0 = corners[..., 0], corners[..., 1]                      # (..., 4)
    x1, y1 = torch.roll(x0, -1, -1), torch.roll(y0, -1, -1)
    cx = (((x0[..., 0] + x0[..., 1]) + x0[..., 2]) + x0[..., 3]) * 0.25
    cy = (((y0[..., 0] + y0[..., 1]) + y0[..., 2]) + y0[..., 3]) * 0.25

    ex, ey = x1 - x0, y1 - y0
    den = torch.clamp(torch.sqrt(ex * ex + ey * ey), min=1e-6)
    ux, uy = ex / den, ey / den
    mx, my = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    inward = uy * (cx[..., None] - mx) + (-ux) * (cy[..., None] - my) >= 0
    nx = torch.where(inward, uy, -uy)
    ny = torch.where(inward, -ux, ux)
    # The 12 points of each edge, (..., 4, S).
    px = x0[..., None] + tab.alphas * ex[..., None]
    py = y0[..., None] + tab.alphas * ey[..., None]
    return _Edges(ux, uy, mx, my, nx, ny, px, py)


def _samples(e: _Edges, tab: _Tables) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of every point's profile samples, (..., 4, S, P)."""
    return (e.px[..., None] + tab.offs * e.nx[..., None, None],
            e.py[..., None] + tab.offs * e.ny[..., None, None])


def sample_points(corners: torch.Tensor,
                  search_range: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of every profile sample that ``refine_edges`` reads for these
    corners, (..., C, 4, 12, P), before ``tap_indices``' clamp."""
    tab = _tables(corners.device, float(search_range))
    return _samples(_edges(corners, tab), tab)


def refine_edges(gray: torch.Tensor, corners: torch.Tensor,
                 dark_inside: torch.Tensor, *,
                 search_range: float = 2.0) -> torch.Tensor:
    """Snap quad edges to the image's intensity gradient.

    gray: (H, W) float32; corners: (C, 4, 2) cyclic; dark_inside: (C,) bool;
    or a batch of each, (B, H, W), (B, C, 4, 2) and (B, C).
    Returns refined corners (..., C, 4, 2); degenerate refinements keep the
    input. Edge k runs from corner k to corner k + 1.
    """
    P = profile(search_range)[1]
    tab = _tables(corners.device, float(search_range))
    x0, y0 = corners[..., 0], corners[..., 1]
    e = _edges(corners, tab)
    ux, uy, mx, my, nx, ny, px, py = e

    # Each point's profile, (..., 4, S, P), and its gradient weights, from
    # samples j + 4 (in) and j (out) at offset j + 2.
    prof = _bilinear(gray, *_samples(e, tab))
    G = max(P - 2 * _PAD, 0)
    g_in, g_out = prof[..., 2 * _PAD:], prof[..., :G]
    diff = torch.where(dark_inside[..., None, None, None], g_out - g_in, g_in - g_out)
    w = torch.where(diff > 0, diff * diff, 0.0)
    terms = torch.stack([w, w * tab.offs[_PAD:_PAD + G]])
    acc = torch.zeros_like(terms[..., 0])
    for j in range(G):
        acc = acc + terms[..., j]
    wsum, num = acc
    n0 = num / torch.clamp(wsum, min=1e-9)
    sample_ok = wsum > 1e-3
    qx, qy = px + n0 * nx[..., None], py + n0 * ny[..., None]

    # Weighted line fit through each edge's adjusted points.
    sw = torch.where(sample_ok, wsum, 0.0)
    tot, sx, sy = _point_sum(torch.stack([sw, qx * sw, qy * sw]))
    tot = torch.clamp(tot, min=1e-9)
    mean_x, mean_y = sx / tot, sy / tot
    dx, dy = qx - mean_x[..., None], qy - mean_y[..., None]
    cxx, cxy, cyy = _point_sum(torch.stack([(sw * dx) * dx, (sw * dx) * dy, (sw * dy) * dy]))
    dd = cxx - cyy
    disc = torch.sqrt(torch.clamp(dd * dd + (4 * cxy) * cxy, min=0.0))
    lam = 0.5 * ((cxx + cyy) + disc)
    v1x, v1y = cxy, lam - cxx
    v2x, v2y = lam - cyy, cxy
    pick = v1x * v1x + v1y * v1y > v2x * v2x + v2y * v2y
    vx, vy = torch.where(pick, v1x, v2x), torch.where(pick, v1y, v2y)
    vn = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-9)

    # An edge is usable with gradient support on most points and a
    # direction; else it keeps its own line.
    good = (sample_ok.sum(-1) >= _NSAMPLES // 2) & (lam > 1e-9)
    mean = torch.stack([torch.where(good, mean_x, mx), torch.where(good, mean_y, my)], -1)
    dirs = torch.stack([torch.where(good, vx / vn, ux), torch.where(good, vy / vn, uy)], -1)

    # Corner k = intersection of edge k - 1 and edge k.
    new = line_intersection(torch.roll(mean, 1, -2), torch.roll(dirs, 1, -2), mean, dirs)
    mvx, mvy = new[..., 0] - x0, new[..., 1] - y0
    moved = torch.sqrt(mvx * mvx + mvy * mvy)
    ok = (torch.isfinite(new[..., 0]) & torch.isfinite(new[..., 1])
          & (moved < search_range + 0.5))
    return torch.where(ok[..., None], new, corners)
