"""Subpixel edge refinement: gradient-weighted line snap for quad edges.

Counterpart of ``isaac_ros_apriltag_tpu/ops/refine.py`` (AprilTag 3's
refine_edges): one intensity profile per sample point along each edge's
normal, gradient-weighted offsets, a weighted line fit per edge, corners
from adjacent-edge intersections, and a fallback to the input corner.

Works on one frame's quads, (C, 4, 2) against an (H, W) image, or on a
batch, (B, C, 4, 2) against (B, H, W): every image read is a gather within
the quad's own frame.
"""

from __future__ import annotations

import torch

from ..utils.geometry import line_intersection

_NSAMPLES = 12      # points sampled along each edge
_STEP = 0.5         # offset step, px (profile resolution)
_GRANGE = 1.0       # gradient baseline half-distance, px (= 2 profile steps)


def bilinear_taps(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Clamp (x, y) to the image, then return (v00, v01, v10, v11, fx, fy).

    img is one frame, (H, W), with coordinates of any shape, or a batch,
    (B, H, W), with coordinates of shape (B, ...) that read frame b's pixels.

    Coordinates are clamped to [0, W - 1.001] x [0, H - 1.001] as in the
    reference. Non-finite coordinates (invalid quad lanes) take index 0,
    which is what the reference's float-to-int conversion gives them, and
    every index is clamped to the image, as the reference's gathers do, so
    no lane can read out of bounds."""
    H, W = img.shape[-2:]
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


def refine_edges(gray: torch.Tensor, corners: torch.Tensor,
                 dark_inside: torch.Tensor, *,
                 search_range: float = 2.0) -> torch.Tensor:
    """Snap quad edges to the image's intensity gradient.

    gray: (H, W) float32; corners: (C, 4, 2) cyclic; dark_inside: (C,) bool;
    or a batch of each, (B, H, W), (B, C, 4, 2) and (B, C).
    Returns refined corners (..., C, 4, 2); degenerate refinements keep the
    input.
    """
    dev = corners.device
    p0 = corners
    p1 = torch.roll(corners, -1, -2)
    centroid = corners.mean(-2, keepdim=True)

    e = p1 - p0
    elen = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    e = e / torch.clamp(elen, min=1e-6)
    n = torch.stack([e[..., 1], -e[..., 0]], -1)
    mid = 0.5 * (p0 + p1)
    inward = (n * (centroid - mid)).sum(-1, keepdim=True) >= 0
    n = torch.where(inward, n, -n)

    alphas = (1.0 + torch.arange(_NSAMPLES, dtype=torch.float32, device=dev)) / (_NSAMPLES + 1)
    pts = p0[..., None, :] + alphas[:, None] * (p1 - p0)[..., None, :]   # (..., 4, S, 2)

    pad = int(round(_GRANGE / _STEP))
    prof_offs = torch.arange(-search_range - _GRANGE,
                             search_range + _GRANGE + _STEP / 2, _STEP,
                             dtype=torch.float32, device=dev)
    base = pts[..., None, :] + prof_offs[:, None] * n[..., None, None, :]
    prof = _bilinear(gray, base[..., 0], base[..., 1])           # (..., 4, S, P)
    g_in = prof[..., 2 * pad:]
    g_out = prof[..., :prof.shape[-1] - 2 * pad]
    offs = prof_offs[pad:-pad]

    diff = torch.where(dark_inside[..., None, None, None], g_out - g_in, g_in - g_out)
    w = torch.where(diff > 0, diff * diff, 0.0)
    wsum = w.sum(-1)
    n0 = (w * offs).sum(-1) / torch.clamp(wsum, min=1e-9)
    sample_ok = wsum > 1e-3

    q = pts + n0[..., None] * n[..., None, :]

    sw = torch.where(sample_ok, wsum, 0.0)[..., None]
    tot = torch.clamp(sw.sum(-2), min=1e-9)
    mean = (q * sw).sum(-2) / tot
    d = q - mean[..., None, :]
    cxx = (sw[..., 0] * d[..., 0] * d[..., 0]).sum(-1)
    cxy = (sw[..., 0] * d[..., 0] * d[..., 1]).sum(-1)
    cyy = (sw[..., 0] * d[..., 1] * d[..., 1]).sum(-1)
    disc = torch.sqrt(torch.clamp((cxx - cyy) ** 2 + 4 * cxy * cxy, min=0.0))
    lam = 0.5 * (cxx + cyy + disc)
    v1 = torch.stack([cxy, lam - cxx], -1)
    v2 = torch.stack([lam - cyy, cxy], -1)
    pick = (v1 * v1).sum(-1, keepdim=True) > (v2 * v2).sum(-1, keepdim=True)
    dirs = torch.where(pick, v1, v2)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-9)

    edge_ok = sample_ok.sum(-1) >= _NSAMPLES // 2
    dir_ok = lam > 1e-9
    good = (edge_ok & dir_ok)[..., None]
    mean = torch.where(good, mean, mid)
    dirs = torch.where(good, dirs, e)

    new = line_intersection(torch.roll(mean, 1, -2), torch.roll(dirs, 1, -2), mean, dirs)
    moved = torch.linalg.vector_norm(new - corners, dim=-1)
    ok = torch.isfinite(new).all(-1) & (moved < search_range + 0.5)
    return torch.where(ok[..., None], new, corners)
