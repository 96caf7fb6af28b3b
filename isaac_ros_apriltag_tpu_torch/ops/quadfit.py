"""Quad fitting: per-cluster angular-bin moments -> candidate quads.

Counterpart of ``isaac_ros_apriltag_tpu/ops/quadfit.py``: circular prefix
sums over K=64 angular bins, a +-2-bin line-fit error per bin, the top-10
circular local maxima as corner candidates, an exhaustive search over the
C(10,4) cyclic 4-subsets, re-fit lines -> corners, and geometric gates.
``lax.top_k`` (ties to the lower index) becomes a stable descending sort.
Every step works per cluster, so a batch of frames' clusters, (B, C, ...),
is fitted as one (B*C, ...) set of clusters.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.geometry import line_intersection

_NBINS = 64
_MAXIMA = 10
# All 4-subsets of the top-M maxima in cyclic (ascending angular) order.
_COMBOS = np.array(list(itertools.combinations(range(_MAXIMA), 4)), np.int64)


class Quads(NamedTuple):
    corners: torch.Tensor    # ([B,] C, 4, 2) float32 — pixel coords, cyclic order
    valid: torch.Tensor      # (C,) bool
    dark_inside: torch.Tensor  # (C,) bool
    fit_err: torch.Tensor    # (C,) float32 — total arc MSE of winning combo
    gates: torch.Tensor      # (C, 7) bool


def _arc_sums(S_list, a: torch.Tensor, b: torch.Tensor):
    """Sums of per-bin values over the circular bin range [a, b] inclusive
    for every (C, K+1) prefix table in S_list; b < a is an empty arc, b may
    pass K (wraps). One {-1, 0, 1} selector contraction per table, as in the
    reference."""
    C, K1 = S_list[0].shape
    K = K1 - 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    shape = (C,) + tuple(shape[1:])
    a = a.expand(shape).reshape(C, -1)
    b = b.expand(shape).reshape(C, -1)
    wrap = (b >= K)[..., None]
    iota = torch.arange(K1, device=a.device)
    ia = a.clamp(0, K)[..., None]
    ib = (b + 1).clamp(0, K)[..., None]
    iw = (b - K + 1).clamp(0, K)[..., None]
    f32 = torch.float32
    sel = torch.where(wrap,
                      (iota == iw).to(f32) - (iota == ia).to(f32) + (iota == K).to(f32),
                      (iota == ib).to(f32) - (iota == ia).to(f32))   # (C, P, K+1)
    return [torch.bmm(sel, S[:, :, None])[..., 0].reshape(shape) for S in S_list]


def _line_fit(msums: tuple, W: torch.Tensor):
    """Arc moment sums + weight -> (ex, ey, cxx, cxy, cyy, err), err being
    the smaller covariance eigenvalue."""
    Sx, Sy, Sxx, Sxy, Syy = msums
    Wf = torch.clamp(W, min=1e-6)
    ex, ey = Sx / Wf, Sy / Wf
    cxx = Sxx / Wf - ex * ex
    cxy = Sxy / Wf - ex * ey
    cyy = Syy / Wf - ey * ey
    disc = torch.sqrt(torch.clamp((cxx - cyy) ** 2 + 4 * cxy * cxy, min=0.0))
    err = 0.5 * (cxx + cyy - disc)
    return ex, ey, cxx, cxy, cyy, err


def _line_dir(cxx, cxy, cyy):
    """Principal direction (largest-eigenvalue eigenvector) of the 2x2 cov."""
    disc = torch.sqrt(torch.clamp((cxx - cyy) ** 2 + 4 * cxy * cxy, min=0.0))
    lam = 0.5 * (cxx + cyy + disc)
    v1 = torch.stack([cxy, lam - cxx], -1)
    v2 = torch.stack([lam - cyy, cxy], -1)
    n1 = (v1 * v1).sum(-1, keepdim=True)
    n2 = (v2 * v2).sum(-1, keepdim=True)
    v = torch.where(n1 > n2, v1, v2)
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-12))


def fit_quads_from_moments(m, *, max_line_fit_mse: float = 10.0,
                           critical_cos: float = 0.985,
                           min_area: float = 64.0) -> Quads:
    """Consumes ops.cluster_moments.ClusterMoments, of one frame (C, ...)
    or of a batch (B, C, ...); the quads have the same leading dims."""
    lead, K = m.bw.shape[:-1], m.bw.shape[-1]
    if K != _NBINS:
        raise ValueError(f"expected {_NBINS} bins, got {K}")
    B = [b.reshape(-1, K) for b in (m.bw, m.bx, m.by, m.bxx, m.bxy, m.byy)]
    centroid = m.centroid.reshape(-1, 2)
    n, cluster_valid = m.count.reshape(-1), m.valid.reshape(-1)
    C = centroid.shape[0]
    dev = centroid.device
    cx = centroid[:, 0:1]
    cy = centroid[:, 1:2]
    scale = torch.clamp(m.scale.reshape(C, 1), min=1e-6)     # (C, 1)
    zero = torch.zeros((C, 1), dtype=torch.float32, device=dev)
    S = [torch.cat([zero, torch.cumsum(b, -1)], -1) for b in B]
    Sw, Sx, Sy, Sxx, Sxy, Syy = S

    # --- per-bin corner error: line fit over a +-2-bin window ---------------
    kb = torch.arange(K, device=dev)[None, :]
    a = (kb - 2) % K
    *msums, Wn = _arc_sums((Sx, Sy, Sxx, Sxy, Syy, Sw), a, a + 4)
    *_, errs = _line_fit(tuple(msums), Wn)                      # (C, K)
    errs = torch.where(Wn >= 4.0, errs, -torch.inf)

    # --- circular local maxima -> top-M candidate bins ----------------------
    prev = torch.roll(errs, 1, -1)
    nxt = torch.roll(errs, -1, -1)
    is_max = (errs > prev) & (errs >= nxt) & torch.isfinite(errs)
    max_errs = torch.where(is_max, errs, -torch.inf)
    top_vals, top_idx = torch.sort(max_errs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :_MAXIMA], top_idx[:, :_MAXIMA]
    cand_valid = torch.isfinite(top_vals)
    cand_sorted = torch.sort(torch.where(cand_valid, top_idx, 2 * K), -1).values

    # --- score all 4-subsets -------------------------------------------------
    combos = torch.as_tensor(_COMBOS, device=dev)
    cidx = cand_sorted[:, combos]                               # (C, Ncomb, 4)
    combo_ok = torch.all(cidx < K, -1)
    c1 = torch.roll(cidx, -1, -1) + torch.where(torch.arange(4, device=dev) == 3, K, 0)
    arc_a = cidx + 1
    arc_b = c1 - 1
    nbins_arc = arc_b - arc_a + 1
    *msums, Wn = _arc_sums((Sx, Sy, Sxx, Sxy, Syy, Sw), arc_a, arc_b)
    ex, ey, cxx, cxy, cyy, aerr = _line_fit(tuple(msums), Wn)   # (C, Ncomb, 4)
    arc_ok = (nbins_arc >= 1) & (Wn >= 3.0)
    combo_err = torch.where(combo_ok & torch.all(arc_ok, -1), aerr.sum(-1), torch.inf)
    best = torch.argmin(combo_err, -1)                          # (C,)
    best_err = torch.gather(combo_err, 1, best[:, None])[:, 0]
    have_combo = torch.isfinite(best_err)

    def take(x):
        return torch.gather(x, 1, best[:, None, None].expand(C, 1, 4))[:, 0]

    ex, ey = take(ex), take(ey)
    cxx, cxy, cyy, aerr = take(cxx), take(cxy), take(cyy), take(aerr)

    # --- winning lines -> corners --------------------------------------------
    pts = torch.stack([ex, ey], -1)                             # (C, 4, 2)
    dirs = _line_dir(cxx, cxy, cyy)
    corners = line_intersection(torch.roll(pts, 1, 1), torch.roll(dirs, 1, 1), pts, dirs)
    corners = corners * scale[..., None] + torch.stack([cx, cy], -1)

    # --- gates ----------------------------------------------------------------
    scale2 = scale[..., 0] ** 2
    mse_ok = aerr.amax(-1) * scale2 <= max_line_fit_mse
    x0, y0 = corners[..., 0], corners[..., 1]
    x1, y1 = torch.roll(x0, -1, -1), torch.roll(y0, -1, -1)
    area2 = (x0 * y1 - x1 * y0).sum(-1)
    area_ok = 0.5 * area2.abs() >= min_area
    e_in = corners - torch.roll(corners, 1, 1)
    e_out = torch.roll(corners, -1, 1) - corners
    cosang = (e_in * e_out).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(e_in, dim=-1) * torch.linalg.vector_norm(e_out, dim=-1),
        min=1e-9)
    ang_ok = torch.all(cosang.abs() < critical_cos, -1)
    finite_ok = torch.isfinite(corners).all(-1).all(-1)
    gates = torch.stack([have_combo, mse_ok, area_ok, ang_ok, finite_ok,
                         n >= 8, cluster_valid], -1)
    valid = gates.all(-1)

    # Normalize winding: positive signed area (y-down CCW); reverse 1<->3.
    flip = corners[:, [0, 3, 2, 1]]
    corners = torch.where((area2 < 0)[:, None, None], flip, corners)
    return Quads(corners=corners.reshape(*lead, 4, 2), valid=valid.reshape(lead),
                 dark_inside=m.dark_inside, fit_err=(best_err * scale2).reshape(lead),
                 gates=gates.reshape(*lead, -1))
