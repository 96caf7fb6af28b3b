"""Quad fitting: per-cluster angular-bin moments -> candidate quads.

Counterpart of ``isaac_ros_apriltag_tpu/ops/quadfit.py``: circular prefix
sums over K=64 angular bins, a +-2-bin line-fit error per bin, the top-10
circular local maxima as corner candidates, an exhaustive search over the
C(10,4) cyclic 4-subsets, re-fit lines -> corners, and geometric gates.
``lax.top_k`` (ties to the lower index) becomes a stable descending sort.
Every step works per cluster, so a batch of frames' clusters, (B, C, ...),
is fitted as one (B*C, ...) set of clusters.

The reference reads an arc's sum from the prefix tables through a {-1, 0,
1} selector contraction, since per-element gathers serialize on a TPU;
here the two or three entries are gathered and added in one fixed order
(``_arc_sums``), and every other float step is written in the order the
CUDA kernel (csrc/quadfit.cu) takes, so ``search_plain`` is that kernel's
plain version bit for bit, and ``fit_epilogue`` (the winners' lines ->
corners, gates and winding) that of the kernel's fitting launch.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.geometry import line_intersection

_NBINS = 64
_MAXIMA = 10
# All 4-subsets of the top-M maxima in cyclic (ascending angular) order.
_COMBOS = np.array(list(itertools.combinations(range(_MAXIMA), 4)), np.int64)


@functools.lru_cache(maxsize=None)
def _combos(device: torch.device) -> torch.Tensor:
    """_COMBOS on `device`, uploaded once (a copy from numpy memory at every
    call would make the host wait for the device's queue)."""
    return torch.as_tensor(_COMBOS, device=device)


class Quads(NamedTuple):
    corners: torch.Tensor    # ([B,] C, 4, 2) float32 — pixel coords, cyclic order
    valid: torch.Tensor      # (C,) bool
    dark_inside: torch.Tensor  # (C,) bool
    fit_err: torch.Tensor    # (C,) float32 — total arc MSE of winning combo
    gates: torch.Tensor      # (C, 7) bool


class QuadSearch(NamedTuple):
    """The 4-subset search of N clusters: the winning combo (an index into
    _COMBOS; 0 where none is valid), its total arc error (inf where none is
    valid) and its four arcs' line fits, arc j running from corner j to
    corner j + 1."""
    best: torch.Tensor       # (N,) int64
    best_err: torch.Tensor   # (N,) float32
    ex: torch.Tensor         # (N, 4) float32 each: arc centroid,
    ey: torch.Tensor
    cxx: torch.Tensor        # covariance,
    cxy: torch.Tensor
    cyy: torch.Tensor
    aerr: torch.Tensor       # and smaller eigenvalue (the arc's MSE)


def prefix_tables(m) -> torch.Tensor:
    """ClusterMoments of (C, ...) or (B, C, ...) -> (N, 6, K+1) float32
    circular prefix sums of the bin tables w, x, y, xx, xy, yy, N = B*C."""
    K = m.bw.shape[-1]
    b = torch.stack([t.reshape(-1, K) for t in (m.bw, m.bx, m.by, m.bxx, m.bxy, m.byy)], 1)
    zero = torch.zeros((*b.shape[:2], 1), dtype=torch.float32, device=b.device)
    return torch.cat([zero, torch.cumsum(b, -1)], -1)


def _arc_sums(S: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Sums of each of the (N, 6, K+1) prefix tables' bins over the circular
    bin range [a, b] inclusive; a, b broadcast to (N, ...); b < a is an empty
    arc, b may pass K (wraps). A direct arc is S[ib] - S[ia]; a wrapped one
    (S[K] - S[ia]) + S[iw], exactly S[iw] where ia == K and exactly S[K]
    where iw == ia (the reference's selector coefficients). Returns the six
    (N, ...) sums w, x, y, xx, xy, yy."""
    N, T, K1 = S.shape
    K = K1 - 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    shape = (N,) + tuple(shape[1:])
    a = a.expand(shape).reshape(N, 1, -1)
    b = b.expand(shape).reshape(N, 1, -1)
    ia = a.clamp(0, K)
    ib = (b + 1).clamp(0, K)
    iw = (b - K + 1).clamp(0, K)

    def at(i):
        return torch.gather(S, 2, i.expand(N, T, i.shape[-1]))

    Sa, Sw, SK = at(ia), at(iw), S[..., K:]
    wrapped = torch.where(ia == K, Sw, torch.where(iw == ia, SK, (SK - Sa) + Sw))
    sums = torch.where(b >= K, wrapped, at(ib) - Sa)
    return sums.reshape(N, T, *shape[1:]).unbind(1)


def _line_fit(msums: tuple, W: torch.Tensor):
    """Arc moment sums + weight -> (ex, ey, cxx, cxy, cyy, err), err being
    the smaller covariance eigenvalue."""
    Sx, Sy, Sxx, Sxy, Syy = msums
    Wf = torch.clamp(W, min=1e-6)
    ex, ey = Sx / Wf, Sy / Wf
    cxx = Sxx / Wf - ex * ex
    cxy = Sxy / Wf - ex * ey
    cyy = Syy / Wf - ey * ey
    disc = torch.sqrt(torch.clamp((cxx - cyy) ** 2 + (4 * cxy) * cxy, min=0.0))
    err = 0.5 * ((cxx + cyy) - disc)
    return ex, ey, cxx, cxy, cyy, err


def candidates(S: torch.Tensor) -> torch.Tensor:
    """(N, 6, K+1) prefix tables -> (N, M) corner candidate bins, ascending,
    2K past the last: the circular local maxima of the +-2-bin line-fit
    error, the M largest (ties to the lower bin)."""
    K = S.shape[-1] - 1
    kb = torch.arange(K, device=S.device)[None, :]
    a = (kb - 2) % K
    Wn, *msums = _arc_sums(S, a, a + 4)
    *_, errs = _line_fit(tuple(msums), Wn)                      # (N, K)
    errs = torch.where(Wn >= 4.0, errs, -torch.inf)
    prev = torch.roll(errs, 1, -1)
    nxt = torch.roll(errs, -1, -1)
    is_max = (errs > prev) & (errs >= nxt) & torch.isfinite(errs)
    max_errs = torch.where(is_max, errs, -torch.inf)
    top_vals, top_idx = torch.sort(max_errs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :_MAXIMA], top_idx[:, :_MAXIMA]
    cand_valid = torch.isfinite(top_vals)
    return torch.sort(torch.where(cand_valid, top_idx, 2 * K), -1).values


def search_plain(S: torch.Tensor) -> QuadSearch:
    """(N, 6, K+1) prefix tables -> the best cyclic 4-subset of each
    cluster's candidates by total arc line-fit error (argmin: NaN first,
    ties to the lower combo). The plain version of csrc/quadfit.cu."""
    K = S.shape[-1] - 1
    dev = S.device
    cidx = candidates(S)[:, _combos(dev)]                        # (N, Ncomb, 4)
    combo_ok = torch.all(cidx < K, -1)
    c1 = torch.roll(cidx, -1, -1) + torch.where(torch.arange(4, device=dev) == 3, K, 0)
    arc_a = cidx + 1
    arc_b = c1 - 1
    nbins_arc = arc_b - arc_a + 1
    Wn, *msums = _arc_sums(S, arc_a, arc_b)
    ex, ey, cxx, cxy, cyy, aerr = _line_fit(tuple(msums), Wn)   # (N, Ncomb, 4)
    arc_ok = (nbins_arc >= 1) & (Wn >= 3.0)
    a0, a1, a2, a3 = aerr.unbind(-1)
    combo_err = torch.where(combo_ok & torch.all(arc_ok, -1), ((a0 + a1) + a2) + a3,
                            torch.inf)
    best = torch.argmin(combo_err, -1)                          # (N,)
    best_err = torch.gather(combo_err, 1, best[:, None])[:, 0]
    N = S.shape[0]

    def take(x):
        return torch.gather(x, 1, best[:, None, None].expand(N, 1, 4))[:, 0]

    return QuadSearch(best, best_err, *(take(x) for x in (ex, ey, cxx, cxy, cyy, aerr)))


def _line_dir(cxx, cxy, cyy):
    """Principal direction (largest-eigenvalue eigenvector) of the 2x2 cov,
    as (x, y)."""
    dd = cxx - cyy
    disc = torch.sqrt(torch.clamp(dd * dd + (4 * cxy) * cxy, min=0.0))
    lam = 0.5 * ((cxx + cyy) + disc)
    v1x, v1y = cxy, lam - cxx
    v2x, v2y = lam - cyy, cxy
    pick = v1x * v1x + v1y * v1y > v2x * v2x + v2y * v2y
    vx, vy = torch.where(pick, v1x, v2x), torch.where(pick, v1y, v2y)
    vn = torch.sqrt(torch.clamp(vx * vx + vy * vy, min=1e-12))
    return vx / vn, vy / vn


def fit_epilogue(q: QuadSearch, centroid: torch.Tensor, scale: torch.Tensor,
                 count: torch.Tensor, cluster_valid: torch.Tensor, *,
                 max_line_fit_mse: float = 10.0, critical_cos: float = 0.985,
                 min_area: float = 64.0) -> tuple[torch.Tensor, ...]:
    """The winners' lines of N clusters -> (corners (N, 4, 2), valid (N,),
    fit_err (N,), gates (N, 7)): the line directions, the corners as the
    intersections of adjacent lines in the cluster's frame, the geometric
    gates and the winding. centroid (N, 2), scale (N,), count (N,) and
    cluster_valid (N,) are the clusters'. The plain version of the epilogue
    of csrc/quadfit.cu's fitting launch, bit for bit: elementwise, every sum
    over the four corners written out in index order."""
    have_combo = torch.isfinite(q.best_err)
    s = torch.clamp(scale, min=1e-6)[:, None]                   # (N, 1)
    dx, dy = _line_dir(q.cxx, q.cxy, q.cyy)                     # (N, 4) each
    pts = torch.stack([q.ex, q.ey], -1)
    dirs = torch.stack([dx, dy], -1)
    corners = line_intersection(torch.roll(pts, 1, 1), torch.roll(dirs, 1, 1), pts, dirs)
    x0 = corners[..., 0] * s + centroid[:, 0:1]                 # (N, 4)
    y0 = corners[..., 1] * s + centroid[:, 1:2]
    x1, y1 = torch.roll(x0, -1, -1), torch.roll(y0, -1, -1)

    scale2 = s[:, 0] * s[:, 0]
    a = q.aerr
    amax = torch.maximum(torch.maximum(torch.maximum(a[:, 0], a[:, 1]), a[:, 2]), a[:, 3])
    mse_ok = amax * scale2 <= max_line_fit_mse
    t = x0 * y1 - x1 * y0
    area2 = ((t[:, 0] + t[:, 1]) + t[:, 2]) + t[:, 3]
    area_ok = 0.5 * area2.abs() >= min_area
    # Corner k's incoming edge (from k - 1) and outgoing edge (to k + 1).
    ix, iy = x0 - torch.roll(x0, 1, -1), y0 - torch.roll(y0, 1, -1)
    ox, oy = x1 - x0, y1 - y0
    cosang = (ix * ox + iy * oy) / torch.clamp(
        torch.sqrt(ix * ix + iy * iy) * torch.sqrt(ox * ox + oy * oy), min=1e-9)
    ang_ok = torch.all(cosang.abs() < critical_cos, -1)
    finite_ok = torch.all(torch.isfinite(x0) & torch.isfinite(y0), -1)
    gates = torch.stack([have_combo, mse_ok, area_ok, ang_ok, finite_ok,
                         count >= 8, cluster_valid], -1)
    valid = gates.all(-1)

    # Normalize winding: positive signed area (y-down CCW); reverse 1<->3.
    # Corners (0, 3, 2, 1) by flip and roll: an index list would be copied
    # to the device, and the host would wait for it.
    corners = torch.stack([x0, y0], -1)
    flip = torch.roll(torch.flip(corners, (1,)), 1, 1)
    corners = torch.where((area2 < 0)[:, None, None], flip, corners)
    return corners, valid, q.best_err * scale2, gates


def fit_from_tables(S: torch.Tensor, m, *, max_line_fit_mse: float = 10.0,
                    critical_cos: float = 0.985, min_area: float = 64.0) -> Quads:
    """The prefix tables S of the ClusterMoments m -> its Quads: search_plain,
    then fit_epilogue (ops/cuda/quadfit.py::quad_fit runs both in one
    launch)."""
    lead = m.bw.shape[:-1]
    corners, valid, fit_err, gates = fit_epilogue(
        search_plain(S), m.centroid.reshape(-1, 2), m.scale.reshape(-1), m.count.reshape(-1),
        m.valid.reshape(-1), max_line_fit_mse=max_line_fit_mse, critical_cos=critical_cos,
        min_area=min_area)
    return Quads(corners=corners.reshape(*lead, 4, 2), valid=valid.reshape(lead),
                 dark_inside=m.dark_inside, fit_err=fit_err.reshape(lead),
                 gates=gates.reshape(*lead, -1))


def fit_quads_from_moments(m, *, max_line_fit_mse: float = 10.0,
                           critical_cos: float = 0.985, min_area: float = 64.0) -> Quads:
    """Consumes ops.cluster_moments.ClusterMoments, of one frame (C, ...)
    or of a batch (B, C, ...); the quads have the same leading dims."""
    if m.bw.shape[-1] != _NBINS:
        raise ValueError(f"expected {_NBINS} bins, got {m.bw.shape[-1]}")
    return fit_from_tables(prefix_tables(m), m, max_line_fit_mse=max_line_fit_mse,
                           critical_cos=critical_cos, min_area=min_area)
