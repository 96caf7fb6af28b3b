"""Wrappers of the quad-fit search kernel (csrc/quadfit.cu).

``fit_quads_from_moments`` is the CUDA path of the quad fit: the prefix
tables (torch.cat + torch.cumsum), then one fitting launch of
qf_search_kernel, which finds the corner candidates, searches the
4-subsets, fits the winner's lines and runs the epilogue (corners, gates,
winding) into the Quads fields. ``quad_search`` is the search alone (the
winner and its lines). Each checks its input, then on CPU tensors runs the
plain version (ops/quadfit.py::search_plain, fit_from_tables);
on CUDA tensors it launches the kernel or raises and adds one to
``launches``. Both launch on the current stream, with their outputs
allocated here by torch.empty and no host sync, so a detect call that runs
them can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import quadfit as plain
from ..quadfit import _NBINS, Quads, QuadSearch
from . import _lib

launches = 0    # qf_search_kernel launches made by quad_search and fit_quads_from_moments

_TABLES = 6     # w, x, y, xx, xy, yy


def _check_tables(S: torch.Tensor) -> int:
    """Raise unless S is contiguous float32 (N, 6, K+1) prefix tables of
    1 to 2^31 - 1 clusters on the CPU or a CUDA device; returns N."""
    if S.dtype != torch.float32 or S.ndim != 3 or S.shape[1:] != (_TABLES, _NBINS + 1):
        raise ValueError(f"S must be a float32 (N, {_TABLES}, {_NBINS + 1}) tensor, got "
                         f"{S.dtype} {tuple(S.shape)}")
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    N = S.shape[0]
    if not 1 <= N < 2 ** 31:
        raise ValueError(f"the search takes 1 to 2^31 - 1 clusters, got {N}")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {S.device}")
    return N


def quad_search(S: torch.Tensor) -> QuadSearch:
    """(N, 6, K+1) float32 prefix tables (ops/quadfit.py::prefix_tables) ->
    each cluster's QuadSearch, bit-exact with search_plain."""
    global launches
    N = _check_tables(S)
    if S.device.type == "cpu":
        return plain.search_plain(S)
    best = torch.empty(N, dtype=torch.int64, device=S.device)
    best_err = torch.empty(N, dtype=torch.float32, device=S.device)
    lines = torch.empty((_TABLES, N, 4), dtype=torch.float32, device=S.device)
    with torch.cuda.device(S.device):
        status = _lib.library().apriltag_quadfit_search(
            S.data_ptr(), best.data_ptr(), best_err.data_ptr(), lines.data_ptr(), N,
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_quadfit_search")
    launches += 1
    return QuadSearch(best, best_err, *lines.unbind(0))


def quad_fit(S: torch.Tensor, m, *, max_line_fit_mse: float = 10.0,
             critical_cos: float = 0.985, min_area: float = 64.0) -> Quads:
    """The fitting launch: (N, 6, K+1) float32 prefix tables of the
    ClusterMoments m (ops/quadfit.py::prefix_tables) -> the Quads, bit-exact
    with its plain version, ops/quadfit.py::fit_from_tables."""
    global launches
    N = _check_tables(S)
    lead = m.bw.shape[:-1]
    clusters = {"centroid": (m.centroid, torch.float32, (*lead, 2)),
                "scale": (m.scale, torch.float32, lead), "count": (m.count, torch.int32, lead),
                "valid": (m.valid, torch.bool, lead)}
    for name, (t, dtype, shape) in clusters.items():
        if t.dtype != dtype or t.shape != shape or t.device != S.device:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {S.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if lead.numel() != N:
        raise ValueError(f"{N} clusters' tables for {lead.numel()} clusters")
    kw = dict(max_line_fit_mse=max_line_fit_mse, critical_cos=critical_cos, min_area=min_area)
    if S.device.type == "cpu":
        return plain.fit_from_tables(S, m, **kw)
    dev = S.device
    corners = torch.empty((*lead, 4, 2), dtype=torch.float32, device=dev)
    valid = torch.empty(lead, dtype=torch.bool, device=dev)
    fit_err = torch.empty(lead, dtype=torch.float32, device=dev)
    gates = torch.empty((*lead, 7), dtype=torch.bool, device=dev)
    centroid, scale, count, cvalid = (t.contiguous() for t in (m.centroid, m.scale, m.count,
                                                                m.valid))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_quadfit_fit(
            S.data_ptr(), centroid.data_ptr(), scale.data_ptr(), count.data_ptr(),
            cvalid.data_ptr(), corners.data_ptr(), valid.data_ptr(), fit_err.data_ptr(),
            gates.data_ptr(), N, *(_lib.float_bits(v) for v in kw.values()),
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_quadfit_fit")
    launches += 1
    return Quads(corners=corners, valid=valid, dark_inside=m.dark_inside, fit_err=fit_err,
                 gates=gates)


def fit_quads_from_moments(m, *, max_line_fit_mse: float = 10.0,
                           critical_cos: float = 0.985, min_area: float = 64.0) -> Quads:
    """The plain version's signature and results (ops/quadfit.py::
    fit_quads_from_moments), bit for bit: the prefix tables, then one
    fitting launch (quad_fit)."""
    if m.bw.shape[-1] != _NBINS:
        raise ValueError(f"expected {_NBINS} bins, got {m.bw.shape[-1]}")
    return quad_fit(plain.prefix_tables(m), m, max_line_fit_mse=max_line_fit_mse,
                    critical_cos=critical_cos, min_area=min_area)
