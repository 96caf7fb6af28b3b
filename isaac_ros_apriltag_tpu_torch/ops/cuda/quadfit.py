"""Wrapper of the quad-fit search kernel (csrc/quadfit.cu).

``fit_quads_from_moments`` is the CUDA path of the quad fit: the prefix
tables (torch.cat + torch.cumsum), one launch of qf_search_kernel for the
corner candidates, the 4-subset search and the winner's line fits, then
the plain version's torch ops on the (N, 4) winners (line directions,
intersections, gates, winding). ``quad_search`` checks its input, then on
a CPU tensor runs the plain version (ops/quadfit.py::search_plain); on a
CUDA tensor it launches the kernel or raises and adds one to ``launches``.
It launches on the current stream, with its outputs allocated here by
torch.empty and no host sync, so a detect call that runs it can be captured
in a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import quadfit as plain
from ..quadfit import _NBINS, Quads, QuadSearch
from . import _lib

launches = 0    # qf_search_kernel launches made by quad_search

_TABLES = 6     # w, x, y, xx, xy, yy


def quad_search(S: torch.Tensor) -> QuadSearch:
    """(N, 6, K+1) float32 prefix tables (ops/quadfit.py::prefix_tables) ->
    each cluster's QuadSearch, bit-exact with search_plain."""
    global launches
    if S.dtype != torch.float32 or S.ndim != 3 or S.shape[1:] != (_TABLES, _NBINS + 1):
        raise ValueError(f"S must be a float32 (N, {_TABLES}, {_NBINS + 1}) tensor, got "
                         f"{S.dtype} {tuple(S.shape)}")
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    N = S.shape[0]
    if not 1 <= N < 2 ** 31:
        raise ValueError(f"the search takes 1 to 2^31 - 1 clusters, got {N}")
    if S.device.type == "cpu":
        return plain.search_plain(S)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
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


def fit_quads_from_moments(m, *, max_line_fit_mse: float = 10.0,
                           critical_cos: float = 0.985, min_area: float = 64.0) -> Quads:
    """The plain version's signature and results (ops/quadfit.py::
    fit_quads_from_moments), its search on the kernel: bit-exact with it."""
    return plain.fit_quads_from_moments(m, max_line_fit_mse=max_line_fit_mse,
                                        critical_cos=critical_cos, min_area=min_area,
                                        search=quad_search)
