"""The detector's picks within each frame: the top candidate quads before
refinement and decode, and the dedupe and top tags after decode.

Counterparts of the inline steps of ``isaac_ros_apriltag_tpu/detector.py``
(`_detect_from_clusters`, and `_dedupe` at :80), on a batch (B, N, ...).
``select_and_refine`` (``select_candidates``, then ops/refine.py::
refine_edges) and ``finish_detections`` are the plain versions of
csrc/tail.cu's refine_kernel and tail_finish_kernel, bit for bit:
every float step is elementwise and in the kernels' order (sums over the
four corners in index order, norms sqrt(x*x + y*y)), and a top-k is
torch.sort(descending=True, stable=True): NaN first, ties to the lower
index, as the kernels' ranks count them. ``lax.top_k`` takes ties the same
way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.geometry import line_intersection
from .decode import DecodeResult
from .refine import refine_edges


class Candidates(NamedTuple):
    """The top quads of each frame by fit quality, best first."""
    corners: torch.Tensor      # (B, K, 4, 2) float32, full-resolution pixels
    dark_inside: torch.Tensor  # (B, K) bool
    pre_valid: torch.Tensor    # (B, K) bool: a valid quad of the wanted polarity
    num_quads: torch.Tensor    # (B,) int32: such quads in the frame


class RefinedCandidates(NamedTuple):
    """The top quads of each frame by fit quality, best first, refined."""
    corners: torch.Tensor      # (B, K, 4, 2) float32: refined full-resolution corners
    pre_valid: torch.Tensor    # (B, K) bool: a valid quad of the wanted polarity
    num_quads: torch.Tensor    # (B,) int32: such quads in the frame


class Selection(NamedTuple):
    """The top decoded tags of each frame by decision margin, best first."""
    valid: torch.Tensor        # (B, T) bool
    id: torch.Tensor           # (B, T) int32, -1 where not valid
    hamming: torch.Tensor      # (B, T) int32
    margin: torch.Tensor       # (B, T) float32
    center: torch.Tensor       # (B, T, 2) float32: the diagonals' intersection
    corners: torch.Tensor      # (B, T, 4, 2) float32
    num_detections: torch.Tensor  # (B,) int32
    overflow: torch.Tensor     # (B,) bool


def upscale_coords(xy: torch.Tensor, d: int) -> torch.Tensor:
    """Decimated-image pixel coords -> full-resolution pixel coords."""
    if d == 1:
        return xy
    return xy * d + (d - 1) / 2.0


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i], ...] for x (B, N, ...) and idx (B, k)."""
    B, k = idx.shape
    trail = x.shape[2:]
    return torch.gather(x, 1, idx.reshape(B, k, *[1] * len(trail)).expand(B, k, *trail))


def top(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame top-k of (B, N) like lax.top_k: descending, ties to the
    lower index (NaN first)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _sum4(t: torch.Tensor) -> torch.Tensor:
    """((t0 + t1) + t2) + t3 over the last dim (the four corners)."""
    return ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]


def _edge_lengths(corners: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) -> (..., 4): edge k runs from corner k - 1 to corner k."""
    e = corners - torch.roll(corners, 1, -2)
    return torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])


def select_candidates(corners: torch.Tensor, valid: torch.Tensor, dark_inside: torch.Tensor,
                      fit_err: torch.Tensor, *, want_dark: bool, k: int,
                      decimate: int) -> Candidates:
    """(B, C) fitted quads -> the top k of each frame by perimeter / (1 +
    fit error) among the valid quads whose dark side is `want_dark` (the
    rest score -inf), with their corners upscaled from the decimated image
    (`decimate`) to full resolution."""
    qvalid = valid & (dark_inside == want_dark)
    score = torch.where(qvalid, _sum4(_edge_lengths(corners)) / (1.0 + fit_err), -torch.inf)
    top_s, top_i = top(score, k)
    return Candidates(corners=upscale_coords(take(corners, top_i), decimate),
                      dark_inside=take(dark_inside, top_i), pre_valid=torch.isfinite(top_s),
                      num_quads=qvalid.sum(-1).to(torch.int32))


def select_and_refine(gray: torch.Tensor, corners: torch.Tensor, valid: torch.Tensor,
                      dark_inside: torch.Tensor, fit_err: torch.Tensor, *, want_dark: bool,
                      k: int, decimate: int, search_range: float) -> RefinedCandidates:
    """select_candidates, then refine_edges of the picked quads on the
    (B, H, W) float32 gray frames: the plain version of csrc/tail.cu's
    refine_kernel, which makes both in one launch."""
    cand = select_candidates(corners, valid, dark_inside, fit_err, want_dark=want_dark, k=k,
                             decimate=decimate)
    return RefinedCandidates(corners=refine_edges(gray, cand.corners, cand.dark_inside,
                                                  search_range=search_range),
                             pre_valid=cand.pre_valid, num_quads=cand.num_quads)


def finish_detections(dec: DecodeResult, pre_valid: torch.Tensor, num_quads: torch.Tensor,
                      overflow: torch.Tensor, *, k: int,
                      min_decision_margin: float) -> Selection:
    """(B, N) decoded candidates -> each frame's top k tags by decision
    margin. A candidate counts where it was a valid quad (`pre_valid`),
    decoded and has a margin of at least `min_decision_margin`; then
    candidate j is suppressed where a better candidate i (a larger margin,
    or an equal one at a lower index) of the same id lies near it (centers
    closer than 0.75 of the larger mean edge length). `overflow` is the
    cluster stage's, ORed with more valid quads than candidates."""
    N = pre_valid.shape[-1]
    valid = pre_valid & dec.valid & (dec.margin >= min_decision_margin)
    c = dec.corners
    cx, cy = _sum4(c[..., 0]) * 0.25, _sum4(c[..., 1]) * 0.25          # (B, N)
    edge = _sum4(_edge_lengths(c)) * 0.25
    dx = cx[:, :, None] - cx[:, None, :]                              # (B, i, j)
    dy = cy[:, :, None] - cy[:, None, :]
    near = torch.sqrt(dx * dx + dy * dy) < 0.75 * torch.maximum(edge[:, :, None],
                                                                 edge[:, None, :])
    same = dec.id[:, :, None] == dec.id[:, None, :]
    both = valid[:, :, None] & valid[:, None, :]
    m = dec.margin
    idx = torch.arange(N, device=m.device)
    better = (m[:, :, None] > m[:, None, :]) | (
        (m[:, :, None] == m[:, None, :]) & (idx[:, None] < idx[None, :]))
    valid = valid & ~torch.any(near & same & both & better, 1)

    top_s, top_f = top(torch.where(valid, m, -torch.inf), k)
    sel_valid = torch.isfinite(top_s)
    corners = take(c, top_f)
    c0, c1, c2, c3 = corners.unbind(-2)
    return Selection(valid=sel_valid, id=torch.where(sel_valid, take(dec.id, top_f), -1),
                     hamming=take(dec.hamming, top_f), margin=take(m, top_f),
                     center=line_intersection(c0, c2 - c0, c1, c3 - c1), corners=corners,
                     num_detections=sel_valid.sum(-1).to(torch.int32),
                     overflow=overflow | (num_quads > N))
