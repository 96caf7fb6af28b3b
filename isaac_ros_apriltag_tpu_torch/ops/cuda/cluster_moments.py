"""Wrappers of the cluster-moment kernels (csrc/cluster_moments.cu).

``extract_cluster_moments`` is the CUDA path of the stage: the pair-count
and pair kernels, one stable torch.sort of the keys, the segments kernel
(segment sizes, the size gate, the top-C) and the moments kernel (one block
a frame and slot: centroid, scale, dark side and the bin tables). A CPU
tensor runs the plain version (ops/cluster_moments.py::
extract_cluster_moments); a CUDA tensor launches the kernels or raises.
Each kernel's wrapper adds one to its own counter where it launches; on a
CPU tensor it runs that kernel's plain version, also in
ops/cluster_moments.py. Every launch goes on the current stream, with
outputs and scratch allocated here by torch.empty and no host sync, so the
stage can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from .. import cluster_moments as plain
from ..batch import batch_first, first_frame
from ..cluster_moments import NBINS, ClusterMoments, SlotMoments, TopSegments
from . import _lib

count_launches = 0      # cm_edge_count_kernel launches made by edge_count
pairs_launches = 0      # cm_edge_pairs_kernel launches made by edge_pairs
segments_launches = 0   # cm_segments_kernel launches made by top_segments
moments_launches = 0    # cm_moments_kernel launches made by slot_moments


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_front(trinary: torch.Tensor, dense: torch.Tensor) -> tuple[int, int, int]:
    """Raise on what the pair kernels do not take; return (B, H, W)."""
    if trinary.device.type != "cuda" or dense.device != trinary.device:
        raise ValueError("trinary and dense must lie on the same CUDA device")
    if trinary.dtype != torch.uint8 or dense.dtype != torch.int32:
        raise ValueError("trinary must be uint8 and dense int32")
    if trinary.ndim != 3 or trinary.shape != dense.shape or trinary.numel() == 0:
        raise ValueError("trinary and dense must be non-empty (B, H, W) tensors of one shape")
    if not (trinary.is_contiguous() and dense.is_contiguous()):
        raise ValueError("trinary and dense must be contiguous")
    B, H, W = trinary.shape
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    return B, H, W


def edge_count(trinary: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 trinary + int32 dense ids -> (B,) int32 pairs a frame
    before decimation."""
    global count_launches
    if trinary.device.type == "cpu":
        return plain.edge_count_plain(trinary, dense)
    B, H, W = _check_front(trinary, dense)
    num_edge = torch.zeros(B, dtype=torch.int32, device=trinary.device)
    with torch.cuda.device(trinary.device):
        status = _lib.library().apriltag_cm_count(trinary.data_ptr(), dense.data_ptr(),
                                                  num_edge.data_ptr(), B, H, W, _stream())
    _lib.check(status, "apriltag_cm_count")
    count_launches += 1
    return num_edge


def edge_pairs(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor,
               E: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((B, 4 H W) int32 keys decimated to the budget E, int32 pays),
    offset-major."""
    global pairs_launches
    if trinary.device.type == "cpu":
        return plain.edge_pairs_plain(trinary, dense, num_edge, E)
    B, H, W = _check_front(trinary, dense)
    if num_edge.shape != (B,) or num_edge.dtype != torch.int32 or num_edge.device != trinary.device:
        raise ValueError("num_edge must be a (B,) int32 tensor on the frames' device")
    if (9 * E) // 10 < 1:
        raise ValueError(f"the pair budget E={E} is under 2")
    key = torch.empty((B, 4 * H * W), dtype=torch.int32, device=trinary.device)
    pay = torch.empty_like(key)
    with torch.cuda.device(trinary.device):
        status = _lib.library().apriltag_cm_pairs(
            trinary.data_ptr(), dense.data_ptr(), num_edge.data_ptr(), key.data_ptr(),
            pay.data_ptr(), B, H, W, (9 * E) // 10, _stream())
    _lib.check(status, "apriltag_cm_pairs")
    pairs_launches += 1
    return key, pay


def top_segments(key_s: torch.Tensor, num_edge: torch.Tensor, comp_overflow: torch.Tensor, *,
                 E: int, E2: int, max_clusters: int, min_cluster_pixels: int,
                 max_perimeter: int) -> TopSegments:
    """(B, N >= E) int32 sorted keys -> each frame's top-C segments, counts,
    stride and overflow (ops/cluster_moments.py::TopSegments)."""
    global segments_launches
    kw = dict(E=E, E2=E2, max_clusters=max_clusters, min_cluster_pixels=min_cluster_pixels,
              max_perimeter=max_perimeter)
    if key_s.device.type == "cpu":
        return plain.top_segments_plain(key_s, num_edge, comp_overflow, **kw)
    dev = key_s.device
    if key_s.ndim != 2 or key_s.dtype != torch.int32 or not key_s.is_contiguous():
        raise ValueError("key_s must be a contiguous (B, N) int32 tensor")
    B, N = key_s.shape
    if not 1 <= E <= N or key_s.data_ptr() % 16 or N % 4:
        raise ValueError("key_s must hold E keys a row, rows of a multiple of 4 keys "
                         "starting 16-byte aligned")
    if not 1 <= max_clusters <= 128 or (9 * E) // 10 < 1:
        raise ValueError("max_clusters must be in [1, 128] and E at least 2")
    for name, t, dt in (("num_edge", num_edge, torch.int32),
                        ("comp_overflow", comp_overflow, torch.bool)):
        if t.shape != (B,) or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B},) {dt} tensor on {dev}")
    C = max_clusters
    i32 = dict(dtype=torch.int32, device=dev)
    cand = torch.empty((2, B, E), **i32)
    top_pos, count = torch.empty((B, C), **i32), torch.empty((B, C), **i32)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    n_clusters, n_eligible, stride = (torch.empty(B, **i32) for _ in range(3))
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_segments(
            key_s.data_ptr(), num_edge.data_ptr(), comp_overflow.data_ptr(), cand[0].data_ptr(),
            cand[1].data_ptr(), top_pos.data_ptr(), count.data_ptr(), valid.data_ptr(),
            n_clusters.data_ptr(), n_eligible.data_ptr(), stride.data_ptr(),
            overflow.data_ptr(), B, N, E, E2, C, min_cluster_pixels, max_perimeter,
            (9 * E) // 10, _stream())
    _lib.check(status, "apriltag_cm_segments")
    segments_launches += 1
    return TopSegments(top_pos=top_pos, count=count, valid=valid, num_clusters=n_clusters,
                       num_eligible=n_eligible, edge_stride=stride, overflow=overflow)


def slot_moments(perm: torch.Tensor, pay: torch.Tensor, top_pos: torch.Tensor,
                 count: torch.Tensor, E2: int) -> SlotMoments:
    """(B, N) int64 sort permutation, (B, N) int32 pays, (B, C) int32 top-C
    starts and sizes -> each slot's bin tables, centroid, scale and dark
    side over its E2-resident pairs (ops/cluster_moments.py::SlotMoments)."""
    global moments_launches
    if perm.device.type == "cpu":
        return plain.slot_moments_plain(perm, pay, top_pos, count, E2)
    dev = perm.device
    if (perm.ndim != 2 or perm.dtype != torch.int64 or pay.shape != perm.shape
            or pay.dtype != torch.int32 or not (perm.is_contiguous() and pay.is_contiguous())):
        raise ValueError("perm must be a contiguous (B, N) int64 tensor and pay int32 of its shape")
    B, N = perm.shape
    C = count.shape[-1]
    for name, t in (("top_pos", top_pos), ("count", count)):
        if t.shape != (B, C) or t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B}, C) int32 tensor on {dev}")
    if pay.device != dev or not 1 <= C <= 128:
        raise ValueError("pay must lie on perm's device, and C must be in [1, 128]")
    f32 = dict(dtype=torch.float32, device=dev)
    table = torch.empty((B, C, NBINS, 6), **f32)
    centroid, scale = torch.empty((B, C, 2), **f32), torch.empty((B, C), **f32)
    dark = torch.empty((B, C), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_moments(
            perm.data_ptr(), pay.data_ptr(), top_pos.data_ptr(), count.data_ptr(),
            table.data_ptr(), centroid.data_ptr(), scale.data_ptr(), dark.data_ptr(), B, N, C,
            E2, _stream())
    _lib.check(status, "apriltag_cm_moments")
    moments_launches += 1
    return SlotMoments(table=table, centroid=centroid, scale=scale, dark_inside=dark)


def extract_cluster_moments(trinary: torch.Tensor, dense: torch.Tensor, *,
                            comp_overflow: torch.Tensor, max_edge_points: int,
                            max_clusters: int, min_cluster_pixels: int,
                            max_cluster_points: int = 1024) -> ClusterMoments:
    """The plain version's signature and results: (B, H, W) or (H, W)
    trinary and dense ids -> ClusterMoments. On the card: the integer
    outputs, centroid and scale bit-exact with the plain version, the bin
    tables within an f32 rounding of its f64 sums."""
    plain.check_shapes(*trinary.shape[-2:], max_clusters)
    if trinary.device.type == "cpu":
        return plain.extract_cluster_moments(
            trinary, dense, comp_overflow=comp_overflow, max_edge_points=max_edge_points,
            max_clusters=max_clusters, min_cluster_pixels=min_cluster_pixels,
            max_cluster_points=max_cluster_points)
    if trinary.device.type != "cuda":
        raise ValueError(f"unsupported device {trinary.device}")
    trinary, single = batch_first(trinary, 2)
    dense, _ = batch_first(dense, 2)
    B, H, W = trinary.shape
    E = min(max_edge_points, 4 * H * W)
    if E < max_clusters:
        raise ValueError(f"the pair budget {E} must hold max_clusters={max_clusters} pairs")
    E2 = min(max_clusters * max_cluster_points, E)
    trinary, dense = trinary.contiguous(), dense.to(torch.int32).contiguous()
    comp_overflow = comp_overflow.to(torch.bool).expand(B).contiguous()
    num_edge = edge_count(trinary, dense)
    key, pay = edge_pairs(trinary, dense, num_edge, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    seg = top_segments(key_s, num_edge, comp_overflow, E=E, E2=E2, max_clusters=max_clusters,
                       min_cluster_pixels=min_cluster_pixels, max_perimeter=4 * (W + H))
    mom = slot_moments(perm, pay, seg.top_pos, seg.count, E2)
    bw, bx, by, bxx, bxy, byy = (mom.table[..., i] for i in range(6))
    out = ClusterMoments(
        bw=bw, bx=bx, by=by, bxx=bxx, bxy=bxy, byy=byy, count=seg.count,
        centroid=mom.centroid, scale=mom.scale, dark_inside=mom.dark_inside, valid=seg.valid,
        num_clusters=seg.num_clusters, num_eligible=seg.num_eligible,
        num_edge_points=num_edge, edge_stride=seg.edge_stride, overflow=seg.overflow)
    return first_frame(out) if single else out
