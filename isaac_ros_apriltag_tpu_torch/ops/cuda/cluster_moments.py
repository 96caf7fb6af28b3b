"""Wrappers of the cluster-moment kernels (csrc/cluster_moments.cu).

``extract_cluster_moments`` is the CUDA path of the stage, nine launches in
this order: the pair-count kernel (``edge_count``: num_edge, four pixels
a thread, a fixed grid of one wave); the kept
pairs' sort (``sort_pairs``): the histogram pass (``pair_count``: each
frame's kept count K, every radix pass's digit counts, the first pass's by
offset, and each first-pass tile's counts and their sums over groups of
tiles) and SORT_PASSES stable radix passes, one launch a digit
(``radix_first``: the first, which builds the pairs from the pixels, takes
each tile's place from the histogram pass's tile counts and group sums,
writes the pairs in its order and zeroes pass 1's look-back words;
``radix_scatter``: the later ones, ping-pong between two row pairs, the
last filling [K, E) with int32 max); the two
segment kernels (``segment_tiles``, many blocks a frame: segment sizes, the
size gate, each tile's candidates and a size histogram; ``segment_top``,
one block a frame: the segments that cross tiles, the top-C; together
``top_segments``) and the moments kernel (a power of two of warps a slot,
sized to its pairs, packed into 8-warp blocks: centroid, scale, dark side
and the bin tables, from the pays the sort left beside the keys). No
torch.sort runs. A CPU tensor runs the plain version
(ops/cluster_moments.py::extract_cluster_moments); a CUDA tensor launches
the kernels or raises. Each kernel's wrapper adds one to its own counter
where it launches; on a CPU tensor it runs that kernel's plain version, also
in ops/cluster_moments.py. Every launch goes on the current stream, with
outputs, scratch and the sort's ping-pong rows allocated here by torch.empty
(the sort's counters and digit counts zeroed by one memset) and no host
sync, so the stage can be captured in a CUDA graph: the grids are sized for
the padded rows and the frames' work follows their kept counts on the card.
"""

from __future__ import annotations

import torch

from .. import cluster_moments as plain
from ..batch import batch_first, first_frame
from ..cluster_moments import (FIRST_DIGITS, FIRST_GROUP, NBINS, PAIR_BLOCK, RADIX, SEG_TILE,
                               SORT_PASSES, ClusterMoments, PairTiles, SegmentTiles, SlotMoments,
                               SortRows, TopSegments, sort_tile)
from . import _lib

count_launches = 0        # cm_edge_count_kernel launches made by edge_count
pair_count_launches = 0   # cm_pair_count_kernel launches made by pair_count
scatter_launches = 0      # cm_radix_scatter_kernel launches made by radix_first and radix_scatter
seg_tiles_launches = 0    # cm_seg_tiles_kernel launches made by segment_tiles
seg_top_launches = 0      # cm_seg_top_kernel launches made by segment_top
moments_launches = 0      # cm_moments_kernel launches made by slot_moments


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


def _check_num_edge(num_edge: torch.Tensor, B: int, dev: torch.device, E: int) -> None:
    if (num_edge.shape != (B,) or num_edge.dtype != torch.int32 or num_edge.device != dev
            or not num_edge.is_contiguous()):
        raise ValueError(f"num_edge must be a contiguous ({B},) int32 tensor on the frames' device")
    if (9 * E) // 10 < 1:
        raise ValueError(f"the pair budget E={E} is under 2")


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                  dev: torch.device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {dev}")


def pair_count(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor,
               E: int) -> PairTiles:
    """(B, H, W) uint8 trinary + int32 dense ids, (B,) num_edge -> the
    histogram pass (ops/cluster_moments.py::PairTiles): each frame's kept
    count, every pass's digit counts, the first pass's by offset, by tile
    and by group of tiles, and the sort's scratch (the counters and sums
    zeroed by one memset)."""
    if trinary.device.type == "cpu":
        return plain.pair_count_plain(trinary, dense, num_edge, E)
    return _pair_count(trinary, dense, num_edge, E, 0)[0]


def _pair_count(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor, E: int,
                hist_bins: int) -> tuple[PairTiles, torch.Tensor | None]:
    """pair_count on the card, and (B, hist_bins) int32 zeros from the same
    memset (None for 0 bins): the stage's segment-tiles histogram."""
    global pair_count_launches
    B, H, W = _check_front(trinary, dense)
    dev = trinary.device
    _check_num_edge(num_edge, B, dev, E)
    N, P, R, R0 = 4 * H * W, SORT_PASSES, RADIX, FIRST_DIGITS
    T, nblk = -(-N // sort_tile(B, N)), -(-H * W // PAIR_BLOCK)
    ng = -(-nblk // FIRST_GROUP)
    i32 = dict(dtype=torch.int32, device=dev)
    # One buffer, one memset: ctl, digits, offset digits, group sums, kept, hist.
    sizes = (B * P, P * B * R, B * 4 * R0, B * 4 * ng * R0, B, B * hist_bins)
    ctl, digits, odig, groups, kept, hist = torch.empty(sum(sizes), **i32).split(sizes)
    out = PairTiles(kept=kept, digits=digits.view(P, B, R), offset_digits=odig.view(B, 4, R0),
                    tile_counts=torch.empty((B, 4, nblk, R0), **i32),
                    group_sums=groups.view(B, 4, ng, R0),
                    look=torch.empty((P - 1, B, T, R), **i32), ctl=ctl.view(B, P))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_pair_count(
            trinary.data_ptr(), dense.data_ptr(), num_edge.data_ptr(), out.ctl.data_ptr(),
            out.digits.data_ptr(), out.offset_digits.data_ptr(), out.group_sums.data_ptr(),
            out.kept.data_ptr(), out.tile_counts.data_ptr(), B, H, W, (9 * E) // 10,
            B * hist_bins, _stream())
    _lib.check(status, "apriltag_cm_pair_count")
    pair_count_launches += 1
    return out, hist.view(B, hist_bins) if hist_bins else None


def _check_tiles(tiles: PairTiles, B: int, N: int, dev: torch.device,
                 hw: tuple[int, int] | None = None) -> None:
    """Raise on a PairTiles the first pass (frames of shape hw) or a later
    pass does not take."""
    P, R, R0 = SORT_PASSES, RADIX, FIRST_DIGITS
    T = -(-N // sort_tile(B, N))
    fields = [("kept", tiles.kept, (B,)), ("digits", tiles.digits, (P, B, R)),
              ("offset_digits", tiles.offset_digits, (B, 4, R0)),
              ("look", tiles.look, (P - 1, B, T, R)), ("ctl", tiles.ctl, (B, P))]
    if hw is not None:
        nblk = -(-hw[0] * hw[1] // PAIR_BLOCK)
        fields += [("tile_counts", tiles.tile_counts, (B, 4, nblk, R0)),
                   ("group_sums", tiles.group_sums, (B, 4, -(-nblk // FIRST_GROUP), R0))]
    for name, t, shape in fields:
        _check_tensor(name, t, shape, torch.int32, dev)


def radix_first(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor,
                tiles: PairTiles, E: int) -> SortRows:
    """The first radix pass, from the pixels: (B, 4 H W) rows holding each
    frame's kept pairs stably sorted by their first digit in [0, K) (the
    rest undefined) (ops/cluster_moments.py::radix_first_plain), and pass
    1's look-back words zeroed on the frame's live tiles. Runs once after
    pair_count, whose tiles it reads."""
    global scatter_launches
    if trinary.device.type == "cpu":
        return plain.radix_first_plain(trinary, dense, num_edge, tiles, E)
    B, H, W = _check_front(trinary, dense)
    dev = trinary.device
    _check_num_edge(num_edge, B, dev, E)
    N = 4 * H * W
    _check_tiles(tiles, B, N, dev, (H, W))
    if not 1 <= E <= N:
        raise ValueError(f"E={E} out of [1, 4 H W]")
    key = torch.empty((B, N), dtype=torch.int32, device=dev)
    pay = torch.empty_like(key)
    tile = sort_tile(B, N)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_radix_first(
            trinary.data_ptr(), dense.data_ptr(), num_edge.data_ptr(), tiles.kept.data_ptr(),
            tiles.digits.data_ptr(), tiles.offset_digits.data_ptr(), tiles.tile_counts.data_ptr(),
            tiles.group_sums.data_ptr(), tiles.look.data_ptr(), key.data_ptr(), pay.data_ptr(), B,
            H, W, (9 * E) // 10, -(-N // tile), tile // 256, _stream())
    _lib.check(status, "apriltag_cm_radix_first")
    scatter_launches += 1
    return SortRows(key=key, pay=pay)


def radix_scatter(rows: SortRows, tiles: PairTiles, k: int, *, E: int,
                  out: tuple[torch.Tensor, torch.Tensor] | None = None) -> SortRows:
    """A later radix pass k (1 <= k < SORT_PASSES):
    rows' [0, K) stably sorted by that digit into `out` (two (B, N) int32
    rows, key and pay; allocated here when None). Only [0, K) of the out
    rows is written, and, in the last pass, I32MAX into [K, E); the pass
    before the last zeroes the next one's look-back words. Each pass runs
    once, in order, after radix_first. The grid holds ceil(E / tile) blocks
    a frame (at most the row's tiles), which take the frame's tiles in
    order, so a frame whose K passes E takes more tiles a block."""
    global scatter_launches
    if not 1 <= k < SORT_PASSES:
        raise ValueError(f"pass {k} out of [1, {SORT_PASSES}): pass 0 is radix_first")
    if rows.key.device.type == "cpu":
        return plain.radix_scatter_plain(rows, tiles, k)
    dev = rows.key.device
    if rows.key.ndim != 2:
        raise ValueError("the rows must be (B, N) tensors")
    B, N = rows.key.shape
    if B > _lib.MAX_BATCH or N % 4:
        raise ValueError(f"rows of {B} frames of {N} slots: at most {_lib.MAX_BATCH} frames of "
                         "4 H W slots")
    if not 1 <= E <= N:
        raise ValueError(f"E={E} out of [1, {N}]")
    for name, t in (("key", rows.key), ("pay", rows.pay)):
        _check_tensor(name, t, (B, N), torch.int32, dev)
    _check_tiles(tiles, B, N, dev)
    if out is None:
        out = (torch.empty_like(rows.key), torch.empty_like(rows.pay))
    for name, t in zip(("out key", "out pay"), out):
        _check_tensor(name, t, (B, N), torch.int32, dev)
        if any(t.data_ptr() == r.data_ptr() for r in rows):
            raise ValueError("a pass cannot write the rows it reads")
    tile = sort_tile(B, N)
    T = -(-N // tile)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_radix_scatter(
            rows.key.data_ptr(), rows.pay.data_ptr(), tiles.kept.data_ptr(),
            tiles.digits.data_ptr(), tiles.look.data_ptr(), tiles.ctl.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), B, N, T, min(T, max(1, -(-E // tile))), k,
            tile // 256, E, _stream())
    _lib.check(status, "apriltag_cm_radix_scatter")
    scatter_launches += 1
    return SortRows(key=out[0], pay=out[1])


def sort_pairs(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor,
               E: int) -> tuple[SortRows, torch.Tensor]:
    """The kept pairs sorted by key, ties in layout order: pair_count, the
    first pass radix_first, then the later radix_scatter passes between its
    rows and one other pair of rows, SORT_PASSES passes in all.
    Returns (rows, (B,) kept counts K): keys bit-exact with
    torch.sort(stable=True) of edge_pairs_plain's padded row on [0, max(K,
    E)) and pays on [0, K) (sort_pairs_plain); nothing reads a row past
    those."""
    tiles = pair_count(trinary, dense, num_edge, E)
    return _radix_passes(trinary, dense, num_edge, tiles, E), tiles.kept


def _radix_passes(trinary: torch.Tensor, dense: torch.Tensor, num_edge: torch.Tensor,
                  tiles: PairTiles, E: int) -> SortRows:
    """sort_pairs' passes after pair_count: radix_first, then the later
    radix_scatter passes between its rows and one other pair of rows."""
    rows = radix_first(trinary, dense, num_edge, tiles, E)
    spare = None
    for k in range(1, SORT_PASSES):
        moved = radix_scatter(rows, tiles, k, E=E, out=spare)
        spare, rows = (rows.key, rows.pay), moved
    return rows


def _check_segments(E: int, max_perimeter: int) -> int:
    """Raise on a budget or size range the segment kernels do not take;
    return the tiles a frame."""
    if (9 * E) // 10 < 1:
        raise ValueError("E must be at least 2")
    if not 0 <= max_perimeter < 1 << 15:
        raise ValueError(f"max_perimeter {max_perimeter} out of [0, 2**15)")
    return -(-E // SEG_TILE)


def segment_tiles(key_s: torch.Tensor, num_edge: torch.Tensor, *, E: int,
                  min_cluster_pixels: int, max_perimeter: int,
                  hist: torch.Tensor | None = None) -> SegmentTiles:
    """(B, N >= E) int32 sorted keys -> each tile's fields, candidates, the
    size histogram and the valid keys (ops/cluster_moments.py::
    SegmentTiles). `hist`, where given, is a zeroed (B, max_perimeter + 1)
    int32 buffer (the sort's memset zeroes it in the stage) that becomes
    the histogram; else the launcher zeroes one of its own."""
    global seg_tiles_launches
    if key_s.device.type == "cpu":
        return plain.segment_tiles_plain(key_s, num_edge, E=E,
                                         min_cluster_pixels=min_cluster_pixels,
                                         max_perimeter=max_perimeter)
    dev = key_s.device
    if key_s.ndim != 2 or key_s.dtype != torch.int32 or not key_s.is_contiguous():
        raise ValueError("key_s must be a contiguous (B, N) int32 tensor")
    B, N = key_s.shape
    if not 1 <= E <= N or key_s.data_ptr() % 16 or N % 4:
        raise ValueError("key_s must hold E keys a row, rows of a multiple of 4 keys "
                         "starting 16-byte aligned")
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    tiles = _check_segments(E, max_perimeter)
    if (num_edge.shape != (B,) or num_edge.dtype != torch.int32 or num_edge.device != dev
            or not num_edge.is_contiguous()):
        raise ValueError(f"num_edge must be a contiguous ({B},) int32 tensor on {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    zeroed = hist is not None
    if zeroed:
        _check_tensor("hist", hist, (B, max_perimeter + 1), torch.int32, dev)
    out = SegmentTiles(stats=torch.empty((B, 5, tiles), **i32),
                       cand=torch.empty((B, tiles * SEG_TILE), **i32),
                       hist=hist if zeroed else torch.empty((B, max_perimeter + 1), **i32),
                       nv=torch.empty(B, **i32))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_seg_tiles(
            key_s.data_ptr(), num_edge.data_ptr(), *(t.data_ptr() for t in out), B, N, E, tiles,
            min_cluster_pixels, max_perimeter, (9 * E) // 10, int(zeroed), _stream())
    _lib.check(status, "apriltag_cm_seg_tiles")
    seg_tiles_launches += 1
    return out


def segment_top(tiles: SegmentTiles, num_edge: torch.Tensor, comp_overflow: torch.Tensor, *,
                E: int, E2: int, max_clusters: int, min_cluster_pixels: int,
                max_perimeter: int) -> TopSegments:
    """segment_tiles' results -> each frame's top-C segments, counts,
    stride and overflow (ops/cluster_moments.py::TopSegments). Reads the
    tiles' results and writes none of them."""
    global seg_top_launches
    kw = dict(E=E, E2=E2, max_clusters=max_clusters, min_cluster_pixels=min_cluster_pixels,
              max_perimeter=max_perimeter)
    if tiles.stats.device.type == "cpu":
        return plain.segment_top_plain(tiles, num_edge, comp_overflow, **kw)
    dev = tiles.stats.device
    B = tiles.stats.shape[0]
    T = _check_segments(E, max_perimeter)
    if not 1 <= max_clusters <= 128:
        raise ValueError("max_clusters must be in [1, 128]")
    for name, t, shape, dt in (("stats", tiles.stats, (B, 5, T), torch.int32),
                               ("cand", tiles.cand, (B, T * SEG_TILE), torch.int32),
                               ("hist", tiles.hist, (B, max_perimeter + 1), torch.int32),
                               ("nv", tiles.nv, (B,), torch.int32),
                               ("num_edge", num_edge, (B,), torch.int32),
                               ("comp_overflow", comp_overflow, (B,), torch.bool)):
        if t.shape != shape or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dt} tensor on {dev}")
    C = max_clusters
    i32 = dict(dtype=torch.int32, device=dev)
    cross = torch.empty((B, T), **i32)
    top_pos, count = torch.empty((B, C), **i32), torch.empty((B, C), **i32)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    n_clusters, n_eligible, stride = (torch.empty(B, **i32) for _ in range(3))
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_seg_top(
            *(t.data_ptr() for t in tiles), num_edge.data_ptr(), comp_overflow.data_ptr(),
            cross.data_ptr(), top_pos.data_ptr(), count.data_ptr(),
            valid.data_ptr(), n_clusters.data_ptr(), n_eligible.data_ptr(), stride.data_ptr(),
            overflow.data_ptr(), B, T, E, E2, C, min_cluster_pixels, max_perimeter,
            (9 * E) // 10, _stream())
    _lib.check(status, "apriltag_cm_seg_top")
    seg_top_launches += 1
    return TopSegments(top_pos=top_pos, count=count, valid=valid, num_clusters=n_clusters,
                       num_eligible=n_eligible, edge_stride=stride, overflow=overflow)


def top_segments(key_s: torch.Tensor, num_edge: torch.Tensor, comp_overflow: torch.Tensor, *,
                 E: int, E2: int, max_clusters: int, min_cluster_pixels: int,
                 max_perimeter: int, hist: torch.Tensor | None = None) -> TopSegments:
    """(B, N >= E) int32 sorted keys -> each frame's top-C segments, counts,
    stride and overflow, as top_segments_plain: segment_tiles (into `hist`
    where given: zeros), then segment_top."""
    tiles = segment_tiles(key_s, num_edge, E=E, min_cluster_pixels=min_cluster_pixels,
                          max_perimeter=max_perimeter, hist=hist)
    return segment_top(tiles, num_edge, comp_overflow, E=E, E2=E2, max_clusters=max_clusters,
                       min_cluster_pixels=min_cluster_pixels, max_perimeter=max_perimeter)


def slot_moments(pay_s: torch.Tensor, top_pos: torch.Tensor, count: torch.Tensor,
                 E2: int) -> SlotMoments:
    """(B, N) int32 pays in sorted order, (B, C) int32 top-C starts and
    sizes -> each slot's bin tables, centroid, scale and dark side over its
    E2-resident pairs (ops/cluster_moments.py::SlotMoments)."""
    global moments_launches
    if pay_s.device.type == "cpu":
        return plain.slot_moments_plain(pay_s, top_pos, count, E2)
    dev = pay_s.device
    if pay_s.ndim != 2 or pay_s.dtype != torch.int32 or not pay_s.is_contiguous():
        raise ValueError("pay_s must be a contiguous (B, N) int32 tensor")
    B, N = pay_s.shape
    C = count.shape[-1]
    for name, t in (("top_pos", top_pos), ("count", count)):
        if t.shape != (B, C) or t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B}, C) int32 tensor on {dev}")
    if not 1 <= C <= 128:
        raise ValueError("C must be in [1, 128]")
    f32 = dict(dtype=torch.float32, device=dev)
    table = torch.empty((B, C, NBINS, 6), **f32)
    centroid, scale = torch.empty((B, C, 2), **f32), torch.empty((B, C), **f32)
    dark = torch.empty((B, C), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_cm_moments(
            pay_s.data_ptr(), top_pos.data_ptr(), count.data_ptr(), table.data_ptr(),
            centroid.data_ptr(), scale.data_ptr(), dark.data_ptr(), B, N, C, E2, _stream())
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
    max_perimeter = 4 * (W + H)
    # The sort's memset also zeroes the segment-tiles kernel's histogram.
    tiles, hist = _pair_count(trinary, dense, num_edge, E, max_perimeter + 1)
    rows = _radix_passes(trinary, dense, num_edge, tiles, E)
    seg = top_segments(rows.key, num_edge, comp_overflow, E=E, E2=E2, max_clusters=max_clusters,
                       min_cluster_pixels=min_cluster_pixels, max_perimeter=max_perimeter,
                       hist=hist)
    mom = slot_moments(rows.pay, seg.top_pos, seg.count, E2)
    bw, bx, by, bxx, bxy, byy = (mom.table[..., i] for i in range(6))
    out = ClusterMoments(
        bw=bw, bx=bx, by=by, bxx=bxx, bxy=bxy, byy=byy, count=seg.count,
        centroid=mom.centroid, scale=mom.scale, dark_inside=mom.dark_inside, valid=seg.valid,
        num_clusters=seg.num_clusters, num_eligible=seg.num_eligible,
        num_edge_points=num_edge, edge_stride=seg.edge_stride, overflow=seg.overflow)
    return first_frame(out) if single else out
