"""Sort-centric boundary clustering: trinary + dense ids -> per-cluster
angular moments.

Counterpart of ``isaac_ros_apriltag_tpu/ops/cluster_moments.py``:
  1. black/white neighbour pairs over 4 offsets whose components both
     passed resolve's area gate, hash-decimated when over the pair budget E;
  2. one stable sort by the packed (black, white) dense-id key;
  3. segment sizes from positions (one reverse cummin), top-C by size as
     one stable descending sort, slot ids broadcast by a packed cummax;
  4. a second sort compacts the top-C clusters' pairs to E2; per-cluster
     sums and the (cluster, bin) moment tables are one-hot matmuls.

The one-hot matmuls are the reference's, taken in f64 where it took f32.
Every summand is an f32 value, so the f64 sums are exact (or within f64
rounding) whatever order the BLAS adds them in. The reference's f32 sums are
not: a small cluster far from the origin has E[r^2] ~ 1e5 px^2 against a
variance ~ 10 px^2, and the f32 rounding of the sum of r^2, amplified 1e4
times by E[r^2] - |c|^2, moves its scale by up to 1% from one summation
order to another (the reference jitted against the reference op by op, on
tests/test_torch_tail.py's scene). So the variance is also taken in f64
from the exact sums. The port is held to an f64 oracle at rtol 1e-5 and to
the reference within the reference's own spread. The integer outputs
(counts, valid, dark_inside, num_*, edge_stride, overflow) and the centroid
are bit-exact with the reference. The reference's int32 wraparound hash and
uint32 packs are computed in int64 with the same low bits.

The function takes a batch of frames, (B, H, W), or one frame, (H, W). Each
frame's pairs are sorted, scanned and scattered along the last dim of a
(B, ...) tensor, and the one-hot contractions are batched matmuls, so no
frame sees another's pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .batch import batch_first, first_frame
from .resolve import _KBITS, _KMAX

_I32MAX = torch.iinfo(torch.int32).max
NBINS = 64                   # angular bins (matches ops/quadfit.py)

# Neighbour offsets (dx, dy): right, down, down-left, down-right.
_OFFSETS = ((1, 0), (0, 1), (-1, 1), (1, 1))


class ClusterMoments(NamedTuple):
    """Per-cluster angular moment tables (inputs to ops.quadfit)."""

    bw: torch.Tensor     # (B, C, NBINS) sum of weights (no B for one frame)
    bx: torch.Tensor     # sum sx
    by: torch.Tensor     # sum sy
    bxx: torch.Tensor    # sum sx*sx
    bxy: torch.Tensor    # sum sx*sy
    byy: torch.Tensor    # sum sy*sy
    count: torch.Tensor       # (B, C) int32 boundary points (post-decimation)
    centroid: torch.Tensor    # (B, C, 2) float32 pixel coords
    scale: torch.Tensor       # (B, C) float32 sqrt(mean r^2) in pixels
    dark_inside: torch.Tensor  # (B, C) bool
    valid: torch.Tensor       # (B, C) bool
    num_clusters: torch.Tensor    # (B,) each
    num_eligible: torch.Tensor
    num_edge_points: torch.Tensor
    edge_stride: torch.Tensor
    overflow: torch.Tensor


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = x[..., i + dy, j + dx]; `fill` where that is outside
    the frame."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)] = \
        x[..., max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)]
    return out


def _diamond_bin(dx: torch.Tensor, dy: torch.Tensor, nbins: int) -> torch.Tensor:
    """Monotone circular angle surrogate -> bin id in [0, nbins)."""
    ax = dx.abs()
    ay = dy.abs()
    denom = torch.clamp(ax + ay, min=1e-12)
    t = torch.where(dy >= 0,
                    torch.where(dx >= 0, dy / denom, 1.0 + ax / denom),
                    torch.where(dx < 0, 2.0 + ay / denom, 3.0 + dx / denom))
    return (t * (nbins / 4.0)).to(torch.int64).clamp(0, nbins - 1)


def extract_cluster_moments(trinary: torch.Tensor, dense: torch.Tensor, *,
                            comp_overflow: torch.Tensor, max_edge_points: int,
                            max_clusters: int, min_cluster_pixels: int,
                            max_cluster_points: int = 1024) -> ClusterMoments:
    """trinary + area-gated dense component ids (ops/resolve.py) -> moments;
    (B, H, W) with (B,) comp_overflow, or one frame without the batch dim."""
    trinary, single = batch_first(trinary, 2)
    dense, _ = batch_first(dense, 2)
    B, H, W = trinary.shape
    dev = trinary.device
    E = min(max_edge_points, 4 * H * W)
    C, K = max_clusters, NBINS
    if not (2 * W < (1 << 12) and 2 * H < (1 << 12)):
        raise ValueError(
            "packed coords support segmentation images up to 2047x2047; "
            f"got {H}x{W} — use quad_decimate for larger frames")
    if C > 128:
        raise ValueError("max_clusters must be <= 128 (8-bit slot packing)")

    # --- dense pair generation (4 offsets), per frame ----------------------
    i32 = torch.int32
    xs = torch.arange(W, dtype=i32, device=dev).expand(H, W)
    ys = torch.arange(H, dtype=i32, device=dev)[:, None].expand(H, W)
    dense = dense.to(i32)
    key_all, pay_all, m_all = [], [], []
    for dx, dy in _OFFSETS:
        v0 = trinary
        v1 = _shift(trinary, dy, dx, 127)
        pair = (v0.to(i32) + v1.to(i32)) == 255
        d1 = _shift(dense, dy, dx, _KMAX)
        p_black = v0 == 0
        db = torch.where(p_black, dense, d1)
        dw = torch.where(p_black, d1, dense)
        m = pair & (db != _KMAX) & (dw != _KMAX)
        sgn = torch.where(p_black, 1, -1).to(i32)
        g = (dx * sgn + 1) | ((dy * sgn + 1) << 2)
        key_all.append(torch.where(m, (db << _KBITS) | dw, _I32MAX))
        pay_all.append((2 * xs + dx) | ((2 * ys + dy) << 12) | (g << 24))
        m_all.append(m)
    # Offset-major within each frame, as the reference's stack + reshape.
    key = torch.stack(key_all, 1).reshape(B, -1)
    pay = torch.stack(pay_all, 1).reshape(B, -1).to(i32)
    mask = torch.stack(m_all, 1).reshape(B, -1)

    # --- overflow decimation (hash gate, uniform spatial subsample) ---------
    num_edge = mask.sum(-1).to(i32)
    budget = (9 * E) // 10
    stride = torch.clamp((num_edge + budget - 1) // budget, min=1)
    # Bits 15..30 of the int32-wrapped product pay * -1640531527.
    pay_hash = ((pay.to(torch.int64) * -1640531527) >> 15) & 0xFFFF
    keep = mask & (pay_hash % stride[:, None] == 0)

    # --- sort 1: group by (black, white) dense-id pair ----------------------
    key_s, perm = torch.sort(torch.where(keep, key, _I32MAX), dim=-1, stable=True)
    key_s = key_s[:, :E]
    pay_s = torch.gather(pay, 1, perm[:, :E])
    valid = key_s != _I32MAX
    prev_key = torch.cat([torch.full((B, 1), -1, dtype=key_s.dtype, device=dev),
                          key_s[:, :-1]], 1)
    first = valid & (key_s != prev_key)

    # --- per-segment counts from positions (one reverse cummin) -------------
    idxs = torch.arange(E, dtype=torch.int64, device=dev)
    nxt_first = torch.cat([first[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    nxt_valid = torch.cat([valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    is_last = valid & (nxt_first | ~nxt_valid)
    candl = torch.where(is_last, idxs, E)
    last_at = torch.cummin(candl.flip(-1), -1).values.flip(-1)
    cnt0 = last_at - idxs + 1

    # --- top-C segments by size (gates in true-pixel units) -----------------
    max_perimeter = 2 * (2 * W + 2 * H)
    count_at_start = torch.where(first, cnt0, 0)
    true_size = count_at_start * stride[:, None]
    eligible = (true_size >= min_cluster_pixels) & (true_size <= max_perimeter)
    gated = torch.where(eligible, count_at_start, 0)
    # Stable ascending sort of -size: ties go to the lower position.
    neg_sizes, top_pos = torch.sort(-gated, dim=-1, stable=True)
    top_sizes, top_pos = -neg_sizes[:, :C], top_pos[:, :C]
    cvalid = top_sizes > 0
    ccnt = torch.where(cvalid, top_sizes, 0).to(torch.float32)

    # --- slot ids broadcast to members (C-scatter + one packed cummax) ------
    rank = torch.cumsum(first.to(torch.int64), -1) << 8
    slot_seed = torch.zeros((B, E + 1), dtype=torch.int64, device=dev)
    slot_seed.scatter_(1, torch.where(cvalid, top_pos, E),
                       torch.arange(1, C + 1, dtype=torch.int64, device=dev).expand(B, C))
    slot = (torch.cummax(rank | slot_seed[:, :E], -1).values & 0xFF) - 1

    # --- sort 2: compact the top-C clusters' pairs to the E2 budget ---------
    key2 = torch.where(valid & (slot >= 0), slot, C)
    E2 = min(C * max_cluster_points, E)
    n_slot_pairs = (key2 != C).sum(-1)
    slot_overflow = n_slot_pairs > E2
    key2, perm2 = torch.sort(key2, dim=-1, stable=True)
    key2 = key2[:, :E2]
    pay2 = torch.gather(pay_s, 1, perm2[:, :E2])
    v2 = key2 != C
    slot2 = torch.where(v2, key2, C)
    x2 = (pay2 & 0xFFF).to(torch.float32) * 0.5
    y2 = ((pay2 >> 12) & 0xFFF).to(torch.float32) * 0.5
    gp2 = pay2 >> 24
    gx2 = ((gp2 & 0x3) - 1).to(torch.float32)
    gy2 = (((gp2 >> 2) & 0x3) - 1).to(torch.float32)
    w2 = v2.to(torch.float32)

    # --- per-cluster stats at E2: one batched one-hot f64 matmul ------------
    f64 = torch.float64
    F2 = torch.stack([w2, x2 * w2, y2 * w2, (x2 * x2 + y2 * y2) * w2,
                      gx2 * w2, gy2 * w2, (x2 * gx2 + y2 * gy2) * w2], -1)
    onehot = (slot2[..., None] == torch.arange(C, dtype=slot2.dtype, device=dev)
              ).to(f64)                                            # (B, E2, C)
    ctot64 = onehot.mT @ F2.to(f64)                                # (B, C, 7)
    ctot = ctot64.to(torch.float32)
    safe = torch.clamp(ctot[..., 0], min=1.0)
    # Sums of half-pixel coords are exact in f32 too, so the centroid is
    # the reference's to the bit.
    ccx = ctot[..., 1] / safe
    ccy = ctot[..., 2] / safe
    safe64 = safe.to(f64)
    r2m = (ctot64[..., 3] / safe64 - (ctot64[..., 1] / safe64) ** 2
           - (ctot64[..., 2] / safe64) ** 2).to(torch.float32)
    cscale = torch.sqrt(torch.clamp(r2m, min=1e-12))
    mean_dot = (ctot[..., 6] - ccx * ctot[..., 4] - ccy * ctot[..., 5]) / safe
    dark = mean_dot > 0

    # --- per-pair angular bin about the cluster centroid --------------------
    # One nonzero product per row: the fetch is exact.
    paramC = torch.stack([ccx, ccy, torch.clamp(r2m, min=1e-12)], -1)  # (B, C, 3)
    params = (onehot @ paramC.to(f64)).to(torch.float32)              # (B, E2, 3)
    cx2, cy2, r2_2 = params[..., 0], params[..., 1], params[..., 2]
    bins = _diamond_bin(x2 - cx2, y2 - cy2, K)
    inv2 = torch.rsqrt(torch.clamp(r2_2, min=1e-12))
    sxn = (x2 - cx2) * inv2
    syn = (y2 - cy2) * inv2

    # --- (cluster, bin) cell tables: factored one-hot matmul ----------------
    F3 = torch.stack([w2, sxn * w2, syn * w2, sxn * sxn * w2,
                      sxn * syn * w2, syn * syn * w2], -1)          # (B, E2, 6)
    oh_bin = (bins[..., None] == torch.arange(K, device=dev)).to(f64)   # (B, E2, K)
    G = (oh_bin[..., None] * F3.to(f64)[..., None, :]).reshape(B, E2, K * 6)
    table = (onehot.mT @ G).to(torch.float32).reshape(B, C, K, 6)
    bw, bx, by, bxx, bxy, byy = [table[..., i] for i in range(6)]

    n_clusters = first.sum(-1).to(i32)
    n_eligible = eligible.sum(-1).to(i32)
    out = ClusterMoments(
        bw=bw, bx=bx, by=by, bxx=bxx, bxy=bxy, byy=byy,
        count=ccnt.to(i32),
        centroid=torch.stack([ccx, ccy], -1),
        scale=cscale, dark_inside=dark, valid=cvalid,
        num_clusters=n_clusters, num_eligible=n_eligible,
        num_edge_points=num_edge, edge_stride=stride.to(i32),
        overflow=((num_edge > E) | comp_overflow | (n_eligible > C)
                  | slot_overflow))
    return first_frame(out) if single else out
