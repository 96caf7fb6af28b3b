"""Sort-based component resolution in compacted-rank space.

Counterpart of ``isaac_ros_apriltag_tpu/ops/resolve.py``: the contraction
between the two CCL scan phases (``resolve_roots_rank``) and the final
resolve (``resolve_components`` in rank-table mode), both bit-exact with the
reference. Flat-label mode and ``with_roots`` are not ported.

How the reference's primitives map to PyTorch:
  - ``lax.sort`` (stable, operands carried along) -> ``torch.sort(stable=True)``
    and gathers through the permutation; sorting by a permutation is an
    inverse-permutation scatter;
  - the ``mode="fill"`` gathers and out-of-bounds scatter drops -> explicit
    range masks and a dump slot past the end of each table;
  - the packed uint32 cummax broadcasts -> the same bits in int64;
  - the segmented sum over roots -> ``index_add_`` of int64 counts per group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_KBITS = 15                  # dense component ids: [0, 2^15)
_KMAX = (1 << _KBITS) - 1    # sentinel dense id for ineligible components

_I64 = torch.int64


class ResolvedComponents(NamedTuple):
    dense: torch.Tensor        # (H, W) int32 in [0, _KMAX]; _KMAX = gated out
    n_eligible: torch.Tensor   # () int components passing the area gate
    overflow: torch.Tensor     # () bool — a static capacity was exceeded
    converged: torch.Tensor    # () bool — parent chains fully resolved


def _gather_fill(table: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """table[idx], with `fill` where idx is out of range (JAX mode="fill")."""
    n = table.shape[0]
    inb = (idx >= 0) & (idx < n)
    return torch.where(inb, table[idx.clamp(0, n - 1)], fill)


def _unsort(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[perm[i]] = vals[i] (perm is a permutation)."""
    out = torch.empty_like(vals)
    out[perm] = vals
    return out


def _groups(key: torch.Tensor, sent: int, R: int):
    """Sort keys (stable) and compact the starts of the distinct non-sentinel
    keys into an (R,) table, as the reference's first two sorts do.

    Returns (lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid): sorted keys,
    the sort permutation, sorted-valid mask, group rank of every sorted
    position, the group count, group start positions P and labels D for the
    first R groups (D = sent past n_groups), and the slot index/valid mask.
    """
    dev = key.device
    N = key.shape[0]
    lab_s, idx_s = torch.sort(key, stable=True)
    prev = torch.cat([torch.full((1,), -1, dtype=lab_s.dtype, device=dev), lab_s[:-1]])
    vs = lab_s != sent
    first = vs & (lab_s != prev)
    rank = torch.cumsum(first.to(_I64), 0) - 1
    n_groups = rank[-1] + 1
    # Group starts are at ascending positions with ranks 0, 1, ...: scatter
    # each into its rank's slot (slots past R go to the dump slot R).
    slot = torch.where(first & (rank < R), rank, R)
    P = torch.zeros((R + 1,), dtype=_I64, device=dev)
    P.scatter_(0, slot, torch.arange(N, dtype=_I64, device=dev))
    P = P[:R]
    ks = torch.arange(R, dtype=_I64, device=dev)
    kvalid = ks < n_groups
    D = torch.where(kvalid, lab_s[P].to(_I64), sent)
    return lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid


def _pointer_double(parx: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    prev = parx
    for _ in range(max(steps, 1)):
        prev = parx
        parx = parx[parx]
    return parx, prev


def resolve_roots_rank(label: torch.Tensor, valid: torch.Tensor, *,
                       max_components: int = 1 << 16,
                       chain_steps: int = 5
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) flat-index labels -> (rank_img, rank_table, overflowed).

    rank_img[p] = compacted index ("rank") of p's chain-fixpoint label;
    rank_table[r] = that rank's root flat pixel index, ascending in r.
    Invalid pixels and pixels of over-capacity groups get rank R.
    """
    H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit ranks in the packed broadcast)")
    dev = label.device
    flat = label.reshape(-1).to(_I64)
    vflat = valid.reshape(-1)
    key = torch.where(vflat, flat, N)
    lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid = _groups(key, N, R)

    flatp = torch.cat([flat, torch.full((1,), N, dtype=_I64, device=dev)])
    par = torch.where(kvalid, _gather_fill(flatp, D, N), N)
    # inv: label value -> compacted index; unmatched values -> slot R.
    inv = torch.full((N + 2,), R, dtype=_I64, device=dev)
    inv.scatter_(0, torch.where(kvalid, D, N + 1), ks)
    inv = inv[:N + 1]
    parx = torch.cat([inv[par.clamp(0, N)], torch.full((1,), R, dtype=_I64, device=dev)])
    parx, _ = _pointer_double(parx, chain_steps)
    root_rank = parx[:R]

    # ONE-chunk broadcast: group rank (16 high bits) | root rank (16 low).
    seed = torch.zeros((N + 1,), dtype=_I64, device=dev)
    seed.scatter_(0, torch.where(kvalid, P, N), root_rank)
    seed = seed[:N]
    rank16 = rank.clamp(max=(1 << 16) - 1) << 16
    carried = torch.cummax(rank16 | seed, 0).values & 0xFFFF
    rank_sorted = torch.where(vs & (rank < R), carried, R)
    rank_flat = _unsort(idx_s, rank_sorted)
    rank_img = torch.where(valid, rank_flat.reshape(H, W), R).to(torch.int32)
    return rank_img, D.to(torch.int32), n_groups > R


def resolve_components(label: torch.Tensor, valid: torch.Tensor, *,
                       min_component_pixels: int,
                       max_components: int = 1 << 16,
                       chain_steps: int = 4,
                       rank_table: torch.Tensor) -> ResolvedComponents:
    """(H, W) rank-space labels + validity -> area-gated dense component ids.

    label[p] is a rank r with rank_table[r] the flat index of a pixel in p's
    component (ranks ascending in root flat index), as produced by
    resolve_roots_rank followed by an opaque-mode scan phase.
    """
    H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536")
    if rank_table.shape[0] != R:
        raise ValueError("rank_table capacity mismatch: "
                         f"{rank_table.shape[0]} != {R}")
    dev = label.device
    SENT = R
    flat = label.reshape(-1).to(_I64)
    key = torch.where(valid.reshape(-1), flat, SENT)
    lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid = _groups(key, SENT, R)
    n_valid_pix = vs.sum()
    nxt = torch.cat([P[1:], torch.zeros((1,), dtype=_I64, device=dev)])
    nxt = torch.where(ks == n_groups - 1, n_valid_pix, nxt)
    cnt = torch.where(kvalid, nxt - P, 0)

    # --- chain resolution through the rank-sized tables ---------------------
    flatp = torch.cat([flat, torch.full((1,), SENT, dtype=_I64, device=dev)])
    Tp = torch.cat([rank_table.to(_I64), torch.full((1,), N, dtype=_I64, device=dev)])
    root_pix = torch.where(kvalid, _gather_fill(Tp, D, N), N)
    par = _gather_fill(flatp, root_pix, SENT)
    inv = torch.full((R + 2,), R, dtype=_I64, device=dev)
    inv.scatter_(0, torch.where(kvalid, D, R + 1), ks)
    inv = inv[:R + 1]
    parx = torch.cat([inv[par.clamp(0, R)], torch.full((1,), R, dtype=_I64, device=dev)])
    parx, prev = _pointer_double(parx, chain_steps)
    converged = torch.all(parx == prev)
    Dx = torch.cat([D, torch.full((1,), SENT, dtype=_I64, device=dev)])
    root = torch.where(kvalid, Dx[parx[:R]], SENT)

    # --- component sizes + area gate + dense ranking (root order) ----------
    rkey, korder = torch.sort(root, stable=True)
    rcnt = cnt[korder]
    rprev = torch.cat([torch.full((1,), -1, dtype=_I64, device=dev), rkey[:-1]])
    rfirst = rkey != rprev
    gid = torch.cumsum(rfirst.to(_I64), 0) - 1
    totals = torch.zeros((R,), dtype=_I64, device=dev).index_add_(0, gid, rcnt)
    size_m = totals[gid]
    eligible = (rkey != SENT) & (size_m >= min_component_pixels)
    crank = torch.cumsum((rfirst & eligible).to(_I64), 0) - 1
    n_eligible = crank[-1] + 1
    dense_m = torch.where(eligible & (crank < _KMAX), crank, _KMAX)
    dense_k = _unsort(korder, dense_m)

    # --- broadcast to pixels: seed at P, packed cummax, un-sort ------------
    seed = torch.zeros((N + 1,), dtype=_I64, device=dev)
    seed.scatter_(0, torch.where(kvalid, P, N), dense_k + 1)
    seed = seed[:N]
    rank16 = rank.clamp(max=(1 << 16) - 1) << 16
    carry = torch.cummax(rank16 | seed, 0).values & 0xFFFF
    dense_sorted = torch.where(vs & (carry > 0), carry - 1, _KMAX)
    dense = _unsort(idx_s, dense_sorted).reshape(H, W).to(torch.int32)
    overflow = (n_groups > R) | (n_eligible > _KMAX)
    return ResolvedComponents(dense=dense, n_eligible=n_eligible,
                              overflow=overflow, converged=converged)
