"""Sort-based component resolution: CCL labels -> gated dense component ids.

Counterpart of ``isaac_ros_apriltag_tpu/ops/resolve.py``, bit-exact with the
reference: the contraction between the two CCL scan phases, in rank space
(``resolve_roots_rank``) or in flat-label space (``resolve_roots``), and the
final resolve (``resolve_components``) on rank-space labels with their rank
table or on flat-index labels (the single-phase flow and the row-sharded
front, parallel/spatial.py), optionally with each pixel's root label
(``with_roots``).

Both take a batch of frames, (B, H, W), or one frame, (H, W). Every sort,
cumsum, cummax and gather runs along the last dim of a (B, N) tensor, and
every scatter into a per-frame table goes along dim 1 with the frame's own
dump slot past the end, so no frame reads or writes another's entries.
Labels are flat indices within their frame, as in the reference.

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

from .batch import batch_first, first_frame

_KBITS = 15                  # dense component ids: [0, 2^15)
_KMAX = (1 << _KBITS) - 1    # sentinel dense id for ineligible components

_I64 = torch.int64


class ResolvedComponents(NamedTuple):
    dense: torch.Tensor        # (B, H, W) int32 in [0, _KMAX]; _KMAX = gated out
    n_eligible: torch.Tensor   # (B,) int components passing the area gate
    overflow: torch.Tensor     # (B,) bool — a static capacity was exceeded
    converged: torch.Tensor    # (B,) bool — parent chains fully resolved


class RootedComponents(NamedTuple):
    """ResolvedComponents and each pixel's root: resolve_components with
    with_roots=True (the reference's `roots` field)."""
    dense: torch.Tensor
    n_eligible: torch.Tensor
    overflow: torch.Tensor
    converged: torch.Tensor
    roots: torch.Tensor        # (B, H, W) int32 min-flat-index root per pixel
    #   (equals a fully converged CCL labeling)


def _gather_fill(table: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """table[b, idx[b, i]], with `fill` where the index is out of range (JAX
    mode="fill")."""
    n = table.shape[-1]
    inb = (idx >= 0) & (idx < n)
    return torch.where(inb, torch.gather(table, 1, idx.clamp(0, n - 1)), fill)


def _unsort(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[b, perm[b, i]] = vals[b, i] (each perm[b] is a permutation)."""
    return torch.empty_like(vals).scatter_(1, perm, vals)


def _col(B: int, value: int, dev) -> torch.Tensor:
    """A (B, 1) int64 column of `value`."""
    return torch.full((B, 1), value, dtype=_I64, device=dev)


def _groups(key: torch.Tensor, sent: int, R: int):
    """Sort each frame's keys (stable) and compact the starts of the distinct
    non-sentinel keys into a (B, R) table, as the reference's first two
    sorts do.

    Returns (lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid): sorted keys,
    the sort permutation, sorted-valid mask, group rank of every sorted
    position, the (B,) group count, group start positions P and labels D for
    the first R groups (D = sent past n_groups), and the slot index/valid mask.
    """
    dev = key.device
    B, N = key.shape
    lab_s, idx_s = torch.sort(key, dim=-1, stable=True)
    prev = torch.cat([_col(B, -1, dev), lab_s[:, :-1]], 1)
    vs = lab_s != sent
    first = vs & (lab_s != prev)
    rank = torch.cumsum(first.to(_I64), -1) - 1
    n_groups = rank[:, -1] + 1
    # Group starts are at ascending positions with ranks 0, 1, ...: scatter
    # each into its rank's slot (slots past R go to the dump slot R).
    slot = torch.where(first & (rank < R), rank, R)
    P = torch.zeros((B, R + 1), dtype=_I64, device=dev)
    P.scatter_(1, slot, torch.arange(N, dtype=_I64, device=dev).expand(B, N))
    P = P[:, :R]
    ks = torch.arange(R, dtype=_I64, device=dev)
    kvalid = ks < n_groups[:, None]
    D = torch.where(kvalid, torch.gather(lab_s, 1, P), sent)
    return lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid


def _pointer_double(parx: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    prev = parx
    for _ in range(max(steps, 1)):
        prev = parx
        parx = torch.gather(parx, 1, parx)
    return parx, prev


def _inverse(D: torch.Tensor, kvalid: torch.Tensor, ks: torch.Tensor, size: int,
             R: int) -> torch.Tensor:
    """(B, size + 1) table: label value -> its compacted index; unmatched
    values -> R."""
    B = D.shape[0]
    inv = torch.full((B, size + 2), R, dtype=_I64, device=D.device)
    inv.scatter_(1, torch.where(kvalid, D, size + 1), ks.expand(B, -1))
    return inv[:, :size + 1]


def _broadcast(rank: torch.Tensor, kvalid: torch.Tensor, P: torch.Tensor,
               vals: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Each sorted position takes the `bits`-bit value seeded at its group's
    start: one packed cummax, group rank (16 bits, clamped) above the value."""
    B, N = rank.shape
    seed = torch.zeros((B, N + 1), dtype=_I64, device=rank.device)
    seed.scatter_(1, torch.where(kvalid, P, N), vals)
    high = rank.clamp(max=(1 << 16) - 1) << bits
    return torch.cummax(high | seed[:, :N], -1).values & ((1 << bits) - 1)


def _broadcast_roots(rank, kvalid, P, root_k):
    """Root flat indices (up to 22 bits: N < 2^22 under the 2047x2047 image
    guard) broadcast as two 11-bit chunks, each packed +1 under the group rank
    (rank << 12 | chunk + 1); -1 where a position's group was not seeded or
    its root is negative."""
    lo, hi = (_broadcast(rank, kvalid, P,
                         (((root_k >> shift) & 0x7FF) + 1) * (root_k >= 0), bits=12)
              for shift in (0, 11))
    return torch.where((lo > 0) & (hi > 0), ((hi - 1) << 11) | (lo - 1), -1)


def _flat_parents(flat, D, kvalid, ks, N, R):
    """(B, R + 1) compacted parent map of flat-index labels: slot k points at
    the slot of flat[D_k] (the label at the group's label pixel); slots that
    match no group, and the extra slot R, point at R."""
    dev = flat.device
    flatp = torch.cat([flat, _col(flat.shape[0], N, dev)], 1)
    par = torch.where(kvalid, _gather_fill(flatp, D, N), N)
    inv = _inverse(D, kvalid, ks, N, R)
    return torch.cat([torch.gather(inv, 1, par.clamp(0, N)), _col(flat.shape[0], R, dev)], 1)


def resolve_roots_rank(label: torch.Tensor, valid: torch.Tensor, *,
                       max_components: int = 1 << 16,
                       chain_steps: int = 5
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) flat-index labels -> (rank_img, rank_table, overflowed);
    one frame, (H, W), gives the same without the batch dim.

    rank_img[b, p] = compacted index ("rank") of p's chain-fixpoint label;
    rank_table[b, r] = that rank's root flat pixel index, ascending in r.
    Invalid pixels and pixels of over-capacity groups get rank R.
    """
    label, single = batch_first(label, 2)
    valid, _ = batch_first(valid, 2)
    B, H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit ranks in the packed broadcast)")
    flat = label.reshape(B, N).to(_I64)
    vflat = valid.reshape(B, N)
    key = torch.where(vflat, flat, N)
    lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid = _groups(key, N, R)

    parx, _ = _pointer_double(_flat_parents(flat, D, kvalid, ks, N, R), chain_steps)
    carried = _broadcast(rank, kvalid, P, parx[:, :R])
    rank_sorted = torch.where(vs & (rank < R), carried, R)
    rank_flat = _unsort(idx_s, rank_sorted)
    rank_img = torch.where(valid, rank_flat.reshape(B, H, W), R).to(torch.int32)
    out = rank_img, D.to(torch.int32), n_groups > R
    return first_frame(out) if single else out


def resolve_roots(label: torch.Tensor, valid: torch.Tensor, *,
                  max_components: int = 1 << 16,
                  chain_steps: int = 5) -> torch.Tensor:
    """(B, H, W) flat-index labels -> (B, H, W) chain-root labels (the
    contraction step in flat-label space); one frame, (H, W), gives (H, W).

    Every valid pixel's label is replaced by its chain fixpoint, the
    component's min flat index; invalid pixels and pixels of over-capacity
    groups keep their incoming label.
    """
    label, single = batch_first(label, 2)
    valid, _ = batch_first(valid, 2)
    B, H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit group ranks in the packed broadcast)")
    dev = label.device
    flat = label.reshape(B, N).to(_I64)
    key = torch.where(valid.reshape(B, N), flat, N)
    _, idx_s, _, rank, _, P, D, ks, kvalid = _groups(key, N, R)
    parx, _ = _pointer_double(_flat_parents(flat, D, kvalid, ks, N, R), chain_steps)
    Dx = torch.cat([D, _col(B, N, dev)], 1)
    root_k = torch.where(kvalid, torch.gather(Dx, 1, parx[:, :R]), -1)
    roots = _unsort(idx_s, _broadcast_roots(rank, kvalid, P, root_k)).reshape(B, H, W)
    out = torch.where(valid & (roots >= 0), roots, label).to(torch.int32)
    return out[0] if single else out


def resolve_components(label: torch.Tensor, valid: torch.Tensor, *,
                       min_component_pixels: int,
                       max_components: int = 1 << 16,
                       chain_steps: int = 4,
                       with_roots: bool = False,
                       rank_table: torch.Tensor | None = None
                       ) -> ResolvedComponents | RootedComponents:
    """(B, H, W) CCL labels + validity -> area-gated dense component ids; one
    frame, (H, W) (with an (R,) rank table in rank mode), gives the same
    without the batch dim.

    Without `rank_table`, label[b, p] is the flat index of a pixel in p's
    component with label <= p, as a scan CCL leaves it (`chain_steps`
    pointer doublings resolve chains up to depth 2^chain_steps; `converged`
    says whether that sufficed). With `rank_table`, label[b, p] is a rank r
    with rank_table[b, r] the flat index of a pixel in p's component (ranks
    ascending in root flat index), as produced by resolve_roots_rank followed
    by a scan phase; the dense ids are those of the flat form. `with_roots`
    (flat mode only) returns RootedComponents, which adds each valid pixel's
    root flat index.
    """
    label, single = batch_first(label, 2)
    valid, _ = batch_first(valid, 2)
    B, H, W = label.shape
    N = H * W
    R = min(max_components, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536")
    if rank_table is not None:
        if with_roots:
            raise ValueError("with_roots is unsupported in rank-space mode")
        rank_table, _ = batch_first(rank_table, 1)
        if rank_table.shape[-1] != R:
            raise ValueError("rank_table capacity mismatch: "
                             f"{rank_table.shape[-1]} != {R}")
    dev = label.device
    SENT = R if rank_table is not None else N    # one past the largest label
    flat = label.reshape(B, N).to(_I64)
    key = torch.where(valid.reshape(B, N), flat, SENT)
    lab_s, idx_s, vs, rank, n_groups, P, D, ks, kvalid = _groups(key, SENT, R)
    n_valid_pix = vs.sum(-1)
    nxt = torch.cat([P[:, 1:], _col(B, 0, dev)], 1)
    nxt = torch.where(ks == n_groups[:, None] - 1, n_valid_pix[:, None], nxt)
    cnt = torch.where(kvalid, nxt - P, 0)

    # --- chain resolution on the compacted labels ---------------------------
    if rank_table is not None:
        # parent of rank group v = the rank label at v's root pixel.
        flatp = torch.cat([flat, _col(B, SENT, dev)], 1)
        Tp = torch.cat([rank_table.to(_I64), _col(B, N, dev)], 1)
        root_pix = torch.where(kvalid, _gather_fill(Tp, D, N), N)
        par = _gather_fill(flatp, root_pix, SENT)
        inv = _inverse(D, kvalid, ks, R, R)
        parx = torch.cat([torch.gather(inv, 1, par.clamp(0, R)), _col(B, R, dev)], 1)
    else:
        parx = _flat_parents(flat, D, kvalid, ks, N, R)
    parx, prev = _pointer_double(parx, chain_steps)
    converged = torch.all(parx == prev, -1)
    Dx = torch.cat([D, _col(B, SENT, dev)], 1)
    root = torch.where(kvalid, torch.gather(Dx, 1, parx[:, :R]), SENT)

    # --- component sizes + area gate + dense ranking (root order) ----------
    rkey, korder = torch.sort(root, dim=-1, stable=True)
    rcnt = torch.gather(cnt, 1, korder)
    rprev = torch.cat([_col(B, -1, dev), rkey[:, :-1]], 1)
    rfirst = rkey != rprev
    gid = torch.cumsum(rfirst.to(_I64), -1) - 1
    totals = torch.zeros((B, R), dtype=_I64, device=dev).scatter_add_(1, gid, rcnt)
    size_m = torch.gather(totals, 1, gid)
    eligible = (rkey != SENT) & (size_m >= min_component_pixels)
    crank = torch.cumsum((rfirst & eligible).to(_I64), -1) - 1
    n_eligible = crank[:, -1] + 1
    dense_m = torch.where(eligible & (crank < _KMAX), crank, _KMAX)
    dense_k = _unsort(korder, dense_m)

    # --- broadcast to pixels: seed at P, packed cummax, un-sort ------------
    carry = _broadcast(rank, kvalid, P, dense_k + 1)
    dense_sorted = torch.where(vs & (carry > 0), carry - 1, _KMAX)
    dense = _unsort(idx_s, dense_sorted).reshape(B, H, W).to(torch.int32)
    overflow = (n_groups > R) | (n_eligible > _KMAX)
    out = ResolvedComponents(dense=dense, n_eligible=n_eligible,
                             overflow=overflow, converged=converged)
    if with_roots:
        root_flat = _unsort(idx_s, _broadcast_roots(rank, kvalid, P, root)).reshape(B, H, W)
        roots = torch.where(valid & (root_flat >= 0), root_flat, label).to(torch.int32)
        out = RootedComponents(*out, roots=roots)
    return first_frame(out) if single else out
