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

Below the twin, the table formulation (resolve_roots_rank_tables,
resolve_components_tables) gives the same results from count, scan, slots
(the contraction) or final (the final resolve) and map passes over
per-frame label tables, with no N-length sort, cumsum or cummax, and no
sort of the slots. Its plain passes (count_plain, tile_sums_plain,
scan_plain, slots_plain, final_plain, the composition of slots_plain and
dense_plain, map_plain) are the plain versions of csrc/resolve.cu's
kernels, and ops/cuda/resolve.py runs it with the kernels (backend
'cuda'); backend 'torch' runs the twin.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


def _dense_ranks(root: torch.Tensor, cnt: torch.Tensor, sent: int,
                 min_component_pixels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Component sizes, the area gate and the dense ranking in root order,
    on the (B, R) slot tables: root[b, k] is slot k's root label (`sent` for
    no group), cnt[b, k] its pixel count. Returns (dense_k, n_eligible):
    each slot's dense id (_KMAX where gated out) and the (B,) count of
    eligible components."""
    B, R = root.shape
    dev = root.device
    rkey, korder = torch.sort(root, dim=-1, stable=True)
    rcnt = torch.gather(cnt, 1, korder)
    rprev = torch.cat([_col(B, -1, dev), rkey[:, :-1]], 1)
    rfirst = rkey != rprev
    gid = torch.cumsum(rfirst.to(_I64), -1) - 1
    totals = torch.zeros((B, R), dtype=_I64, device=dev).scatter_add_(1, gid, rcnt)
    size_m = torch.gather(totals, 1, gid)
    eligible = (rkey != sent) & (size_m >= min_component_pixels)
    crank = torch.cumsum((rfirst & eligible).to(_I64), -1) - 1
    n_eligible = crank[:, -1] + 1
    dense_m = torch.where(eligible & (crank < _KMAX), crank, _KMAX)
    return _unsort(korder, dense_m), n_eligible


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

    dense_k, n_eligible = _dense_ranks(root, cnt, SENT, min_component_pixels)

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


# --- the table formulation: count, scan, slots or final, and map passes -----
#
# The same results as resolve_roots_rank and resolve_components in rank mode
# and flat mode, without an N-length sort, cumsum, cummax or unsort. Labels
# are indices into a per-frame table of S entries (S = N for flat labels,
# R for ranks), so a presence table and an exclusive scan over it give the
# distinct labels in the order the sort gave them:
#   count  cnt[b, L] = valid pixels labelled L (a pixel pass);
#   scan   each present label's group rank, capped at R (inv), the first R
#          present labels in order (D) and the group count (a pass over S);
#   slots  (the contraction) each slot's parent slot, followed 2^s hops as
#          s pointer doublings would take it: the map's table;
#   final  (the final resolve) the same chains, each root slot's pixel
#          total, the area gate and each root slot's dense id in root
#          order: the map's table (slots_plain's roots and totals, then
#          dense_plain);
#   map    each pixel's value from a (B, R + 1) table through inv (a pixel
#          pass).
# The five passes are arguments (TablePasses): PLAIN_PASSES here, the
# kernels' wrappers in ops/cuda/resolve.py. Valid pixels' labels must lie
# in [0, S]; a label of S is the twin's sentinel (no group).


class TablePasses(NamedTuple):
    count: Callable       # (label, valid, S) -> cnt
    scan: Callable        # (cnt, R) -> (inv, D, n_groups)
    slots: Callable       # (label, inv, D, n_groups, steps) -> see slots_plain
    final: Callable       # (label, inv, D, n_groups, steps, rank_table, cnt,
                          #  min_component_pixels) -> see final_plain
    map: Callable         # (label, valid, inv, table, fill) -> out


def count_plain(label: torch.Tensor, valid: torch.Tensor, S: int) -> torch.Tensor:
    """(B, N) int32 labels + (B, N) bool validity -> (B, S) int32 cnt:
    cnt[b, L] = the valid pixels of frame b labelled L, for L in [0, S);
    labels outside it are not counted."""
    B, _ = label.shape
    key = torch.where(valid & (label >= 0) & (label < S), label.to(_I64), S)
    cnt = torch.zeros((B, S + 1), dtype=torch.int32, device=label.device)
    cnt.scatter_add_(1, key, torch.ones(key.shape, dtype=torch.int32, device=label.device))
    return cnt[:, :S].contiguous()


SCAN_TILE = 4096     # table entries a block of the scan kernels takes (csrc/resolve.cu)


def tile_sums_plain(cnt: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 label counts -> (B, T) int32: the present labels
    (cnt > 0) of each tile of SCAN_TILE entries, T tiles covering S + 1
    entries (the scan's first step)."""
    B, S = cnt.shape
    T = -(-(S + 1) // SCAN_TILE)
    present = torch.nn.functional.pad((cnt > 0).to(torch.int32), (0, T * SCAN_TILE - S))
    return present.reshape(B, T, SCAN_TILE).sum(-1, dtype=torch.int32)


def scan_plain(cnt: torch.Tensor, R: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S) int32 label counts -> (inv, D, n_groups), all int32.

    inv (B, S + 1): a present label's group rank (how many present labels
    are smaller), capped at R; R for an absent label and for entry S.
    D (B, R): the k-th present label, S past the frame's n_groups.
    n_groups (B,): the present labels."""
    B, S = cnt.shape
    dev = cnt.device
    present = cnt > 0
    incl = torch.cumsum(present.to(_I64), -1)
    rank = incl - present.to(_I64)
    inv = torch.cat([torch.where(present, rank.clamp(max=R), R), _col(B, R, dev)], 1)
    slot = torch.where(present & (rank < R), rank, R)
    D = torch.full((B, R + 1), S, dtype=_I64, device=dev)
    D.scatter_(1, slot, torch.arange(S, dtype=_I64, device=dev).expand(B, S))
    return (inv.to(torch.int32), D[:, :R].to(torch.int32).contiguous(),
            incl[:, -1].to(torch.int32))


def map_plain(label: torch.Tensor, valid: torch.Tensor, inv: torch.Tensor,
              table: torch.Tensor, fill: int) -> torch.Tensor:
    """(B, N) int32 labels + (B, N) bool validity, (B, S + 1) inv and
    (B, R + 1) int32 table -> (B, N) int32: table[b, inv[b, L]] for a valid
    pixel labelled L in [0, S), `fill` for any other pixel."""
    S = inv.shape[-1] - 1
    ok = valid & (label >= 0) & (label < S)
    r = torch.gather(inv, 1, torch.where(ok, label.to(_I64), S))
    return torch.where(ok, torch.gather(table, 1, r.to(_I64)), fill).to(torch.int32)


def _slot_parents(lab: torch.Tensor, inv: torch.Tensor, label_k: torch.Tensor,
                  R: int) -> torch.Tensor:
    """(B, R + 1) compacted parent map: slot k points at the slot of the
    label at pixel label_k[b, k] (a flat index; out of [0, N) reads the
    table's sentinel, S), through inv; the extra slot R points at R."""
    B, N = lab.shape
    S = inv.shape[-1] - 1
    inb = (label_k >= 0) & (label_k < N)
    par = torch.where(inb, torch.gather(lab, 1, label_k.clamp(0, N - 1)).to(_I64), S)
    parx = torch.gather(inv, 1, par.clamp(0, S)).to(_I64)
    return torch.cat([parx, _col(B, R, lab.device)], 1)


WALK_CHECK = 16      # hops between slots_plain's checks that every walk has stopped


def _walk(f: torch.Tensor, x: torch.Tensor, e: int) -> torch.Tensor:
    """f^(2^e)(x) for (B, M) starts x into (B, R + 1) parent maps f, by
    following f: a walk at a fixpoint stays there (every WALK_CHECK hops,
    the walks stop if all are); after R + 1 hops over the R + 1 slots every
    walk is on a cycle, and the 2^e - (R + 1) hops left are taken modulo its
    length."""
    R = f.shape[-1] - 1
    n = 1 << e
    for i in range(min(n, R + 1)):
        y = torch.gather(f, 1, x)
        if i % WALK_CHECK == WALK_CHECK - 1 and i + 1 < n and torch.equal(y, x):
            return x
        x = y
    if n <= R + 1:
        return x
    length, z = torch.ones_like(x), torch.gather(f, 1, x)
    while bool((away := z != x).any()):
        length += away
        z = torch.where(away, torch.gather(f, 1, z), z)
    pw, sq, q = torch.ones_like(x) % length, torch.full_like(x, 2) % length, e
    while q:                                        # 2^e modulo each cycle's length
        if q & 1:
            pw = pw * sq % length
        sq, q = sq * sq % length, q >> 1
    rest = (pw - (R + 1)) % length
    for j in range(int(rest.max())):
        x = torch.where(j < rest, torch.gather(f, 1, x), x)
    return x


def slots_plain(lab: torch.Tensor, inv: torch.Tensor, D: torch.Tensor, n_groups: torch.Tensor,
                steps: int, rank_table: torch.Tensor | None = None,
                cnt: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot tables' chains, from (B, N) int32 pixel labels and scan's
    (inv (B, S + 1), D (B, R), n_groups (B,)): slot k's parent is the slot
    of the label at pixel D[b, k] (rank_table[b, D[b, k]], (B, S), in rank
    mode), R for a slot past n_groups and for the extra slot R; each slot
    follows it 2^s hops, s = max(steps, 1) (the root), which is what s
    pointer doublings give.

    Without cnt (the contraction): ((B, R + 1) int32 map table, root & 0xFFFF
    and R at slot R; (B,) bool n_groups > R).
    With cnt ((B, S) int32 label counts; the final resolve): ((B, R) int32
    root slots, (B, R + 2) int32 acc): acc[:, :R] each root slot's pixels
    (a slot's count cnt[D[k]] added at its root; roots R add nothing, and
    slot R - 1 nothing when n_groups > R), acc[:, R] the counts of slots
    0 .. R - 2 when n_groups > R (slot R - 1 takes them negated), else 0,
    and acc[:, R + 1] 1 where some slot's root differs from its 2^(s-1)
    hops (the chains did not converge), else 0."""
    B, N = lab.shape
    R, S = D.shape[1], inv.shape[1] - 1
    dev = lab.device
    ks = torch.arange(R, device=dev)
    kvalid = ks < n_groups.to(_I64)[:, None]
    Dl = D.to(_I64)
    label_k = Dl if rank_table is None else torch.gather(rank_table.to(_I64), 1,
                                                          Dl.clamp(0, S - 1))
    f = _slot_parents(lab, inv, torch.where(kvalid, label_k, N), R)
    e = max(steps, 1) - 1
    half = _walk(f, torch.arange(R + 1, device=dev).expand(B, -1), e)
    root = _walk(f, half, e)
    over = n_groups > R
    if cnt is None:
        return torch.cat([root[:, :R] & 0xFFFF, _col(B, R, dev)], 1).to(torch.int32), over
    c = torch.where(kvalid, torch.gather(cnt, 1, Dl.clamp(0, S - 1)).to(_I64), 0)
    r = root[:, :R]
    adds = kvalid & (r < R) & ~(over[:, None] & (ks == R - 1))
    totals = torch.zeros((B, R + 1), dtype=_I64, device=dev)
    totals.scatter_add_(1, torch.where(adds, r, R), torch.where(adds, c, 0))
    minus = torch.where(over, c[:, :R - 1].sum(-1), 0)
    unconverged = (half != root).any(-1).to(_I64)
    acc = torch.cat([totals[:, :R], minus[:, None], unconverged[:, None]], 1)
    return r.to(torch.int32), acc.to(torch.int32)


def dense_plain(root: torch.Tensor, acc: torch.Tensor, n_groups: torch.Tensor,
                min_component_pixels: int):
    """The final resolve's area gate and dense ranks, from slots_plain's
    (B, R) root slots and (B, R + 2) acc and the (B,) group counts.

    A root slot r < R is a component when some slot's root is r: its total
    is positive, or it is the root of slot R - 1 when n_groups > R (whose
    total then takes minus acc[:, R]). It is eligible when its total reaches
    min_component_pixels. Its dense id is the count of eligible root slots
    below it (root slots order as the twin's root labels: D increases).
    Returns ((B, R + 1) int32 map table: each slot's dense id through its
    root slot, _KMAX where gated out or past _KMAX - 1, slot R taking slot
    65535's at R = 65536 and _KMAX else; (B,) int64 n_eligible; (B,) bool
    overflow: n_groups > R or n_eligible > _KMAX; (B,) bool converged)."""
    B, R = root.shape
    dev = root.device
    over = n_groups > R
    sp = torch.where(over, root[:, R - 1].to(_I64), -1)
    is_sp = torch.arange(R, device=dev) == sp[:, None]
    totals = acc[:, :R].to(_I64)
    present = (totals > 0) | is_sp
    totals = totals - torch.where(is_sp, acc[:, R:R + 1].to(_I64), 0)
    eligible = present & (totals >= min_component_pixels)
    rank = torch.cumsum(eligible.to(_I64), -1) - eligible.to(_I64)
    dense_r = torch.where(eligible & (rank < _KMAX), rank, _KMAX)
    rl = root.to(_I64)
    dense_k = torch.where(rl < R, torch.gather(dense_r, 1, rl.clamp(max=R - 1)), _KMAX)
    tail = dense_k[:, R - 1:] if R == 1 << 16 else _col(B, _KMAX, dev)
    n_eligible = eligible.sum(-1)
    return (torch.cat([dense_k, tail], 1).to(torch.int32), n_eligible,
            over | (n_eligible > _KMAX), acc[:, R + 1] == 0)


def final_plain(lab: torch.Tensor, inv: torch.Tensor, D: torch.Tensor, n_groups: torch.Tensor,
                steps: int, rank_table: torch.Tensor | None, cnt: torch.Tensor,
                min_component_pixels: int):
    """The final resolve's pass: slots_plain's root slots and totals (with
    cnt), then dense_plain. Returns dense_plain's ((B, R + 1) int32 map
    table, (B,) int64 n_eligible, (B,) bool overflow, (B,) bool converged)."""
    return dense_plain(*slots_plain(lab, inv, D, n_groups, steps, rank_table, cnt), n_groups,
                       min_component_pixels)


PLAIN_PASSES = TablePasses(count_plain, scan_plain, slots_plain, final_plain, map_plain)


def _pixels(label: torch.Tensor, valid: torch.Tensor, R_cap: int | None = None):
    """(B, H, W) or (H, W) labels and validity -> ((B, N) int32 labels,
    (B, N) bool validity, (B, H, W), whether a batch dim was added, R)."""
    label, single = batch_first(label, 2)
    valid, _ = batch_first(valid, 2)
    B, H, W = label.shape
    N = H * W
    R = min(R_cap, N)
    if R > (1 << 16):
        raise ValueError("max_components must be <= 65536 "
                         "(16-bit group ranks, as the twin packs them)")
    lab = label.reshape(B, N).to(torch.int32).contiguous()
    return lab, valid.reshape(B, N).to(torch.bool).contiguous(), (B, H, W), single, R


def resolve_roots_rank_tables(label: torch.Tensor, valid: torch.Tensor, *,
                              max_components: int = 1 << 16, chain_steps: int = 5,
                              passes: TablePasses = PLAIN_PASSES):
    """resolve_roots_rank's results, bit for bit, by the count, scan, slots
    and map passes: rank_img[b, p] = the low 16 bits of the chain-fixpoint
    slot of p's group when that group's rank is under R, else R (as the
    twin's packed broadcast and its rank < R mask give it)."""
    lab, vflat, (B, H, W), single, R = _pixels(label, valid, max_components)
    inv, D, n_groups = passes.scan(passes.count(lab, vflat, H * W), R)
    table, overflow = passes.slots(lab, inv, D, n_groups, chain_steps)
    rank_img = passes.map(lab, vflat, inv, table, R).reshape(B, H, W)
    out = rank_img, D, overflow
    return first_frame(out) if single else out


def resolve_components_tables(label: torch.Tensor, valid: torch.Tensor, *,
                              min_component_pixels: int, max_components: int = 1 << 16,
                              chain_steps: int = 4,
                              rank_table: torch.Tensor | None = None,
                              passes: TablePasses = PLAIN_PASSES) -> ResolvedComponents:
    """resolve_components' results (without with_roots), bit for bit, by the
    count, scan, final and map passes. Two of the twin's behaviours
    on a frame of more than R groups are kept on purpose:
      - slot R - 1's size is the twin's difference against the zero pad of
        its start positions: minus the pixels of slots 0 .. R - 2, so that
        slot is never eligible with a positive size gate;
      - groups past R take, when R = 65536, group 65535's dense id (the
        twin's 16-bit group ranks clamp there), else _KMAX."""
    lab, vflat, (B, H, W), single, R = _pixels(label, valid, max_components)
    N = H * W
    if rank_table is not None:
        rank_table, _ = batch_first(rank_table, 1)
        if rank_table.shape[-1] != R:
            raise ValueError("rank_table capacity mismatch: "
                             f"{rank_table.shape[-1]} != {R}")
        if rank_table.dtype != torch.int32:        # pixels outside [0, N) all read the sentinel
            rank_table = rank_table.clamp(-1, N).to(torch.int32)
        rank_table = rank_table.contiguous()
    SENT = R if rank_table is not None else N       # one past the largest label
    cnt = passes.count(lab, vflat, SENT)
    inv, D, n_groups = passes.scan(cnt, R)
    table, n_eligible, overflow, converged = passes.final(lab, inv, D, n_groups, chain_steps,
                                                          rank_table, cnt,
                                                          min_component_pixels)
    dense = passes.map(lab, vflat, inv, table, _KMAX).reshape(B, H, W)
    out = ResolvedComponents(dense=dense, n_eligible=n_eligible, overflow=overflow,
                             converged=converged)
    return first_frame(out) if single else out
