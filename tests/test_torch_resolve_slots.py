"""The resolve stage's slot passes (ops/resolve.py: slots_plain, the chain
walk, the contraction's pass, and final_plain, slots_plain's totals then
dense_plain's presence, gate and dense ranks, the final resolve's; the
plain versions of csrc/resolve.cu's chain kernel) against the formulation
they replace, pointer doubling (_pointer_double) and the sort of the roots
(_dense_ranks), bit for bit on every output and dtype, in the contraction,
rank mode and flat mode: on random labels, on the scene and noise cases of
test_torch_resolve_tables.py, and on rows that reach the edges (a root
slot that no slot maps to with a zero size gate, more groups than R, R =
65536, more than _KMAX eligible components, a chain longer than 2^s,
labels and pixels out of range, an empty frame beside a full one, cycles
walked past R + 1 hops). On those rows a numpy mirror of the formulation
(components by root slot) equals the plain passes, a mirror that ranks
components by their first slot fails, and the whole stage equals the twin.
A numpy mirror of the chain kernel's cluster formulation (each of CLUSTER
blocks owning ceil(R / CLUSTER) slots, double-buffered doubling rounds
with the early stop that skip the slots a round left unchanged, gathers
from the owner block, per-block eligible counts and offsets) equals the
plain passes on those rows and on random tables (odd R among them), and
through the whole stage the twin; a mirror that doubles in place, in one
buffer, does not. The CUDA wrappers route CPU tensors to the plain
versions."""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import SLOT_ROWS, parent_chain_form, slot_rows
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib, launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from test_torch_resolve_tables import _front, _speckle

torch.set_num_threads(2)

_KMAX = tres._KMAX
_I64 = torch.int64


def _doubling(lab, inv, D, n_groups, steps, rank_table=None, cnt=None, min_px=0):
    """The formulation the slot passes replace (chip_smoke.py's
    parent_chain_form): the parent map doubled `steps` times, then (final
    resolve) each slot's size with slot R - 1's rule and the stable sort of
    the root labels with its cumsums. Returns what slots_plain returns
    without cnt, else what final_plain returns."""
    return parent_chain_form(lab, inv, D, n_groups, steps, rank_table, cnt, min_px)


def _plain(lab, inv, D, n_groups, steps, rank_table=None, cnt=None, min_px=0):
    """slots_plain, or (with cnt) final_plain: slots_plain, then dense_plain."""
    if cnt is None:
        return tres.slots_plain(lab, inv, D, n_groups, steps, rank_table)
    return tres.final_plain(lab, inv, D, n_groups, steps, rank_table, cnt, min_px)


def _mirror(lab, inv, D, n_groups, steps, rank_table, cnt, min_px, by="root"):
    """A numpy mirror of the slots and dense kernels' formulation, frame by
    frame: each slot's parent, 2^s hops, components as the slots that share
    a root slot under R (slot R - 1 counting minus slots 0 .. R - 2 with
    more groups than R), the gate, and dense ids in the order of the root
    slots (by="root") or of each component's first slot (by="first", the
    wrong order)."""
    lab, inv, D, cnt = (t.numpy().astype(np.int64) for t in (lab, inv, D, cnt))
    B, N = lab.shape
    R, S = D.shape[1], inv.shape[1] - 1
    hops = 1 << max(steps, 1)
    out = []
    for b in range(B):
        ng = int(n_groups[b])
        nv = min(ng, R)
        ks = np.arange(nv)
        p = D[b, ks] if rank_table is None else rank_table[b].numpy().astype(np.int64)[D[b, ks]]
        inb = (p >= 0) & (p < N)
        l = np.where(inb, lab[b, np.clip(p, 0, N - 1)], S)
        f = np.full(R + 1, R)
        f[ks] = inv[b, np.clip(l, 0, S)]
        x = np.arange(R + 1)
        for i in range(hops):
            x = f[x]
            if i == hops // 2 - 1:
                half = x.copy()
        c = np.zeros(R, np.int64)
        c[ks] = cnt[b, D[b, ks]]
        if ng > R:
            c[R - 1] = -c[:R - 1].sum()
        member = x[ks] < R
        roots, mk = x[ks][member], ks[member]
        size = np.bincount(roots, weights=c[mk], minlength=R).astype(np.int64)
        eligible = (np.bincount(roots, minlength=R) > 0) & (size >= min_px)
        first = np.full(R, R)
        np.minimum.at(first, roots, mk)
        order = np.flatnonzero(eligible)
        if by == "first":
            order = order[np.argsort(first[order], kind="stable")]
        ids = np.full(R + 1, _KMAX)
        ids[order] = np.minimum(np.arange(len(order)), _KMAX)
        table = np.full(R + 1, _KMAX)
        table[ks] = ids[x[ks]]
        if R == 1 << 16:
            table[R] = table[R - 1]
        out.append((table, len(order), ng > R or len(order) > _KMAX, bool((half == x).all())))
    return (torch.from_numpy(np.stack([o[0] for o in out])).to(torch.int32),
            torch.tensor([o[1] for o in out], dtype=_I64),
            torch.tensor([o[2] for o in out]), torch.tensor([o[3] for o in out]))


# --- a numpy mirror of the chain kernel's cluster formulation ---------------

CLUSTER = 8              # csrc/resolve.cu: a frame's blocks, one cluster
CHAIN_THREADS = 1024     # threads a block
CHAIN_PER_THREAD = 8     # slots a thread at most: 65536 / (CLUSTER CHAIN_THREADS)


def _owner(x, P):
    """The block that owns slot x < R: x / P by the kernel's multiply and
    shift, magic = ceil(2^32 / P)."""
    magic = np.uint64(((1 << 32) + P - 1) // P)
    return ((np.asarray(x, np.uint64) * magic) >> np.uint64(32)).astype(np.int64)


def _gather(bufs, x, P, R, fill=None):
    """bufs' entry of each slot x: from the owner block's buffer for x < R
    (a DSMEM read), R (or fill) for x = R."""
    x = np.asarray(x, np.int64)
    out = np.full(x.shape, R if fill is None else fill, np.int64)
    m = x < R
    q = _owner(x[m], P)
    got = np.empty(q.shape, np.int64)
    for b in np.unique(q):
        sel = q == b
        got[sel] = bufs[b][x[m][sel] - b * P]
    out[m] = got
    return out


def _cluster_frame(lab, inv, D, ng, steps, table, cnt, min_px, in_place=False):
    """One frame through the chain kernel's steps: the contraction's (map
    table, overflow) without cnt, else the final resolve's (map table,
    n_eligible, overflow, converged). in_place: the doubling jumps in one
    buffer, slot by slot (a wrong formulation)."""
    N, S, R = lab.shape[0], inv.shape[0] - 1, D.shape[0]
    P = -(-R // CLUSTER)
    ranges = [(min(q * P, R), min(q * P + P, R)) for q in range(CLUSTER)]
    over = ng > R
    cur, counts = [], []
    for lo, hi in ranges:                      # parents, block by block
        k = np.arange(lo, hi)
        live = k < ng
        d = np.where(live, D[k], -1)
        p = d if table is None else np.where(live, table[np.clip(d, 0, S - 1)], -1)
        p = np.where(live, np.where((p >= 0) & (p < N), lab[np.clip(p, 0, N - 1)], S), -1)
        cur.append(np.where(live, inv[np.clip(p, 0, S)], R))
        counts.append(np.where(live, cnt[np.clip(d, 0, S - 1)], 0) if cnt is not None else None)
    # Two buffers a block; a slot that a round leaves unchanged is done: no
    # later round reads or writes it, in either buffer.
    other = [np.full_like(c, -7) for c in cur]
    done = [np.zeros(len(c), bool) for c in cur]
    half = cur
    for _ in range(max(steps, 1)):
        if in_place:
            half = [c.copy() for c in cur]
            for c in cur:
                for i in range(len(c)):
                    c[i] = _gather(cur, [c[i]], P, R)[0]
            changed = any(bool((a != b).any()) for a, b in zip(cur, half))
        else:
            changed = False
            for c, o, d in zip(cur, other, done):
                x = c[~d]
                y = _gather(cur, x, P, R)
                o[~d] = y
                changed |= bool((y != x).any())
                d[~d] = y == x
            half, cur, other = cur, other, cur
        if not changed:
            break
    if cnt is None:
        return np.concatenate([np.concatenate(cur) & 0xFFFF, [R]]), over
    tot = [np.zeros(hi - lo, np.int64) for lo, hi in ranges]
    minus = 0
    for (lo, hi), root, c in zip(ranges, cur, counts):       # DSMEM atomics at the owners
        k = np.arange(lo, hi)
        adds = (c != 0) & (root < R) & ~(over & (k == R - 1))
        own = _owner(root[adds], P)
        for b in np.unique(own):
            sel = own == b
            np.add.at(tot[b], root[adds][sel] - b * P, c[adds][sel])
        minus += int(c[k < R - 1].sum()) if over else 0
    unconverged = any(bool((a != b).any()) for a, b in zip(half, cur))
    sp = int(_gather(cur, [R - 1], P, R)[0]) if over else -1
    elig, bases, block_counts = [], [], []
    for (lo, hi), tt in zip(ranges, tot):   # the gate; ballots a (round j, warp), scanned
        r = np.arange(lo, hi)
        el = ((tt > 0) | (r == sp)) & (tt - np.where(r == sp, minus, 0) >= min_px)
        lanes = np.zeros(CHAIN_PER_THREAD * CHAIN_THREADS, bool)
        lanes[:hi - lo] = el
        ballots = lanes.reshape(CHAIN_PER_THREAD * CHAIN_THREADS // 32, 32)
        pop = ballots.sum(1)
        base = np.repeat(np.cumsum(pop) - pop, 32) + (np.cumsum(ballots, 1) - ballots).ravel()
        elig.append(el)
        bases.append(base[:hi - lo])
        block_counts.append(int(pop.sum()))
    offsets = np.cumsum(block_counts) - block_counts
    total = int(sum(block_counts))
    ids = [np.where(el & (off + base < _KMAX), off + base, _KMAX)
           for el, base, off in zip(elig, bases, offsets)]
    out = np.concatenate([_gather(ids, root, P, R, fill=_KMAX) for root in cur])
    out = np.concatenate([out, [out[R - 1] if R == 1 << 16 else _KMAX]])
    return out, total, over or total > _KMAX, not unconverged


def _cluster(lab, inv, D, n_groups, steps, rank_table=None, cnt=None, min_px=0,
             in_place=False):
    """_cluster_frame on each frame, stacked as slots_plain (without cnt) or
    final_plain returns them."""
    lab, inv, D = (t.numpy().astype(np.int64) for t in (lab, inv, D))
    tab = None if rank_table is None else rank_table.numpy().astype(np.int64)
    cn = None if cnt is None else cnt.numpy().astype(np.int64)
    frames = [_cluster_frame(lab[b], inv[b], D[b], int(n_groups[b]), steps,
                             None if tab is None else tab[b], None if cn is None else cn[b],
                             min_px, in_place) for b in range(lab.shape[0])]
    table = torch.from_numpy(np.stack([f[0] for f in frames])).to(torch.int32)
    if cnt is None:
        return table, torch.tensor([f[1] for f in frames])
    return (table, torch.tensor([f[1] for f in frames], dtype=_I64),
            torch.tensor([f[2] for f in frames]), torch.tensor([f[3] for f in frames]))


CLUSTER_PASSES = tres.TablePasses(tres.count_plain, tres.scan_plain, _cluster, _cluster,
                                  tres.map_plain)


def _same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), f"field {i} differs"


def _tables(lab, valid, R, rank_table=None):
    """(B, N) labels through count_plain and scan_plain: (cnt, inv, D,
    n_groups) of flat labels (S = N) or of ranks (S = R)."""
    S = R if rank_table is not None else lab.shape[1]
    cnt = tres.count_plain(lab, valid, S)
    return (cnt, *tres.scan_plain(cnt, R))


def _check_slots(lab, valid, R, steps, min_px, rank_table=None, contraction=True):
    """slots_plain and dense_plain against _doubling in the final resolve,
    and slots_plain alone against it in the contraction; returns the final
    resolve's outputs."""
    cnt, inv, D, ng = _tables(lab, valid, R, rank_table)
    got = _plain(lab, inv, D, ng, steps, rank_table, cnt, min_px)
    _same(got, _doubling(lab, inv, D, ng, steps, rank_table, cnt, min_px))
    if contraction:
        _same(_plain(lab, inv, D, ng, steps), _doubling(lab, inv, D, ng, steps))
    return got


# --- rows that reach the edges (chip_smoke.py's SLOT_ROWS) ------------------

ROWS = {name: (torch.from_numpy(lab), torch.from_numpy(valid), R, steps, min_px,
               None if table is None else torch.from_numpy(table))
        for name, (lab, valid, R, steps, min_px, table) in slot_rows().items()}


def _flat_pixels(name):
    labels, valid, R, steps, min_px, table = ROWS[name]
    B = labels.shape[0]
    return labels.reshape(B, -1), valid.reshape(B, -1), R, steps, min_px, table


@pytest.mark.parametrize("name", SLOT_ROWS)
def test_edge_rows_match_the_doubling(name):
    """Each row through slots_plain and dense_plain against the doubling and
    the sort of the roots, and what the row is built to show."""
    lab, valid, R, steps, min_px, table = _flat_pixels(name)
    got = _check_slots(lab, valid, R, steps, min_px, table, contraction=table is None)
    cnt, inv, D, ng = _tables(lab, valid, R, table)
    root, acc = tres.slots_plain(lab, inv, D, ng, steps, table, cnt)
    if "no slot maps" in name:
        free = set(range(int(ng[0]))) - set(root[0].tolist())
        assert free and not bool(got[3][0])           # unconverged, root slots nobody maps to
    if "more groups" in name or "no valid" in name:
        assert bool(got[2][-1]) and int(acc[-1, R]) > 0
    if "more groups" in name:                     # one root slot, of total 0 under a gate of 1
        assert set(root[1].tolist()) == {0} and int(got[1][1]) == 0
    if "65536" in name:
        assert int(got[0][0, R]) == int(got[0][0, R - 1]) == 1 and bool(got[2][0])
    if "_KMAX" in name:
        assert int(got[1][0]) > _KMAX and bool(got[2][0])
        assert int(got[0][0, -2]) == _KMAX
    if "longer" in name:
        assert not bool(got[3][0])
    if "no valid" in name:
        assert int(ng[0]) == 0 and int(got[1][0]) == 0 and bool((got[0][0] == _KMAX).all())
    if "cycles" in name:
        assert 1 << (steps - 1) > R + 1


@pytest.mark.parametrize("name", SLOT_ROWS)
def test_edge_rows_stage_matches_the_twin(name):
    """The whole stage on each row, the plain composition against the twin:
    the final resolve, and (flat rows) the contraction."""
    labels, valid, R, steps, min_px, table = ROWS[name]
    kw = dict(min_component_pixels=min_px, max_components=R, chain_steps=steps)
    if table is not None:
        kw["rank_table"] = table
    _same(tres.resolve_components_tables(labels, valid, **kw),
          tres.resolve_components(labels, valid, **kw))
    if table is None:
        rkw = dict(max_components=R, chain_steps=steps)
        _same(tres.resolve_roots_rank_tables(labels, valid, **rkw),
              tres.resolve_roots_rank(labels, valid, **rkw))


@pytest.mark.parametrize("name", SLOT_ROWS)
def test_mirror_ranks_components_by_root_slot(name):
    """The numpy mirror of the kernels' formulation equals the plain passes
    on each row; a mirror that ranks components by their first slot does
    not."""
    lab, valid, R, steps, min_px, table = _flat_pixels(name)
    cnt, inv, D, ng = _tables(lab, valid, R, table)
    args = (lab, inv, D, ng, steps, table, cnt, min_px)
    got = _plain(*args)
    _same(_mirror(*args), got)
    wrong = _mirror(*args, by="first")
    assert not torch.equal(wrong[0], got[0])


@pytest.mark.parametrize("name", SLOT_ROWS)
def test_cluster_mirror_matches_the_plain_passes(name):
    """The chain kernel's cluster formulation on each row: the final resolve
    equal to final_plain, the contraction (flat rows) to slots_plain, and
    the whole stage through it (CLUSTER_PASSES) equal to the twin."""
    lab, valid, R, steps, min_px, table = _flat_pixels(name)
    cnt, inv, D, ng = _tables(lab, valid, R, table)
    _same(_cluster(lab, inv, D, ng, steps, table, cnt, min_px),
          _plain(lab, inv, D, ng, steps, table, cnt, min_px))
    if table is None:
        _same(_cluster(lab, inv, D, ng, steps), _plain(lab, inv, D, ng, steps))
    labels, valid, _, _, _, _ = ROWS[name]
    kw = dict(min_component_pixels=min_px, max_components=R, chain_steps=steps)
    if table is not None:
        kw["rank_table"] = table
    _same(tres.resolve_components_tables(labels, valid, passes=CLUSTER_PASSES, **kw),
          tres.resolve_components(labels, valid, **kw))
    if table is None:
        rkw = dict(max_components=R, chain_steps=steps)
        _same(tres.resolve_roots_rank_tables(labels, valid, passes=CLUSTER_PASSES, **rkw),
              tres.resolve_roots_rank(labels, valid, **rkw))


def test_in_place_doubling_differs_on_a_long_chain():
    """Doubling in one buffer (a slot reads entries that this round already
    jumped) is not f^(2^s) on a chain that has not converged: on the chain
    longer than 2^s the in-place mirror's tables differ from the plain
    passes, while the double-buffered mirror's equal them."""
    lab, valid, R, steps, min_px, _ = _flat_pixels(
        "a chain longer than 2^s, pixel labels out of range")
    cnt, inv, D, ng = _tables(lab, valid, R)
    want = _plain(lab, inv, D, ng, steps, None, cnt, min_px)
    _same(_cluster(lab, inv, D, ng, steps, None, cnt, min_px), want)
    wrong = _cluster(lab, inv, D, ng, steps, None, cnt, min_px, in_place=True)
    assert not torch.equal(wrong[0], want[0]) and bool(wrong[3][0]) != bool(want[3][0])
    assert not torch.equal(_cluster(lab, inv, D, ng, steps, in_place=True)[0],
                           _plain(lab, inv, D, ng, steps)[0])


def test_owner_division_is_exact():
    """The kernel's x / P by a multiply and a shift is exact for every slot
    x <= 8 P at every P a block may own (R in [1, 65536]): it is monotone in
    x, so exactness at each multiple of P and one below it suffices."""
    for P in range(1, (1 << 16) // CLUSTER + 1):
        q = np.arange(1, CLUSTER + 1)
        x = np.concatenate([[0], q * P - 1, q * P])
        assert (_owner(x, P) == x // P).all(), P


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_slot_tables_cluster_mirror(seed):
    """test_random_slot_tables_match_the_doubling's tables (and capacities R
    that are not multiples of CLUSTER: 7 leaves blocks without a slot)
    through the cluster mirror, equal to the plain passes."""
    rng = np.random.default_rng(seed)
    B, N = 3, 600
    valid = torch.from_numpy(rng.random((B, N)) < 0.7)
    lab = torch.from_numpy(rng.integers(0, N, (B, N), dtype=np.int32))
    lab = torch.where(valid, lab, torch.from_numpy(rng.integers(-5, 3 * N, (B, N),
                                                                dtype=np.int32)))
    for R, steps, min_px in ((7, 3, 1), (16, 6, 2), (64, 3, 1), (N, 1, 0), (N // 2, 5, 3),
                             (N - 3, 4, 2)):
        cnt, inv, D, ng = _tables(lab, valid, R)
        _same(_cluster(lab, inv, D, ng, steps, None, cnt, min_px),
              _plain(lab, inv, D, ng, steps, None, cnt, min_px))
        _same(_cluster(lab, inv, D, ng, steps), _plain(lab, inv, D, ng, steps))
    R = 64
    ranks = torch.from_numpy(rng.integers(0, R + 1, (B, N), dtype=np.int32))
    table = torch.from_numpy(rng.integers(-3, N + 4, (B, R), dtype=np.int32))
    for steps, min_px in ((2, 2), (7, 0)):
        cnt, inv, D, ng = _tables(ranks, valid, R, table)
        _same(_cluster(ranks, inv, D, ng, steps, table, cnt, min_px),
              _plain(ranks, inv, D, ng, steps, table, cnt, min_px))


def test_cluster_mirror_at_the_main_path_capacity_plus_one():
    """R = 28801, the 720p capacity plus one: P = 3601 slots a block, the
    last block short; a random frame of 40000 pixels in flat mode."""
    rng = np.random.default_rng(9)
    N, R = 40000, 28801
    valid = torch.from_numpy(rng.random((1, N)) < 0.8)
    lab = torch.from_numpy(rng.integers(0, N, (1, N), dtype=np.int32))
    cnt, inv, D, ng = _tables(lab, valid, R)
    assert int(ng[0]) < R
    for steps, min_px in ((3, 2), (5, 1)):
        _same(_cluster(lab, inv, D, ng, steps, None, cnt, min_px),
              _plain(lab, inv, D, ng, steps, None, cnt, min_px))
        _same(_cluster(lab, inv, D, ng, steps), _plain(lab, inv, D, ng, steps))


# --- random tables, scenes and noise -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_slot_tables_match_the_doubling(seed):
    """Labels that point anywhere (garbage at invalid pixels, negative and
    past the frame), so parents point up and down and form cycles, at
    several capacities and chain steps; ranks with a rank table of pixels in
    and out of the frame."""
    rng = np.random.default_rng(seed)
    B, N = 3, 600
    valid = torch.from_numpy(rng.random((B, N)) < 0.7)
    lab = torch.from_numpy(rng.integers(0, N, (B, N), dtype=np.int32))
    lab = torch.where(valid, lab, torch.from_numpy(rng.integers(-5, 3 * N, (B, N),
                                                                dtype=np.int32)))
    for R, steps, min_px in ((16, 6, 2), (64, 3, 1), (N, 1, 0), (N // 2, 5, 3)):
        _check_slots(lab, valid, R, steps, min_px)
    R = 64
    ranks = torch.from_numpy(rng.integers(0, R + 1, (B, N), dtype=np.int32))
    table = torch.from_numpy(rng.integers(-3, N + 4, (B, R), dtype=np.int32))
    for steps, min_px in ((2, 2), (7, 0)):
        _check_slots(ranks, valid, R, steps, min_px, table, contraction=False)


@pytest.mark.parametrize("case", ["scene", "scenes of noise 3", "speckle"])
def test_scenes_and_noise_match_the_doubling(case):
    """The phase-1 labels of test_torch_resolve_tables.py's scenes and
    speckle (the contraction and the flat resolve), and their phase-2 rank
    labels after the contraction (the rank-mode resolve)."""
    tri, lab = {"scene": lambda: _front((0,)), "scenes of noise 3": lambda: _front((1, 2, 3), 3.0),
                "speckle": lambda: _speckle((2, 96, 160))}[case]()
    tri, lab = torch.from_numpy(tri), torch.from_numpy(lab)
    B = tri.shape[0]
    valid = tri != 127
    for R in (256, 1 << 16):
        R = min(R, lab[0].numel())
        _check_slots(lab.reshape(B, -1), valid.reshape(B, -1), R, 5, 25)
        rank_img, table, _ = tres.resolve_roots_rank(lab, valid, max_components=R, chain_steps=5)
        lab2, _ = ccl_scan(tri, 3, backend="torch", label0=rank_img)
        _check_slots(lab2.reshape(B, -1), valid.reshape(B, -1), R, 3, 25, table,
                     contraction=False)


# --- the kernels' source and wrappers on the CPU -----------------------------


def test_kernel_constants_match_the_plain_versions():
    """csrc/resolve.cu's dense-id width and slot capacity are ops/resolve.py's,
    and its chain kernel's cluster size, threads and slots a block are the
    cluster mirror's, within a block's shared memory (227 KB)."""
    with open(os.path.join(_lib._CSRC, "resolve.cu")) as f:
        src = f.read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("KBITS")) == tres._KBITS
    assert const("MAX_R") == "1 << 16"
    assert int(const("CLUSTER")) == CLUSTER and int(const("CHAIN_THREADS")) == CHAIN_THREADS
    assert const("CHAIN_SLOTS") == "MAX_R / CLUSTER"
    assert const("CHAIN_PER_THREAD") == "CHAIN_SLOTS / CHAIN_THREADS"
    assert (1 << 16) // CLUSTER // CHAIN_THREADS == CHAIN_PER_THREAD
    assert const("CHAIN_SMEM") == "CHAIN_SLOTS * 14"
    assert (1 << 16) // CLUSTER * 14 <= 232448


def test_cuda_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    """slots and final on CPU tensors run slots_plain and final_plain: no
    kernel is built or counted."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_lib, "library", no_library)
    before = launch_counts()
    lab, valid, R, steps, min_px, table = _flat_pixels("cycles walked past R + 1 hops")
    cnt, inv, D, ng = _tables(lab, valid, R)
    _same(rk.slots(lab, inv, D, ng, steps), tres.slots_plain(lab, inv, D, ng, steps))
    _same(rk.final(lab, inv, D, ng, steps, None, cnt, min_px),
          tres.final_plain(lab, inv, D, ng, steps, None, cnt, min_px))
    assert launch_counts() == before


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises: no fallback."""
    t = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.slots(t, t, t, t[0, :1], 3)
    with pytest.raises(ValueError, match="CUDA"):
        rk.final(t, t, t, t[0, :1], 3, None, t, 1)
