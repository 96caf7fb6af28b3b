"""The resolve stage's slot passes (ops/resolve.py: slots_plain, the chain
walk, and dense_plain, presence, totals and the dense ranks; the plain
versions of csrc/resolve.cu's slots and dense kernels) against the
formulation they replace, pointer doubling (_pointer_double) and the sort
of the roots (_dense_ranks), bit for bit on every output and dtype, in the
contraction, rank mode and flat mode: on random labels, on the scene and
noise cases of test_torch_resolve_tables.py, and on rows that reach the
edges (a root slot that no slot maps to with a zero size gate, more groups
than R, R = 65536, more than _KMAX eligible components, a chain longer
than 2^s, labels and pixels out of range, an empty frame beside a full
one, cycles walked past R + 1 hops). On those rows a numpy mirror of the
kernels' formulation (components by root slot) equals the plain passes, a
mirror that ranks components by their first slot fails, and the whole
stage equals the twin. The CUDA wrappers route CPU tensors to the plain
versions."""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import SLOT_ROWS, parent_dense_form, parent_slots_form, slot_rows
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib, launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from test_torch_resolve_tables import _front, _speckle

torch.set_num_threads(2)

_KMAX = tres._KMAX
_I64 = torch.int64


def _doubling(lab, inv, D, n_groups, steps, rank_table=None, cnt=None, min_px=0):
    """The formulation the slot passes replace (chip_smoke.py's parent
    forms): the parent map doubled `steps` times, then (final resolve) each
    slot's size with slot R - 1's rule and the stable sort of the root labels
    with its cumsums. Returns what slots_plain returns without cnt, else what
    dense_plain returns."""
    out = parent_slots_form(lab, inv, D, n_groups, steps, rank_table, cnt)
    if cnt is None:
        return out
    root, cnt_k, converged = out
    return (*parent_dense_form(root, cnt_k, n_groups, inv.shape[1] - 1, min_px), converged)


def _plain(lab, inv, D, n_groups, steps, rank_table=None, cnt=None, min_px=0):
    """slots_plain, then (with cnt) dense_plain."""
    out = tres.slots_plain(lab, inv, D, n_groups, steps, rank_table, cnt)
    return out if cnt is None else tres.dense_plain(*out, n_groups, min_px)


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
    """csrc/resolve.cu's dense-id width and slot capacity are ops/resolve.py's."""
    with open(os.path.join(_lib._CSRC, "resolve.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int KBITS = (\d+);", src).group(1)) == tres._KBITS
    assert re.search(r"constexpr int MAX_R = 1 << 16;", src)


def test_cuda_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    """slots and dense on CPU tensors run slots_plain and dense_plain: no
    kernel is built or counted."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_lib, "library", no_library)
    before = launch_counts()
    lab, valid, R, steps, min_px, table = _flat_pixels("cycles walked past R + 1 hops")
    cnt, inv, D, ng = _tables(lab, valid, R)
    _same(rk.slots(lab, inv, D, ng, steps), tres.slots_plain(lab, inv, D, ng, steps))
    root, acc = rk.slots(lab, inv, D, ng, steps, None, cnt)
    _same((root, acc), tres.slots_plain(lab, inv, D, ng, steps, None, cnt))
    _same(rk.dense(root, acc, ng, min_px), tres.dense_plain(root, acc, ng, min_px))
    assert launch_counts() == before


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises: no fallback."""
    t = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.slots(t, t, t, t[0, :1], 3)
    with pytest.raises(ValueError, match="CUDA"):
        rk.dense(t, t, t[0, :1], 1)
