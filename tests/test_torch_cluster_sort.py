"""The cluster stage's sort of the kept pairs on the CPU.

The CUDA path (ops/cuda/cluster_moments.py::sort_pairs, csrc/
cluster_moments.cu) compacts the kept pairs tile by tile, (offset, block of
pixels) in offset-major order, and sorts them by a stable LSD radix sort:
each pass a histogram of each sort tile's digits, the (digit, tile) scan in
digit-major order, and each key's rank among the keys of its digit before
it in its tile. A numpy mirror of those steps, at small tiles and digit
widths and at the kernels' own, is held here to numpy's stable argsort and
to the kernels' plain versions (ops/cluster_moments.py: pair_count_plain,
pair_write_plain, radix_scatter_plain), and their composition to the
reference's stable sort of the padded row (edge_pairs_plain, then
torch.sort), on noisy scenes, on chip_smoke.py's synthetic frames (an empty
frame beside a checkerboard, one key, the largest dense ids, more kept pairs
than E) and on its synthetic rows of kept keys (all keys equal, keys at
2^30 - 1, K = 0 beside a full row, K on tile boundaries, K past E). A mirror
whose first or last pass ranks ties from the higher position must fail on
each of them. The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import SORT_FRAMES, SORT_ROWS, sort_frames, sort_rows
from isaac_ros_apriltag_tpu_torch.config import DetectorConfig
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as P
from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib
from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as K
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

torch.set_num_threads(2)

I32MAX = np.iinfo(np.int32).max
KEY_BITS = 30                # two 15-bit dense ids
KMAT = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]], np.float32)
# (pixels a compaction block, positions a sort tile, digit bits): small ones
# that cut every case into many tiles and passes, and the kernels' own.
MIRROR_SIZES = ((16, 8, 3), (64, 64, 5), (1024, 1024, P.RADIX_BITS),
                (4096, 4096, P.RADIX_BITS))
ROWS = sort_rows()
FRAMES = sort_frames()


@pytest.fixture(scope="module")
def scenes():
    """Two noisy 480x640 frames (three tags, noise 2 and 3) through the plain
    front: name -> (trinary, dense ids, E) at 240x320, at the detector's E
    and at E 124, where the kept pairs pass E (stride > 1)."""
    fam = get_family("tag36h11")
    imgs = []
    for k, noise in enumerate((2.0, 3.0)):
        tags = []
        for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.2, 0.18)]):
            t = np.array([x, y, 1.1 + 0.1 * k])
            tags.append(dict(family=fam, id=5 * i + 2 + k, R=upright_pose(t, 0.1 * i), t=t,
                             tag_size=0.16))
        imgs.append(render_tags(KMAT, (480, 640), tags, noise=noise))
    gray = torch.from_numpy(np.stack(imgs)).to(torch.float32)
    tri = adaptive_threshold(_pad_to_tiles(_decimate(gray, 2), 4), 4, 5)
    valid = tri != 127
    E, R = DetectorConfig(backend="torch").effective_capacities(*tri.shape[-2:])
    lab, _ = ccl_scan(tri, 8, backend="torch")
    rank_img, table, _ = resolve_roots_rank(lab, valid, max_components=R)
    lab, _ = ccl_scan(tri, 6, backend="torch", label0=rank_img)
    dense = resolve_components(lab, valid, min_component_pixels=25, max_components=R,
                               chain_steps=3, rank_table=table).dense
    return {"noisy scenes": (tri, dense, E), "noisy scenes, E 124": (tri, dense, 124)}


def _frame_case(scenes, name):
    if name in scenes:
        return scenes[name]
    tri, dense, E = FRAMES[name]
    return torch.from_numpy(tri), torch.from_numpy(dense), E


FRAME_CASES = ("noisy scenes", "noisy scenes, E 124", *SORT_FRAMES)


# --- the numpy mirror ------------------------------------------------------


def mirror_compact(tri, dense, num_edge, E, block):
    """The compaction's steps, frame by frame: each (offset o, block of
    `block` pixels) tile's kept pairs counted, the tiles' first positions
    by an exclusive scan of the counts in o-major order, and each kept pair
    placed at its tile's first position plus the kept pairs before it in
    the tile.
    Returns (the tiles' counts (B, 4 nblk), kept (B,), keys and pays (B,
    4 H W), int32 max and 0 past K)."""
    key, pay, mask = (a.numpy() for a in P._pairs(tri, dense))
    keep = P._keep(torch.from_numpy(pay), torch.from_numpy(mask),
                   P._edge_stride(num_edge, E)).numpy()
    B, N = key.shape
    HW = N // 4
    nblk = -(-HW // block)
    counts = np.zeros((B, 4 * nblk), np.int64)
    keys = np.full((B, N), I32MAX, np.int64)
    pays = np.zeros((B, N), np.int64)
    kept = np.zeros(B, np.int64)
    for b in range(B):
        tiles = np.zeros((4, nblk * block), bool)
        tiles[:, :HW] = keep[b].reshape(4, HW)
        counts[b] = tiles.reshape(4 * nblk, block).sum(-1)
        first = np.cumsum(counts[b]) - counts[b]
        rank = np.cumsum(tiles.reshape(4 * nblk, block), -1) - 1
        at = (first[:, None] + rank).reshape(4, -1)[:, :HW].reshape(-1)
        keys[b, at[keep[b]]] = key[b][keep[b]]
        pays[b, at[keep[b]]] = pay[b][keep[b]]
        kept[b] = counts[b].sum()
    return counts, kept, keys, pays


def mirror_pass(keys, pays, kept, k, tile, bits, ties_high=False):
    """Radix pass k of `bits`-bit digits, frame by frame: each sort tile's
    histogram of its keys' digits, the (digit, tile) scan in digit-major
    order, and each key's rank among the keys of its digit before it in its
    tile (after it, when `ties_high`: wrong on purpose). Returns (keys,
    pays, each frame's (tile, digit) destinations)."""
    R = 1 << bits
    out_k, out_p, offs = np.full_like(keys, I32MAX), np.zeros_like(pays), []
    for b, n in enumerate(kept):
        d = (keys[b, :n] >> (bits * k)) & (R - 1)
        t = np.arange(n) // tile
        T = -(-n // tile)
        hist = np.bincount(t * R + d, minlength=T * R).reshape(T, R)
        by_digit = hist.T.reshape(-1)
        dest = (np.cumsum(by_digit) - by_digit).reshape(R, T).T          # (tile, digit)
        group = t * R + d
        order = np.argsort(group, kind="stable")
        starts = np.r_[0, np.cumsum(np.bincount(group, minlength=T * R))[:-1]]
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - starts[group[order]]
        if ties_high:
            rank = hist[t, d] - 1 - rank
        at = dest[t, d] + rank
        out_k[b, at], out_p[b, at] = keys[b, :n], pays[b, :n]
        offs.append(dest)
    return out_k, out_p, offs


def mirror_sort(keys, pays, kept, tile, bits, ties_high_in=None):
    """All the passes; pass `ties_high_in` ranks ties from the higher
    position (wrong on purpose: in every pass, an even number of passes
    would undo it on keys that all tie)."""
    for k in range(-(-KEY_BITS // bits)):
        keys, pays, _ = mirror_pass(keys, pays, kept, k, tile, bits, k == ties_high_in)
    return keys, pays


def stable_argsort(keys, pays, kept):
    """Each frame's keys [0, K) and pays in numpy's stable argsort order."""
    out_k, out_p = np.full_like(keys, I32MAX), np.zeros_like(pays)
    for b, n in enumerate(kept):
        order = np.argsort(keys[b, :n], kind="stable")
        out_k[b, :n], out_p[b, :n] = keys[b, order], pays[b, order]
    return out_k, out_p


def _row(name):
    keys, pays, kept, E = ROWS[name]
    return keys.astype(np.int64), pays.astype(np.int64), kept.astype(np.int64), E


def _rows_torch(keys, pays):
    return P.SortRows(key=torch.from_numpy(keys.astype(np.int32)),
                      pay=torch.from_numpy(pays.astype(np.int32)))


def _tiles_of(keys, kept):
    """PairTiles as the count kernel leaves them for rows of kept keys."""
    B, N = keys.shape
    key = torch.from_numpy(keys.astype(np.int32))
    T = -(-N // P.sort_tile(B, N))
    return P.PairTiles(counts=torch.zeros((B, 4), dtype=torch.int32),
                       kept=torch.from_numpy(kept.astype(np.int32)),
                       digits=torch.stack([P.digit_counts_plain(key, torch.from_numpy(kept), 0)]
                                          + [torch.zeros((B, P.RADIX), dtype=torch.int32)]
                                          * (P.SORT_PASSES - 1)),
                       look=torch.zeros((P.SORT_PASSES, B, T, P.RADIX), dtype=torch.int32),
                       ctl=torch.zeros((B, P.CTL), dtype=torch.int32))


# --- the synthetic rows of kept keys -------------------------------------


@pytest.mark.parametrize("size", MIRROR_SIZES[1:], ids=lambda s: f"tile{s[1]}-bits{s[2]}")
@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_mirror_sorts_rows_like_stable_argsort(name, size):
    """The radix mirror at sort tiles of 64, 1024 and 4096 positions and
    5- and 8-bit digits sorts each synthetic row as numpy's stable argsort."""
    _, tile, bits = size
    keys, pays, kept, _ = _row(name)
    got = mirror_sort(keys, pays, kept, tile, bits)
    want = stable_argsort(keys, pays, kept)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_plain_passes_match_mirror_on_rows(name):
    """radix_scatter_plain, pass by pass, gives the mirror's keys and pays
    at the kernels' tile and digit width; the mirror's destinations are the
    digit counts each pass is given scanned, and each pass gives the next
    pass's digit counts."""
    keys, pays, kept, _ = _row(name)
    B, N = keys.shape
    tile = P.sort_tile(B, N)
    tiles = _tiles_of(keys, kept)
    rows = _rows_torch(keys, pays)
    mk, mp = keys, pays
    for k in range(P.SORT_PASSES):
        counts = tiles.digits[k].numpy()
        mk2, mp2, offs = mirror_pass(mk, mp, kept, k, tile, P.RADIX_BITS)
        for b, dest in enumerate(offs):
            if len(dest):
                np.testing.assert_array_equal(dest[0], np.cumsum(counts[b]) - counts[b])
        rows, nxt = P.radix_scatter_plain(rows, tiles, k)
        if nxt is not None:
            np.testing.assert_array_equal(nxt.numpy(), P.digit_counts_plain(
                torch.from_numpy(mk2.astype(np.int32)), tiles.kept, k + 1).numpy())
            tiles.digits[k + 1] = nxt
        mk, mp = mk2, mp2
        np.testing.assert_array_equal(rows.key.numpy(), mk, err_msg=f"pass {k}")
        for b, n in enumerate(kept):
            np.testing.assert_array_equal(rows.pay.numpy()[b, :n], mp[b, :n], err_msg=f"pass {k}")


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_cpu_radix_wrapper_runs_the_plain_passes(name):
    """On CPU tensors radix_scatter runs radix_scatter_plain and launches
    nothing; SORT_PASSES passes give numpy's stable argsort."""
    keys, pays, kept, E = _row(name)
    tiles = _tiles_of(keys, kept)
    rows = _rows_torch(keys, pays)
    launches = K.scatter_launches
    for k in range(P.SORT_PASSES):
        rows = K.radix_scatter(rows, tiles, k, E=E)
    assert K.scatter_launches == launches, "nothing launched on the CPU"
    want = stable_argsort(keys, pays, kept)
    np.testing.assert_array_equal(rows.key.numpy(), want[0])
    for b, n in enumerate(kept):
        np.testing.assert_array_equal(rows.pay.numpy()[b, :n], want[1][b, :n])


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_rows_expose_a_mirror_with_ties_high(name):
    """Each synthetic row holds equal digits within a tile: a mirror whose
    first or last pass ranks them from the higher position sorts it
    otherwise, at the kernels' tile and digits and at small ones."""
    keys, pays, kept, _ = _row(name)
    want = stable_argsort(keys, pays, kept)
    for tile, bits in ((P.sort_tile(*keys.shape), P.RADIX_BITS), (8, 3)):
        for wrong in (0, -(-KEY_BITS // bits) - 1):
            got = mirror_sort(keys, pays, kept, tile, bits, ties_high_in=wrong)
            assert not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])), \
                f"{name}: the mirror with ties high in pass {wrong} agrees at tile {tile}"


def test_rows_reach_their_edges():
    """The rows hold what they are named for, at the kernels' tiles."""
    keys, _, kept, _ = ROWS["all keys equal, ties across every tile"]
    assert all(len(np.unique(keys[b, :n])) == 1 for b, n in enumerate(kept))
    assert kept[0] > 4 * P.sort_tile(*keys.shape)
    keys, _, kept, _ = ROWS["keys at 2^30 - 1 and 0"]
    assert keys[0, :kept[0]].max() == (1 << 30) - 1 and keys[0, :kept[0]].min() == 0
    keys, _, kept, _ = ROWS["K = 0 beside a full row"]
    assert kept.tolist() == [0, keys.shape[1]]
    for name, tile in (("K on 1024-position tile boundaries", 1024),
                       ("K on 4096-position tile boundaries", 4096)):
        keys, _, kept, _ = ROWS[name]
        assert P.sort_tile(*keys.shape) == tile and (kept % tile == 0).all() and kept.max() > tile
    keys, _, kept, E = ROWS["K past E, tiles walked in a loop"]
    tile = P.sort_tile(*keys.shape)
    assert (kept > E).all() and -(-kept.min() // tile) > 2 * -(-E // tile)
    # The kernels' 4096-position tiles stage a tile in shared memory: a
    # frame's blocks each take several of them in turn.
    keys, _, kept, E = ROWS["K past E, 4096-position tiles walked in a loop"]
    tile = P.sort_tile(*keys.shape)
    assert tile == 4096 and -(-kept.max() // tile) > 4 * -(-E // tile)
    assert kept[1] % tile == 0 and len(np.unique(keys[1, :kept[1]])) == 1 and kept[3] == 0


# --- the compaction and the whole sort on frames --------------------------


@pytest.mark.parametrize("block", (16, 64, 1024, 4096))
@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_compaction_matches_mirror(scenes, name, block):
    """pair_count_plain and pair_write_plain at compaction blocks of 16, 64
    and 1024 (the kernels') and 4096 pixels: the tiles' counts, the kept
    counts and the kept pairs in layout order are the mirror's; the first
    pass's digit counts are those of the kept keys, the others' 0."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    counts, kept, keys, pays = mirror_compact(tri, dense, ne, E, block)
    tiles = P.pair_count_plain(tri, dense, ne, E, block=block)
    np.testing.assert_array_equal(tiles.counts.numpy(), counts)
    np.testing.assert_array_equal(tiles.kept.numpy(), kept)
    rows = P.pair_write_plain(tri, dense, ne, tiles, E, block=block)
    np.testing.assert_array_equal(rows.key.numpy(), keys)
    np.testing.assert_array_equal(rows.pay.numpy(), pays)
    want = P.digit_counts_plain(rows.key, tiles.kept, 0)
    np.testing.assert_array_equal(tiles.digits[0].numpy(), want.numpy())
    assert not tiles.digits[1:].any()


@pytest.mark.parametrize("size", MIRROR_SIZES, ids=lambda s: f"block{s[0]}-tile{s[1]}-bits{s[2]}")
@pytest.mark.parametrize("name", FRAME_CASES)
def test_mirror_sorts_frames_like_torch_sort(scenes, name, size):
    """The mirror's compaction and radix passes at each size give the
    reference's stable sort of the padded row: keys on the whole row, pays
    on [0, K)."""
    block, tile, bits = size
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    _, kept, keys, pays = mirror_compact(tri, dense, ne, E, block)
    got_k, got_p = mirror_sort(keys, pays, kept, tile, bits)
    key, pay = P.edge_pairs_plain(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    np.testing.assert_array_equal(got_k, key_s.numpy())
    pay_s = torch.gather(pay, 1, perm).numpy()
    for b, n in enumerate(kept):
        np.testing.assert_array_equal(got_p[b, :n], pay_s[b, :n])


@pytest.mark.parametrize("block", (16, 1024, 4096))
@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_sort_equals_edge_pairs_and_torch_sort(scenes, name, block):
    """sort_pairs_plain (the count, write and radix passes' plain versions
    composed) equals edge_pairs_plain followed by torch.sort(stable=True),
    and each pass equals the mirror's at the kernels' tile and digits."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    rows, kept = P.sort_pairs_plain(tri, dense, ne, E, block=block)
    key, pay = P.edge_pairs_plain(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    assert torch.equal(rows.key, key_s)
    pay_s = torch.gather(pay, 1, perm)
    for b, n in enumerate(kept.tolist()):
        assert torch.equal(rows.pay[b, :n], pay_s[b, :n])
    tiles = P.pair_count_plain(tri, dense, ne, E, block=block)
    step = P.pair_write_plain(tri, dense, ne, tiles, E, block=block)
    mk, mp = step.key.numpy().astype(np.int64), step.pay.numpy().astype(np.int64)
    tile = P.sort_tile(*step.key.shape)
    for k in range(P.SORT_PASSES):
        step, nxt = P.radix_scatter_plain(step, tiles, k)
        if nxt is not None:
            tiles.digits[k + 1] = nxt
        mk, mp, _ = mirror_pass(mk, mp, tiles.kept.numpy(), k, tile, P.RADIX_BITS)
        np.testing.assert_array_equal(step.key.numpy(), mk, err_msg=f"pass {k}")


@pytest.mark.parametrize("name", FRAME_CASES)
def test_frames_expose_a_mirror_with_ties_high(scenes, name):
    """Each frame's kept keys tie within sort tiles: a mirror whose first or
    last pass ranks ties from the higher position sorts them otherwise."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    _, kept, keys, pays = mirror_compact(tri, dense, ne, E, P.PAIR_BLOCK)
    want = stable_argsort(keys, pays, kept)
    for wrong in (0, P.SORT_PASSES - 1):
        got = mirror_sort(keys, pays, kept, P.sort_tile(*keys.shape), P.RADIX_BITS,
                          ties_high_in=wrong)
        assert not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])), wrong


@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_sort_at_a_cut_num_edge(scenes, name):
    """With num_edge cut to a quarter of the frame's pairs the stride falls
    and more pairs may be kept than num_edge: sort_pairs_plain still equals
    edge_pairs_plain followed by torch.sort(stable=True), at the kernels'
    block and tile and at the mirror's small ones."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense) // 4
    key, pay = P.edge_pairs_plain(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    pay_s = torch.gather(pay, 1, perm)
    for block, tile in ((None, None), (16, 8)):
        rows, kept = P.sort_pairs_plain(tri, dense, ne, E, block=block, tile=tile)
        assert torch.equal(rows.key, key_s)
        for b, n in enumerate(kept.tolist()):
            assert torch.equal(rows.pay[b, :n], pay_s[b, :n])


def test_cut_num_edge_keeps_more_than_num_edge(scenes):
    """The cut reaches what it is for: some frame keeps more pairs than
    its num_edge."""
    over = []
    for name in FRAME_CASES:
        tri, dense, E = _frame_case(scenes, name)
        ne = P.edge_count_plain(tri, dense) // 4
        over.append(bool((P.pair_count_plain(tri, dense, ne, E).kept > ne).any()))
    assert any(over)


def test_frames_reach_their_edges(scenes):
    """The frames hold what they are named for: an empty frame beside one
    decimated at stride 3, one key, keys of the largest dense ids, and more
    kept pairs than E (stride > 1), here and in the noisy scenes at E 124."""
    def facts(name):
        tri, dense, E = _frame_case(scenes, name)
        ne = P.edge_count_plain(tri, dense)
        rows, kept = P.sort_pairs_plain(tri, dense, ne, E)
        return rows, kept, P._edge_stride(ne, E), E

    rows, kept, stride, _ = facts("an empty frame beside a checkerboard (stride 3)")
    assert kept[0] == 0 and kept[1] > 0 and stride.tolist() == [1, 3]
    rows, kept, _, _ = facts("one key: a black half and a white half")
    assert kept[0] > 0 and (rows.key[0, :int(kept[0])] == 1).all()
    rows, kept, _, _ = facts("the largest dense ids")
    assert int(rows.key[0, int(kept[0]) - 1]) == (32766 << 15) | 32766
    for name in ("K past E: a checkerboard at E 240 (stride 57)", "noisy scenes, E 124"):
        _, kept, stride, E = facts(name)
        assert (kept > E).any() and (stride > 1).all(), name


def test_cpu_sort_wrappers_run_the_plain_versions(scenes):
    """On CPU tensors pair_count, pair_write and sort_pairs run their plain
    versions, at the kernels' block of pixels, and launch nothing."""
    tri, dense, E = scenes["noisy scenes"]
    ne = K.edge_count(tri, dense)
    counters = ("pair_count_launches", "pair_write_launches", "scatter_launches")
    before = [getattr(K, c) for c in counters]
    tiles = K.pair_count(tri, dense, ne, E)
    want = P.pair_count_plain(tri, dense, ne, E)
    for f in ("counts", "kept", "digits"):
        assert torch.equal(getattr(tiles, f), getattr(want, f)), f
    rows = K.pair_write(tri, dense, ne, tiles, E)
    assert torch.equal(rows.key, P.pair_write_plain(tri, dense, ne, want, E).key)
    got, kept = K.sort_pairs(tri, dense, ne, E)
    plain_rows, plain_kept = P.sort_pairs_plain(tri, dense, ne, E)
    assert torch.equal(got.key, plain_rows.key) and torch.equal(kept, plain_kept)
    assert [getattr(K, c) for c in counters] == before, "nothing launched on the CPU"


def test_entry_points_match_the_sources():
    """_lib binds each entry point of csrc/*.cu with its count of pointer and
    int arguments (the stream last), as the sources declare them: a wrong
    count would pass a pointer as an int on the card."""
    declared = {}
    for name in _lib._SOURCES:
        with open(os.path.join(_lib._CSRC, name)) as f:
            src = f.read()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            kinds = [a.strip().rsplit(" ", 1)[0] for a in args.split(",")]
            assert kinds[-1] == "void*", f"{fn}: the stream comes last"
            n_ptr = sum(k.endswith("*") for k in kinds[:-1])
            n_int = sum(k == "int" for k in kinds[:-1])
            assert n_ptr + n_int == len(kinds) - 1, fn
            declared[fn] = (n_ptr, n_int)
    assert declared == {name: (n_ptr, n_int) for name, n_ptr, n_int in _lib._ENTRY_POINTS}
