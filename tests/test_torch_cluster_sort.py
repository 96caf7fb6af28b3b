"""The cluster stage's sort of the kept pairs on the CPU.

The CUDA path (ops/cuda/cluster_moments.py::sort_pairs, csrc/
cluster_moments.cu) sorts the kept pairs by a stable LSD radix sort in two
kernels: one histogram pass over the pixels (every pass's digit counts of
the kept keys, the first pass's also by offset and by tile, and the kept
count), then four passes, a 6-bit digit and three of 8 bits. The first pass
builds the pairs from the pixels again, tile by tile, (offset, block of
pixels) in offset-major order: a kept pair goes to its digit's first
position, plus the keys of its digit at the offsets before its own, plus
those of the earlier blocks at its offset (the histogram pass's sums of
groups of tiles, then its group's tile counts), plus its rank in its tile
(the warps before its warp, then its place in its warp's pixels). Each later pass
takes sort tiles of the rows: a histogram of each tile's digits, the
(digit, tile) scan in digit-major order, and each key's rank among the keys
of its digit before it in its tile. A numpy mirror of those steps, at small
blocks, tiles and digit widths and at the kernels' own, is held here to
numpy's stable argsort and to the kernels' plain versions
(ops/cluster_moments.py: pair_count_plain, radix_first_plain (which is
radix_scatter_plain over pair_write_plain's layout order) and
radix_scatter_plain), and their composition to the reference's stable sort
of the padded row (edge_pairs_plain, then torch.sort), on noisy scenes, on
chip_smoke.py's synthetic frames (an empty frame beside a checkerboard, one
key, the largest dense ids, more kept pairs than E, rows of 94 pixels, one
key over 48 pixel blocks) and on its synthetic rows of kept keys (all keys
equal, keys at 2^30 - 1, K = 0 beside a full row, K on tile boundaries, K
past E). Wrong mirrors must fail on each of them: a pass that ranks ties
from the higher position, a first pass whose tiles are pixel-major, one
that leaves out the earlier offsets' keys. The kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py).
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
BITS = P.RADIX_BITS          # the later passes' digit width of the kernels
WARP_PIX = 128               # a first-pass warp's pixels of the kernels' block
# (pixels a first-pass block, positions a later pass's sort tile, digit
# bits): small ones that cut every case into many tiles and passes, and the
# kernels' digits at small tiles and blocks and at the kernels' own.
MIRROR_SIZES = ((16, 8, 3), (64, 64, 5), (256, 64, BITS), (64, 256, BITS),
                (P.PAIR_BLOCK, 1024, BITS), (4096, 4096, BITS))
WRONG_FIRST = ("ties from the higher pixel", "tiles pixel-major", "no earlier offsets")
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


def mirror_passes(bits):
    return -(-KEY_BITS // bits)


def mirror_digit(keys, k, bits):
    """Digit k of `bits`-bit later passes: the first pass takes the key's
    low bits the later passes leave, pass k the `bits` above the digits
    before it."""
    npass = mirror_passes(bits)
    if k == 0:
        return keys & ((1 << (KEY_BITS - (npass - 1) * bits)) - 1)
    return (keys >> (KEY_BITS - (npass - k) * bits)) & ((1 << bits) - 1)


def mirror_pairs(tri, dense, num_edge, E):
    """Each frame's pairs in the padded layout (offset-major, then pixel):
    (B, 4 H W) int64 keys and pays and the kept mask."""
    key, pay, mask = P._pairs(tri, dense)
    keep = P._keep(pay, mask, P._edge_stride(num_edge, E))
    return key.numpy().astype(np.int64), pay.numpy().astype(np.int64), keep.numpy()


def mirror_layout(key, pay, keep):
    """The kept pairs in layout order in [0, K) of each row, int32 max and 0
    past K: (kept (B,), keys, pays)."""
    B, N = key.shape
    keys, pays = np.full((B, N), I32MAX, np.int64), np.zeros((B, N), np.int64)
    kept = keep.sum(-1)
    for b in range(B):
        keys[b, :kept[b]], pays[b, :kept[b]] = key[b][keep[b]], pay[b][keep[b]]
    return kept, keys, pays


def mirror_histogram(key, keep, bits, block=P.PAIR_BLOCK, group=16):
    """The histogram pass as the kernel counts, frame by frame: a block's
    threads take 4 consecutive pixels each (a warp 128), a thread's runs of
    equal kept keys at an offset merged, then the consecutive lanes of a
    warp that hold one run of one key merged (lanes with no run or more
    than one break the segments), each merged run added once, with its
    length, into every pass's digit count (the first pass's by offset); and
    each (offset, block) tile's count of each first digit, and their sums
    over groups of `group` tiles. Returns (digits (P, B, R), offset digits
    (B, 4, R0), kept (B,), tile counts (B, 4, blocks, R0), group sums (B,
    4, groups, R0))."""
    B, N = key.shape
    HW, R, npass = N // 4, 1 << bits, mirror_passes(bits)
    R0 = 1 << (KEY_BITS - (npass - 1) * bits)
    digits = np.zeros((npass, B, R), np.int64)
    odig = np.zeros((B, 4, R0), np.int64)
    nblk = -(-HW // block)
    words = np.zeros((B, 4, nblk, R0), np.int64)
    span = nblk * block
    for b in range(B):
        k4 = np.full((4, span), -1, np.int64)
        k4[:, :HW] = np.where(keep[b], key[b], -1).reshape(4, HW)
        runs = []                       # (offset, key, length) of each merged run
        for o in range(4):
            th = k4[o].reshape(-1, 32, 4)           # (warp, lane, pixel) in order
            for warp in th:
                lane_key, lane_len = [], []
                for px in warp:
                    kp = px[px >= 0]
                    starts = np.flatnonzero(np.r_[True, kp[1:] != kp[:-1]]) if len(kp) else []
                    if len(starts) > 1:
                        bounds = np.r_[starts, len(kp)]
                        runs += [(o, kp[s], e - s) for s, e in zip(bounds[:-1], bounds[1:])]
                    lane_key.append(kp[0] if len(starts) == 1 else -1)
                    lane_len.append(len(kp) if len(starts) == 1 else 0)
                seg_key, seg_len = -1, 0
                for kk, ll in zip(lane_key + [-2], lane_len + [0]):
                    if kk != seg_key:
                        if seg_key >= 0:
                            runs.append((o, seg_key, seg_len))
                        seg_key, seg_len = kk, 0
                    seg_len += ll
        for o, kk, ll in runs:
            odig[b, o, mirror_digit(kk, 0, bits)] += ll
            for k in range(npass):
                digits[k, b, mirror_digit(kk, k, bits)] += ll
        o, px = np.nonzero(keep[b].reshape(4, HW))
        np.add.at(words[b], (o, px // block, mirror_digit(key[b].reshape(4, HW)[o, px], 0, bits)),
                  1)
    ng = -(-nblk // group)
    sums = np.zeros((B, 4, ng, R0), np.int64)
    np.add.at(sums, (slice(None), slice(None), np.arange(nblk) // group), words)
    return digits, odig, keep.sum(-1), words, sums


def mirror_first_pass(key, pay, keep, block, bits, warp_pix=None, group=None, wrong=None):
    """The first pass, frame by frame, over the tiles (offset o, block of
    `block` pixels): each tile's count of each first digit; a kept pair's
    place is its digit's first position (the frame's digit counts scanned),
    plus the keys of its digit at the offsets before o, plus those of the
    tiles (o, block') before its own (a look-back chain an offset), plus its
    rank in its tile in pixel order: with `warp_pix`, the kernel's form, the
    keys of its digit in the warps before its warp's pixels plus its rank
    in its warp; with `group`, the kernel's prefix over the tiles before:
    the sums of the whole groups of `group` tiles before the tile's group,
    then its group's tiles before it. `wrong` (WRONG_FIRST; wrong on purpose): ties ranked from
    the higher pixel; the tiles ordered pixel-major (block, then offset),
    without the offsets' term; the earlier offsets' keys left out. Returns
    (keys, pays) of (B, 4 H W), int32 max and 0 past K."""
    B, N = key.shape
    HW, R = N // 4, 1 << (KEY_BITS - (mirror_passes(bits) - 1) * bits)
    nblk = -(-HW // block)
    out_k, out_p = np.full((B, N), I32MAX, np.int64), np.zeros((B, N), np.int64)
    for b in range(B):
        o, px = np.nonzero(keep[b].reshape(4, HW))           # layout order
        k = key[b].reshape(4, HW)[o, px]
        d, blk = mirror_digit(k, 0, bits), px // block
        hist = np.zeros((4, nblk, R), np.int64)
        np.add.at(hist, (o, blk, d), 1)
        total = hist.sum((0, 1))
        base = np.cumsum(total) - total
        odig = hist.sum(1)
        earlier_off = np.cumsum(odig, 0) - odig
        earlier_blk = np.cumsum(hist, 1) - hist
        if group:
            sums = np.zeros((4, -(-nblk // group), R), np.int64)
            np.add.at(sums, (slice(None), np.arange(nblk) // group), hist)
            for q in range(nblk):
                g = q // group
                earlier_blk[:, q] = sums[:, :g].sum(1) + hist[:, g * group:q].sum(1)
        if warp_pix:                                           # warps before, then in-warp rank
            wp = px % block // warp_pix
            nw = -(-block // warp_pix)
            wh = np.zeros((4, nblk, nw, R), np.int64)
            np.add.at(wh, (o, blk, wp, d), 1)
            key_group = ((o * nblk + blk) * nw + wp) * R + d
            rank = np.cumsum(wh, 2)[o, blk, wp, d] - wh[o, blk, wp, d]
        else:
            key_group = (o * nblk + blk) * R + d
            rank = np.zeros(len(k), np.int64)
        order = np.argsort(key_group, kind="stable")
        starts = np.r_[0, np.cumsum(np.bincount(key_group,
                                                minlength=key_group.max() + 1 if len(k) else 1))]
        within = np.empty(len(k), np.int64)
        within[order] = np.arange(len(k)) - starts[key_group[order]]
        rank = rank + within
        if wrong == "ties from the higher pixel":
            rank = hist[o, blk, d] - 1 - rank
        if wrong == "tiles pixel-major":
            by_block = hist.transpose(1, 0, 2).reshape(4 * nblk, R)
            before = (np.cumsum(by_block, 0) - by_block).reshape(nblk, 4, R)
            at = base[d] + before[blk, o, d] + rank
        elif wrong == "no earlier offsets":
            at = base[d] + earlier_blk[o, blk, d] + rank
        else:
            at = base[d] + earlier_off[o, d] + earlier_blk[o, blk, d] + rank
        out_k[b, at], out_p[b, at] = k, pay[b].reshape(4, HW)[o, px]
    return out_k, out_p


def mirror_pass(keys, pays, kept, k, tile, bits, ties_high=False):
    """Later radix pass k of `bits`-bit digits, frame by frame: each sort
    tile's histogram of its keys' digits, the (digit, tile) scan in
    digit-major order, and each key's rank among the keys of its digit
    before it in its tile (after it, when `ties_high`: wrong on purpose).
    Returns (keys, pays, each frame's (tile, digit) destinations)."""
    R = 1 << bits
    out_k, out_p, offs = np.full_like(keys, I32MAX), np.zeros_like(pays), []
    for b, n in enumerate(kept):
        d = mirror_digit(keys[b, :n], k, bits)
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


def mirror_sort(keys, pays, kept, tile, bits, ties_high_in=None, first=0):
    """Passes first .. of the rows; pass `ties_high_in` ranks ties from the
    higher position (wrong on purpose: in every pass, an even number of
    passes would undo it on keys that all tie)."""
    for k in range(first, mirror_passes(bits)):
        keys, pays, _ = mirror_pass(keys, pays, kept, k, tile, bits, k == ties_high_in)
    return keys, pays


def mirror_sort_frame(tri, dense, num_edge, E, block, tile, bits, wrong=None):
    """The mirror's whole sort of a frame: its first pass over (offset,
    block) tiles (`wrong` as mirror_first_pass), then the later passes over
    sort tiles of `tile`. Returns (keys, pays, kept)."""
    key, pay, keep = mirror_pairs(tri, dense, num_edge, E)
    keys, pays = mirror_first_pass(key, pay, keep, block, bits, wrong=wrong)
    kept = keep.sum(-1)
    keys, pays = mirror_sort(keys, pays, kept, tile, bits, first=1)
    return keys, pays, kept


def stable_argsort(keys, pays, kept):
    """Each frame's keys [0, K) and pays in numpy's stable argsort order."""
    out_k, out_p = np.full_like(keys, I32MAX), np.zeros_like(pays)
    for b, n in enumerate(kept):
        order = np.argsort(keys[b, :n], kind="stable")
        out_k[b, :n], out_p[b, :n] = keys[b, order], pays[b, order]
    return out_k, out_p


def torch_sorted(tri, dense, ne, E):
    """The reference's stable sort of the padded row: (keys, pays) numpy."""
    key, pay = P.edge_pairs_plain(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    return key_s.numpy(), torch.gather(pay, 1, perm).numpy()


def assert_sorted_like(keys, pays, kept, want_k, want_p, msg=""):
    np.testing.assert_array_equal(keys, want_k, err_msg=msg)
    for b, n in enumerate(kept):
        np.testing.assert_array_equal(pays[b, :n], want_p[b, :n], err_msg=msg)


def _row(name):
    keys, pays, kept, E = ROWS[name]
    return keys.astype(np.int64), pays.astype(np.int64), kept.astype(np.int64), E


def _rows_torch(keys, pays):
    return P.SortRows(key=torch.from_numpy(keys.astype(np.int32)),
                      pay=torch.from_numpy(pays.astype(np.int32)))


def _tiles_of(keys, kept):
    """PairTiles as the histogram pass leaves them for rows of kept keys
    (every pass's digit counts; no pixels, so no offsets: all at offset 0)."""
    B, N = keys.shape
    key = torch.from_numpy(keys.astype(np.int32))
    K_ = torch.from_numpy(kept.astype(np.int32))
    npass, R, R0 = P.SORT_PASSES, P.RADIX, P.FIRST_DIGITS
    T = -(-N // P.sort_tile(B, N))
    digits = torch.stack([P.digit_counts_plain(key, K_, k) for k in range(npass)])
    i32 = dict(dtype=torch.int32)
    return P.PairTiles(kept=K_, digits=digits,
                       offset_digits=torch.nn.functional.pad(digits[0][:, None, :R0],
                                                             (0, 0, 0, 3)),
                       tile_counts=torch.zeros((B, 4, 1, R0), **i32),
                       group_sums=torch.zeros((B, 4, 1, R0), **i32),
                       look=torch.zeros((npass - 1, B, T, R), **i32),
                       ctl=torch.zeros((B, npass), **i32))


# --- the synthetic rows of kept keys -------------------------------------


@pytest.mark.parametrize("size", MIRROR_SIZES[1:], ids=lambda s: f"tile{s[1]}-bits{s[2]}")
@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_mirror_sorts_rows_like_stable_argsort(name, size):
    """The radix mirror at sort tiles of 64, 256, 1024 and 4096 positions
    and 5- and 8-bit digits sorts each synthetic row as numpy's stable
    argsort."""
    _, tile, bits = size
    keys, pays, kept, _ = _row(name)
    got = mirror_sort(keys, pays, kept, tile, bits)
    want = stable_argsort(keys, pays, kept)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_plain_passes_match_mirror_on_rows(name):
    """radix_scatter_plain, pass by pass, gives the mirror's keys and pays
    at the kernels' tile; the mirror's destinations are the digit counts
    each pass is given scanned."""
    keys, pays, kept, _ = _row(name)
    B, N = keys.shape
    tile = P.sort_tile(B, N)
    tiles = _tiles_of(keys, kept)
    rows = _rows_torch(keys, pays)
    mk, mp = keys, pays
    for k in range(P.SORT_PASSES):
        counts = tiles.digits[k].numpy()
        mk, mp, offs = mirror_pass(mk, mp, kept, k, tile, BITS)
        for b, dest in enumerate(offs):
            if len(dest):
                np.testing.assert_array_equal(dest[0], np.cumsum(counts[b]) - counts[b])
        rows = P.radix_scatter_plain(rows, tiles, k)
        msg = f"pass {k}"
        np.testing.assert_array_equal(rows.key.numpy(), mk, err_msg=msg)
        for b, n in enumerate(kept):
            np.testing.assert_array_equal(rows.pay.numpy()[b, :n], mp[b, :n], err_msg=msg)


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_cpu_radix_wrapper_runs_the_plain_passes(name):
    """On CPU tensors radix_scatter runs radix_scatter_plain and launches
    nothing; the plain first pass, then the wrapper's later passes, give
    numpy's stable argsort; pass 0 and a pass past the last are refused
    (the first pass reads the pixels)."""
    keys, pays, kept, E = _row(name)
    want = stable_argsort(keys, pays, kept)
    launches = K.scatter_launches
    tiles = _tiles_of(keys, kept)
    rows = P.radix_scatter_plain(_rows_torch(keys, pays), tiles, 0)
    for k in range(1, P.SORT_PASSES):
        rows = K.radix_scatter(rows, tiles, k, E=E)
    for k in (0, P.SORT_PASSES):
        with pytest.raises(ValueError, match="pass"):
            K.radix_scatter(rows, tiles, k, E=E)
    np.testing.assert_array_equal(rows.key.numpy(), want[0])
    for b, n in enumerate(kept):
        np.testing.assert_array_equal(rows.pay.numpy()[b, :n], want[1][b, :n])
    assert K.scatter_launches == launches, "nothing launched on the CPU"


@pytest.mark.parametrize("name", list(SORT_ROWS))
def test_rows_expose_a_mirror_with_ties_high(name):
    """Each synthetic row holds equal digits within a tile: a mirror whose
    first or last pass ranks them from the higher position sorts it
    otherwise, at the kernels' tile and digits and at small ones."""
    keys, pays, kept, _ = _row(name)
    want = stable_argsort(keys, pays, kept)
    tile = P.sort_tile(*keys.shape)
    for tile, bits in ((tile, BITS), (8, 3)):
        for wrong in (0, mirror_passes(bits) - 1):
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


# --- the histogram pass, the first pass and the whole sort on frames ----------


@pytest.mark.parametrize("block", (16, 64, 1024, 4096))
@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_compaction_matches_mirror(scenes, name, block):
    """pair_count_plain gives the histogram pass's mirror (runs merged as
    the kernel merges them): every pass's digit
    counts, the first pass's by offset, the kept counts, each first-pass
    tile's counts and their sums over groups of 16 tiles; pair_write_plain
    the kept pairs in layout order; the first pass's plain version
    (radix_first_plain) the mirror's first pass over (offset, block) tiles
    of 16, 64, 1024 (the kernels') and 4096 pixels, and at the kernels'
    block the mirror of the kernel's own form (a warp's pixels, then the
    warps before it; the tiles before as sums of groups of 16, then the
    group's tiles)."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    key, pay, keep = mirror_pairs(tri, dense, ne, E)
    kept, keys, pays = mirror_layout(key, pay, keep)
    rows = P.pair_write_plain(tri, dense, ne, E)
    np.testing.assert_array_equal(rows.key.numpy(), keys)
    np.testing.assert_array_equal(rows.pay.numpy(), pays)
    tiles = P.pair_count_plain(tri, dense, ne, E)
    if block == P.PAIR_BLOCK:
        digits, odig, mkept, words, sums = mirror_histogram(key, keep, BITS)
        np.testing.assert_array_equal(tiles.digits.numpy(), digits)
        np.testing.assert_array_equal(tiles.offset_digits.numpy(), odig)
        np.testing.assert_array_equal(tiles.kept.numpy(), mkept)
        np.testing.assert_array_equal(tiles.tile_counts.numpy(), words)
        np.testing.assert_array_equal(tiles.group_sums.numpy(), sums)
    np.testing.assert_array_equal(tiles.kept.numpy(), kept)
    want = mirror_first_pass(key, pay, keep, block, BITS)
    got = P.radix_first_plain(tri, dense, ne, tiles, E)
    assert_sorted_like(got.key.numpy(), got.pay.numpy(), kept, *want)
    if block == P.PAIR_BLOCK:
        form = mirror_first_pass(key, pay, keep, block, BITS, warp_pix=WARP_PIX, group=16)
        np.testing.assert_array_equal(form[0], want[0])
        np.testing.assert_array_equal(form[1], want[1])


@pytest.mark.parametrize("size", MIRROR_SIZES, ids=lambda s: f"block{s[0]}-tile{s[1]}-bits{s[2]}")
@pytest.mark.parametrize("name", FRAME_CASES)
def test_mirror_sorts_frames_like_torch_sort(scenes, name, size):
    """The mirror's first pass and later passes at each size give the
    reference's stable sort of the padded row: keys on the whole row, pays
    on [0, K)."""
    block, tile, bits = size
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    keys, pays, kept = mirror_sort_frame(tri, dense, ne, E, block, tile, bits)
    assert_sorted_like(keys, pays, kept, *torch_sorted(tri, dense, ne, E))


@pytest.mark.parametrize("tile", (64, 256, 1024, 4096))
@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_sort_equals_edge_pairs_and_torch_sort(scenes, name, tile):
    """sort_pairs_plain (the histogram pass, the first pass and the later
    passes' plain versions composed) equals edge_pairs_plain followed by
    torch.sort(stable=True), and each later pass equals the mirror's at
    sort tiles of 64, 256, 1024 and 4096 (the kernels' two)."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    rows, kept = P.sort_pairs_plain(tri, dense, ne, E, tile=tile)
    assert_sorted_like(rows.key.numpy(), rows.pay.numpy(), kept.tolist(),
                       *torch_sorted(tri, dense, ne, E))
    tiles = P.pair_count_plain(tri, dense, ne, E, tile=tile)
    step = P.radix_first_plain(tri, dense, ne, tiles, E)
    mk, mp = step.key.numpy().astype(np.int64), step.pay.numpy().astype(np.int64)
    for k in range(1, P.SORT_PASSES):
        step = P.radix_scatter_plain(step, tiles, k)
        mk, mp, _ = mirror_pass(mk, mp, tiles.kept.numpy(), k, tile, BITS)
        np.testing.assert_array_equal(step.key.numpy(), mk, err_msg=f"pass {k}")


@pytest.mark.parametrize("name", FRAME_CASES)
def test_frames_expose_a_mirror_with_ties_high(scenes, name):
    """Each frame's kept keys tie within sort tiles: a mirror whose first or
    last pass over the rows ranks ties from the higher position sorts them
    otherwise."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    kept, keys, pays = mirror_layout(*mirror_pairs(tri, dense, ne, E))
    want = stable_argsort(keys, pays, kept)
    for wrong in (0, P.SORT_PASSES - 1):
        got = mirror_sort(keys, pays, kept, P.sort_tile(*keys.shape), BITS, ties_high_in=wrong)
        assert not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])), wrong


@pytest.mark.parametrize("wrong", WRONG_FIRST)
@pytest.mark.parametrize("name", FRAME_CASES)
def test_frames_expose_a_wrong_first_pass(scenes, name, wrong):
    """A first pass that ranks ties from the higher pixel, one whose tiles
    are pixel-major, and one that leaves out the earlier offsets' keys each
    sort every frame otherwise than torch.sort, at the kernels' block and
    digits (each frame's ties span offsets and blocks)."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense)
    want_k, want_p = torch_sorted(tri, dense, ne, E)
    keys, pays, kept = mirror_sort_frame(tri, dense, ne, E, P.PAIR_BLOCK, 4096, BITS,
                                         wrong=wrong)
    same = np.array_equal(keys, want_k) and all(
        np.array_equal(pays[b, :n], want_p[b, :n]) for b, n in enumerate(kept))
    assert not same, f"{name}: the first pass with {wrong} agrees"


@pytest.mark.parametrize("name", FRAME_CASES)
def test_plain_sort_at_a_cut_num_edge(scenes, name):
    """With num_edge cut to a quarter of the frame's pairs the stride falls
    and more pairs may be kept than num_edge: sort_pairs_plain still equals
    edge_pairs_plain followed by torch.sort(stable=True), and so does the
    mirror at its small sizes."""
    tri, dense, E = _frame_case(scenes, name)
    ne = P.edge_count_plain(tri, dense) // 4
    want = torch_sorted(tri, dense, ne, E)
    rows, kept = P.sort_pairs_plain(tri, dense, ne, E)
    assert_sorted_like(rows.key.numpy(), rows.pay.numpy(), kept.tolist(), *want)
    keys, pays, kept = mirror_sort_frame(tri, dense, ne, E, 16, 8, 3)
    assert_sorted_like(keys, pays, kept, *want)


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
    decimated at stride 3, one key, keys of the largest dense ids, more
    kept pairs than E (stride > 1), here and in the noisy scenes at E 124,
    and one key tied across three offsets and 48 pixel blocks."""
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
    name = "one key over 48 pixel blocks: diagonal stripes"
    tri, dense, E = _frame_case(scenes, name)
    tiles = P.pair_count_plain(tri, dense, P.edge_count_plain(tri, dense), E)
    assert -(-tri.shape[1] * tri.shape[2] // P.PAIR_BLOCK) == 48
    assert int((tiles.offset_digits.sum(-1) > 0).sum()) == 3
    assert int((tiles.digits[0] > 0).sum()) == 1 and int(tiles.kept[0]) > 4 * P.PAIR_BLOCK


def test_cpu_sort_wrappers_run_the_plain_versions(scenes):
    """On CPU tensors pair_count, radix_first, radix_scatter and sort_pairs
    run their plain versions and launch nothing."""
    tri, dense, E = scenes["noisy scenes"]
    ne = K.edge_count(tri, dense)
    counters = ("pair_count_launches", "scatter_launches")
    before = [getattr(K, c) for c in counters]
    tiles = K.pair_count(tri, dense, ne, E)
    want = P.pair_count_plain(tri, dense, ne, E)
    for f in P.PairTiles._fields:
        assert torch.equal(getattr(tiles, f), getattr(want, f)), f
    rows = K.radix_first(tri, dense, ne, tiles, E)
    assert torch.equal(rows.key, P.radix_first_plain(tri, dense, ne, want, E).key)
    rows = K.radix_scatter(rows, tiles, 1, E=E)
    assert torch.equal(rows.key, P.radix_scatter_plain(
        P.radix_first_plain(tri, dense, ne, want, E), want, 1).key)
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
