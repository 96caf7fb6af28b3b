"""The cluster stage's pair count and moments kernels, mirrored in numpy on
the CPU.

The CUDA path (ops/cuda/cluster_moments.py: edge_count, slot_moments;
csrc/cluster_moments.cu: cm_edge_count_kernel, cm_moments_kernel) counts a
frame's pairs four pixels a thread: where W % 4 == 0 the pixels' trinary
bytes and their neighbours' come as packed words, a pair is a byte of
value 0xFF in their XOR (trinary values are 0, 127 and 255), and its two
ids' `!= KMAX` tests are bit masks of the 5 ids of the pixels' row and the
6 of the row below; else each pixel reads its own neighbours. A fixed grid
strides over each frame's 1024-pixel blocks. The moments kernel splits a
slot's E2-resident pairs over a power of two of warps (about 256 pairs a
warp, at most 8) packed into 8-warp blocks in slot order; sums the
centroid terms as integers; and in pass 2 takes its warp's pairs 32 at a
time, a pair a lane, ranks the lanes by angle bin (ballots), stages their
terms in that order, sums each bin's segment in f64 by a segmented tree
of shuffles and adds the sums into the warp's table from the segment's
head; the slot's warp tables are summed in warp order.

The numpy mirrors below repeat those steps and that order. The count's is
held bit-exact to edge_count_plain and to the JAX package's
num_edge_points; the moments' to slot_moments_plain (centroid, scale, dark
side and the weight column exact, the other columns within one f32 ulp)
and, through it, to the JAX package's extract_cluster_moments. Wrong
mirrors must fail on each case: a quad that drops its last column, a right
neighbour read past the row's end, a bin segment that ends one rank early,
a warp range that drops its last pair. The kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py phase 23).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import COUNT_FRAMES, MOMENT_ROWS, count_frames, moment_rows
from isaac_ros_apriltag_tpu.ops import cluster_moments as jcm
from isaac_ros_apriltag_tpu_torch.config import DetectorConfig
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as P
from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as K
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

torch.set_num_threads(2)

KMAX = (1 << 15) - 1
NBINS, NQ = P.NBINS, 6
KMAT = np.array([[210.0, 0, 160], [0, 210.0, 120], [0, 0, 1]], np.float32)
MIN_PIX = 24
# csrc/cluster_moments.cu's moments kernel shape: warps a block; pairs a
# warp, about, at up to MOM_FEW_FRAMES frames a launch and past them
MOM_WARPS, MOM_FEW_FRAMES, MOM_PAIRS = 8, 2, (64, 128)
PIX_THREADS = 256            # the count's threads a block, 4 pixels each
WRONG_COUNT = ("drops the last column", "right neighbour past the row")
WRONG_MOMENTS = ("a segment ends one rank early", "range drops its last pair")


# --- inputs ------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """Two 240x320 frames (two tags each and noise 3) through the plain
    front: (uint8 trinary, int32 dense ids) at 120x160."""
    fam = get_family("tag36h11")
    imgs = []
    for b in range(2):
        tags = []
        for i, (x, y) in enumerate([(-0.2 + 0.03 * b, -0.1), (0.2, 0.1 - 0.04 * b)]):
            t = np.array([x, y, 1.0])
            tags.append(dict(family=fam, id=3 + 7 * i + b, R=upright_pose(t, 0.2 * i + 0.1 * b),
                             t=t, tag_size=0.16))
        imgs.append(render_tags(KMAT, (240, 320), tags, noise=3.0, seed=b))
    gray = torch.from_numpy(np.stack(imgs)).to(torch.float32)
    tri = adaptive_threshold(_pad_to_tiles(_decimate(gray, 2), 4), 4, 5)
    valid = tri != 127
    R = DetectorConfig(backend="torch").effective_capacities(*tri.shape[-2:])[1]
    lab, _ = ccl_scan(tri, 8, backend="torch")
    rank_img, table, _ = resolve_roots_rank(lab, valid, max_components=R)
    lab, _ = ccl_scan(tri, 6, backend="torch", label0=rank_img)
    dense = resolve_components(lab, valid, min_component_pixels=25, max_components=R,
                               chain_steps=3, rank_table=table).dense
    return tri.numpy(), dense.to(torch.int32).numpy()


def count_cases(scenes):
    """The scenes, the scenes cut to W 157 (the scalar path), and
    chip_smoke.py's COUNT_FRAMES."""
    tri, dense = scenes
    return {"scenes (W % 4 == 0)": (tri, dense),
            "scenes cut to W 157": (np.ascontiguousarray(tri[:, :, :157]),
                                    np.ascontiguousarray(dense[:, :, :157])),
            **count_frames()}


COUNT_CASES = ("scenes (W % 4 == 0)", "scenes cut to W 157", *COUNT_FRAMES)
# The cases a wrong vector-path mirror must fail on (W % 4 == 0, pairs there).
VEC_EXPOSED = ("scenes (W % 4 == 0)", "speckle, W 4", "pairs on every frame edge, W 16",
               "speckle, batch 8, W 960")


# --- the count's mirror --------------------------------------------------------

def _vcmpeq4_ff(x):
    """__vcmpeq4(x, 0xFFFFFFFF) of uint32 words: 0xFF in each byte equal to 0xFF."""
    out = np.zeros_like(x)
    for i in range(4):
        out |= np.where(((x >> np.uint32(8 * i)) & np.uint32(0xFF)) == 0xFF,
                        np.uint32(0xFF << (8 * i)), np.uint32(0))
    return out


def _pack(cols):
    """Four uint8-valued arrays -> uint32 words, cols[i] in byte i."""
    w = np.zeros(cols[0].shape, np.uint32)
    for i, c in enumerate(cols):
        w |= c.astype(np.uint32) << np.uint32(8 * i)
    return w


def mirror_quads_vec(tri, dense, H, W, wrong=None):
    """The vector path's count of one frame's quads (W % 4 == 0): load_quad's
    words and ids, quad_pair_bits, the id masks and __popc; (H W / 4,)."""
    t, d = tri.reshape(-1).astype(np.uint32), dense.reshape(-1)
    HW = H * W
    p = np.arange(0, HW, 4)
    y, x = p // W, p % W
    right = x + 4 < W if wrong != "right neighbour past the row" else p + 4 < HW
    left, down = x > 0, y + 1 < H

    def at(idx, ok, fill, src):
        ok = ok & (idx < src.size)
        return np.where(ok, src[np.where(ok, idx, 0)], fill)

    a = _pack([t[p + i] for i in range(4)])
    r0 = at(p + 4, right, 127, t).astype(np.uint32)
    d0 = [d[p + i] for i in range(4)] + [at(p + 4, right, KMAX, d)]
    c = np.where(down, _pack([at(p + W + i, down, 127, t) for i in range(4)]),
                 np.uint32(0x7F7F7F7F))
    l1 = at(p + W - 1, down & left, 127, t).astype(np.uint32)
    r1 = at(p + W + 4, down & right, 127, t).astype(np.uint32)
    d1 = ([at(p + W - 1, down & left, KMAX, d)] + [at(p + W + i, down, KMAX, d) for i in range(4)]
          + [at(p + W + 4, down & right, KMAX, d)])
    nb = [(a >> np.uint32(8)) | (r0 << np.uint32(24)), c, (c << np.uint32(8)) | l1,
          (c >> np.uint32(8)) | (r1 << np.uint32(24))]
    k0 = sum((d0[i] != KMAX).astype(np.uint32) << np.uint32(i) for i in range(5))
    k1 = sum((d1[j] != KMAX).astype(np.uint32) << np.uint32(j) for j in range(6))
    kn = [k0 >> np.uint32(1), k1 >> np.uint32(1), k1, k1 >> np.uint32(2)]
    last = np.uint32(0x7 if wrong == "drops the last column" else 0xF)
    count = np.zeros(p.shape, np.int64)
    for o in range(4):
        pm = _vcmpeq4_ff(a ^ nb[o].astype(np.uint32)) & np.uint32(0x01010101)
        bits = (pm | pm >> np.uint32(7) | pm >> np.uint32(14) | pm >> np.uint32(21)) & last
        m = bits & k0 & kn[o]
        count += np.array([bin(int(v)).count("1") for v in m])
    return count


def mirror_pixels(tri, dense, H, W):
    """The scalar path: each pixel's 4 neighbours read alone (make_pair's mask)."""
    t, d = tri.astype(np.int32), dense
    n = 0
    for dx, dy in ((1, 0), (0, 1), (-1, 1), (1, 1)):
        for yy in range(H):
            for xx in range(W):
                ny, nx = yy + dy, xx + dx
                inside = 0 <= nx < W and ny < H
                v1 = t[ny, nx] if inside else 127
                d1 = d[ny, nx] if inside else KMAX
                n += t[yy, xx] + v1 == 255 and d[yy, xx] != KMAX and d1 != KMAX
    return n


def mirror_count(tri, dense, wrong=None):
    """(B, H, W) uint8 trinary, int32 ids -> (B,) int32 as cm_edge_count_kernel counts."""
    B, H, W = tri.shape
    if W % 4 == 0:
        return np.array([mirror_quads_vec(tri[b], dense[b], H, W, wrong).sum()
                         for b in range(B)], np.int32)
    return np.array([mirror_pixels(tri[b], dense[b], H, W) for b in range(B)], np.int32)


def count_grid(B, H, W, fill):
    """apriltag_cm_count's grid: (blocks a frame, iterations) for a card
    holding `fill` blocks at once."""
    nblk = -(-H * W // (4 * PIX_THREADS))
    iters = -(-nblk // max(1, fill // B))
    return -(-nblk // iters), iters


@functools.lru_cache(maxsize=None)
def _jax_stage(**kw):
    return jax.jit(functools.partial(jcm.extract_cluster_moments, **kw))


def _jax_moments(tri, dense, **kw):
    """The JAX package's extract_cluster_moments of one frame, jitted."""
    return _jax_stage(**kw)(jnp.asarray(tri), jnp.asarray(dense),
                            comp_overflow=jnp.asarray(False))


def _jax_num_edge(tri, dense):
    E = 3 * tri.shape[-2] * tri.shape[-1] // 4 + 1
    return np.array([int(_jax_moments(tri[b], dense[b], max_edge_points=E, max_clusters=8,
                                      min_cluster_pixels=MIN_PIX).num_edge_points)
                     for b in range(tri.shape[0])], np.int32)


@pytest.mark.parametrize("name", COUNT_CASES)
def test_count_mirror_matches_plain_and_jax(scenes, name):
    tri, dense = count_cases(scenes)[name]
    got = mirror_count(tri, dense)
    want = P.edge_count_plain(torch.from_numpy(tri), torch.from_numpy(dense)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_num_edge(tri, dense))
    np.testing.assert_array_equal(
        K.edge_count(torch.from_numpy(tri), torch.from_numpy(dense)).numpy(), want)
    if name == "all ids KMAX":
        assert not got.any()
    if name.startswith("pairs on every frame edge"):
        H, W = tri.shape[1:]                 # every side neighbour pairs, no diagonal one
        assert got[0] == H * (W - 1) + (H - 1) * W


@pytest.mark.parametrize("wrong", WRONG_COUNT)
@pytest.mark.parametrize("name", VEC_EXPOSED)
def test_count_cases_expose_a_wrong_mirror(scenes, name, wrong):
    tri, dense = count_cases(scenes)[name]
    want = P.edge_count_plain(torch.from_numpy(tri), torch.from_numpy(dense)).numpy()
    assert not np.array_equal(mirror_count(tri, dense, wrong), want)


@pytest.mark.parametrize("B,H,W", [(1, 360, 640), (8, 540, 960), (1, 1080, 1920), (3, 9, 4),
                                   (2, 1, 5)])
@pytest.mark.parametrize("fill", [132 * 8, 132 * 6, 7])
def test_count_grid_visits_each_quad_once(B, H, W, fill):
    """Thread t of block k visits quads (k PIX_THREADS + t) + i G PIX_THREADS
    while under the frame's quads: every quad once, at most `fill` blocks
    in all unless one block a frame is already more."""
    G, iters = count_grid(B, H, W, fill)
    nq = -(-H * W // 4)
    seen = np.zeros(nq, np.int64)
    start = np.arange(G * PIX_THREADS)
    for i in range(iters + 1):
        q = start + i * G * PIX_THREADS
        np.add.at(seen, q[q < nq], 1)
    assert (seen == 1).all()
    assert G * B <= max(fill, B)


# --- the moments kernel's mirror -------------------------------------------------

def pairs_a_warp(B):
    return MOM_PAIRS[B > MOM_FEW_FRAMES]


def slot_warps(n, per):
    k = max(1, -(-n // per))
    return MOM_WARPS if k >= MOM_WARPS else 1 << (k - 1).bit_length()


def resident_pairs(count, E2):
    """(C,) counts -> (C,) E2-resident pairs a slot."""
    c = count.astype(np.int64)
    return np.minimum(np.clip(E2 - (np.cumsum(c) - c), 0, None), c)


def mirror_packing(n, C, per):
    """The kernel's warp assignment of one frame: {block: [(slot, rank,
    parts) or None for each of its MOM_WARPS warps]}. Slots take consecutive
    warps in slot order when their warp counts never grow, else slot j
    takes block j."""
    w = [slot_warps(int(v), per) for v in n]
    packed = all(w[j] <= w[j - 1] for j in range(1, C))
    blocks = {}
    first = 0
    for j in range(C):
        at = first if packed else MOM_WARPS * j
        for r in range(w[j]):
            blk, u = divmod(at + r, MOM_WARPS)
            blocks.setdefault(blk, [None] * MOM_WARPS)
            assert blocks[blk][u] is None
            blocks[blk][u] = (j, r, w[j])
        first += w[j]
    return blocks


def _f32(v):
    return np.float32(v)


def mirror_bin(dx, dy):
    """diamond_bin in f32."""
    ax, ay = abs(dx), abs(dy)
    den = max(_f32(ax + ay), _f32(1e-12))
    if dy >= 0:
        a = dy / den if dx >= 0 else _f32(1.0) + ax / den
    else:
        a = _f32(2.0) + ay / den if dx < 0 else _f32(3.0) + dx / den
    return min(max(int(_f32(a * _f32(16.0))), 0), NBINS - 1)


def mirror_centroid(pays, n):
    """Pass 1's integer sums and the centroid: (cx, cy, r2, scale, dark, inv)."""
    X, Y, gp = pays & 0xFFF, (pays >> 12) & 0xFFF, pays >> 24
    gx, gy = (gp & 3) - 1, ((gp >> 2) & 3) - 1
    x, y = X.astype(np.float32) * _f32(0.5), Y.astype(np.float32) * _f32(0.5)
    s3 = int(((x * x + y * y) * _f32(4.0)).astype(np.int64).sum())
    c = [float(n), 0.5 * int(X.sum()), 0.5 * int(Y.sum()), 0.25 * s3, float(gx.sum()),
         float(gy.sum()), 0.5 * int((X * gx + Y * gy).sum())]
    f = [_f32(v) for v in c]
    safe = f[0] if f[0] >= 1 else _f32(1.0)
    cx, cy = f[1] / safe, f[2] / safe
    s64 = float(safe)
    m1, m2 = c[1] / s64, c[2] / s64
    r2 = max(_f32((c[3] / s64 - m1 * m1) - m2 * m2), _f32(1e-12))
    mean_dot = (f[6] - cx * f[4] - cy * f[5]) / safe
    inv = _f32(torch.rsqrt(torch.tensor(r2, dtype=torch.float32)).item())
    return cx, cy, r2, np.sqrt(r2), bool(mean_dot > 0), inv


def mirror_add_bins(has, bins, terms, tab, wrong=None):
    """add_bins: the lanes ranked by (bin, lane), no pair last; each bin's
    segment of the ranked order summed by the segmented tree (the lane at
    rank r adds rank r + d's sum while in its segment, d = 1, 2, 4, ...; all
    at once a step), the sums and the segment's length added at its head."""
    keys = [bins[lane] if has[lane] else NBINS for lane in range(32)]
    order = sorted(range(32), key=lambda lane: (keys[lane], lane))
    k = [keys[lane] for lane in order]
    v = [list(terms[lane]) for lane in order]
    heads = [r for r in range(32) if r == 0 or k[r - 1] != k[r]]
    end = {}
    for h, nxt in zip(heads, heads[1:] + [32]):
        for r in range(h, nxt):
            end[r] = nxt
    if wrong == "a segment ends one rank early":
        end = {r: max(r + 1, e - 1) if e < 32 else e for r, e in end.items()}
    d = 1
    while d < 32:
        v = [[a + o for a, o in zip(v[r], v[r + d])] if r + d < end[r] else v[r]
             for r in range(32)]
        d *= 2
    for h in heads:
        if k[h] < NBINS:
            tab[k[h]][0] += float(end[h] - h)
            for q in range(NQ - 1):
                tab[k[h]][q + 1] += v[h][q]


def mirror_warp_table(pays, lo, hi, cx, cy, inv, wrong=None):
    """Pass 2 of one warp over pairs [lo, hi) of its slot, 32 at a time, a
    pair a lane: (NBINS, NQ) f64."""
    tab = [[0.0] * NQ for _ in range(NBINS)]
    for base in range(lo, hi, 32):
        has, bins = [False] * 32, [0] * 32
        terms = [[0.0] * (NQ - 1) for _ in range(32)]
        for lane in range(min(32, hi - base)):
            pv = int(pays[base + lane])
            x, y = _f32(pv & 0xFFF) * _f32(0.5), _f32((pv >> 12) & 0xFFF) * _f32(0.5)
            dx, dy = x - cx, y - cy
            ux, uy = dx * inv, dy * inv
            has[lane], bins[lane] = True, mirror_bin(dx, dy)
            terms[lane] = [float(t) for t in (ux, uy, ux * ux, ux * uy, uy * uy)]
        mirror_add_bins(has, bins, terms, tab, wrong)
    return tab


def mirror_moments(pay_s, top_pos, count, E2, wrong=None):
    """(B, N) int32 sorted pays, (B, C) int32 top_pos and count -> the
    moments kernel's (table, centroid, scale, dark) in its order of sums."""
    B, C = count.shape
    table = np.zeros((B, C, NBINS, NQ), np.float32)
    centroid = np.zeros((B, C, 2), np.float32)
    scale = np.zeros((B, C), np.float32)
    dark = np.zeros((B, C), bool)
    for b in range(B):
        n = resident_pairs(count[b], E2)
        for j in range(C):
            pays = pay_s[b, top_pos[b, j]:top_pos[b, j] + n[j]].astype(np.int64)
            cx, cy, _, sc, dk, inv = mirror_centroid(pays, int(n[j]))
            centroid[b, j], scale[b, j], dark[b, j] = (cx, cy), sc, dk
            parts = slot_warps(int(n[j]), pairs_a_warp(B))
            tabs = []
            for r in range(parts):
                lo, hi = r * int(n[j]) // parts, (r + 1) * int(n[j]) // parts
                if wrong == "range drops its last pair" and hi > lo:
                    hi -= 1
                tabs.append(mirror_warp_table(pays, lo, hi, cx, cy, inv, wrong))
            total = np.array(tabs[0])
            for t in tabs[1:]:
                total = total + np.array(t)      # f64, in warp order
            table[b, j] = total.astype(np.float32)
    return table, centroid, scale, dark


def _sorted_pays(tri, dense, E):
    """Sorted keys and pays of frames (edge_pairs_plain, torch.sort)."""
    t, d = torch.from_numpy(tri), torch.from_numpy(dense)
    ne = P.edge_count_plain(t, d)
    key, pay = P.edge_pairs_plain(t, d, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    return key_s, torch.gather(pay, 1, perm), ne


def moment_cases(scenes):
    """name -> (pay_s, top_pos, count, E2) as numpy arrays: the scenes' top
    128 slots at the stage's E2 and at an E2 that cuts slot 3 in its middle,
    and chip_smoke.py's MOMENT_ROWS."""
    tri, dense = scenes
    E = 3 * tri.shape[1] * tri.shape[2] // 4
    key_s, pay_s, ne = _sorted_pays(tri, dense, E)
    ovf = torch.zeros(2, dtype=torch.bool)
    per = 4 * (tri.shape[1] + tri.shape[2])
    seg = P.top_segments_plain(key_s, ne, ovf, E=E, E2=128 * 1024, max_clusters=128,
                               min_cluster_pixels=MIN_PIX, max_perimeter=per)
    pay, top, cnt = pay_s.numpy(), seg.top_pos.numpy(), seg.count.numpy()
    cut = int(cnt[0, :3].sum() + cnt[0, 3] // 2)
    return {"scenes, C 128": (pay, top, cnt, min(128 * 1024, E)),
            "scenes, a slot cut at E2 in its middle": (pay, top, cnt, cut), **moment_rows()}


MOMENT_CASES = ("scenes, C 128", "scenes, a slot cut at E2 in its middle", *MOMENT_ROWS)


def _ulp_apart(a, b):
    """Cells of f32 arrays a, b more than one ulp apart."""
    up = np.nextafter(b, np.float32(np.inf))
    down = np.nextafter(b, np.float32(-np.inf))
    return ~((a == b) | (a == up) | (a == down))


def _plain(case):
    pay, top, cnt, E2 = case
    return P.slot_moments_plain(torch.from_numpy(pay), torch.from_numpy(top),
                                torch.from_numpy(cnt), E2)


@pytest.fixture(scope="module")
def mcases(scenes):
    return moment_cases(scenes)


@pytest.mark.parametrize("name", MOMENT_CASES)
def test_moments_mirror_matches_plain(mcases, name):
    case = mcases[name]
    table, centroid, scale, dark = mirror_moments(*case)
    want = _plain(case)
    np.testing.assert_array_equal(centroid, want.centroid.numpy())
    np.testing.assert_array_equal(scale, want.scale.numpy())
    np.testing.assert_array_equal(dark, want.dark_inside.numpy())
    wt = want.table.numpy()
    np.testing.assert_array_equal(table[..., 0], wt[..., 0])
    assert not _ulp_apart(table, wt).any()
    # every resident pair once in its slot's weight column
    n = np.stack([resident_pairs(c, case[3]) for c in case[2]])
    np.testing.assert_array_equal(table[..., 0].sum(-1), n)
    if name == MOMENT_ROWS[0]:
        assert n[0, 0] > MOM_WARPS * pairs_a_warp(1)
        assert (table[0, 1, :, 0] > 0).sum() == 1          # one bin
        assert (table[0, 2, :, 0] > 0).sum() == 2          # two bins
        assert n[0, 3] == 1 and n[0, 5] == 0
    if name == "scenes, a slot cut at E2 in its middle":
        assert 0 < n[0, 3] < case[2][0, 3] and n[0, 4] == 0
    if name == MOMENT_ROWS[2]:
        assert 0 < n[0, 2] < case[2][0, 2] and n[0, 3] == 0
    cpu = K.slot_moments(*(torch.from_numpy(a) for a in case[:3]), case[3])
    for got, ref in zip(cpu, want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("wrong", WRONG_MOMENTS)
@pytest.mark.parametrize("name", MOMENT_CASES)
def test_moment_cases_expose_a_wrong_mirror(mcases, name, wrong):
    case = mcases[name]
    table = mirror_moments(*case, wrong=wrong)[0]
    assert not np.array_equal(table[..., 0], _plain(case).table.numpy()[..., 0])


@pytest.mark.parametrize("name", MOMENT_CASES)
def test_moments_packing_takes_each_slot_once_in_one_block(mcases, name):
    pay, top, cnt, E2 = mcases[name]
    B, C = cnt.shape
    for b in range(B):
        n = resident_pairs(cnt[b], E2)
        blocks = mirror_packing(n, C, pairs_a_warp(B))
        assert max(blocks) < C                             # the grid's C blocks a frame
        seen = {}
        for blk, warps in blocks.items():
            assert warps[0] is not None                    # a block's warps fill from warp 0
            for u, w in enumerate(warps):
                if w is not None:
                    j, r, parts = w
                    seen.setdefault(j, set()).add((blk, u - r, r))
                    assert 0 <= u - r and u - r + parts <= MOM_WARPS
        assert sorted(seen) == list(range(C))
        for j, parts in seen.items():
            assert len({(blk, lead) for blk, lead, _ in parts}) == 1   # one block, one lead
            assert sorted(r for _, _, r in parts) == list(range(slot_warps(int(n[j]),
                                                                           pairs_a_warp(B))))


def test_mirror_through_plain_matches_jax(scenes, mcases):
    """The mirror's moments of frame 0 in the stage's slots against the JAX
    package's extract_cluster_moments on the same frame (integer fields
    exact, floats as tests/test_torch_batch.py holds the stage)."""
    tri, dense = scenes
    H, W = tri.shape[1:]
    kw = dict(max_edge_points=3 * H * W // 4, max_clusters=128, min_cluster_pixels=MIN_PIX,
              max_cluster_points=1024)
    ref = _jax_moments(tri[0], dense[0], **kw)
    pay, top, cnt, E2 = mcases["scenes, C 128"]
    np.testing.assert_array_equal(cnt[0], np.asarray(ref.count))
    table, centroid, scale, dark = mirror_moments(pay[:1], top[:1], cnt[:1], E2)
    np.testing.assert_array_equal(dark[0], np.asarray(ref.dark_inside))
    for got, f in [(table[0, ..., i], f) for i, f in enumerate(("bw", "bx", "by", "bxx", "bxy",
                                                                 "byy"))] + [
            (centroid[0], "centroid"), (scale[0], "scale")]:
        want = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=1e-6 * max(1.0, np.abs(want).max()), err_msg=f)
