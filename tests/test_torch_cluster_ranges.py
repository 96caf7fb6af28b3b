"""The cluster-moment stage's range formulation on the CPU.

The CUDA path (ops/cuda/cluster_moments.py, csrc/cluster_moments.cu) reads
each top-C cluster as one contiguous range of the sorted pair keys: a
segment's size by binary search, the top C by a size histogram, its
threshold and the ties at it taken in position order, each slot's
E2-resident pairs as its range cut by the sizes of the slots before it, and
per-slot sums. A numpy mirror of those steps is held here against the plain
version (ops/cluster_moments.py::extract_cluster_moments, the reference's
one-hot formulation), and the kernels' plain versions against the mirror, on
scenes that cut the pairs at E, tie in segment size, hold more eligible
segments than slots, and overflow the E2 slot budget. Integer outputs, the
centroid and the scale must be bit-exact; the bin tables may differ by one
f32 ulp, where f64 sums added in another order round apart. The kernels
themselves run only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import segment_rows
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

I32MAX = np.iinfo(np.int32).max
KMAT = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]], np.float32)
MIN_PIX = 24                 # the detector's min_cluster_pixels
EXACT = ("count", "valid", "num_clusters", "num_eligible", "num_edge_points", "edge_stride",
         "overflow", "dark_inside", "centroid", "scale")
TABLES = ("bw", "bx", "by", "bxx", "bxy", "byy")
# name -> (max_edge_points or None for the detector's, max_clusters, max_cluster_points,
# min_cluster_pixels). At 150 px few enough segments pass for frame 0 to
# overflow by its slot budget alone.
CASES = {
    "default": (None, 128, 1024, MIN_PIX),
    "eligible_past_slots": (None, 16, 1024, MIN_PIX),
    "slot_overflow": (None, 128, 4, 150),
    "cut_at_E": (124, 8, 1024, MIN_PIX),
}


@pytest.fixture(scope="module")
def frames():
    """Two noisy 480x640 frames (three tags, noise 2 and 3) through the
    plain front: trinary, dense ids and comp_overflow at 240x320."""
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
    rank_img, table, ovf = resolve_roots_rank(lab, valid, max_components=R)
    lab, _ = ccl_scan(tri, 6, backend="torch", label0=rank_img)
    res = resolve_components(lab, valid, min_component_pixels=25, max_components=R,
                             chain_steps=3, rank_table=table)
    return dict(tri=tri, dense=res.dense, ovf=res.overflow | ovf, E=E)


def mirror_segments(key_s, num_edge, comp_overflow, *, E, E2, C, min_pix, max_per,
                    tile=P.SEG_TILE, ties_high=False, cut_crossing=False):
    """The two segment kernels' steps in numpy, frame by frame, on tiles of
    `tile` keys (csrc/cluster_moments.cu: cm_seg_tiles_kernel, a block a
    tile, then cm_seg_top_kernel, a block a frame). `ties_high` and
    `cut_crossing` are wrong on purpose: ties at the threshold size to the
    higher position; a segment that crosses its tile's end cut there. Also
    returns each frame's tile fields as segment_tiles_plain lays them out."""
    B = key_s.shape[0]
    budget = (9 * E) // 10
    T = -(-E // tile)
    top_pos = np.zeros((B, C), np.int32)
    count = np.zeros((B, C), np.int32)
    out = dict(n_clusters=[], n_eligible=[], stride=[], overflow=[], ties=[], stats=[],
               hist=[], nv=[], cand=[])
    for b in range(B):
        ks = key_s[b, :E].astype(np.int64)
        stride = max(1, (int(num_edge[b]) + budget - 1) // budget)
        # The tiles kernel, a block a tile [lo, hi).
        lo = np.arange(T) * tile
        hi = np.minimum(lo + tile, E)
        valid = ks < I32MAX
        sp = np.flatnonzero(valid & (ks != np.r_[-1, ks[:-1]]))      # the starts
        st = sp // tile
        vend = lo + np.bincount(np.flatnonzero(valid) // tile, minlength=T)
        k_end = np.where(hi < E, ks[np.minimum(hi, E - 1)], I32MAX)
        open_end = (vend == hi) & (hi < E) & (k_end == ks[hi - 1])
        done = (lo == 0) | (ks[lo] < I32MAX)       # a tile past the prefix reads one key
        writer = done & ((vend < hi) | (hi == E) | (k_end == I32MAX))
        assert writer.sum() == 1, "one tile holds the end of the valid keys"
        nv = int(vend[writer][0])
        tail = np.r_[st[1:] != st[:-1], True]      # the tile's last start
        cross = tail & open_end[st]
        size = np.where(tail, vend[st], np.r_[sp[1:], 0]) - sp
        cand = ~cross & (size * stride >= min_pix) & (size * stride <= max_per)
        hist = np.bincount(size[cand], minlength=max_per + 1)
        fs = np.full(T, I32MAX)
        np.minimum.at(fs, st, sp)
        ls = np.full(T, -1)
        ls[st[cross]] = sp[cross]
        tmax = np.zeros(T, np.int64)
        np.maximum.at(tmax, st[cand], size[cand])
        ncand = np.bincount(st[cand], minlength=T)
        out["stats"].append(np.stack([np.bincount(st, minlength=T), ncand, tmax, fs, ls]))
        out["hist"].append(hist.copy())
        out["nv"].append(nv)
        out["cand"].append([(size[own] << P.SEG_POS_BITS) | (sp[own] - t * tile)
                            for t, own in ((t, cand & (st == t)) for t in range(T))])
        # The top kernel: crossing sizes from the later tiles' first starts.
        later = np.minimum(np.minimum.accumulate(np.r_[fs[1:], I32MAX][::-1])[::-1], nv)
        cs = np.where(ls >= 0, (hi if cut_crossing else later) - ls, 0)
        ccand = (ls >= 0) & (cs * stride >= min_pix) & (cs * stride <= max_per)
        cs = np.where(ccand, cs, 0)
        np.add.at(hist, cs[ccand], 1)
        n_cand = int(cand.sum() + ccand.sum())
        n_elig = n_cand + (E - len(sp) if min_pix <= 0 else 0)
        want = min(C, n_cand)
        ties = 0
        if want:
            at_least = np.r_[np.cumsum(hist[::-1])[::-1], 0]
            Tsz = int(np.flatnonzero(at_least >= want).max())          # the threshold size
            n_gt = int(at_least[Tsz + 1])
            # The candidates of the tiles that hold a size >= T, tile by tile:
            # the tile's own in position order, then its crossing one.
            rel = np.maximum(tmax, cs) >= Tsz
            own = cand & rel[st]
            tl = np.r_[st[own], np.flatnonzero(ccand & rel)]
            kind = np.r_[np.zeros(own.sum(), int), np.ones((ccand & rel).sum(), int)]
            pos = np.r_[sp[own], ls[ccand & rel]]
            sz = np.r_[size[own], cs[ccand & rel]]
            order = np.lexsort((kind, tl))
            pos, sz = pos[order], sz[order]
            at_T = sz == Tsz
            tie_rank = (np.cumsum(at_T[::-1])[::-1] if ties_high else np.cumsum(at_T)) - 1
            take = (sz > Tsz) | (at_T & (tie_rank < want - n_gt))
            ties = int(at_T.sum()) - (want - n_gt)                       # ties left out
            wpos, wsize = pos[take], sz[take]
            order = np.lexsort((wpos, -wsize))                           # size down, position up
            top_pos[b, :want], count[b, :want] = wpos[order], wsize[order]
        out["n_clusters"].append(len(sp))
        out["n_eligible"].append(n_elig)
        out["stride"].append(stride)
        out["overflow"].append(bool(num_edge[b] > E or comp_overflow[b] or n_elig > C
                                    or count[b].sum() > E2))
        out["ties"].append(ties)
    return dict(top_pos=top_pos, count=count, valid=count > 0,
                **{k: np.array(v) if k != "cand" else v for k, v in out.items()})


def _diamond_bin(dx, dy):
    f32 = np.float32
    ax, ay = np.abs(dx), np.abs(dy)
    den = np.maximum(ax + ay, f32(1e-12))
    t = np.where(dy >= 0, np.where(dx >= 0, dy / den, f32(1) + ax / den),
                 np.where(dx < 0, f32(2) + ay / den, f32(3) + dx / den))
    return np.clip((t * f32(16)).astype(np.int64), 0, 63)


def mirror_moments(pay_s, top_pos, count, E2):
    """The moments kernel's steps in numpy, slot by slot: the slot's range
    cut at E2 by the slots before it, exact f64 centroid sums, then each
    pair's terms added in f64 to its bin."""
    f32, f64 = np.float32, np.float64
    B, C = count.shape
    table = np.zeros((B, C, 64, 6), f32)
    centroid = np.zeros((B, C, 2), f32)
    scale = np.zeros((B, C), f32)
    dark = np.zeros((B, C), bool)
    for b in range(B):
        for j in range(C):
            n = max(0, min(int(count[b, j]), E2 - int(count[b, :j].sum())))
            pv = pay_s[b, top_pos[b, j]:top_pos[b, j] + n]
            x = (pv & 0xFFF).astype(f32) * f32(0.5)
            y = ((pv >> 12) & 0xFFF).astype(f32) * f32(0.5)
            gx = ((pv >> 24) & 0x3).astype(f32) - f32(1)
            gy = (((pv >> 24) >> 2) & 0x3).astype(f32) - f32(1)
            c = [float(np.sum(v.astype(f64))) for v in
                 (np.ones_like(x), x, y, x * x + y * y, gx, gy, x * gx + y * gy)]
            f = [f32(v) for v in c]
            safe = max(f[0], f32(1))
            cx, cy = f[1] / safe, f[2] / safe
            s64 = f64(safe)
            r2 = max(f32(c[3] / s64 - (c[1] / s64) * (c[1] / s64) - (c[2] / s64) * (c[2] / s64)),
                     f32(1e-12))
            centroid[b, j] = cx, cy
            scale[b, j] = torch.sqrt(torch.tensor(r2)).numpy()  # the plain version's sqrt
            dark[b, j] = (f[6] - cx * f[4] - cy * f[5]) / safe > 0
            dx, dy = x - cx, y - cy
            inv = torch.rsqrt(torch.tensor(r2)).numpy()          # the plain version's rsqrt
            sx, sy = dx * inv, dy * inv
            terms = np.stack([np.ones_like(sx), sx, sy, sx * sx, sx * sy, sy * sy], -1)
            cells = np.zeros((64, 6), f64)
            np.add.at(cells, _diamond_bin(dx, dy), terms.astype(f64))
            table[b, j] = cells.astype(f32)
    return dict(table=table, centroid=centroid, scale=scale, dark_inside=dark)


def _stage(frames, case):
    """The plain version, the sorted keys and both mirrors for one case."""
    E_arg, C, mcp, min_pix = CASES[case]
    tri, dense, ovf = frames["tri"], frames["dense"], frames["ovf"]
    B, H, W = tri.shape
    E = min(E_arg or frames["E"], 4 * H * W)
    E2 = min(C * mcp, E)
    twin = P.extract_cluster_moments(tri, dense, comp_overflow=ovf, max_edge_points=E,
                                     max_clusters=C, min_cluster_pixels=min_pix,
                                     max_cluster_points=mcp)
    num_edge = P.edge_count_plain(tri, dense)
    key, pay = P.edge_pairs_plain(tri, dense, num_edge, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    pay_s = torch.gather(pay, 1, perm)
    kw = dict(E=E, E2=E2, C=C, min_pix=min_pix, max_per=4 * (W + H))
    seg = mirror_segments(key_s.numpy(), num_edge.numpy(), ovf.numpy(), **kw)
    mom = mirror_moments(pay_s.numpy(), seg["top_pos"], seg["count"], E2)
    return dict(twin=twin, key=key, key_s=key_s, pay_s=pay_s, pay=pay, num_edge=num_edge,
                ovf=ovf, seg=seg, mom=mom, kw=kw)


@pytest.fixture(scope="module")
def stages(frames):
    return {case: _stage(frames, case) for case in CASES}


def test_cases_reach_their_edges(stages):
    """Each scene exercises what it is named for."""
    d = stages["default"]
    assert (d["seg"]["ties"] > 0).all(), "sizes tie at the threshold, some of the ties left out"
    e = stages["eligible_past_slots"]
    assert (e["twin"].num_eligible > 16).all() and e["twin"].overflow.all()
    s = stages["slot_overflow"]
    t = s["twin"]
    assert (t.count.sum(-1) > s["kw"]["E2"]).all()
    # Frame 0 overflows by its slot budget alone.
    assert bool(t.overflow[0]) and not bool(s["ovf"][0])
    assert int(t.num_eligible[0]) <= 128 and int(t.num_edge_points[0]) <= s["kw"]["E"]
    c = stages["cut_at_E"]
    kept = (c["key"] != I32MAX).sum(-1)
    assert (kept > c["kw"]["E"]).all(), f"kept pairs {kept.tolist()} must pass E"


@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_plain_version(stages, case):
    st = stages[case]
    twin, seg, mom = st["twin"], st["seg"], st["mom"]
    want = dict(count=seg["count"], valid=seg["valid"], num_clusters=seg["n_clusters"],
                num_eligible=seg["n_eligible"], num_edge_points=st["num_edge"].numpy(),
                edge_stride=seg["stride"], overflow=seg["overflow"],
                dark_inside=mom["dark_inside"], centroid=mom["centroid"], scale=mom["scale"])
    for f in EXACT:
        np.testing.assert_array_equal(getattr(twin, f).numpy(), want[f], err_msg=f)
    for i, f in enumerate(TABLES):
        np.testing.assert_array_max_ulp(getattr(twin, f).numpy(), mom["table"][..., i], maxulp=1)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_plain_versions_match_mirror(stages, case):
    """The plain versions the card holds each kernel to (ops/cluster_moments.py)."""
    st = stages[case]
    kw, seg, mom = st["kw"], st["seg"], st["mom"]
    got = P.top_segments_plain(st["key_s"], st["num_edge"], st["ovf"], E=kw["E"], E2=kw["E2"],
                               max_clusters=kw["C"], min_cluster_pixels=kw["min_pix"],
                               max_perimeter=kw["max_per"])
    for f, m in (("top_pos", "top_pos"), ("count", "count"), ("valid", "valid"),
                 ("num_clusters", "n_clusters"), ("num_eligible", "n_eligible"),
                 ("edge_stride", "stride"), ("overflow", "overflow")):
        np.testing.assert_array_equal(getattr(got, f).numpy(), seg[m], err_msg=f)
    mp = P.slot_moments_plain(st["pay_s"], got.top_pos, got.count, kw["E2"])
    for f in ("centroid", "scale", "dark_inside"):
        np.testing.assert_array_equal(getattr(mp, f).numpy(), mom[f], err_msg=f)
    np.testing.assert_array_max_ulp(mp.table.numpy(), mom["table"], maxulp=1)


def test_wrapper_runs_the_plain_version_on_the_cpu(frames, stages):
    """A CPU tensor goes to the plain version, whole and kernel by kernel;
    one frame without the batch dim gives that frame's results."""
    tri, dense, ovf = frames["tri"], frames["dense"], frames["ovf"]
    st = stages["default"]
    kw = dict(max_edge_points=st["kw"]["E"], max_clusters=128, min_cluster_pixels=MIN_PIX)
    counters = ("count_launches", "pair_count_launches", "scatter_launches",
                "seg_tiles_launches", "seg_top_launches", "moments_launches")
    counts = [getattr(K, c) for c in counters]
    got = K.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(st["twin"], f)), f
    one = K.extract_cluster_moments(tri[1], dense[1], comp_overflow=ovf[1], **kw)
    for f in one._fields:
        assert torch.equal(getattr(one, f), getattr(got, f)[1]), f
    E, E2 = st["kw"]["E"], st["kw"]["E2"]
    assert torch.equal(K.edge_count(tri, dense), st["num_edge"])
    rows, kept = K.sort_pairs(tri, dense, st["num_edge"], E)
    assert torch.equal(rows.key, st["key_s"])
    for b, n in enumerate(kept.tolist()):
        assert torch.equal(rows.pay[b, :n], st["pay_s"][b, :n])
    seg = K.top_segments(st["key_s"], st["num_edge"], ovf, E=E, E2=E2, max_clusters=128,
                         min_cluster_pixels=MIN_PIX, max_perimeter=st["kw"]["max_per"])
    assert torch.equal(seg.count, st["twin"].count)
    mom = K.slot_moments(rows.pay, seg.top_pos, seg.count, E2)
    assert torch.equal(mom.centroid, st["twin"].centroid)
    assert [getattr(K, c) for c in counters] == counts, "nothing launched on the CPU"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_argument_errors(device):
    """The plain version's two limits hold on every device; a device that
    is neither the CPU nor a card raises."""
    kw = dict(comp_overflow=torch.zeros(1, dtype=torch.bool, device=device),
              max_edge_points=4096, min_cluster_pixels=MIN_PIX)
    wide = torch.zeros((1, 8, 2048), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="2047x2047"):
        K.extract_cluster_moments(wide, wide.to(torch.int32), max_clusters=128, **kw)
    small = torch.zeros((1, 8, 8), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="max_clusters must be <= 128"):
        K.extract_cluster_moments(small, small.to(torch.int32), max_clusters=129, **kw)
    if device == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            K.extract_cluster_moments(small, small.to(torch.int32), max_clusters=16, **kw)


SEG_FIELDS = (("top_pos", "top_pos"), ("count", "count"), ("valid", "valid"),
              ("num_clusters", "n_clusters"), ("num_eligible", "n_eligible"),
              ("edge_stride", "stride"), ("overflow", "overflow"))
TILES = (8, 64, P.SEG_TILE)
ROWS = segment_rows()


def _top_kw(kw: dict) -> dict:
    return dict(E=kw["E"], E2=kw["E2"], max_clusters=kw["C"], min_cluster_pixels=kw["min_pix"],
                max_perimeter=kw["max_per"])


def _mirror_kw(kw: dict) -> dict:
    return dict(E=kw["E"], E2=kw["E2"], C=kw["max_clusters"], min_pix=kw["min_cluster_pixels"],
                max_per=kw["max_perimeter"])


def _assert_segments(got, want: dict, what: str) -> None:
    for f, m in SEG_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[m], err_msg=f"{what}: {f}")


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_mirror_matches_plain_version(stages, case, tile):
    """The segment kernels' tile decomposition at tile lengths 8, 64 and the
    kernel's own gives top_segments_plain's results bit for bit."""
    st = stages[case]
    kw = _top_kw(st["kw"])
    want = P.top_segments_plain(st["key_s"], st["num_edge"], st["ovf"], **kw)
    got = mirror_segments(st["key_s"].numpy(), st["num_edge"].numpy(), st["ovf"].numpy(),
                          tile=tile, **st["kw"])
    for f, m in SEG_FIELDS:
        np.testing.assert_array_equal(getattr(want, f).numpy(), got[m], err_msg=f)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(ROWS))
def test_tiled_mirror_on_synthetic_rows(name, tile):
    """chip_smoke.py's synthetic rows (segments across many tiles, ending on
    tile edges, ties split across tiles, fewer candidates than C, none, a
    zero size gate with nv < E, a frame with no valid key, a 16001-bin
    histogram): the mirror against top_segments_plain."""
    keys, num_edge, ovf, kw = ROWS[name]
    want = P.top_segments_plain(torch.from_numpy(keys), torch.from_numpy(num_edge),
                                torch.from_numpy(ovf), **kw)
    got = mirror_segments(keys, num_edge, ovf, tile=tile, **_mirror_kw(kw))
    for f, m in SEG_FIELDS:
        np.testing.assert_array_equal(getattr(want, f).numpy(), got[m], err_msg=f)


@pytest.mark.parametrize("name", list(ROWS))
def test_segment_plain_versions_on_synthetic_rows(name):
    """segment_tiles_plain lays out the mirror's tile fields, histogram,
    valid keys and candidates; segment_top_plain on them, and the CPU
    wrappers' composition, give top_segments_plain's results."""
    keys, num_edge, ovf, kw = ROWS[name]
    k, ne, ov = torch.from_numpy(keys), torch.from_numpy(num_edge), torch.from_numpy(ovf)
    m = mirror_segments(keys, num_edge, ovf, **_mirror_kw(kw))
    tiles = P.segment_tiles_plain(k, ne, E=kw["E"], min_cluster_pixels=kw["min_cluster_pixels"],
                                  max_perimeter=kw["max_perimeter"])
    np.testing.assert_array_equal(tiles.stats.numpy(), m["stats"])
    np.testing.assert_array_equal(tiles.hist.numpy(), m["hist"])
    np.testing.assert_array_equal(tiles.nv.numpy(), m["nv"])
    cand = tiles.cand.numpy().reshape(len(keys), -1, P.SEG_TILE)
    for b, frame in enumerate(m["cand"]):
        for t, c in enumerate(frame):
            np.testing.assert_array_equal(cand[b, t, :len(c)], c, err_msg=f"frame {b} tile {t}")
    want = P.top_segments_plain(k, ne, ov, **kw)
    _assert_segments(P.segment_top_plain(tiles, ne, ov, **kw), m, "segment_top_plain")
    _assert_segments(K.top_segments(k, ne, ov, **kw), m, "the CPU wrappers")
    for got, w in zip(K.top_segments(k, ne, ov, **kw), want):
        assert torch.equal(got, w)


# The wrong mirrors each synthetic row must expose (ties to the higher
# position; a crossing segment cut at its tile's end).
CATCHES = {"a segment across many tiles": ("ties_high", "cut_crossing"),
           "segments ending on tile edges": ("ties_high", "cut_crossing"),
           "ties at T split across tiles": ("ties_high", "cut_crossing"),
           "fewer candidates than C": ("cut_crossing",),
           "no candidates": ("cut_crossing",),
           "min_cluster_pixels 0, nv < E": ("ties_high", "cut_crossing"),
           "a frame with no valid key": ("ties_high", "cut_crossing"),
           "a histogram of 16001 bins": ("ties_high", "cut_crossing"),
           "T in the last coarse bin": ("cut_crossing",),
           "ties straddling T inside a coarse bin": ("ties_high", "cut_crossing"),
           "entries past one round of the top kernel": ("ties_high", "cut_crossing"),
           "tiles past one chunk of the top kernel": ("ties_high", "cut_crossing"),
           "min_cluster_pixels -1, a segment cut at E": ("ties_high", "cut_crossing")}


@pytest.mark.parametrize("name", list(ROWS))
def test_synthetic_rows_expose_wrong_mirrors(name):
    """Each synthetic row reaches the edge it is named for: a mirror that
    takes ties at the threshold from the higher position, or that cuts a
    crossing segment at its tile's end, gives other results there."""
    keys, num_edge, ovf, kw = ROWS[name]
    want = P.top_segments_plain(torch.from_numpy(keys), torch.from_numpy(num_edge),
                                torch.from_numpy(ovf), **kw)
    for wrong in CATCHES[name]:
        got = mirror_segments(keys, num_edge, ovf, **_mirror_kw(kw), **{wrong: True})
        assert any(not np.array_equal(getattr(want, f).numpy(), got[m]) for f, m in SEG_FIELDS), \
            f"{name}: the {wrong} mirror agrees"


def test_synthetic_rows_reach_their_edges():
    """The rows hold what they are named for, at the kernel's 512-key tiles."""
    got = {name: (P.top_segments_plain(torch.from_numpy(k), torch.from_numpy(ne),
                                       torch.from_numpy(ov), **kw),
                  P.segment_tiles_plain(torch.from_numpy(k), torch.from_numpy(ne), E=kw["E"],
                                        min_cluster_pixels=kw["min_cluster_pixels"],
                                        max_perimeter=kw["max_perimeter"]), kw)
           for name, (k, ne, ov, kw) in ROWS.items()}
    for name, (seg, tiles, kw) in got.items():
        assert (tiles.stats[:, 4] >= 0).any(), f"{name}: a segment crosses a tile's end"
    seg, tiles, _ = got["a segment across many tiles"]
    assert int(seg.count[0, 0]) == 3000 and int(seg.edge_stride[1]) == 2
    seg, tiles, _ = got["segments ending on tile edges"]
    assert (tiles.stats[0, 4, :2] == -1).all() and int(tiles.stats[0, 0, 1]) == 2
    seg, _, kw = got["fewer candidates than C"]
    assert 0 < int(seg.valid.sum()) < kw["max_clusters"]
    seg, _, _ = got["no candidates"]
    assert not seg.valid.any() and int(seg.num_eligible[0]) == 0
    seg, tiles, kw = got["min_cluster_pixels 0, nv < E"]
    assert int(tiles.nv[0]) < kw["E"] and int(seg.num_eligible[0]) == kw["E"]
    seg, tiles, _ = got["a frame with no valid key"]
    assert int(tiles.nv[0]) == 0 and not seg.valid[0].any() and bool(seg.overflow[0])
    seg, tiles, kw = got["a histogram of 16001 bins"]
    assert tiles.hist.shape[-1] == 16001 and int(seg.count[0, 0]) == 13000 > 12000
    seg, _, _ = got["ties at T split across tiles"]
    assert bool(seg.overflow[0]) and int((seg.count[0] == 30).sum()) == 18


@pytest.mark.parametrize("case", list(CASES))
def test_wrappers_compose_the_plain_segment_versions(stages, case):
    """On CPU tensors top_segments runs segment_tiles_plain then
    segment_top_plain: every field equals top_segments_plain's."""
    st = stages[case]
    kw = _top_kw(st["kw"])
    want = P.top_segments_plain(st["key_s"], st["num_edge"], st["ovf"], **kw)
    got = K.top_segments(st["key_s"], st["num_edge"], st["ovf"], **kw)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# The segment-top kernel's own steps (cm_seg_top_kernel): TOP_THREADS
# threads of TOP_TPT tiles a chunk, coarse bins of 32 sizes (a warp's bins
# of a round), TOP_PER consecutive entries a thread a round.
TOP_THREADS, TOP_TPT, TOP_PER, TOP_BIN = 256, 4, 8, 32
# Layouts that take the kernel's chunk and round loops more than once on
# small rows: (threads, tiles a thread, entries a thread a round).
TOP_LAYOUTS = {"kernel": (TOP_THREADS, TOP_TPT, TOP_PER), "chunks of 8 tiles": (4, 2, 8),
               "rounds of 6 entries": (3, 4, 2)}
# Wrong on purpose: ties at T to the higher position; the coarse bins
# floor((max_per + 1) / 32), dropping the last, partial one; T's coarse bin
# read past the last size (where the coarse bins follow in shared memory);
# the crossing segments left out of the histograms; T taken at its coarse
# bin's lowest size; the winners above T tied by position descending.
TOP_WRONG = ("ties_high", "coarse_floor", "fine_unmasked", "no_cross_hist", "coarse_threshold",
             "gt_pos_desc")


def mirror_top_kernel(tiles, num_edge, comp_overflow, *, E, E2, C, min_pix, max_per,
                      layout=TOP_LAYOUTS["kernel"], wrong=None):
    """cm_seg_top_kernel's steps in numpy, frame by frame, on a
    SegmentTiles: the histogram and its coarse bins; pass 1 over chunks from
    the last (each crossing start's end from the later tiles' first starts,
    the gated size added into both histograms); T's coarse bin by the
    lanes' sums from the top and one lane's walk, then T among its 32 bins;
    pass 2 over chunks in order: the entries of the tiles that reach T laid
    out by their offsets, taken a run a thread a round (a binary search
    each), the sizes above T listed, the size-T entries placed in entry
    order. Returns the TopSegments fields as numpy arrays."""
    threads, tpt, per = layout
    chunk = threads * tpt
    stats, cand, hist, nv = (x.numpy().astype(np.int64) for x in tiles)
    B, _, T = stats.shape
    budget = (9 * E) // 10
    NB = max_per + 1
    NCB = NB // TOP_BIN if wrong == "coarse_floor" else -(-NB // TOP_BIN)
    top_pos, count = np.zeros((B, C), np.int32), np.zeros((B, C), np.int32)
    fields = {k: np.zeros(B, np.int64) for k in ("n_clusters", "n_eligible", "stride")}
    overflow = np.zeros(B, bool)
    for b in range(B):
        ns, nc, mx, fs, ls = stats[b]
        stride = max(1, (int(num_edge[b]) + budget - 1) // budget)
        fine = hist[b].copy()
        coarse = np.array([fine[g * TOP_BIN:(g + 1) * TOP_BIN].sum() for g in range(NCB)])
        cs = np.zeros(T, np.int64)
        later = int(nv[b])
        for c0 in range((T - 1) // chunk * chunk, -1, -chunk):
            u = np.arange(c0, min(c0 + chunk, T))
            after = np.minimum.accumulate(np.r_[fs[u][1:], I32MAX][::-1])[::-1]
            nxt = np.minimum(after, later)
            later = min(later, int(fs[u].min()))
            cnt = nxt - ls[u]
            keep = (ls[u] >= 0) & (cnt * stride >= min_pix) & (cnt * stride <= max_per)
            cs[u] = np.where(keep, cnt, 0)
            if wrong != "no_cross_hist":
                for c in cs[u][keep]:
                    fine[c] += 1
                    if c // TOP_BIN < NCB:
                        coarse[c // TOP_BIN] += 1
        tot_first = int(ns.sum())
        tot_cand = int(nc.sum() + (cs > 0).sum())
        tot_elig = tot_cand + (E - tot_first if min_pix <= 0 else 0)
        want = min(C, tot_cand)
        Tsz, ngt = I32MAX, 0
        if want > 0:
            cpl = -(-NCB // 32)
            sums, spans = [], []
            for lane in range(32):
                hi = NCB - lane * cpl
                lo = max(0, hi - cpl)
                spans.append((lo, hi))
                sums.append(int(coarse[lo:hi].sum()) if hi > lo else 0)
            inc = np.cumsum(sums)
            hits = np.flatnonzero(inc >= want)
            if len(hits):          # a wrong histogram may hold fewer than want: no T
                L = int(hits[0])
                acc = int(inc[L] - sums[L])
                lo, hi = spans[L]
                for x in range(hi - 1, lo - 1, -1):
                    if acc + coarse[x] >= want:
                        G, above = x, acc
                        break
                    acc += int(coarse[x])
                xs = G * TOP_BIN + TOP_BIN - 1 - np.arange(TOP_BIN)
                # Past the last bin the kernel reads 0; the unmasked read
                # would find the coarse bins that follow the bins in memory.
                past = coarse[np.clip(xs - NB, 0, NCB - 1)] if wrong == "fine_unmasked" else 0
                v = np.where(xs < NB, fine[np.minimum(xs, NB - 1)], past)
                finc = np.cumsum(v)
                hits = np.flatnonzero(above + finc >= want)
                F = int(hits[0]) if len(hits) else TOP_BIN - 1
                Tsz = G * TOP_BIN if wrong == "coarse_threshold" else int(xs[F])
                ngt = above + int((v[xs > Tsz]).sum())
        ties = want - ngt
        gt, eq_base = [], 0
        for c0 in range(0, T, chunk):
            u = np.arange(c0, min(c0 + chunk, T))
            n = np.where(np.maximum(mx[u], cs[u]) >= Tsz, nc[u] + (cs[u] > 0), 0)
            off = np.cumsum(n) - n
            tot = int(n.sum())
            for f0 in range(0, tot, threads * per):
                f = np.arange(f0, min(f0 + threads * per, tot))
                a = np.searchsorted(off, f, side="right") - 1     # the last tile with off <= f
                j = f - off[a]
                own = j < nc[u[a]]
                raw = cand[b, u[a] * P.SEG_TILE + np.where(own, j, 0)]
                size = np.where(own, raw >> P.SEG_POS_BITS, cs[u[a]])
                pos = np.where(own, u[a] * P.SEG_TILE + (raw & ((1 << P.SEG_POS_BITS) - 1)),
                               ls[u[a]])
                gt += list(zip(size[size > Tsz], pos[size > Tsz]))
                at_T = np.flatnonzero(size == Tsz)
                place = eq_base + np.arange(len(at_T))
                if wrong == "ties_high":
                    place = place[::-1]
                for i, p in zip(at_T, place):
                    if 0 <= p < ties:
                        top_pos[b, ngt + p], count[b, ngt + p] = pos[i], Tsz
                eq_base += len(at_T)
        # The kernel lists ngt < C sizes above T and ranks them into [0, ngt):
        # a wrong T that lists more, or ranks past C, leaves the frame undefined.
        assert wrong is not None or len(gt) == ngt < C or want == 0
        for sz, p in gt:
            r = sum(s > sz or (s == sz and (q > p if wrong == "gt_pos_desc" else q < p))
                    for s, q in gt)
            if r >= C or len(gt) != ngt:
                top_pos[b], count[b] = -1, -1
                break
            top_pos[b, r], count[b, r] = p, sz
        tot_size = int(sum(s for s, _ in gt)) + ties * Tsz if want > 0 else 0
        fields["n_clusters"][b], fields["n_eligible"][b], fields["stride"][b] = (
            tot_first, tot_elig, stride)
        overflow[b] = bool(num_edge[b] > E or comp_overflow[b] or tot_elig > C or tot_size > E2)
    return dict(top_pos=top_pos, count=count, valid=count > 0, overflow=overflow,
                **{k: v.astype(np.int32) for k, v in fields.items()})


def _top_kernel_inputs(keys, num_edge, ovf, kw):
    k, ne, ov = torch.from_numpy(keys), torch.from_numpy(num_edge), torch.from_numpy(ovf)
    tiles = P.segment_tiles_plain(k, ne, E=kw["E"], min_cluster_pixels=kw["min_cluster_pixels"],
                                  max_perimeter=kw["max_perimeter"])
    return k, ne, ov, tiles


def _assert_top_mirror(got: dict, want, what: str) -> None:
    for f, m in SEG_FIELDS:
        np.testing.assert_array_equal(getattr(want, f).numpy(), got[m], err_msg=f"{what}: {f}")


@pytest.mark.parametrize("layout", list(TOP_LAYOUTS))
@pytest.mark.parametrize("name", list(ROWS))
def test_top_kernel_mirror_on_synthetic_rows(name, layout):
    """The segment-top kernel's mirror, on segment_tiles_plain's tiles of
    chip_smoke.py's synthetic rows, equals segment_top_plain (its _top_c:
    the stable descending sort) and top_segments_plain on every field, at
    the kernel's layout and at layouts that loop over chunks and rounds."""
    keys, num_edge, ovf, kw = ROWS[name]
    k, ne, ov, tiles = _top_kernel_inputs(keys, num_edge, ovf, kw)
    got = mirror_top_kernel(tiles, num_edge, ovf, layout=TOP_LAYOUTS[layout], **_mirror_kw(kw))
    _assert_top_mirror(got, P.segment_top_plain(tiles, ne, ov, **kw), "segment_top_plain")
    _assert_top_mirror(got, P.top_segments_plain(k, ne, ov, **kw), "top_segments_plain")


@pytest.mark.parametrize("layout", list(TOP_LAYOUTS))
@pytest.mark.parametrize("case", list(CASES))
def test_top_kernel_mirror_on_scenes(stages, case, layout):
    """The same mirror on the scenes' sorted keys (E cut, ties, eligible
    past C, slot overflow) equals segment_top_plain."""
    st = stages[case]
    kw = _top_kw(st["kw"])
    tiles = P.segment_tiles_plain(st["key_s"], st["num_edge"], E=kw["E"],
                                  min_cluster_pixels=kw["min_cluster_pixels"],
                                  max_perimeter=kw["max_perimeter"])
    got = mirror_top_kernel(tiles, st["num_edge"].numpy(), st["ovf"].numpy(),
                            layout=TOP_LAYOUTS[layout], **_mirror_kw(kw))
    _assert_top_mirror(got, P.segment_top_plain(tiles, st["num_edge"], st["ovf"], **kw),
                       "segment_top_plain")


# The wrong top-kernel mirrors each synthetic row of the top kernel's own
# edges must expose.
TOP_CATCHES = {"T in the last coarse bin": ("coarse_floor", "fine_unmasked", "no_cross_hist"),
               "ties straddling T inside a coarse bin": ("ties_high", "coarse_threshold",
                                                         "gt_pos_desc"),
               "entries past one round of the top kernel": ("ties_high", "coarse_threshold"),
               "tiles past one chunk of the top kernel": ("ties_high", "coarse_threshold",
                                                          "no_cross_hist"),
               "min_cluster_pixels -1, a segment cut at E": ("ties_high", "coarse_threshold"),
               "a segment across many tiles": ("no_cross_hist",)}


@pytest.mark.parametrize("name", list(TOP_CATCHES))
def test_top_kernel_rows_expose_wrong_mirrors(name):
    """Each of these rows reaches the top kernel's edge it is named for: the
    wrong mirrors of TOP_WRONG named for it give other results there."""
    keys, num_edge, ovf, kw = ROWS[name]
    _, ne, ov, tiles = _top_kernel_inputs(keys, num_edge, ovf, kw)
    want = P.segment_top_plain(tiles, ne, ov, **kw)
    for wrong in TOP_CATCHES[name]:
        assert wrong in TOP_WRONG
        got = mirror_top_kernel(tiles, num_edge, ovf, wrong=wrong, **_mirror_kw(kw))
        assert any(not np.array_equal(getattr(want, f).numpy(), got[m]) for f, m in SEG_FIELDS), \
            f"{name}: the {wrong} mirror agrees"


def test_top_kernel_rows_reach_their_edges():
    """The top kernel's rows hold what they are named for: T in the last,
    partial coarse bin; T inside a coarse bin with ties straddling it and
    equal sizes above it; more entries than a round (2048); more tiles
    than a chunk (1024) with crossing segments on its edge; want 0; a
    segment cut at E under a negative size gate."""
    def top(name):
        keys, num_edge, ovf, kw = ROWS[name]
        _, ne, ov, tiles = _top_kernel_inputs(keys, num_edge, ovf, kw)
        return P.segment_top_plain(tiles, ne, ov, **kw), tiles, kw

    seg, _, kw = top("T in the last coarse bin")
    T = int(seg.count[0, -1])
    assert T // TOP_BIN == kw["max_perimeter"] // TOP_BIN and (kw["max_perimeter"] + 1) % TOP_BIN
    seg, _, _ = top("ties straddling T inside a coarse bin")
    c = seg.count[0].tolist()
    assert c[:3] == [50, 50, 50] and c[-1] == 45 and 45 % TOP_BIN and int(seg.num_eligible[0]) > 21
    seg, tiles, kw = top("entries past one round of the top kernel")
    T = int(seg.count[0, -1])
    # Every tile with a candidate reaches T = 24, the least size that passes.
    assert int(tiles.stats[0, 1].sum()) > TOP_THREADS * TOP_PER and T == kw["min_cluster_pixels"]
    assert kw["E"] % P.SEG_TILE
    seg, tiles, kw = top("tiles past one chunk of the top kernel")
    chunk = TOP_THREADS * TOP_TPT
    assert tiles.stats.shape[-1] > chunk and int(tiles.stats[0, 4, chunk - 1]) >= 0
    assert kw["min_cluster_pixels"] < 0 and bool(seg.overflow[0])
    seg, _, _ = top("no candidates")
    assert not seg.valid.any()
    seg, tiles, kw = top("min_cluster_pixels -1, a segment cut at E")
    assert int(seg.count[0, 0]) == kw["E"] - 1500 and kw["E"] % P.SEG_TILE


SEG_KPT = 16        # keys a lane of cm_seg_tiles_kernel (csrc/cluster_moments.cu)
WALK_GROUPS = (1, 3, None)   # groups a frame of the mirror's walk (None: a group a tile)


def mirror_tile_walk(key_s, num_edge, *, E, min_pix, max_per, groups=None, tile=P.SEG_TILE,
                     prev_minus_one=False, stale_keys=False):
    """cm_seg_tiles_kernel in numpy, frame by frame: `groups` groups a frame
    (None: one a tile), group g walking tiles g, g + groups, ...; a tile's
    keys SEG_KPT consecutive ones a lane; a lane's first key compared with
    the previous lane's last (lane 0: the key before the tile); each lane's
    starts sized from the first start of the lanes after it (a suffix
    minimum) and its own from the last back; the candidates compacted by a
    prefix over the lanes; the walk ended at the first tile past the valid
    prefix, whose fields and those of the group's later tiles are written at
    once. Returns segment_tiles_plain's fields as numpy, the candidate
    entries the kernel leaves unwritten 0. `prev_minus_one` (every lane's
    first key compared with -1) and `stale_keys` (a walk's later tiles read
    with its first tile's keys) are wrong on purpose."""
    B = key_s.shape[0]
    T = -(-E // tile)
    G = T if groups is None else min(groups, T)
    budget = (9 * E) // 10
    stats = np.zeros((B, 5, T), np.int64)
    cand = np.zeros((B, T * tile), np.int64)
    hist = np.zeros((B, max_per + 1), np.int64)
    nv = np.full(B, -1, np.int64)
    lane_no = np.arange(tile // SEG_KPT)
    for b in range(B):
        ks = key_s[b].astype(np.int64)
        stride = max(1, (int(num_edge[b]) + budget - 1) // budget)
        for g in range(G):
            first_keys = None
            for u in range(g, T, G):
                s, e = u * tile, min(u * tile + tile, E)
                if u > 0 and ks[s] == I32MAX:
                    stats[b, :, u::G] = np.array([0, 0, 0, I32MAX, -1])[:, None]
                    break
                k = np.full(tile, I32MAX, np.int64)
                k[:e - s] = ks[s:e]
                if stale_keys and first_keys is not None:
                    k = first_keys
                first_keys = k if first_keys is None else first_keys
                lanes = k.reshape(-1, SEG_KPT)
                i0 = s + SEG_KPT * lane_no
                prev = np.r_[ks[s - 1] if s > 0 else -1, lanes[:-1, -1]]
                if prev_minus_one:
                    prev = np.full_like(prev, -1)
                valid = lanes < I32MAX
                start = valid & (lanes != np.concatenate([prev[:, None], lanes[:, :-1]], 1))
                pos = i0[:, None] + np.arange(SEG_KPT)
                first = np.where(start.any(1), np.where(start, pos, I32MAX).min(1), I32MAX)
                after = np.r_[np.minimum.accumulate(first[::-1])[::-1][1:], I32MAX]
                vend = s + int(valid.sum())
                full = vend == e
                k_end = ks[e] if e < E else I32MAX
                open_end = full and e < E and k_end == ks[e - 1]
                sizes = np.zeros_like(lanes)
                for lane in range(len(lanes)):
                    nxt = after[lane]
                    for j in range(SEG_KPT - 1, -1, -1):
                        if start[lane, j]:
                            i = int(pos[lane, j])
                            tail = nxt == I32MAX
                            if not (tail and open_end):
                                cnt = (vend if tail else nxt) - i
                                if min_pix <= cnt * stride <= max_per:
                                    sizes[lane, j] = cnt
                            nxt = i
                own = sizes.reshape(-1) > 0
                at = np.cumsum(own) - 1
                cand[b, s + at[own]] = (sizes.reshape(-1)[own] << P.SEG_POS_BITS) | (
                    pos.reshape(-1)[own] - s)
                np.add.at(hist[b], sizes.reshape(-1)[own], 1)
                n_starts = int(start.sum())
                ls = int(pos[start].max()) if n_starts else -1
                stats[b, :, u] = (n_starts, int(own.sum()), int(sizes.max()), first.min(),
                                  ls if open_end and n_starts else -1)
                if not full or e == E or k_end == I32MAX:
                    nv[b] = vend
    return dict(stats=stats, cand=cand, hist=hist, nv=nv)


def _walk_tiles(m: dict):
    return P.SegmentTiles(stats=torch.from_numpy(m["stats"]).to(torch.int32),
                          cand=torch.from_numpy(m["cand"]).to(torch.int32),
                          hist=torch.from_numpy(m["hist"]).to(torch.int32),
                          nv=torch.from_numpy(m["nv"]).to(torch.int32))


def _assert_walk_matches(keys, num_edge, ovf, kw, groups) -> None:
    k, ne, ov = torch.from_numpy(keys), torch.from_numpy(num_edge), torch.from_numpy(ovf)
    tkw = dict(E=kw["E"], min_cluster_pixels=kw["min_cluster_pixels"],
               max_perimeter=kw["max_perimeter"])
    m = mirror_tile_walk(keys, num_edge, E=kw["E"], min_pix=kw["min_cluster_pixels"],
                         max_per=kw["max_perimeter"], groups=groups)
    want = P.segment_tiles_plain(k, ne, **tkw)
    for f in want._fields:
        np.testing.assert_array_equal(m[f], getattr(want, f).numpy(), err_msg=f)
    got = P.segment_top_plain(_walk_tiles(m), ne, ov, **kw)
    for f, a, w in zip(got._fields, got, P.top_segments_plain(k, ne, ov, **kw)):
        assert torch.equal(a, w), f


@pytest.mark.parametrize("groups", WALK_GROUPS)
@pytest.mark.parametrize("name", list(ROWS))
def test_tile_walk_mirror_on_synthetic_rows(name, groups):
    """The tiles kernel's walk (a warp a 512-key tile, 16 keys a lane, the
    tiles of a frame walked by 1, 3 or one group a tile) lays out
    segment_tiles_plain's fields, candidates, histogram and valid keys on
    chip_smoke.py's rows, and segment_top_plain on them gives
    top_segments_plain's results."""
    keys, num_edge, ovf, kw = ROWS[name]
    _assert_walk_matches(keys, num_edge, ovf, kw, groups)


@pytest.mark.parametrize("groups", WALK_GROUPS)
@pytest.mark.parametrize("case", list(CASES))
def test_tile_walk_mirror_on_scenes(stages, case, groups):
    st = stages[case]
    _assert_walk_matches(st["key_s"].numpy(), st["num_edge"].numpy(), st["ovf"].numpy(),
                         _top_kw(st["kw"]), groups)


@pytest.mark.parametrize("name", list(ROWS))
def test_synthetic_rows_expose_wrong_walks(name):
    """Every row exposes a walk that compares each lane's first key with -1
    and one whose later tiles keep the first tile's keys (one group a
    frame)."""
    keys, num_edge, ovf, kw = ROWS[name]
    want = P.segment_tiles_plain(torch.from_numpy(keys), torch.from_numpy(num_edge), E=kw["E"],
                                 min_cluster_pixels=kw["min_cluster_pixels"],
                                 max_perimeter=kw["max_perimeter"])
    for wrong in ("prev_minus_one", "stale_keys"):
        m = mirror_tile_walk(keys, num_edge, E=kw["E"], min_pix=kw["min_cluster_pixels"],
                             max_per=kw["max_perimeter"], groups=1, **{wrong: True})
        assert any(not np.array_equal(m[f], getattr(want, f).numpy()) for f in want._fields), \
            f"{name}: the {wrong} walk agrees"
