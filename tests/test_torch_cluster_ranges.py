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


def mirror_segments(key_s, num_edge, comp_overflow, *, E, E2, C, min_pix, max_per):
    """The segments kernel's steps in numpy, frame by frame."""
    B = key_s.shape[0]
    budget = (9 * E) // 10
    top_pos = np.zeros((B, C), np.int32)
    count = np.zeros((B, C), np.int32)
    out = dict(n_clusters=[], n_eligible=[], stride=[], overflow=[], ties=[])
    for b in range(B):
        ks = key_s[b, :E]
        nv = int(np.searchsorted(ks, I32MAX, "left"))            # the valid prefix
        stride = max(1, (int(num_edge[b]) + budget - 1) // budget)
        starts = np.flatnonzero(np.r_[True, ks[1:nv] != ks[:nv - 1]])[:nv]
        size = np.searchsorted(ks[:nv], ks[starts], "right") - starts
        true = size.astype(np.int64) * stride
        elig = (true >= min_pix) & (true <= max_per)
        n_elig = int(elig.sum()) + (E - len(starts) if min_pix <= 0 else 0)
        cpos, csize = starts[elig], size[elig]                  # candidates, position order
        want = min(C, len(cpos))
        ties = 0
        if want:
            at_least = np.cumsum(np.bincount(csize, minlength=max_per + 1)[::-1])[::-1]
            T = int(np.flatnonzero(at_least >= want).max())      # the threshold size
            n_gt = int(at_least[T + 1]) if T < max_per else 0
            tie_rank = np.cumsum(csize == T) - 1
            take = (csize > T) | ((csize == T) & (tie_rank < want - n_gt))
            ties = int((csize == T).sum()) - (want - n_gt)      # ties left out
            wpos, wsize = cpos[take], csize[take]
            order = np.lexsort((wpos, -wsize))                   # size down, position up
            top_pos[b, :want], count[b, :want] = wpos[order], wsize[order]
        out["n_clusters"].append(len(starts))
        out["n_eligible"].append(n_elig)
        out["stride"].append(stride)
        out["overflow"].append(bool(num_edge[b] > E or comp_overflow[b] or n_elig > C
                                    or count[b].sum() > E2))
        out["ties"].append(ties)
    return dict(top_pos=top_pos, count=count, valid=count > 0,
                **{k: np.array(v) for k, v in out.items()})


def _diamond_bin(dx, dy):
    f32 = np.float32
    ax, ay = np.abs(dx), np.abs(dy)
    den = np.maximum(ax + ay, f32(1e-12))
    t = np.where(dy >= 0, np.where(dx >= 0, dy / den, f32(1) + ax / den),
                 np.where(dx < 0, f32(2) + ay / den, f32(3) + dx / den))
    return np.clip((t * f32(16)).astype(np.int64), 0, 63)


def mirror_moments(perm, pay, top_pos, count, E2):
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
            pv = pay[b, perm[b, top_pos[b, j]:top_pos[b, j] + n]]
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
    kw = dict(E=E, E2=E2, C=C, min_pix=min_pix, max_per=4 * (W + H))
    seg = mirror_segments(key_s.numpy(), num_edge.numpy(), ovf.numpy(), **kw)
    mom = mirror_moments(perm.numpy(), pay.numpy(), seg["top_pos"], seg["count"], E2)
    return dict(twin=twin, key=key, key_s=key_s, perm=perm, pay=pay, num_edge=num_edge,
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
    mp = P.slot_moments_plain(st["perm"], st["pay"], got.top_pos, got.count, kw["E2"])
    for f in ("centroid", "scale", "dark_inside"):
        np.testing.assert_array_equal(getattr(mp, f).numpy(), mom[f], err_msg=f)
    np.testing.assert_array_max_ulp(mp.table.numpy(), mom["table"], maxulp=1)


def test_wrapper_runs_the_plain_version_on_the_cpu(frames, stages):
    """A CPU tensor goes to the plain version, whole and kernel by kernel;
    one frame without the batch dim gives that frame's results."""
    tri, dense, ovf = frames["tri"], frames["dense"], frames["ovf"]
    st = stages["default"]
    kw = dict(max_edge_points=st["kw"]["E"], max_clusters=128, min_cluster_pixels=MIN_PIX)
    counts = (K.count_launches, K.pairs_launches, K.segments_launches, K.moments_launches)
    got = K.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(st["twin"], f)), f
    one = K.extract_cluster_moments(tri[1], dense[1], comp_overflow=ovf[1], **kw)
    for f in one._fields:
        assert torch.equal(getattr(one, f), getattr(got, f)[1]), f
    E, E2 = st["kw"]["E"], st["kw"]["E2"]
    assert torch.equal(K.edge_count(tri, dense), st["num_edge"])
    key, pay = K.edge_pairs(tri, dense, st["num_edge"], E)
    assert torch.equal(key, st["key"]) and torch.equal(pay, st["pay"])
    seg = K.top_segments(st["key_s"], st["num_edge"], ovf, E=E, E2=E2, max_clusters=128,
                         min_cluster_pixels=MIN_PIX, max_perimeter=st["kw"]["max_per"])
    assert torch.equal(seg.count, st["twin"].count)
    mom = K.slot_moments(st["perm"], st["pay"], seg.top_pos, seg.count, E2)
    assert torch.equal(mom.centroid, st["twin"].centroid)
    assert (K.count_launches, K.pairs_launches, K.segments_launches,
            K.moments_launches) == counts, "nothing launched on the CPU"


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
