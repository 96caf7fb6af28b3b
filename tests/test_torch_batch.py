"""The PyTorch port's batched stages, stage by stage, on a batch of three
DIFFERENT frames: each stage run on the batch must give, frame by frame,
what the same stage gives on that frame alone, and what the JAX package
gives on that frame (run frame by frame, never vmapped).

Frames differ in tag ids, tag positions and noise seed, so a stage that let
one frame read another's pixels, labels or table entries would show here
(the reference only ever batches identical frames). Integer outputs are
exact; float outputs use the gates of tests/test_torch_tail.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu.models.families import get_family as jget_family
from isaac_ros_apriltag_tpu.ops import cluster_moments as jcm
from isaac_ros_apriltag_tpu.ops import decode as jdec
from isaac_ros_apriltag_tpu.ops import pose as jpose
from isaac_ros_apriltag_tpu.ops import quadfit as jqf
from isaac_ros_apriltag_tpu.ops import refine as jref
from isaac_ros_apriltag_tpu.ops import resolve as jres
from isaac_ros_apriltag_tpu.ops.pallas.ccl_fused import ccl_scan_pallas
from isaac_ros_apriltag_tpu.ops.pallas.threshold import adaptive_threshold_pallas
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as tcm
from isaac_ros_apriltag_tpu_torch.ops import decode as tdec
from isaac_ros_apriltag_tpu_torch.ops import pose as tpose
from isaac_ros_apriltag_tpu_torch.ops import quadfit as tqf
from isaac_ros_apriltag_tpu_torch.ops import refine as tref
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold

B = 3
K = np.array([[210.0, 0, 160], [0, 210.0, 120], [0, 0, 1]], np.float32)
R = (120 * 160) // 8                # the detector's component capacity at 120x160
MOMENT_KW = dict(max_edge_points=(3 * 120 * 160) // 4, max_clusters=128,
                 min_cluster_pixels=24, max_cluster_points=1024)
INT_FIELDS = ("count", "valid", "num_clusters", "num_eligible", "num_edge_points",
              "edge_stride", "overflow", "dark_inside")
FLOAT_FIELDS = ("bw", "bx", "by", "bxx", "bxy", "byy", "centroid", "scale")


def _t(a):
    return torch.from_numpy(np.array(a))


def _frame_tags(b):
    """Frame b: two tags whose ids and positions depend on b."""
    fam = jget_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.2 + 0.03 * b, -0.1), (0.2, 0.1 - 0.04 * b)]):
        t = np.array([x, y, 1.0])
        tags.append(dict(family=fam, id=7 * i + 3 + b, R=upright_pose(t, 0.1 * i + 0.05 * b),
                         t=t, tag_size=0.16))
    return tags


@pytest.fixture(scope="module")
def frames():
    """Three 240x320 gray frames, their 120x160 segmentation images and
    trinaries (the port's twin, which the tests below hold to JAX)."""
    imgs = np.stack([render_tags(K, (240, 320), _frame_tags(b), noise=2.0, seed=b)
                     for b in range(B)])
    gray = torch.from_numpy(imgs).to(torch.float32)
    seg = _pad_to_tiles(_decimate(gray, 2), 4).contiguous()
    tri = adaptive_threshold(seg, 4, 5)
    return dict(imgs=imgs, gray=gray, seg=seg, tri=tri)


def _speckle(b, shape=(64, 128)):
    rng = np.random.default_rng(10 + b)
    return rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.3, 0.2, 0.5])


# --- front ------------------------------------------------------------------

def test_grayscale_and_decimate_batched(frames):
    rgb = np.stack([np.stack([f, f[::-1], f[:, ::-1]], -1) for f in frames["imgs"]])
    batched = grayscale(torch.from_numpy(rgb), "rgb8", batched=True)
    mono = grayscale(torch.from_numpy(frames["imgs"][..., None]), "mono8", batched=True)
    assert torch.equal(mono, frames["gray"])
    for b in range(B):
        assert torch.equal(batched[b], grayscale(torch.from_numpy(rgb[b]), "rgb8"))
        assert torch.equal(frames["seg"][b], _pad_to_tiles(_decimate(frames["gray"][b], 2), 4))


def test_threshold_batched_matches_frames_and_reference(frames):
    seg, tri = frames["seg"], frames["tri"]
    assert tri.shape == seg.shape
    assert torch.equal(thr_kernel.adaptive_threshold(seg, 4, 5), tri)
    for b in range(B):
        assert torch.equal(tri[b], adaptive_threshold(seg[b], 4, 5))
        want = adaptive_threshold_pallas(jnp.asarray(seg[b].numpy()), 4, 5, interpret=True)
        np.testing.assert_array_equal(np.asarray(want), tri[b].numpy())


@pytest.mark.parametrize("ts", [2, 8])
def test_threshold_batched_random(ts):
    """Frames of different contrast: a tile halo at a frame's edge must clamp
    to that frame, not read the next one's tiles."""
    rng = np.random.default_rng(ts)
    g = rng.uniform(0, 255, (B, 64, 128)).astype(np.float32)
    g[1] = 100.0 + g[1] * 0.01          # flat, low-contrast frame between two noisy ones
    out = adaptive_threshold(torch.from_numpy(g), ts, 5)
    for b in range(B):
        want = adaptive_threshold_pallas(jnp.asarray(g[b]), ts, 5, interpret=True)
        np.testing.assert_array_equal(np.asarray(want), out[b].numpy())
    assert (out[1] == 127).all()


# --- CCL -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_scan_twins_batched_match_frames(seed):
    """One round of K2's and K3's twins on a batch equals the same round on
    each frame: no run and no diagonal hop crosses from one frame to the
    next (white rows meet at every frame boundary)."""
    rng = np.random.default_rng(seed)
    tri = np.stack([_speckle(b + 3 * seed, (17, 23)) for b in range(B)])
    tri[:, 0, :] = 255
    tri[:, -1, :] = 255
    lab = np.stack([rng.permutation(17 * 23).astype(np.int32).reshape(17, 23)
                    for _ in range(B)])
    t, l = torch.from_numpy(tri), torch.from_numpy(lab)
    rows, cols = ccl.row_scan_plain(t, l), ccl.col_diag_scan_plain(t, l)
    # The wrappers take the twins for CPU tensors.
    assert torch.equal(ccl.row_scan(t, l), rows) and torch.equal(ccl.col_diag_scan(t, l), cols)
    for b in range(B):
        assert torch.equal(rows[b], ccl.row_scan_plain(t[b], l[b]))
        assert torch.equal(cols[b], ccl.col_diag_scan_plain(t[b], l[b]))


@functools.lru_cache(maxsize=None)
def _pallas_scan(b, rounds):
    a, conv = ccl_scan_pallas(jnp.asarray(_speckle(b)), rounds, interpret=True)
    return np.asarray(a), bool(conv)


@pytest.mark.parametrize("rounds", [2, 8])
def test_ccl_scan_batched_matches_frames_and_reference(rounds):
    tri = torch.from_numpy(np.stack([_speckle(b) for b in range(B)]))
    lab, conv = ccl.ccl_scan(tri, rounds, backend="torch")
    assert lab.shape == tri.shape and conv.shape == (B,)
    for b in range(B):
        lb, cb = ccl.ccl_scan(tri[b], rounds, backend="torch")
        assert torch.equal(lab[b], lb) and bool(conv[b]) == bool(cb)
        want, wconv = _pallas_scan(b, rounds)
        np.testing.assert_array_equal(want, lab[b].numpy())
        assert bool(conv[b]) == wconv


def test_ccl_scan_converged_per_frame():
    """One frame converges in one round, the others do not."""
    tri = np.stack([_speckle(b) for b in range(B)])
    tri[1] = 127
    tri[1, 4:12, 8:120] = 0
    _, conv = ccl.ccl_scan(torch.from_numpy(tri), 2, backend="torch")
    assert conv.tolist() == [False, True, False]


def test_ccl_scan_label0_batched(frames):
    """The detector's two phases on the scene batch: phase 1, the rank
    contraction, then phase 2 seeded with the rank image."""
    tri = frames["tri"]
    valid = tri != 127
    lab1, c1 = ccl.ccl_scan(tri, 8, backend="cuda")       # CPU tensors: the twins
    rank_img, table, ovf = tres.resolve_roots_rank(lab1, valid, max_components=R)
    lab2, c2 = ccl.ccl_scan(tri, 6, backend="torch", label0=rank_img)
    for b in range(B):
        a1, ac1 = ccl_scan_pallas(jnp.asarray(tri[b].numpy()), 8, interpret=True)
        np.testing.assert_array_equal(np.asarray(a1), lab1[b].numpy())
        assert bool(ac1) == bool(c1[b])
        ri, rt, ro = jres.resolve_roots_rank(a1, jnp.asarray(valid[b].numpy()),
                                             max_components=R)
        np.testing.assert_array_equal(np.asarray(ri), rank_img[b].numpy())
        np.testing.assert_array_equal(np.asarray(rt), table[b].numpy())
        assert bool(ro) == bool(ovf[b])
        a2, ac2 = ccl_scan_pallas(jnp.asarray(tri[b].numpy()), 6, interpret=True,
                                  label0=ri, opaque=True)
        np.testing.assert_array_equal(np.asarray(a2), lab2[b].numpy())
        assert bool(ac2) == bool(c2[b])
        lb, cb = ccl.ccl_scan(tri[b], 6, backend="torch", label0=rank_img[b])
        assert torch.equal(lb, lab2[b]) and bool(cb) == bool(c2[b])


# --- resolve ---------------------------------------------------------------

@pytest.fixture(scope="module")
def resolved(frames):
    tri = frames["tri"]
    valid = tri != 127
    lab1, _ = ccl.ccl_scan(tri, 8, backend="torch")
    rank = tres.resolve_roots_rank(lab1, valid, max_components=R)
    lab2, _ = ccl.ccl_scan(tri, 6, backend="torch", label0=rank[0])
    res = tres.resolve_components(lab2, valid, min_component_pixels=25, max_components=R,
                                  chain_steps=3, rank_table=rank[1])
    return dict(valid=valid, lab1=lab1, lab2=lab2, rank=rank, res=res)


@pytest.mark.parametrize("cap,steps", [(R, 5), (64, 2)])
def test_resolve_roots_rank_batched(frames, resolved, cap, steps):
    """Includes an over-capacity case (64 groups) in every frame."""
    valid, lab1 = resolved["valid"], resolved["lab1"]
    img, table, ovf = tres.resolve_roots_rank(lab1, valid, max_components=cap,
                                              chain_steps=steps)
    for b in range(B):
        one = tres.resolve_roots_rank(lab1[b], valid[b], max_components=cap, chain_steps=steps)
        assert torch.equal(img[b], one[0]) and torch.equal(table[b], one[1])
        assert bool(ovf[b]) == bool(one[2])
        ji, jt, jo = jres.resolve_roots_rank(jnp.asarray(lab1[b].numpy()),
                                             jnp.asarray(valid[b].numpy()),
                                             max_components=cap, chain_steps=steps)
        np.testing.assert_array_equal(np.asarray(ji), img[b].numpy())
        np.testing.assert_array_equal(np.asarray(jt), table[b].numpy())
        assert bool(jo) == bool(ovf[b])


@pytest.mark.parametrize("min_px", [4, 25])
def test_resolve_components_batched(resolved, min_px):
    valid, lab2, (_, table, _) = resolved["valid"], resolved["lab2"], resolved["rank"]
    res = tres.resolve_components(lab2, valid, min_component_pixels=min_px, max_components=R,
                                  chain_steps=3, rank_table=table)
    assert res.dense.shape == lab2.shape and res.n_eligible.shape == (B,)
    for b in range(B):
        one = tres.resolve_components(lab2[b], valid[b], min_component_pixels=min_px,
                                      max_components=R, chain_steps=3, rank_table=table[b])
        for f in res._fields:
            assert torch.equal(getattr(res, f)[b], getattr(one, f)), f
        j = jres.resolve_components(jnp.asarray(lab2[b].numpy()), jnp.asarray(valid[b].numpy()),
                                    min_component_pixels=min_px, max_components=R,
                                    chain_steps=3, rank_table=jnp.asarray(table[b].numpy()))
        np.testing.assert_array_equal(np.asarray(j.dense), res.dense[b].numpy())
        assert int(j.n_eligible) == int(res.n_eligible[b])
        assert bool(j.overflow) == bool(res.overflow[b])
        assert bool(j.converged) == bool(res.converged[b])


# --- cluster moments and the tail -------------------------------------------

@pytest.fixture(scope="module")
def moments(frames, resolved):
    """The port's batched moments, and the reference's moments per frame
    (op by op, as tests/test_torch_tail.py runs them)."""
    tri, res = frames["tri"], resolved["res"]
    ovf = torch.tensor([False, True, False])
    batched = tcm.extract_cluster_moments(tri, res.dense, comp_overflow=ovf, **MOMENT_KW)
    ref = [jcm.extract_cluster_moments(jnp.asarray(tri[b].numpy()),
                                       jnp.asarray(res.dense[b].numpy()),
                                       comp_overflow=jnp.asarray(bool(ovf[b])), **MOMENT_KW)
           for b in range(B)]
    return batched, ref, ovf


def test_cluster_moments_batched(frames, resolved, moments):
    batched, ref, ovf = moments
    tri, dense = frames["tri"], resolved["res"].dense
    assert batched.bw.shape == (B, 128, 64) and batched.num_clusters.shape == (B,)
    for b in range(B):
        one = tcm.extract_cluster_moments(tri[b], dense[b], comp_overflow=ovf[b], **MOMENT_KW)
        for f in INT_FIELDS:
            assert torch.equal(getattr(batched, f)[b], getattr(one, f)), f
            np.testing.assert_array_equal(np.asarray(getattr(ref[b], f)),
                                          getattr(batched, f)[b].numpy(), err_msg=f)
        for f in FLOAT_FIELDS:
            got = getattr(batched, f)[b].numpy()
            np.testing.assert_allclose(got, getattr(one, f).numpy(), rtol=1e-5,
                                       atol=1e-6 * max(1.0, np.abs(got).max()), err_msg=f)
            want = np.asarray(getattr(ref[b], f))
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=1e-6 * max(1.0, np.abs(want).max()), err_msg=f)
    assert bool(batched.overflow[1])


@pytest.fixture(scope="module")
def tail(frames, moments):
    """Quads, refined corners and decodes: the port on the batch (fed the
    reference's moments, stacked) and the reference frame by frame."""
    _, ref, _ = moments
    stacked = tcm.ClusterMoments(*[_t(np.stack([np.asarray(r[i]) for r in ref]))
                                   for i in range(len(ref[0]))])
    quads = tqf.fit_quads_from_moments(stacked, min_area=16.0)
    fit = jax.jit(lambda m: jqf.fit_quads_from_moments(m, min_area=16.0))
    jquads = [fit(r) for r in ref]
    corners = np.stack([np.asarray(q.corners) for q in jquads]) * 2 + 0.5
    dark = np.stack([np.asarray(q.dark_inside) for q in jquads])
    gray = frames["gray"]
    refined = tref.refine_edges(gray, _t(corners), _t(dark), search_range=3.0)
    jrefine = jax.jit(lambda g, c, d: jref.refine_edges(g, c, d, search_range=3.0))
    jrefined = np.stack([np.asarray(jrefine(jnp.asarray(gray[b].numpy()), corners[b], dark[b]))
                         for b in range(B)])
    fam_j, fam_t = jget_family("tag36h11"), get_family("tag36h11")
    dec = tdec.decode_quads(gray, _t(jrefined), fam_t)
    jdecode = jax.jit(lambda g, c: jdec.decode_quads(g, c, fam_j))
    jdecs = [jdecode(jnp.asarray(gray[b].numpy()), jrefined[b]) for b in range(B)]
    return dict(stacked=stacked, quads=quads, jquads=jquads, corners=corners, dark=dark,
                refined=refined, jrefined=jrefined, dec=dec, jdecs=jdecs)


def test_quadfit_batched(tail):
    """Batched == per frame: gates exact, corners within 1e-3 px. Against
    the reference: the quads that decode to a tag are valid in both, with
    corners within 0.15 px. An axis-aligned border's candidate 4-subsets tie
    within rounding, so the two packages may fit arcs one bin apart
    (tests/test_torch_tail.py measured 0.064 px; frame 1's tag 11 here is
    0.117 px), which refinement on the full image removes (see
    test_refine_and_decode_batched and the end-to-end tests). The other
    clusters are noise blobs and tag fragments that nearly tie, and there
    the reference disagrees even with itself (frame 1, cluster 3: fit error
    23.8 jitted, 1.44 op by op, so the MSE gate flips); neither package is
    at fault, so their gates are not compared."""
    quads, jquads, stacked = tail["quads"], tail["jquads"], tail["stacked"]
    assert quads.corners.shape == (B, 128, 4, 2)
    for b in range(B):
        one = tqf.fit_quads_from_moments(tcm.ClusterMoments(*[x[b] for x in stacked]),
                                         min_area=16.0)
        assert torch.equal(quads.gates[b], one.gates) and torch.equal(quads.valid[b], one.valid)
        v = one.valid.numpy()
        np.testing.assert_allclose(quads.corners[b].numpy()[v], one.corners.numpy()[v],
                                   atol=1e-3)
        jv = np.asarray(jquads[b].valid) & np.asarray(tail["jdecs"][b].valid)
        assert jv.sum() >= 2 and v[jv].all()
        np.testing.assert_allclose(quads.corners[b].numpy()[jv],
                                   np.asarray(jquads[b].corners)[jv], atol=0.15)


def test_refine_and_decode_batched(frames, tail):
    gray = frames["gray"]
    ids = []
    for b in range(B):
        v = np.asarray(tail["jquads"][b].valid)
        one = tref.refine_edges(gray[b], _t(tail["corners"][b]), _t(tail["dark"][b]),
                                search_range=3.0)
        np.testing.assert_allclose(tail["refined"][b].numpy()[v], one.numpy()[v], atol=1e-4)
        np.testing.assert_allclose(tail["refined"][b].numpy()[v], tail["jrefined"][b][v],
                                   atol=1e-3)
        da, db = tail["jdecs"][b], tail["dec"]
        one = tdec.decode_quads(gray[b], _t(tail["jrefined"][b]), get_family("tag36h11"))
        for f in ("valid", "id", "hamming", "rotation"):
            np.testing.assert_array_equal(getattr(db, f)[b].numpy()[v], getattr(one, f).numpy()[v])
            np.testing.assert_array_equal(np.asarray(getattr(da, f))[v],
                                          getattr(db, f)[b].numpy()[v], err_msg=f)
        ok = v & np.asarray(da.valid)      # a failed decode's margin means nothing
        np.testing.assert_allclose(db.margin[b].numpy()[ok], np.asarray(da.margin)[ok],
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(db.corners[b].numpy()[v], np.asarray(da.corners)[v])
        ids.append(sorted(np.asarray(da.id)[v & np.asarray(da.valid)].tolist()))
    assert [set(i) >= {t["id"] for t in _frame_tags(b)} for b, i in enumerate(ids)] == [True] * B


def test_pose_batched(tail):
    """One K for the batch; per-frame rows padded to a common count."""
    rows = []
    for b in range(B):
        da = tail["jdecs"][b]
        ok = np.asarray(tail["jquads"][b].valid) & np.asarray(da.valid)
        rows.append(np.asarray(da.corners)[ok][:2])
    corners = np.stack(rows)                                   # (B, 2, 4, 2)
    got = tpose.estimate_poses(_t(corners), _t(K), 0.16)
    jpose_fn = jax.jit(lambda c, k: jpose.estimate_poses(c, k, 0.16))
    for b in range(B):
        want = jpose_fn(jnp.asarray(corners[b]), jnp.asarray(K))
        one = tpose.estimate_poses(_t(corners[b]), _t(K), 0.16)
        for f in ("translation", "quaternion", "rotation"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(), getattr(one, f).numpy(),
                                       atol=1e-6)
            np.testing.assert_allclose(getattr(got, f)[b].numpy(), np.asarray(getattr(want, f)),
                                       atol=1e-4)
