"""The detector's tail in the PyTorch port against the JAX package: cluster
moments, quad fit, edge refinement, decode, pose and the geometry helpers.

Each stage gets the same inputs in both packages (made with seeded numpy, or
the reference's own upstream output). Integer outputs are exact; float
outputs agree within the stated tolerances, which allow for sums taken in
another order (f32 matmuls, LU solves)."""

import dataclasses

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
from isaac_ros_apriltag_tpu.utils import geometry as jgeo
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch.config import DetectorConfig
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as tcm
from isaac_ros_apriltag_tpu_torch.ops import decode as tdec
from isaac_ros_apriltag_tpu_torch.ops import pose as tpose
from isaac_ros_apriltag_tpu_torch.ops import quadfit as tqf
from isaac_ros_apriltag_tpu_torch.ops import refine as tref
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils import geometry as tgeo

K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]], np.float32)
INT_FIELDS = ("count", "valid", "num_clusters", "num_eligible", "num_edge_points",
              "edge_stride", "overflow", "dark_inside")
MOMENTS = ("bw", "bx", "by", "bxx", "bxy", "byy")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """A noisy 480x640 three-tag frame, its gray image, and the 240x320
    segmentation trinary + dense component ids (through the port's twins,
    which tests/test_torch_{front,ccl,resolve}.py hold bit-exact)."""
    fam = jget_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.2, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=5 * i + 2, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    img = render_tags(K, (480, 640), tags, noise=2.0)
    cfg = DetectorConfig(backend="torch")
    gray = torch.from_numpy(img).to(torch.float32)
    seg = _pad_to_tiles(_decimate(gray, 2), 4)
    tri = adaptive_threshold(seg, 4, 5)
    valid = tri != 127
    _, R = cfg.effective_capacities(*tri.shape)
    lab, _ = ccl_scan(tri, 8, backend="torch")
    rank_img, table, _ = resolve_roots_rank(lab, valid, max_components=R)
    lab, _ = ccl_scan(tri, 6, backend="torch", label0=rank_img)
    res = resolve_components(lab, valid, min_component_pixels=25, max_components=R,
                             chain_steps=3, rank_table=table)
    return dict(gray=gray.numpy(), tri=tri.numpy(), dense=res.dense.numpy())


def _moments_both(scene, max_edge_points):
    kw = dict(max_edge_points=max_edge_points, max_clusters=128, min_cluster_pixels=24,
              max_cluster_points=1024)
    # Run op by op, not under jit: jitted, the reference's f32 one-hot
    # matmuls add in another order, and its scale moves by up to 1% on this
    # scene (see test_cluster_moments_close); op by op, ~5e-4.
    a = jcm.extract_cluster_moments(jnp.asarray(scene["tri"]), jnp.asarray(scene["dense"]),
                                    comp_overflow=jnp.asarray(False), **kw)
    b = tcm.extract_cluster_moments(_t(scene["tri"]), _t(scene["dense"]),
                                    comp_overflow=torch.tensor(False), **kw)
    return a, b


@pytest.fixture(scope="module")
def moments(scene):
    return _moments_both(scene, (3 * 240 * 320) // 4)


@pytest.mark.parametrize("field", INT_FIELDS)
def test_cluster_integer_outputs_exact(moments, field):
    a, b = moments
    np.testing.assert_array_equal(np.asarray(getattr(a, field)), getattr(b, field).numpy())


@pytest.mark.parametrize("field", MOMENTS + ("centroid", "scale"))
def test_cluster_moments_close(moments, field):
    """rtol 2e-3 against the reference, whose own f32 sums are that far from
    exact: its variance E[r^2] - |c|^2 cancels nearly equal numbers, so its
    scale moves by up to 1% between two summation orders (jitted against op
    by op on this scene) and by ~5e-4 from the exact value op by op; every
    scale-normalized moment inherits that. test_cluster_moments_match_oracle
    holds the port to the exact values at rtol 1e-5."""
    a, b = moments
    x, y = np.asarray(getattr(a, field)), getattr(b, field).numpy()
    np.testing.assert_allclose(y, x, rtol=2e-3, atol=1e-6 * max(1.0, np.abs(x).max()))


def _diamond_bin32(dx, dy, nbins=64):
    ax, ay = np.abs(dx), np.abs(dy)
    den = np.maximum(ax + ay, np.float32(1e-12))
    t = np.where(dy >= 0, np.where(dx >= 0, dy / den, 1 + ax / den),
                 np.where(dx < 0, 2 + ay / den, 3 + dx / den)).astype(np.float32)
    return np.clip((t * np.float32(nbins / 4)).astype(np.int64), 0, nbins - 1)


def _moments_oracle(tri, dense, max_clusters, min_cluster_pixels):
    """Cluster moments by their definition, in numpy f64, for a frame whose
    pairs fit the budget (no decimation, no truncation). Bins are taken about
    the f32 centroid, as the detector defines them."""
    H, W = tri.shape
    kmax = jres._KMAX              # the gated-out dense id
    tp = np.pad(tri, 1, constant_values=127)
    dp = np.pad(dense, 1, constant_values=kmax)
    ys, xs = np.mgrid[0:H, 0:W]
    key, x, y = [], [], []
    for dx, dy in ((1, 0), (0, 1), (-1, 1), (1, 1)):
        t1 = tp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        d1 = dp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        black = tri == 0
        db, dw = np.where(black, dense, d1), np.where(black, d1, dense)
        m = (tri.astype(int) + t1 == 255) & (db != kmax) & (dw != kmax)
        key.append(db[m].astype(np.int64) * (kmax + 1) + dw[m])
        x.append(xs[m] + dx / 2)
        y.append(ys[m] + dy / 2)
    key, x, y = np.concatenate(key), np.concatenate(x), np.concatenate(y)
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    ok = (cnt >= min_cluster_pixels) & (cnt <= 2 * (2 * W + 2 * H))
    top = [i for i in np.lexsort((uniq, -cnt)) if ok[i]][:max_clusters]
    out = {f: np.zeros((max_clusters, 64)) for f in MOMENTS}
    out["centroid"], out["scale"] = np.zeros((max_clusters, 2)), np.zeros(max_clusters)
    for s, u in enumerate(top):
        px, py = x[inv == u], y[inv == u]
        n = len(px)
        cx32 = np.float32(px.sum()) / np.float32(n)
        cy32 = np.float32(py.sum()) / np.float32(n)
        r2m = (px ** 2 + py ** 2).sum() / n - (px.sum() / n) ** 2 - (py.sum() / n) ** 2
        out["centroid"][s], out["scale"][s] = (cx32, cy32), np.sqrt(r2m)
        ex, ey = px - np.float64(cx32), py - np.float64(cy32)
        b = _diamond_bin32(ex.astype(np.float32), ey.astype(np.float32))
        norm = np.sqrt(np.float64(np.float32(r2m)))     # the detector keeps r2m in f32
        sx, sy = ex / norm, ey / norm
        for f, v in zip(MOMENTS, (np.ones(n), sx, sy, sx * sx, sx * sy, sy * sy)):
            np.add.at(out[f][s], b, v)
    return out


@pytest.fixture(scope="module")
def oracle(scene):
    return _moments_oracle(scene["tri"], scene["dense"], 128, 24)


@pytest.mark.parametrize("field", MOMENTS + ("centroid", "scale"))
def test_cluster_moments_match_oracle(moments, oracle, field):
    """The port's f64 one-hot sums against the moments' definition in f64:
    rtol 1e-5 (atol 1e-6 of the field's largest value, for cells that sum
    to nearly 0)."""
    _, b = moments
    want, got = oracle[field], getattr(b, field).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_cluster_hash_decimation_exact(scene):
    """Over the pair budget the stream is hash-decimated: the stride and the
    surviving counts are exact (int32 wraparound hash computed in int64)."""
    a, b = _moments_both(scene, 4096)
    assert int(b.edge_stride) > 1 and bool(b.overflow)
    for field in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      getattr(b, field).numpy(), err_msg=field)


@pytest.fixture(scope="module")
def quads(moments):
    """Both quad fits on the reference's moments (the same input)."""
    a, _ = moments
    tm = tcm.ClusterMoments(*[_t(np.asarray(x)) for x in a])
    fit = jax.jit(lambda m: jqf.fit_quads_from_moments(m, min_area=16.0))
    return fit(a), tqf.fit_quads_from_moments(tm, min_area=16.0)


def test_quadfit_matches(quads):
    """Gates and validity are equal. Corners within 0.1 px and fit errors
    within 0.05 px^2 (the MSE gate is 10): an axis-aligned border's lines fit
    with zero error, so candidate 4-subsets tie within rounding noise and the
    two packages may pick arcs one bin apart (measured: 0.064 px on one
    quad), which refinement on the full image then removes."""
    a, b = quads
    np.testing.assert_array_equal(np.asarray(a.gates), b.gates.numpy())
    np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())
    v = np.asarray(a.valid)
    assert v.sum() >= 3
    np.testing.assert_allclose(b.corners.numpy()[v], np.asarray(a.corners)[v], atol=0.1)
    np.testing.assert_allclose(b.fit_err.numpy()[v], np.asarray(a.fit_err)[v], atol=0.05)


@pytest.fixture(scope="module")
def decoded(scene, quads):
    """Refine + decode on the reference's quads, full-resolution gray."""
    a, _ = quads
    corners = np.asarray(a.corners) * 2 + 0.5
    dark = np.asarray(a.dark_inside)
    gray = scene["gray"]
    ra = np.asarray(jax.jit(lambda g, c, d: jref.refine_edges(g, c, d, search_range=3.0))(
        jnp.asarray(gray), jnp.asarray(corners), jnp.asarray(dark)))
    rb = tref.refine_edges(_t(gray), _t(corners), _t(dark), search_range=3.0).numpy()
    fam_j, fam_t = jget_family("tag36h11"), get_family("tag36h11")
    da = jax.jit(lambda g, c: jdec.decode_quads(g, c, fam_j))(jnp.asarray(gray),
                                                              jnp.asarray(ra))
    db = tdec.decode_quads(_t(gray), _t(ra), fam_t)
    return np.asarray(a.valid), ra, rb, da, db


def test_refine_matches(decoded):
    v, ra, rb, _, _ = decoded
    np.testing.assert_allclose(rb[v], ra[v], atol=1e-3)


def test_decode_matches(decoded):
    v, _, _, da, db = decoded
    for f in ("valid", "id", "hamming", "rotation"):
        np.testing.assert_array_equal(np.asarray(getattr(da, f))[v],
                                      getattr(db, f).numpy()[v], err_msg=f)
    np.testing.assert_allclose(db.margin.numpy()[v], np.asarray(da.margin)[v],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(db.corners.numpy()[v], np.asarray(da.corners)[v])
    ids = sorted(np.asarray(da.id)[v & np.asarray(da.valid)].tolist())
    assert set(ids) >= {2, 7, 12}


def test_pose_matches(decoded):
    v, _, _, da, _ = decoded
    ok = v & np.asarray(da.valid)
    corners = np.asarray(da.corners)[ok]
    a = jax.jit(lambda c, k: jpose.estimate_poses(c, k, 0.16))(jnp.asarray(corners),
                                                               jnp.asarray(K))
    b = tpose.estimate_poses(_t(corners), _t(K), 0.16)
    np.testing.assert_allclose(b.translation.numpy(), np.asarray(a.translation), atol=1e-4)
    np.testing.assert_allclose(b.quaternion.numpy(), np.asarray(a.quaternion), atol=1e-4)
    np.testing.assert_allclose(b.rotation.numpy(), np.asarray(a.rotation), atol=1e-4)


def test_nonfinite_corners_gather_in_bounds(scene):
    """Invalid lanes carry NaN/inf corners (parallel-line intersections);
    every gather index is clamped, so nothing raises and finite lanes are
    unaffected."""
    gray = _t(scene["gray"])
    good = np.array([[[100.0, 100.0], [140.0, 100.0], [140.0, 140.0], [100.0, 140.0]]],
                    np.float32)
    bad = np.array([[[np.nan, 1.0], [np.inf, -np.inf], [1e30, -1e30], [0.0, np.nan]]],
                   np.float32)
    both = _t(np.concatenate([good, bad]))
    dark = torch.tensor([True, True])
    r = tref.refine_edges(gray, both, dark)
    r1 = tref.refine_edges(gray, _t(good), dark[:1])
    np.testing.assert_array_equal(r[:1].numpy(), r1.numpy())
    d = tdec.decode_quads(gray, both, get_family("tag36h11"))
    d1 = tdec.decode_quads(gray, _t(good), get_family("tag36h11"))
    assert torch.equal(d.margin[:1], d1.margin[:1])
    assert torch.equal(d.id[:1], d1.id[:1])


def test_popcount_swar():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 52, 1000, dtype=np.int64)
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(tdec._popcount64(torch.from_numpy(x)).numpy(), want)


def test_geometry_matches():
    rng = np.random.default_rng(9)
    src = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], np.float32)
    dst = (src * 50 + rng.normal(0, 5, (16, 4, 2)) + 300).astype(np.float32)
    srcb = np.broadcast_to(src, dst.shape).copy()
    ha = np.asarray(jgeo.homography_from_correspondences(jnp.asarray(srcb), jnp.asarray(dst)))
    hb = tgeo.homography_from_correspondences(_t(srcb), _t(dst)).numpy()
    np.testing.assert_allclose(hb, ha, rtol=1e-4, atol=1e-3)
    M = rng.normal(0, 1, (16, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tgeo.inverse3x3(_t(M)).numpy(),
                               np.asarray(jgeo.inverse3x3(jnp.asarray(M))), rtol=1e-5, atol=1e-6)
    Ra = np.asarray(jgeo.orthonormalize_rotation(jnp.asarray(M)))
    Rb = tgeo.orthonormalize_rotation(_t(M)).numpy()
    np.testing.assert_allclose(Rb, Ra, atol=1e-5)
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    Rq = tgeo.rotmat_from_quat(_t(q)).numpy()
    np.testing.assert_allclose(Rq, np.asarray(jgeo.rotmat_from_quat(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(tgeo.quat_from_rotmat(_t(Rq)).numpy(),
                               np.asarray(jgeo.quat_from_rotmat(jnp.asarray(Rq))), atol=1e-5)
    p = rng.normal(0, 10, (4, 16, 2)).astype(np.float32)
    p[3, :4] = p[1, :4]          # parallel pairs -> midpoint branch
    np.testing.assert_allclose(tgeo.line_intersection(*map(_t, p)).numpy(),
                               np.asarray(jgeo.line_intersection(*map(jnp.asarray, p))),
                               rtol=1e-4, atol=1e-3)


def test_singular_homography_gives_nonfinite_not_error():
    same = torch.zeros((2, 4, 2))
    src = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]).expand(2, 4, 2)
    H = tgeo.homography_from_correspondences(src, same)
    assert H.shape == (2, 3, 3)


def test_convert_carries_parameters():
    """convert.py builds the port's camera, family and config from the
    reference objects' plain values."""
    import isaac_ros_apriltag_tpu as J

    from isaac_ros_apriltag_tpu_torch import convert

    cam = J.CameraModel.create(fx=420.0, fy=421.0, cx=320.0, cy=240.0, width=640, height=480,
                               dist=[0.1, -0.01, 0.001, 0.002, 0.0])
    c = convert.camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), 640, 480)
    np.testing.assert_array_equal(c.K.numpy(), np.asarray(cam.K))
    np.testing.assert_array_equal(c.dist.numpy(), np.asarray(cam.dist))
    assert (c.width, c.height) == (640, 480) and c.has_distortion()
    fj = J.get_family("tag25h9")
    f = convert.family_from_reference(**{k.name: getattr(fj, k.name)
                                         for k in dataclasses.fields(fj)})
    np.testing.assert_array_equal(f.rotation_perm, fj.rotation_perm)
    np.testing.assert_array_equal(f.codes, fj.codes)
    cfg = J.DetectorConfig(tag_size=0.3, max_tags=10, backend="xla")
    p = convert.config_from_reference(dataclasses.asdict(cfg), backend="torch")
    assert p.tag_size == 0.3 and p.max_tags == 10 and p.backend == "torch"
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_reference({"no_such_field": 1})
