"""Row-sharded detection of one frame in the PyTorch port (backend 'torch',
CPU): the band-batched front against the JAX package's sharded front on a
4-device CPU mesh, against the port's own single-device front, and the
SpatialDetector against the Detector and against JAX's SpatialDetector.

The integer front is held bit-exact; detections to ids equal, corners within
0.1 px, translation within 1 cm and quaternion within 0.01 on valid rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.parallel import spatial as jsp
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import (Detector, DetectorConfig, SpatialDetector,
                                          build_spatial_front_fn)
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.parallel.spatial import merge_cut

torch.set_num_threads(2)

TAG_SIZE = 0.16
TAG_XY = [(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18), (0.25, 0.18)]
CFG = DetectorConfig(tag_size=TAG_SIZE, backend="torch")


@pytest.fixture(scope="module")
def cams():
    cam = J.CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    return cam, camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), 640, 480)


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:4]), ("y",))


def _scene(cam, noise):
    """tests/test_spatial.py's scene: four tags, ids 1, 4, 7, 10."""
    fam = J.get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate(TAG_XY):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=3 * i + 1, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=TAG_SIZE))
    return render_tags(np.asarray(cam.K), (cam.height, cam.width), tags, noise=noise)


def _single_front(img, cfg=CFG, rounds=None):
    """The port's single-device trinary and phase-1 scan labels."""
    seg = _pad_to_tiles(_decimate(torch.from_numpy(img).float(), cfg.quad_decimate),
                        cfg.tile_size)
    tri = adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    lab, _ = ccl_scan(tri, rounds or cfg.ccl_scan_rounds, backend="torch")
    return tri, lab


def _assert_detections_match(got, want, n):
    rg = {r["id"]: r for r in got.to_list()}
    rw = {r["id"]: r for r in want.to_list()}
    assert sorted(rg) == sorted(rw) and len(rw) == n
    for i in rw:
        np.testing.assert_allclose(rg[i]["corners"], rw[i]["corners"], atol=0.1)
        np.testing.assert_allclose(rg[i]["translation"], rw[i]["translation"], atol=0.01)
        np.testing.assert_allclose(rg[i]["quaternion"], rw[i]["quaternion"], atol=0.01)


def test_front_matches_jax_spatial_front(cams, jax_mesh):
    """4 bands: trinary and global labels bit-exact with the reference's
    shard_map front. No row next to a cut has a white pixel in column 0 or
    W - 1, so the reference's wrapping cut merge (see test_merge_cut_*) has
    nothing to act on here."""
    cam_j, cam_t = cams
    img = _scene(cam_j, 0.0)
    tri_j, lab_j = jsp.build_spatial_front_fn(J.DetectorConfig(tag_size=TAG_SIZE, backend="xla"),
                                              cam_j, jax_mesh)(jnp.asarray(img))
    tri, lab = build_spatial_front_fn(CFG, cam_t, 4)(torch.from_numpy(img))
    np.testing.assert_array_equal(np.asarray(tri_j), tri.numpy())
    np.testing.assert_array_equal(np.asarray(lab_j), lab.numpy())
    Hb = tri.shape[0] // 4
    cut_rows = tri.numpy()[[y for k in range(1, 4) for y in (k * Hb - 1, k * Hb)]]
    assert not (cut_rows[:, [0, -1]] == 255).any()


# One white pixel in each of two 6-px cut rows (the rest 127): (x in the
# band's cut row, x in the row across the cut, the band pixel's label after
# the merge). Band labels are 100 + x, the other row's x.
WRAP_CASES = [(0, 5, 100),   # x = 0 and x = W - 1 do not touch
              (5, 4, 4),     # the diagonal at the row's right end
              (2, 1, 1),     # a diagonal inside the row
              (0, 1, 1)]     # the diagonal at the row's left end


def _cut_rows(xb, xn):
    tri = np.full((2, 6), 127, np.uint8)
    tri[0, xn] = tri[1, xb] = 255
    lab = np.stack([np.arange(6), 100 + np.arange(6)]).astype(np.int32)
    return tri, lab


@pytest.mark.parametrize("xb,xn,want", WRAP_CASES)
def test_merge_cut_equals_single_device_ccl(xb, xn, want):
    """merge_cut on a band's top row equals the single-device CCL of the two
    cut rows stacked (the neighbour's row above the band's)."""
    tri, lab = _cut_rows(xb, xn)
    t, l = torch.from_numpy(tri), torch.from_numpy(lab)
    got = merge_cut(t[1:], l[1:], t[0], l[0], "top")[0]
    single, _ = ccl_scan(t, 2, backend="torch", label0=l)
    assert torch.equal(got, single[1])
    assert int(got[xb]) == want
    # The same cut seen from the band above: its bottom row and the row below.
    got = merge_cut(t[:1], l[:1], t[1], l[1], "bottom")[0]
    assert torch.equal(got, single[0])


def test_merge_cut_differs_from_jax_at_the_row_ends():
    """The reference's _merge_cut blanks the wrong lane after its roll: at
    x = 0 it merges with the other row's x = W - 1 (label 5, not 100), and it
    drops the true diagonals at both ends. Inside the row it agrees."""
    jax_band = {}
    for xb, xn, want in WRAP_CASES:
        tri, lab = _cut_rows(xb, xn)
        out = jsp._merge_cut(jnp.asarray(tri[1:]), jnp.asarray(lab[1:]), jnp.asarray(tri[0]),
                             jnp.asarray(lab[0]), "top")
        jax_band[(xb, xn)] = int(np.asarray(out)[0, xb])
    assert jax_band == {(0, 5): 5, (5, 4): 105, (2, 1): 1, (0, 1): 100}


def test_band_misalignment_autopads():
    """tests/test_spatial.py's 244-row case: the segmentation height 122 does
    not split into tile-aligned bands, so it is padded, cropped back to 124
    (122 up to tiles), and the tag is still found."""
    cam = J.CameraModel.create(fx=220.0, fy=220.0, cx=320.0, cy=61.0, width=640, height=244)
    cam_t = camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), 640, 244)
    t = np.array([0.0, 0.0, 0.6])
    img = render_tags(np.asarray(cam.K), (244, 640),
                      [dict(family=J.get_family("tag36h11"), id=9, R=upright_pose(t), t=t,
                            tag_size=TAG_SIZE)])
    tri, lab = build_spatial_front_fn(CFG, cam_t, 4)(torch.from_numpy(img))
    assert tri.shape == lab.shape == (124, 320)
    det = SpatialDetector(CFG, cam_t, 4, device="cpu").detect(img)
    assert [r["id"] for r in det.to_list()] == [9]


@pytest.mark.parametrize("nshards", [1, 2, 3, 4, 5])
def test_clean_front_equals_single_device(cams, nshards):
    """On the clean scene both CCLs converge: the sharded trinary and labels
    equal the single-device threshold and phase-1 scan labels."""
    cam_j, cam_t = cams
    img = _scene(cam_j, 0.0)
    tri, lab = build_spatial_front_fn(CFG, cam_t, nshards)(torch.from_numpy(img))
    tri_1, lab_1 = _single_front(img)
    assert torch.equal(tri, tri_1)
    assert torch.equal(lab, lab_1)


@pytest.mark.parametrize("noise", [0.0, 1.0, 1.5])
def test_detections_match_detector(cams, noise):
    """Under noise the bounded CCLs may label unconverged speckle differently,
    but the trinary stays bit-exact and the detections match the
    single-device Detector."""
    cam_j, cam_t = cams
    img = _scene(cam_j, noise)
    sd = SpatialDetector(CFG, cam_t, 4, device="cpu")
    tri, _ = build_spatial_front_fn(CFG, cam_t, 4)(torch.from_numpy(img))
    assert torch.equal(tri, _single_front(img)[0])
    det, stats = sd.detect_with_stats(img)
    _assert_detections_match(det, Detector(CFG, cam_t, device="cpu").detect(img, "mono8"), 4)
    assert int(stats.num_detections) == 4


def test_spatial_detector_matches_jax(cams, jax_mesh):
    """4 bands on both sides, clean scene: the reference's SpatialDetector
    (backend 'xla') and the port's find the same four tags."""
    cam_j, cam_t = cams
    img = _scene(cam_j, 0.0)
    want = jsp.SpatialDetector(J.DetectorConfig(tag_size=TAG_SIZE, backend="xla"), cam_j,
                               jax_mesh).detect(jnp.asarray(img))
    _assert_detections_match(SpatialDetector(CFG, cam_t, 4, device="cpu").detect(img), want, 4)


def test_spatial_detector_checks_its_arguments(cams):
    _, cam_t = cams
    with pytest.raises(ValueError, match="nshards"):
        SpatialDetector(CFG, cam_t, 0, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        SpatialDetector(dataclasses.replace(CFG, backend="cuda"), cam_t, 4, device="cpu")
    with pytest.raises(ValueError, match="camera"):
        SpatialDetector(CFG, cam_t, 4, device="cpu").detect(np.zeros((240, 320), np.uint8))
    front = build_spatial_front_fn(dataclasses.replace(CFG, backend="cuda"), cam_t, 4)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        front(torch.zeros((480, 640), dtype=torch.uint8))
