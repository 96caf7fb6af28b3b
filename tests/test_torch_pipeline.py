"""The graph pipeline of the PyTorch port (rectify -> resize -> detect)
against the JAX package: the camera's rectify map and projection, the
separable rectification plan and its passes, the gather remap, the two
resizes, and GraphPipeline end to end against the reference's
GraphPipeline(backend="interpret").

Calibration: the reference's shipped usb_cam calibration (1280x720), as in
tests/test_pipeline.py, scaled to 640x360 for the end-to-end case."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.ops import remap as jremap
from isaac_ros_apriltag_tpu.pipeline import GraphPipeline as JGraphPipeline
from isaac_ros_apriltag_tpu.utils.render import distort_image as jdistort
from isaac_ros_apriltag_tpu.utils.render import project_corners, render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import DetectorConfig, GraphPipeline, batched_detect_fn
from isaac_ros_apriltag_tpu_torch.convert import (camera_from_reference, config_from_reference,
                                                  rectify_from_reference)
from isaac_ros_apriltag_tpu_torch.ops import remap
from isaac_ros_apriltag_tpu_torch.utils.render import distort_image

REF_K = dict(fx=942.53242, fy=946.21221, cx=642.81122, cy=346.71313)
REF_D = [0.065725, -0.096954, 0.002318, 0.004110, 0.0]


def _cams(scale=0.5):
    w, h = int(1280 * scale), int(720 * scale)
    cam = J.CameraModel.create(width=w, height=h, dist=REF_D,
                               **{k: v * scale for k, v in REF_K.items()})
    return cam, camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), w, h)


def _smooth(h, w, phase=0.0):
    y, x = np.mgrid[0:h, 0:w]
    return (128 + 90 * np.sin(x / 29.0 + phase) * np.cos(y / 31.0)).astype(np.float32)


def _tags(z=1.6, size=0.22, shift=0):
    fam = J.get_family("tag36h11")
    out = []
    for i, (x, y) in enumerate([(-0.35, -0.1), (0.35, 0.12)]):
        t = np.array([x, y, z])
        out.append(dict(family=fam, id=2 * i + 1 + shift, R=upright_pose(t, 0.1 * i + 0.03 * shift),
                        t=t, tag_size=size))
    return out


def test_camera_matches_reference():
    cj, ct = _cams()
    for scale in (1.0, 0.5):
        assert np.array_equal(cj.rectify_map(scale), ct.rectify_map(scale))
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.6, 0.6, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(ct.distort_normalized(torch.from_numpy(xy)).numpy(),
                               np.asarray(cj.distort_normalized(jnp.asarray(xy))), atol=1e-6)
    pts = np.concatenate([xy * 2, rng.uniform(1, 3, (50, 1))], -1).astype(np.float32)
    np.testing.assert_allclose(ct.project(torch.from_numpy(pts)).numpy(),
                               np.asarray(cj.project(jnp.asarray(pts))), atol=1e-6, rtol=1e-6)
    sj, st = cj.scaled(0.5), ct.scaled(0.5)
    np.testing.assert_array_equal(st.K.numpy(), np.asarray(sj.K))
    np.testing.assert_array_equal(st.dist.numpy(), np.asarray(sj.dist))
    assert (st.width, st.height) == (sj.width, sj.height) == (320, 180)


def test_separable_plan_matches_reference():
    cj, ct = _cams()
    pj = jremap.SeparableRectify.from_grid(cj.rectify_map())
    pt = remap.SeparableRectify.from_grid(ct.rectify_map())
    np.testing.assert_array_equal(pt.sx2.numpy(), np.asarray(pj.sx2))
    np.testing.assert_array_equal(pt.sy2.numpy(), np.asarray(pj.sy2))
    assert pt.dx_range == pj.dx_range and pt.dy_range == pj.dy_range


def test_rectify_and_remap_match_reference():
    """The reference's own plan, carried across, on two different frames as
    one batch: within 1e-3 gray levels of the reference on each frame, and
    the batch equal to each frame alone."""
    cj, _ = _cams()
    grid = cj.rectify_map()
    pj = jremap.SeparableRectify.from_grid(grid)
    pt = rectify_from_reference(np.asarray(pj.sx2), np.asarray(pj.sy2), pj.dx_range, pj.dy_range)
    imgs = np.stack([_smooth(360, 640), _smooth(360, 640, 1.3)])
    sep = pt(torch.from_numpy(imgs))
    gat = remap.remap_bilinear(torch.from_numpy(imgs), torch.from_numpy(grid))
    for b in range(2):
        np.testing.assert_allclose(sep[b].numpy(), np.asarray(pj(jnp.asarray(imgs[b]))),
                                   atol=1e-3)
        np.testing.assert_allclose(
            gat[b].numpy(), np.asarray(jremap.remap_bilinear(jnp.asarray(imgs[b]),
                                                             jnp.asarray(grid))), atol=1e-3)
        assert torch.equal(sep[b], pt(torch.from_numpy(imgs[b])))
        assert torch.equal(gat[b], remap.remap_bilinear(torch.from_numpy(imgs[b]),
                                                        torch.from_numpy(grid)))


def test_resize_area_exact():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 60, 80), dtype=np.uint8)
    for f in (2, 4):
        got = remap.resize_area(torch.from_numpy(img), f)
        for b in range(2):
            np.testing.assert_array_equal(got[b].numpy(),
                                          np.asarray(jremap.resize_area(jnp.asarray(img[b]), f)))
    with pytest.raises(ValueError, match="multiple"):
        remap.resize_area(torch.zeros((61, 80)), 2)


@pytest.mark.parametrize("hw", [(30, 40), (45, 50), (90, 120), (17, 80)])
def test_resize_bilinear_matches_reference(hw):
    """Within 1e-3 gray levels (the reference contracts its weight matrices
    in another order; measured 3.4e-4 at the 1.5x upsample)."""
    img = np.random.default_rng(3).uniform(0, 255, (60, 80)).astype(np.float32)
    np.testing.assert_allclose(remap.resize_bilinear(torch.from_numpy(img), hw).numpy(),
                               np.asarray(jremap.resize_bilinear(jnp.asarray(img), hw)),
                               atol=1e-3)


def test_distort_image_matches_reference():
    cj, ct = _cams()
    ideal = render_tags(np.asarray(cj.K), (360, 640), _tags())
    np.testing.assert_array_equal(distort_image(ideal, ct), jdistort(ideal, cj))


def _assert_matches(rows_t, rows_j, tags):
    assert sorted(rows_t) == sorted(rows_j) == sorted(t["id"] for t in tags)
    for i in rows_j:
        np.testing.assert_allclose(rows_t[i]["corners"], rows_j[i]["corners"], atol=0.1)
        np.testing.assert_allclose(rows_t[i]["translation"], rows_j[i]["translation"], atol=0.01)
        np.testing.assert_allclose(rows_t[i]["quaternion"], rows_j[i]["quaternion"], atol=0.01)


@pytest.mark.parametrize("downscale", [1, 2])
def test_graph_pipeline_matches_reference(downscale):
    """A distorted frame through both GraphPipelines (separable rectify):
    ids equal, corners within 0.1 px, translation within 1 cm, quaternion
    within 0.01; the port's corners within 1 px of the truth projected with
    its detection camera. downscale=2 starts from 1280x720."""
    cj, ct = _cams(0.5 * downscale)
    h, w = ct.height, ct.width
    tags = _tags()
    frame = distort_image(render_tags(np.asarray(cj.K), (h, w), tags), ct)
    cfg = J.DetectorConfig(tag_size=0.22, backend="interpret")
    dj, _ = JGraphPipeline(cfg, cj, downscale=downscale, encoding="mono8")(frame)
    gp = GraphPipeline(config_from_reference(dataclasses.asdict(cfg), backend="torch"), ct,
                       downscale=downscale, encoding="mono8", device="cpu")
    dt, _ = gp(frame)
    rows = {r["id"]: r for r in dt.to_list()}
    _assert_matches(rows, {r["id"]: r for r in dj.to_list()}, tags)
    for t in tags:
        want = project_corners(gp.detect_camera.K.numpy(), t["R"], t["t"], t["tag_size"])
        assert np.linalg.norm(np.asarray(rows[t["id"]]["corners"]) - want, axis=-1).max() < 1.0


def test_graph_pipeline_batched_and_exact_remap():
    """Two different distorted frames as one batch equal each frame alone;
    the gather remap finds the same ids, corners within 0.05 px of the
    separable rectify (as tests/test_pipeline.py asks of the reference)."""
    _, ct = _cams()
    frames = np.stack([distort_image(render_tags(ct.K.numpy(), (360, 640), _tags(shift=s),
                                                 noise=1.0, seed=s), ct) for s in (0, 4)])
    cfg = DetectorConfig(tag_size=0.22, backend="torch")
    gp = GraphPipeline(cfg, ct, encoding="mono8", device="cpu")
    det, stats = gp.batched(frames)
    exact, _ = GraphPipeline(cfg, ct, encoding="mono8", exact_remap=True, device="cpu").batched(
        frames)
    for b, shift in enumerate((0, 4)):
        d1, s1 = gp(frames[b])
        db = det.frame(b)
        assert torch.equal(db.valid, d1.valid) and torch.equal(db.id, d1.id)
        v = d1.valid
        np.testing.assert_allclose(db.corners[v].numpy(), d1.corners[v].numpy(), atol=1e-3)
        for f in dataclasses.fields(s1):
            assert torch.equal(getattr(stats.frame(b), f.name), getattr(s1, f.name))
        assert sorted(db.id[v].tolist()) == [1 + shift, 3 + shift]
    assert torch.equal(exact.valid, det.valid) and torch.equal(exact.id, det.id)
    np.testing.assert_allclose(exact.corners[det.valid].numpy(), det.corners[det.valid].numpy(),
                               atol=0.05)


def test_cuda_backend_needs_a_card_device():
    _, ct = _cams()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        batched_detect_fn(DetectorConfig(), ct, "mono8")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphPipeline(DetectorConfig(), ct, device="cpu")
    gp = GraphPipeline(DetectorConfig(backend="torch"), ct, device="cpu")
    with pytest.raises(ValueError, match="images on"):
        gp._detect(torch.zeros((1, 180, 320), device="meta"))
