"""End-to-end: the PyTorch port's Detector (backend 'torch', CPU) against the
JAX package's Detector(backend='interpret'), which runs the Pallas kernels
on the CPU. Same rendered frames, same camera, family and config.

Gates on valid rows: ids and validity equal; corners within 0.1 px,
translation within 1 cm and quaternion within 0.01 (the reference's own
pallas-vs-oracle gate). The integer front's frame statistics are equal."""

import dataclasses

import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.utils.render import project_corners, render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import Detections, Detector, DetectorConfig, batched_detect_fn
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference

TAG_SIZE = 0.16
EXACT_STATS = ("num_edge_points", "num_clusters", "edge_stride", "ccl_converged")


@pytest.fixture(scope="module")
def cams():
    cam = J.CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    return cam, camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), 640, 480)


@pytest.fixture(scope="module")
def detectors(cams):
    cam_j, cam_t = cams
    cfg = J.DetectorConfig(backend="interpret", tag_size=TAG_SIZE)
    port_cfg = config_from_reference(dataclasses.asdict(cfg), backend="torch")
    return J.Detector(cfg, cam_j), Detector(port_cfg, cam_t, device="cpu")


def _tag(tid, t, R):
    return dict(family=J.get_family("tag36h11"), id=tid, R=R, t=np.asarray(t), tag_size=TAG_SIZE)


def _oblique():
    t = np.array([0.02, 0.01, 0.75])
    rx = 0.5
    Rx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    return [_tag(23, t, Rx @ upright_pose(t))]


def _three_noisy():
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(_tag(5 * i + 2, t, upright_pose(t, 0.1 * i)))
    return tags


SCENES = {
    "single": (lambda: [_tag(3, [0.05, -0.02, 0.8], upright_pose(np.zeros(3)))], 0.0),
    "three_noisy": (_three_noisy, 2.0),
    "oblique": (_oblique, 0.0),
}


@pytest.fixture(scope="module")
def results(cams, detectors):
    """Both detectors on every scene, run once and shared."""
    cam_j, _ = cams
    det_j, det_t = detectors
    out = {}
    for name, (make, noise) in SCENES.items():
        tags = make()
        img = render_tags(np.asarray(cam_j.K), (480, 640), tags, noise=noise)
        out[name] = (tags, det_j.detect_with_stats(img, encoding="mono8"),
                     det_t.detect_with_stats(img, encoding="mono8"))
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_detections_match_reference(results, scene):
    tags, (dj, sj), (dt, st) = results[scene]
    rj = {r["id"]: r for r in dj.to_list()}
    rt = {r["id"]: r for r in dt.to_list()}
    assert sorted(rj) == sorted(rt) == sorted(t["id"] for t in tags)
    assert int(dt.count) == len(rt) == int(st.num_detections)
    for i in rj:
        np.testing.assert_allclose(rt[i]["corners"], rj[i]["corners"], atol=0.1)
        np.testing.assert_allclose(rt[i]["translation"], rj[i]["translation"], atol=0.01)
        np.testing.assert_allclose(rt[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
        assert rt[i]["hamming"] == rj[i]["hamming"]
    for f in EXACT_STATS:
        assert int(getattr(sj, f)) == int(getattr(st, f)), f


@pytest.mark.parametrize("scene", list(SCENES))
def test_detections_match_ground_truth(results, cams, scene):
    """Exact corner order (no roll) within 0.7 px of the projected truth."""
    cam_j, _ = cams
    tags, _, (dt, _) = results[scene]
    rows = {r["id"]: r for r in dt.to_list()}
    for tag in tags:
        gt = project_corners(np.asarray(cam_j.K), tag["R"], tag["t"], TAG_SIZE)
        assert np.linalg.norm(np.asarray(rows[tag["id"]]["corners"]) - gt, axis=-1).max() < 0.7


def test_batched_detect_matches_reference_and_frames(cams, detectors, results):
    """The three scenes as one batch of 3 (batched_detect_fn): each frame
    against the reference's result on that frame (the gates above) and
    against the port's own single-frame result (FrameStats, valid and ids
    exact; on valid rows hamming exact, corners within 1e-3 px, translation
    and quaternion within 1e-4)."""
    cam_j, _ = cams
    _, det_t = detectors
    imgs = np.stack([render_tags(np.asarray(cam_j.K), (480, 640), make(), noise=noise)
                     for make, noise in SCENES.values()])
    det, stats = batched_detect_fn(det_t.config, det_t.camera, "mono8")(torch.from_numpy(imgs))
    assert det.valid.shape == (3, det_t.config.max_tags) and stats.num_detections.shape == (3,)
    for b, scene in enumerate(SCENES):
        tags, (dj, sj), (dt, st) = results[scene]
        db, sb = det.frame(b), stats.frame(b)
        rj = {r["id"]: r for r in dj.to_list()}
        rb = {r["id"]: r for r in db.to_list()}
        assert sorted(rb) == sorted(rj) == sorted(t["id"] for t in tags)
        for i in rj:
            np.testing.assert_allclose(rb[i]["corners"], rj[i]["corners"], atol=0.1)
            np.testing.assert_allclose(rb[i]["translation"], rj[i]["translation"], atol=0.01)
            np.testing.assert_allclose(rb[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
        for f in EXACT_STATS:
            assert int(getattr(sj, f)) == int(getattr(sb, f)), f
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(sb, f.name), getattr(st, f.name)), f.name
        v = dt.valid
        assert torch.equal(db.valid, v) and torch.equal(db.id, dt.id)
        assert torch.equal(db.hamming[v], dt.hamming[v])
        for f, tol in (("corners", 1e-3), ("translation", 1e-4), ("quaternion", 1e-4)):
            np.testing.assert_allclose(getattr(db, f)[v].numpy(), getattr(dt, f)[v].numpy(),
                                       atol=tol, err_msg=f)
    assert det.count.tolist() == [len(make()) for make, _ in SCENES.values()]


def test_empty_scene(detectors):
    _, det_t = detectors
    det, stats = det_t.detect_with_stats(np.full((480, 640), 140, np.uint8), encoding="mono8")
    assert det.to_list() == [] and int(det.count) == 0
    assert int(stats.num_detections) == 0
    assert (det.id == -1).all()


def test_rgb_encoding(cams, detectors):
    cam_j, _ = cams
    _, det_t = detectors
    mono = render_tags(np.asarray(cam_j.K), (480, 640),
                       [_tag(7, [0.0, 0.0, 0.8], upright_pose(np.zeros(3)))])
    rows = det_t.detect(np.stack([mono] * 3, -1), encoding="rgb8").to_list()
    assert [r["id"] for r in rows] == [7]


def test_detections_helpers(results):
    _, _, (dt, _) = results["three_noisy"]
    assert sorted(dt.frame_ids("tag36h11")) == ["tag36h11:12", "tag36h11:2", "tag36h11:7"]
    empty = Detections.empty(8)
    assert int(empty.count) == 0 and empty.to_list() == []
    assert empty.rotation.shape == (8, 3, 3) and torch.equal(empty.rotation[3], torch.eye(3))


BAD_CONFIGS = [
    dict(tag_family="tag41h7"),
    dict(tag_family="tag16h5", max_hamming=3),
    dict(tile_size=1),
    dict(tile_size=3),
    dict(max_tags=0),
    dict(max_tags=200),
    dict(max_clusters=256),
    dict(quad_decimate=0),
    dict(ccl_scan_rounds=0),
    dict(ccl_phase2_rounds=-1),
    dict(ccl_resolve_steps=0),
    dict(ccl_rounds=0),
    dict(ccl_jump_every=0),
    dict(max_components=0),
    dict(max_components=1 << 17),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ej:
        J.DetectorConfig(backend="pallas", **kw)
    with pytest.raises(ValueError) as et:
        DetectorConfig(backend="torch", **kw)
    assert str(ej.value).split()[:2] == str(et.value).split()[:2]


def test_backend_names():
    with pytest.raises(ValueError, match="Invalid backend"):
        DetectorConfig(backend="xla")
    with pytest.raises(ValueError, match="Invalid backend"):
        J.DetectorConfig(backend="cuda")


def test_single_phase_ccl_not_supported_yet(cams):
    _, cam_t = cams
    det = Detector(DetectorConfig(backend="torch", ccl_phase2_rounds=0), cam_t, device="cpu")
    with pytest.raises(ValueError, match="ccl_phase2_rounds=0"):
        det.detect(np.zeros((480, 640), np.uint8), encoding="mono8")
