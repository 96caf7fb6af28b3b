"""The PyTorch port (backend 'torch', CPU) on the reference's golden
proof-of-life scene and against an external detector, OpenCV aruco's
AprilTag 36h11.

Golden: the reference's POL contract at 1080p (one detection, id 0, hamming
0, center and corners within 2 px, translation within 0.01 m, quaternion
within 0.01), on the port's own copy of the fixture, which must equal the
JAX package's. cv2.aruco: the 12 scenes of tests/test_external_parity.py
with its tolerances and one corner-order mapping for every scene; the
port's frames go through one batched call."""

import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu.utils import render as jrender
from isaac_ros_apriltag_tpu_torch import CameraModel, Detector, DetectorConfig, batched_detect_fn
from isaac_ros_apriltag_tpu_torch.utils.render import GOLDEN, render_tags
from isaac_ros_apriltag_tpu_torch.utils.render import golden_scene as port_golden_scene

# The scenes of tests/test_external_parity.py, which needs cv2 to import.
PARITY_SCENES = ("grid4_clean", "grid4_noise2", "inplane30", "inplane80", "large_close",
                 "mixed_sizes", "noise4", "oblique_mix", "single_clean", "small_far",
                 "tilt_x30", "tilt_y35")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port's CPU ops here: the suite runs in
    several processes at once, and more threads than cores slow every one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_golden_fixture_is_the_reference(golden_scene):
    """The port's GOLDEN and its rendering equal the JAX package's (the
    golden_scene fixture renders it with the JAX package)."""
    assert GOLDEN.keys() == jrender.GOLDEN.keys()
    for k, v in GOLDEN.items():
        np.testing.assert_array_equal(v, jrender.GOLDEN[k], err_msg=k)
    img = port_golden_scene()
    assert img.shape == GOLDEN["size"] and np.array_equal(img, golden_scene)


def test_golden_pol():
    g = GOLDEN
    cam = CameraModel.create(fx=g["K"][0, 0], fy=g["K"][1, 1], cx=g["K"][0, 2], cy=g["K"][1, 2],
                             width=1920, height=1080)
    det = Detector(DetectorConfig(backend="torch", tag_size=g["tag_size"]), cam, device="cpu")
    rows = det.detect(port_golden_scene(), encoding="mono8").to_list()
    assert len(rows) == 1
    r = rows[0]
    assert r["id"] == 0 and r["hamming"] == 0
    assert np.abs(np.asarray(r["center"]) - g["center"]).max() < 2.0
    assert np.abs(np.asarray(r["corners"]) - g["corners"]).max() < 2.0
    assert np.abs(np.asarray(r["translation"]) - g["translation"]).max() < 0.01
    assert np.abs(np.asarray(r["quaternion"]) - g["quaternion_wxyz"]).max() < 0.01


@pytest.fixture(scope="module")
def parity():
    """Every scene rendered, detected by cv2 and, in one batched call, by the
    port: {scene: (tags, cv2 {id: corners}, port {id: corners})}, and the
    reference test's module."""
    cv2 = pytest.importorskip("cv2")
    import test_external_parity as ep

    assert sorted(ep.SCENES) == list(PARITY_SCENES)
    H, W = ep.H, ep.W
    params = cv2.aruco.DetectorParameters()
    params.cornerRefinementMethod = cv2.aruco.CORNER_REFINE_SUBPIX
    params.cornerRefinementWinSize = 5
    cv_det = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_APRILTAG_36h11), params)
    cam = CameraModel.create(fx=ep.FX, fy=ep.FX, cx=W / 2, cy=H / 2, width=W, height=H)
    imgs = np.stack([render_tags(cam.K.numpy(), (H, W), ep.SCENES[n]["tags"],
                                 noise=ep.SCENES[n]["noise"], seed=7) for n in PARITY_SCENES])
    det, _ = batched_detect_fn(DetectorConfig(backend="torch", tag_size=0.16), cam,
                               "mono8")(torch.from_numpy(imgs))
    out = {}
    for b, name in enumerate(PARITY_SCENES):
        d = det.frame(b)
        ours = {int(i): c for i, c in zip(d.id[d.valid].tolist(), d.corners[d.valid].numpy())}
        out[name] = (ep.SCENES[name]["tags"], ep.cv_detect(cv_det, imgs[b]), ours)
    return out, ep


@pytest.fixture(scope="module")
def corner_mapping(parity):
    """The cv2 -> port corner-order mapping, locked on the single clean tag
    and used for every scene."""
    results, ep = parity
    _, cvs, ours = results["single_clean"]
    assert set(ours) == {0} and set(cvs) == {0}
    err, roll, rev = min((np.linalg.norm(ep._apply(cvs[0], roll, rev) - ours[0], axis=-1).max(),
                          roll, rev) for roll, rev in ep._mappings())
    assert err <= ep.CORNER_TOL, f"no corner mapping matches (best {err}, {roll}, {rev})"
    return roll, rev


@pytest.mark.parametrize("scene", PARITY_SCENES)
def test_matches_cv2_aruco(scene, parity, corner_mapping):
    results, ep = parity
    tags, cvs, ours = results[scene]
    spec = ep.SCENES[scene]
    tol = spec.get("tol", ep.CORNER_TOL if spec["noise"] < 2.0 else ep.NOISY_TOL)
    want = sorted(t["id"] for t in tags)
    assert sorted(ours) == want, f"{scene}: ours missed {set(want) - set(ours)}"
    assert sorted(cvs) == want, f"{scene}: cv2 missed {set(want) - set(cvs)}"
    roll, rev = corner_mapping
    for tid in want:
        err = np.linalg.norm(ep._apply(cvs[tid], roll, rev) - ours[tid], axis=-1).max()
        assert err <= tol, f"{scene} id={tid}: corner err {err:.3f} px"
