"""The PyTorch port's multi-camera rig (backend 'torch', CPU) against the JAX
package, at 320x240 with 8 cameras.

The shared-K rig is one batched call, so it must equal the port's
batched_detect_fn field for field, and the JAX detector
(backend='interpret', the Pallas kernels on the CPU) frame by frame: ids
equal; on valid rows corners within 0.1 px, translation within 1 cm and
quaternion within 0.01. A per-camera rig poses each camera with its own K;
the batched-K pose is held to jax.vmap of the reference's estimate_poses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.detector import build_detect_fn as jbuild_detect_fn
from isaac_ros_apriltag_tpu.ops import pose as jpose
from isaac_ros_apriltag_tpu.parallel.rig import RigDetector as JRigDetector
from isaac_ros_apriltag_tpu.utils.render import project_corners, render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import RigDetector, batched_detect_fn
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import build_batched_detect_fn
from isaac_ros_apriltag_tpu_torch.ops import pose as tpose

N_CAM = 8
TAG_SIZE = 0.16
CFG = J.DetectorConfig(tag_size=TAG_SIZE, backend="interpret", max_tags=8, max_clusters=16)
PORT_CFG = config_from_reference(dataclasses.asdict(CFG), backend="torch")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port's CPU ops here: the suite runs in
    several processes at once, and more threads than cores slow every one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_camera(cam):
    return camera_from_reference(np.asarray(cam.K), np.asarray(cam.dist), cam.width, cam.height)


def _equal(a, b) -> bool:
    """Exact equality, NaN equal to NaN (masked float lanes may hold NaN)."""
    return torch.equal(a, b) if not a.is_floating_point() else bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _tag(c, t):
    return dict(family=J.get_family("tag36h11"), id=5 * c + 2, R=upright_pose(t, 0.07 * c), t=t,
                tag_size=TAG_SIZE)


@pytest.fixture(scope="module")
def shared():
    """Eight cameras with one K, a tag at another place in each frame."""
    cam = J.CameraModel.create(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320, height=240)
    frames = np.stack([
        render_tags(np.asarray(cam.K), (240, 320),
                    [_tag(c, np.array([0.05 * (c % 3 - 1), 0.04 * (c // 3 - 1), 0.8]))],
                    noise=1.0, seed=c)
        for c in range(N_CAM)])
    return cam, frames


@pytest.fixture(scope="module")
def per_camera():
    """Eight cameras, each with its own focal length and principal point, each
    rendering its tag through its own K."""
    cams, frames, truth = [], [], []
    for c in range(N_CAM):
        f = 180.0 + 12.0 * c
        cam = J.CameraModel.create(fx=f, fy=f, cx=160.0 + 2.0 * c, cy=120.0 - 1.5 * c,
                                   width=320, height=240)
        t = np.array([0.03 * (c % 3 - 1), 0.02 * (c // 3 - 1), 0.8])
        frames.append(render_tags(np.asarray(cam.K), (240, 320), [_tag(c, t)], seed=c))
        cams.append(cam)
        truth.append(t)
    return cams, np.stack(frames), truth


def test_with_pose_false_zeroes_only_the_pose(shared):
    cam, frames = shared
    cam_t = _port_camera(cam)
    x = torch.from_numpy(frames[:3])
    det, stats = build_batched_detect_fn(PORT_CFG, cam_t, "mono8")(x)
    nd, ns = build_batched_detect_fn(PORT_CFG, cam_t, "mono8", with_pose=False)(x)
    for f in ("translation", "quaternion", "rotation"):
        assert torch.equal(getattr(nd, f), torch.zeros_like(getattr(det, f))), f
    for f in dataclasses.fields(det):
        if f.name not in ("translation", "quaternion", "rotation"):
            assert _equal(getattr(nd, f.name), getattr(det, f.name)), f.name
    for f in dataclasses.fields(stats):
        assert _equal(getattr(ns, f.name), getattr(stats, f.name)), f.name


def test_per_camera_intrinsics(per_camera):
    """Each camera's detections are posed with its own K (1 cm); a shared-K
    rig (camera 0's K) misplaces them (more than 3 cm on some camera)."""
    cams, frames, truth = per_camera
    cams_t = [_port_camera(c) for c in cams]
    det, _ = RigDetector(PORT_CFG, cams_t[0], N_CAM, device="cpu", cameras=cams_t).detect(frames)
    for c in range(N_CAM):
        rows = det.frame(c).to_list()
        assert [r["id"] for r in rows] == [5 * c + 2]
        assert np.linalg.norm(np.asarray(rows[0]["translation"]) - truth[c]) < 0.01, c
        gt = project_corners(np.asarray(cams[c].K), upright_pose(truth[c], 0.07 * c), truth[c],
                             TAG_SIZE)
        assert np.abs(np.asarray(rows[0]["corners"]) - gt).max() < 0.7, c
    det0, _ = RigDetector(PORT_CFG, cams_t[0], N_CAM, device="cpu").detect(frames)
    worst = max(np.linalg.norm(np.asarray(det0.frame(c).to_list()[0]["translation"]) - truth[c])
                for c in range(1, N_CAM))
    assert worst > 0.03, worst


def test_rig_camera_count_errors(per_camera):
    cams, frames, _ = per_camera
    cams_t = [_port_camera(c) for c in cams]
    with pytest.raises(ValueError, match="7 cameras for 8-camera rig"):
        JRigDetector(CFG, cams[0], N_CAM, cameras=cams[:7])
    with pytest.raises(ValueError, match="7 cameras for 8-camera rig"):
        RigDetector(PORT_CFG, cams_t[0], N_CAM, device="cpu", cameras=cams_t[:7])
    with pytest.raises(ValueError, match="7 frames for 8-camera rig"):
        RigDetector(PORT_CFG, cams_t[0], N_CAM, device="cpu").detect(frames[:7])


def test_batched_k_pose_matches_vmap(per_camera):
    """estimate_poses with one K per frame, (B, 3, 3) against corners
    (B, T, 4, 2), equals jax.vmap of the reference's on the same inputs; with
    the same K in every frame it equals the single-K call."""
    cams, _, _ = per_camera
    rng = np.random.default_rng(5)
    Ks = np.stack([np.asarray(c.K, np.float32) for c in cams])
    corners = np.empty((N_CAM, 3, 4, 2), np.float32)
    for b in range(N_CAM):
        for i in range(3):
            t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08), rng.uniform(0.6, 1.2)])
            R = upright_pose(t, rng.uniform(-0.5, 0.5))
            corners[b, i] = project_corners(Ks[b], R, t, TAG_SIZE) + rng.normal(0, 0.2, (4, 2))
    want = jax.vmap(lambda c, k: jpose.estimate_poses(c, k, TAG_SIZE))(jnp.asarray(corners),
                                                                       jnp.asarray(Ks))
    got = tpose.estimate_poses(torch.from_numpy(corners), torch.from_numpy(Ks), TAG_SIZE)
    for f in ("translation", "quaternion", "rotation"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    one = tpose.estimate_poses(torch.from_numpy(corners), torch.from_numpy(Ks[0]), TAG_SIZE)
    same = tpose.estimate_poses(torch.from_numpy(corners),
                                torch.from_numpy(np.broadcast_to(Ks[0], Ks.shape).copy()), TAG_SIZE)
    for f in ("translation", "quaternion", "rotation"):
        np.testing.assert_allclose(getattr(same, f).numpy(), getattr(one, f).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_shared_k_rig_matches_batched_and_reference(shared):
    cam, frames = shared
    cam_t = _port_camera(cam)
    det, stats = RigDetector(PORT_CFG, cam_t, N_CAM, device="cpu").detect(frames)
    bdet, bstats = batched_detect_fn(PORT_CFG, cam_t, "mono8")(torch.from_numpy(frames))
    for got, want in ((det, bdet), (stats, bstats)):
        for f in dataclasses.fields(want):
            assert _equal(getattr(got, f.name), getattr(want, f.name)), f.name
    jfn = jax.jit(jbuild_detect_fn(CFG, cam, "mono8"))
    for c in range(N_CAM):
        dj, _ = jfn(jnp.asarray(frames[c]))
        dc = det.frame(c)
        rj = {r["id"]: r for r in dj.to_list()}
        rt = {r["id"]: r for r in dc.to_list()}
        assert sorted(rt) == sorted(rj) == [5 * c + 2]
        for i in rj:
            np.testing.assert_allclose(rt[i]["corners"], rj[i]["corners"], atol=0.1)
            np.testing.assert_allclose(rt[i]["translation"], rj[i]["translation"], atol=0.01)
            np.testing.assert_allclose(rt[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
