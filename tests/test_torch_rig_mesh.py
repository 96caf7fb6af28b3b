"""The rig split over a process group on the CPU: four processes joined by
gloo on loopback (parallel/mesh.py) against the one-device port rig and JAX's
mesh rig, at 320x240 with 8 cameras (tests/test_rig.py's scenes and seeds).

On a (4, 1) mesh each rank detects 2 cameras, on the two 'cam' groups of a
(2, 2) mesh 4; every rank must return the whole rig in camera order, equal
to the one-device rig (integers exact, floats on valid rows within 1e-4 px
and 1e-5), and on the jumps flow (the reference's backend 'xla') to JAX's
RigDetector on a 4-device mesh within the float-tail gates. A fifth process
holds a world of one against no group. The children are plain scripts run
by subprocess, all at once, and the whole run is bounded, so a hung
collective fails the test. initialize_multihost's choice of card under NCCL
is held with fakes, so that it runs without a card."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu_torch import (CameraModel, Detections, DetectorConfig, FrameStats,
                                          RigDetector)
from isaac_ros_apriltag_tpu_torch.convert import config_from_reference
from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
N_CAM = 8
TAG_SIZE = 0.16
TIMEOUT_S = 100
CONFIGS = {flow: DetectorConfig(tag_size=TAG_SIZE, max_tags=8, max_clusters=16, backend="torch",
                                ccl_flow=flow) for flow in ("scan", "jumps")}
# The shared-K rig, the per-camera-K rig, and the per-camera frames posed
# with camera 0's K alone.
RIGS = ("shared", "per_camera", "per_camera_shared_k")
MESHES = {"4x1": (WORLD, 1), "2x2": (2, 2)}
FIELDS = [f.name for f in dataclasses.fields(Detections) + dataclasses.fields(FrameStats)]

_CHILD = """
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from isaac_ros_apriltag_tpu_torch import make_mesh
from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh
from test_torch_rig_mesh import MESHES, WORLD, make_rig, run_rigs

torch.set_num_threads(1)

addr, rank, world, scenes, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                  sys.argv[5])
pmesh.initialize_multihost(addr, world, rank, backend="gloo")
try:
    with np.load(scenes) as z:
        z = dict(z)
    saved = {{}}
    if world == 1:
        group = make_mesh(1, 1).get_group("cam")
        saved.update(run_rigs(z, group, "group"))
        saved.update(run_rigs(z, None, "none"))
    else:
        groups = {{name: make_mesh(*shape).get_group("cam") for name, shape in MESHES.items()}}
        for name, group in groups.items():
            saved.update(run_rigs(z, group, name))
        try:
            make_rig(z, "scan", "shared", groups["4x1"], n_cameras=6)
        except ValueError as e:
            saved["six_cameras_error"] = np.array(str(e))
    np.savez(out, **saved)
finally:
    dist.destroy_process_group()
"""


def scenes() -> dict:
    """tests/test_rig.py's two rigs, as numpy: the shared-K frames (noise 1,
    seed c) and K, the per-camera frames (seed c), each camera's K and its
    tag's true translation, rendered by the JAX package. The JAX package is
    imported here and not at the top, so that the children never load it."""
    import isaac_ros_apriltag_tpu as J
    from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose

    fam = J.get_family("tag36h11")

    def tag(c, t):
        return dict(family=fam, id=5 * c + 2, R=upright_pose(t, 0.07 * c), t=t, tag_size=TAG_SIZE)

    K = np.asarray(J.CameraModel.create(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320,
                                        height=240).K)
    shared = [render_tags(K, (240, 320), [tag(c, np.array([0.05 * (c % 3 - 1),
                                                           0.04 * (c // 3 - 1), 0.8]))],
                          noise=1.0, seed=c) for c in range(N_CAM)]
    Ks, frames, truth = [], [], []
    for c in range(N_CAM):
        f = 180.0 + 12.0 * c
        Kc = np.asarray(J.CameraModel.create(fx=f, fy=f, cx=160.0 + 2.0 * c, cy=120.0 - 1.5 * c,
                                             width=320, height=240).K)
        t = np.array([0.03 * (c % 3 - 1), 0.02 * (c // 3 - 1), 0.8])
        frames.append(render_tags(Kc, (240, 320), [tag(c, t)], seed=c))
        Ks.append(Kc)
        truth.append(t)
    return dict(shared=np.stack(shared), shared_K=K, per_camera=np.stack(frames),
                per_camera_K=np.stack(Ks), truth=np.stack(truth))


def _camera(K) -> CameraModel:
    return CameraModel.create(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                              cy=float(K[1, 2]), width=320, height=240)


def make_rig(z: dict, flow: str, rig: str, group, n_cameras: int = N_CAM) -> RigDetector:
    """The port's rig `rig` of RIGS on the CPU, over `group` (or none)."""
    cfg = CONFIGS[flow]
    if rig == "shared":
        return RigDetector(cfg, _camera(z["shared_K"]), n_cameras, "cpu", group=group)
    cams = [_camera(K) for K in z["per_camera_K"]]
    if rig == "per_camera_shared_k":
        return RigDetector(cfg, cams[0], n_cameras, "cpu", group=group)
    return RigDetector(cfg, cams[0], n_cameras, "cpu", cameras=cams, group=group)


def _frames(z: dict, rig: str) -> np.ndarray:
    return z["shared"] if rig == "shared" else z["per_camera"]


def run_rigs(z: dict, group, name: str) -> dict:
    """Every flow and rig over `group`: {name/flow/rig/field: array}, and
    {name/flow/rig/seen: the frame shapes the rig's detect function got}."""
    out = {}
    for flow in CONFIGS:
        for rig in RIGS:
            r = make_rig(z, flow, rig, group)
            seen, fn = [], r._fn
            r._fn = lambda x, fn=fn, seen=seen: (seen.append(tuple(x.shape)), fn(x))[1]
            for part in r.detect(_frames(z, rig)):
                for f in dataclasses.fields(part):
                    out[f"{name}/{flow}/{rig}/{f.name}"] = getattr(part, f.name).numpy()
            out[f"{name}/{flow}/{rig}/seen"] = np.array(seen)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def scene_arrays():
    return scenes()


@pytest.fixture(scope="module")
def ranks(scene_arrays, tmp_path_factory):
    """Run the four ranks and the world of one, all at once; the four ranks'
    saved outputs in rank order, then the world of one's."""
    tmp = tmp_path_factory.mktemp("rig_mesh")
    np.savez(tmp / "scenes.npz", **scene_arrays)
    script = tmp / "child.py"
    script.write_text(_CHILD.format(root=ROOT, tests=os.path.join(ROOT, "tests")))
    addr, solo = f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"
    runs = [(addr, r, WORLD) for r in range(WORLD)] + [(solo, 0, 1)]
    outs = [tmp / f"run{i}.npz" for i in range(len(runs))]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), a, str(r), str(w),
                               str(tmp / "scenes.npz"), str(o)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for (a, r, w), o in zip(runs, outs)]
    errors = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"run {runs[i]} exited {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def one_device(scene_arrays):
    """The one-device port rig of each flow and rig: {flow/rig/field: array}."""
    return {k.split("/", 1)[1]: v for k, v in run_rigs(scene_arrays, None, "one").items()}


def _assert_close_to(got: dict, want: dict, key: str, what: str) -> None:
    """Detections and FrameStats under `key` equal: integers and bools
    exact, floats on valid rows within 1e-4 (px, m; 1e-5 for the unit
    quaternion and rotation)."""
    valid = want[f"{key}/valid"]
    np.testing.assert_array_equal(got[f"{key}/valid"], valid, err_msg=what)
    for name in FIELDS:
        a, b = got[f"{key}/{name}"], want[f"{key}/{name}"]
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name, a.shape, b.shape)
        if a.dtype.kind == "f":
            tol = 1e-5 if name in ("quaternion", "rotation") else 1e-4
            np.testing.assert_allclose(a[valid], b[valid], rtol=0, atol=tol, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def test_jumps_config_is_the_references_xla():
    import isaac_ros_apriltag_tpu as J

    ref = J.DetectorConfig(tag_size=TAG_SIZE, backend="xla", max_tags=8, max_clusters=16)
    assert config_from_reference(dataclasses.asdict(ref), backend="torch") == CONFIGS["jumps"]


@pytest.mark.parametrize("rig", RIGS)
@pytest.mark.parametrize("flow", CONFIGS)
def test_4x1_mesh_ranks_equal_one_device_rig(ranks, one_device, flow, rig):
    """Every rank of the (4, 1) mesh holds the whole rig, 2 cameras detected
    on each, equal to the one-device rig."""
    for r, out in enumerate(ranks[:WORLD]):
        _assert_close_to({k[4:]: v for k, v in out.items() if k.startswith("4x1/")}, one_device,
                         f"{flow}/{rig}", f"rank {r}")


@pytest.mark.parametrize("rig", RIGS)
@pytest.mark.parametrize("flow", CONFIGS)
def test_2x2_mesh_cam_groups_equal_4x1(ranks, flow, rig):
    """The (2, 2) mesh's 'cam' groups are ranks {0, 2} and {1, 3}: global
    rank 3 is rank 1 of its group and must take cameras 4-7. Both groups give
    the whole rig, equal to the (4, 1) mesh's."""
    want = {k[4:]: v for k, v in ranks[0].items() if k.startswith("4x1/")}
    for r, out in enumerate(ranks[:WORLD]):
        _assert_close_to({k[4:]: v for k, v in out.items() if k.startswith("2x2/")}, want,
                         f"{flow}/{rig}", f"rank {r} of the 2x2 mesh")


@pytest.mark.parametrize("rig", ("shared", "per_camera"))
def test_4x1_mesh_matches_jax_mesh_rig(ranks, scene_arrays, rig):
    """JAX's RigDetector on a 4-device 'cam' mesh, backend 'xla' (the port's
    jumps flow): ids equal; on valid rows corners within 0.1 px, translation
    within 1 cm and quaternion within 0.01."""
    import jax
    from jax.sharding import Mesh

    import isaac_ros_apriltag_tpu as J
    from isaac_ros_apriltag_tpu.parallel.rig import RigDetector as JRigDetector

    cfg = J.DetectorConfig(tag_size=TAG_SIZE, backend="xla", max_tags=8, max_clusters=16)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("cam",))
    if rig == "shared":
        jrig = JRigDetector(cfg, J.CameraModel.create(fx=210.0, fy=210.0, cx=160.0, cy=120.0,
                                                      width=320, height=240), N_CAM, mesh=mesh)
    else:
        cams = [J.CameraModel.create(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                                     cy=float(K[1, 2]), width=320, height=240)
                for K in scene_arrays["per_camera_K"]]
        jrig = JRigDetector(cfg, cams[0], N_CAM, mesh=mesh, cameras=cams)
    det, _ = jrig.detect(_frames(scene_arrays, rig))
    valid = np.asarray(det.valid)
    assert valid.sum(1).tolist() == [1] * N_CAM
    for r, out in enumerate(ranks[:WORLD]):
        key = f"4x1/jumps/{rig}"
        np.testing.assert_array_equal(out[f"{key}/valid"], valid, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{key}/id"][valid], np.asarray(det.id)[valid])
        for name, tol in (("corners", 0.1), ("translation", 0.01), ("quaternion", 0.01)):
            np.testing.assert_allclose(out[f"{key}/{name}"][valid],
                                       np.asarray(getattr(det, name))[valid], rtol=0, atol=tol,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("flow", CONFIGS)
def test_4x1_mesh_poses_each_camera_with_its_own_k(ranks, scene_arrays, flow):
    """tests/test_rig.py::test_rig_per_camera_intrinsics on every rank: one
    detection a camera with its id, within 1 cm of the truth; camera 0's K
    on every camera misplaces some tag by more than 3 cm."""
    truth = scene_arrays["truth"]
    for out in ranks[:WORLD]:
        key = f"4x1/{flow}/per_camera"
        valid, ids, t = out[f"{key}/valid"], out[f"{key}/id"], out[f"{key}/translation"]
        for c in range(N_CAM):
            rows = np.nonzero(valid[c])[0]
            assert len(rows) == 1 and ids[c, rows[0]] == 5 * c + 2, c
            assert np.linalg.norm(t[c, rows[0]] - truth[c]) < 0.01, c
        key = f"4x1/{flow}/per_camera_shared_k"
        v0, t0 = out[f"{key}/valid"], out[f"{key}/translation"]
        worst = max(np.linalg.norm(t0[c][v0[c]][0] - truth[c]) for c in range(1, N_CAM))
        assert worst > 0.03, worst


def test_ranks_detect_only_their_cameras(ranks):
    """No camera's work is repeated: each rank's detect function got its own
    n / size cameras, once a detect call (the counterpart of
    tests/test_rig.py::test_rig_throughput_constancy)."""
    for out in ranks[:WORLD]:
        for flow in CONFIGS:
            for rig in RIGS:
                assert out[f"4x1/{flow}/{rig}/seen"].tolist() == [[2, 240, 320]]
                assert out[f"2x2/{flow}/{rig}/seen"].tolist() == [[4, 240, 320]]
    for flow in CONFIGS:
        assert ranks[WORLD][f"group/{flow}/shared/seen"].tolist() == [[N_CAM, 240, 320]]


def test_camera_count_the_group_does_not_divide_raises(ranks):
    for out in ranks[:WORLD]:
        assert str(out["six_cameras_error"]) == ("a 6-camera rig does not split over the 4 ranks "
                                                 "of the group")


@pytest.mark.parametrize("rig", RIGS)
@pytest.mark.parametrize("flow", CONFIGS)
def test_world_of_one_equals_no_group(ranks, flow, rig):
    """A group of one rank gives the rig without a group, bit for bit."""
    out = ranks[WORLD]
    for name in FIELDS:
        a, b = out[f"group/{flow}/{rig}/{name}"], out[f"none/{flow}/{rig}/{name}"]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


class _FakeHost:
    """torch.cuda.device_count, torch.cuda.set_device and
    dist.init_process_group of a host with `cards` cards, recording calls."""

    def __init__(self, monkeypatch, cards: int):
        self.selected, self.init = [], []
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "set_device", self.selected.append)
        monkeypatch.setattr(pmesh.dist, "init_process_group",
                            lambda *a, **k: self.init.append((a, k)))


def test_initialize_multihost_nccl_selects_the_local_card(monkeypatch):
    """Process 5 of a group on 4-card hosts takes card 5 % 4 = 1 and binds
    the communicator to it."""
    host = _FakeHost(monkeypatch, 4)
    pmesh.initialize_multihost("127.0.0.1:29500", 8, 5, backend="nccl")
    assert host.selected == [torch.device("cuda", 1)]
    (args, kwargs), = host.init
    assert args == ("nccl",) and kwargs == dict(init_method="tcp://127.0.0.1:29500", world_size=8,
                                                rank=5, device_id=torch.device("cuda", 1))


def test_initialize_multihost_gloo_selects_no_card(monkeypatch):
    host = _FakeHost(monkeypatch, 4)
    pmesh.initialize_multihost("127.0.0.1:29500", 8, 5, backend="gloo")
    assert host.selected == []
    (args, kwargs), = host.init
    assert args == ("gloo",) and kwargs == dict(init_method="tcp://127.0.0.1:29500", world_size=8,
                                                rank=5)
