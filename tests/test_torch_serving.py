"""The PyTorch port's serving surface on the CPU, held against the JAX
package: TimestampAligner, StreamingRunner / run_stream, the command line
(detect, bench, slam), draw_detections and Detector.detect_checked."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
import isaac_ros_apriltag_tpu.detector as jdetector
from isaac_ros_apriltag_tpu import cli as jcli
from isaac_ros_apriltag_tpu import streaming as jstreaming
from isaac_ros_apriltag_tpu import sync as jsync
from isaac_ros_apriltag_tpu import types as jtypes
from isaac_ros_apriltag_tpu.parallel.slam import map as jmap
from isaac_ros_apriltag_tpu.utils import viz as jviz
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import (CameraModel, Detections, Detector, DetectorConfig,
                                          FrameStats, StreamingRunner, TimestampAligner,
                                          get_family, run_stream)
from isaac_ros_apriltag_tpu_torch import cli
from isaac_ros_apriltag_tpu_torch import detector as tdetector
from isaac_ros_apriltag_tpu_torch.utils.viz import draw_detections

# --- TimestampAligner -----------------------------------------------------------

# (constructor kwargs, pushes (camera, stamp)): the scenarios of tests/test_sync.py.
SYNC_SCENARIOS = {
    "exact_lockstep": (dict(n_cameras=3), [(0, 1.0), (1, 1.0), (2, 1.0), (0, 2.0)]),
    "exact_mismatch": (dict(n_cameras=2), [(0, 1.0), (1, 1.01)]),
    "approximate": (dict(n_cameras=2, tolerance=0.02), [(0, 1.0), (1, 1.012)]),
    "stale_age_out": (dict(n_cameras=2, queue_size=3),
                      [(0, float(k)) for k in range(5)] + [(1, 1.0), (1, 4.0)]),
    "approximate_drift": (dict(n_cameras=3, tolerance=0.005),
                          [(c, 0.1 * k + 0.002 * c) for k in range(4) for c in (2, 0, 1)]),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port's CPU ops here: the suite runs in
    several processes at once, and more threads than cores slow every one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scenario", sorted(SYNC_SCENARIOS))
def test_timestamp_aligner_matches_reference(scenario):
    kw, pushes = SYNC_SCENARIOS[scenario]
    ours, ref = TimestampAligner(**kw), jsync.TimestampAligner(**kw)
    matched = 0
    for k, (cam, stamp) in enumerate(pushes):
        frame = np.full((4, 4), k, np.uint8)
        got, want = ours.push(cam, stamp, frame), ref.push(cam, stamp, frame)
        assert (got is None) == (want is None), k
        if want is not None:
            matched += 1
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert matched == {"exact_lockstep": 1, "exact_mismatch": 0, "approximate": 1,
                       "stale_age_out": 1, "approximate_drift": 4}[scenario]


def test_timestamp_aligner_rejects_bad_config():
    for cls in (TimestampAligner, jsync.TimestampAligner):
        with pytest.raises(ValueError):
            cls(n_cameras=0)
        with pytest.raises(ValueError):
            cls(n_cameras=1, queue_size=0)
        with pytest.raises(ValueError):
            cls(n_cameras=2).push(5, 0.0, np.zeros((4, 4), np.uint8))


# --- StreamingRunner ----------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_streaming_runner_in_order_with_bounded_window(depth):
    """Results in order, equal to the reference runner's; when result k is
    yielded, fn has been called min(k + depth, n) times in both."""
    frames = [np.full((16, 16), i, np.float32) for i in range(7)]

    def trace(fn, calls):
        def wrapped(x):
            calls.append(1)
            return fn(x)
        return wrapped

    ours_calls, ref_calls = [], []
    ours = StreamingRunner(trace(lambda x: x.sum() * 2.0, ours_calls), depth, device="cpu")
    ref = jstreaming.StreamingRunner(trace(jax.jit(lambda x: jnp.sum(x) * 2.0), ref_calls), depth)
    got, want, seen = [], [], []
    for a, b in zip(ours.run(frames), ref.run(frames)):
        got.append(float(a))
        want.append(float(b))
        seen.append((len(ours_calls), len(ref_calls)))
    assert got == want == [float(np.sum(f) * 2.0) for f in frames]
    assert seen == [(min(k + depth, 7),) * 2 for k in range(7)]
    assert run_stream(lambda x: x.sum() * 2.0, frames, depth=depth, device="cpu") == got


def test_streaming_runner_rejects_depth_0():
    for cls in (StreamingRunner, jstreaming.StreamingRunner):
        with pytest.raises(ValueError):
            cls(lambda x: x, depth=0)


def test_streaming_runner_rejects_device_frames():
    with pytest.raises(ValueError, match="host frames"):
        list(StreamingRunner(lambda x: x, 2, device="cpu").run([torch.zeros(4, device="meta")]))


@pytest.fixture(scope="module")
def scene():
    """Tag 7 at 1.1 m on a 640x480 frame, as tests/test_cli.py renders it."""
    t = np.array([0.0, 0.0, 1.1])
    return render_tags(np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]]), (480, 640),
                       [dict(family=J.get_family("tag36h11"), id=7, R=upright_pose(t), t=t,
                             tag_size=0.16)])


def _equal(a, b) -> bool:
    """Exact equality, NaN equal to NaN (masked float lanes may hold NaN)."""
    return torch.equal(a, b) if not a.is_floating_point() else bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _all_equal(x, y):
    for a, b in zip(x, y):
        for f in dataclasses.fields(a):
            assert _equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_detector_through_runner_equals_direct_calls(scene):
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    det = Detector(DetectorConfig(backend="torch", tag_size=0.16), cam, device="cpu")
    rng = np.random.default_rng(0)
    frames = [scene, np.clip(scene + rng.normal(0, 2, scene.shape), 0, 255).astype(np.uint8),
              np.full_like(scene, 140)]
    fn = lambda x: det.detect_with_stats(x, "mono8")      # noqa: E731
    got = run_stream(fn, frames, depth=2, device="cpu")
    assert len(got) == 3
    for g, f in zip(got, frames):
        _all_equal(g, det.detect_with_stats(f, "mono8"))
    assert [r["id"] for r in got[0][0].to_list()] == [7]


# --- command line -------------------------------------------------------------------

CPU = ["--device", "cpu", "--backends", "torch"]
DETECT = ["--size", "0.16", "--fx", "420", "--fy", "420", "--cx", "320", "--cy", "240"]


@pytest.fixture()
def scene_npy(tmp_path, scene):
    p = tmp_path / "scene.npy"
    np.save(p, scene)
    return str(p)


def test_cli_detect_matches_reference(scene_npy, capsys):
    assert cli.main(["detect", "--image", scene_npy, *CPU, *DETECT]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["id"] for r in rows] == [7]
    assert abs(rows[0]["translation"][2] - 1.1) < 0.01
    assert jcli.main(["detect", "--image", scene_npy, "--backends", "xla", *DETECT]) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["id"] for r in want] == [7] and rows[0]["hamming"] == want[0]["hamming"]
    np.testing.assert_allclose(rows[0]["corners"], want[0]["corners"], atol=0.1)
    np.testing.assert_allclose(rows[0]["translation"], want[0]["translation"], atol=0.01)
    np.testing.assert_allclose(rows[0]["quaternion"], want[0]["quaternion"], atol=0.01)


def test_cli_detect_rejects_bad_family(scene_npy):
    with pytest.raises(ValueError):
        cli.main(["detect", "--image", scene_npy, "--tag-family", "tag99h9", *CPU])
    with pytest.raises(ValueError):
        jcli.main(["detect", "--image", scene_npy, "--tag-family", "tag99h9"])


def test_cli_bench_small(capsys):
    assert cli.main(["bench", "--hw", "240,320", "--batch", "2", "--iters", "2", *CPU]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"fps", "detections_per_frame", "backend", "hw"}
    assert res["detections_per_frame"] > 0 and res["fps"] > 0
    assert res["backend"] == "torch" and res["hw"] == [240, 320]


def test_cli_slam_roundtrip(tmp_path, capsys):
    """tests/test_cli.py::test_cli_slam_roundtrip on the port (the jumps
    flow, as the reference runs it with --backends xla); the saved map loads
    in the JAX package's TagMapper."""
    mp = str(tmp_path / "map.npz")
    assert cli.main(["slam", *CPU, "--ccl-flow", "jumps", "--size", "0.16", "--frames", "4",
                     "--tags", "4", "--ba-iters", "4", "--noise", "0.5", "--save-map", mp]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["tags_mapped"] == 4 and res["frames"] == 4
    assert res["ate_rmse_m"] < 0.05
    ref = jmap.TagMapper(K=np.zeros((3, 3)), tag_size=0.0)
    ref.load(mp)
    assert len(ref.lm_ids) == 4 and len(ref.kf_t) == 4 and ref.tag_size == 0.16
    assert int(ref.build_problem().obs_valid.sum()) == len(ref.obs) > 0


# --- draw_detections ----------------------------------------------------------------

def _one_detection():
    """The same detection in both packages' containers."""
    d = Detections.empty(4)
    rows = dict(valid=d.valid.clone(), id=d.id.clone(), center=d.center.clone(),
                corners=d.corners.clone(), translation=d.translation.clone(),
                quaternion=d.quaternion.clone(), rotation=d.rotation.clone())
    rows["valid"][0] = True
    rows["id"][0] = 7
    rows["center"][0] = torch.tensor([32.0, 24.0])
    rows["corners"][0] = torch.tensor([[44.0, 36.0], [20.0, 36.0], [20.0, 12.0], [44.0, 12.0]])
    rows["translation"][0] = torch.tensor([0.01, -0.02, 1.0])
    rows["quaternion"][0] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    rows["rotation"][0] = torch.diag(torch.tensor([-1.0, -1.0, 1.0]))
    ours = dataclasses.replace(d, **rows)
    ref = jtypes.Detections(**{f.name: jnp.asarray(getattr(ours, f.name).numpy())
                               for f in dataclasses.fields(ours)})
    return ours, ref


@pytest.mark.parametrize("case", ["gray", "rgb_axes", "empty"])
def test_draw_detections_matches_reference(case):
    ours, ref = _one_detection()
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    if case == "gray":
        img, kw = np.full((48, 64), 100, np.uint8), {}
    elif case == "rgb_axes":
        img, kw = np.zeros((48, 64, 3), np.uint8), dict(K=K, tag_size=0.2)
    else:
        img, kw = np.zeros((48, 64), np.uint8), dict(K=K, tag_size=0.2)
        ours, ref = Detections.empty(4), jtypes.Detections.empty(4)
    got = draw_detections(img, ours, **kw)
    want = jviz.draw_detections(img, ref, **kw)
    assert got.shape == (48, 64, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert (got != img.reshape(48, 64, -1)).any() == (case != "empty")
    if case == "rgb_axes":
        assert np.array_equal(draw_detections(img, ours, K=torch.from_numpy(K), tag_size=0.2), want)


# --- detect_checked -----------------------------------------------------------------

def test_detect_checked_matches_detect_with_stats(scene):
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    det = Detector(DetectorConfig(backend="torch", tag_size=0.16), cam, device="cpu")
    got = det.detect_checked(scene, "mono8")
    _all_equal(got, det.detect_with_stats(scene, "mono8"))
    assert int(got[1].num_detections) == 1


def _good_result():
    """A result that meets every invariant, as numpy arrays: rows 0 and 1
    valid; invalid rows hold NaN and out-of-range values, which must not
    count."""
    T = 4
    nan = np.float32(np.nan)
    det = dict(valid=np.array([True, True, False, False]),
               id=np.array([3, 5, -1, 10**6], np.int32),
               hamming=np.zeros(T, np.int32),
               decision_margin=np.array([50.0, 40.0, nan, 0.0], np.float32),
               center=np.array([[10, 10], [30, 30], [nan, nan], [0, 0]], np.float32),
               corners=np.tile(np.array([[12, 12], [8, 12], [8, 8], [12, 8]], np.float32),
                               (T, 1, 1)),
               translation=np.array([[0, 0, 1], [0.1, 0, 1], [nan, 0, 0], [0, 0, 0]], np.float32),
               quaternion=np.array([[0, 0, 0, 1], [1, 0, 0, 0], [nan] * 4, [0] * 4], np.float32),
               rotation=np.tile(np.eye(3, dtype=np.float32), (T, 1, 1)))
    det["corners"][3] = nan
    stats = dict(num_edge_points=np.int32(100), num_clusters=np.int32(4), num_quads=np.int32(3),
                 num_detections=np.int32(2), edge_stride=np.int32(1),
                 ccl_converged=np.bool_(True), overflow=np.bool_(False))
    return det, stats


def _doctor(det, stats, case):
    if case == "corners":
        det["corners"][0, 1, 0] = np.nan
    elif case == "centers":
        det["center"][1, 1] = np.inf
    elif case == "translations":
        det["translation"][0, 2] = np.nan
    elif case == "quaternions":
        det["quaternion"][1] = [2.0, 0.0, 0.0, 0.0]
    elif case == "id":
        det["id"][0] = get_family("tag36h11").ncodes
    elif case == "count":
        stats["num_detections"] = np.int32(3)


@pytest.mark.parametrize("case", ["corners", "centers", "translations", "quaternions", "id",
                                  "count"])
def test_detect_checked_raises_reference_message(case, monkeypatch):
    """Each invariant, violated on a valid row of a doctored result, raises
    the reference's message; the undoctored result passes both."""
    cam_j = J.CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    cam_t = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    img = np.zeros((480, 640), np.uint8)
    for doctored in (False, True):
        det, stats = _good_result()
        if doctored:
            _doctor(det, stats, case)
        ours = (Detections(**{k: torch.from_numpy(np.asarray(v)) for k, v in det.items()}),
                FrameStats(**{k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()}))
        ref = (jtypes.Detections(**{k: jnp.asarray(v) for k, v in det.items()}),
               jtypes.FrameStats(**{k: jnp.asarray(v) for k, v in stats.items()}))
        monkeypatch.setattr(tdetector, "build_detect_fn", lambda *a, **k: lambda x: ours)
        monkeypatch.setattr(jdetector, "build_detect_fn", lambda *a, **k: lambda x: ref)
        ours_det = Detector(DetectorConfig(backend="torch"), cam_t, device="cpu")
        ref_det = J.Detector(J.DetectorConfig(backend="xla"), cam_j)
        if not doctored:
            ours_det.detect_checked(img, "mono8")
            ref_det.detect_checked(img, "mono8")
            continue
        with pytest.raises(Exception) as want:
            ref_det.detect_checked(img, "mono8")
        with pytest.raises(RuntimeError) as got:
            ours_det.detect_checked(img, "mono8")
        assert str(got.value) in tdetector.INVARIANTS
        assert str(want.value).startswith(str(got.value)), (str(want.value), str(got.value))
