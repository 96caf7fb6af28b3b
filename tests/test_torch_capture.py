"""capture.GraphedCall, the CUDA graph replay of the detect functions, held
on the CPU through a stand-in for the card (StubCuda): its graph reruns
the captured function on the static input and writes the result into the
static outputs it returned at capture, as a CUDAGraph's replay overwrites
its outputs; its streams and events log what the wrapper asks of them.

The function under capture is the port's batched detector (backend
'torch') on three different 240x320 frames; replayed results must equal
the eager calls bit for bit and, on valid rows, the JAX package's
Detector(backend='interpret') within the float-tail gate (corners 0.1 px,
translation 1 cm, quaternion 0.01; ids and FrameStats counts exact)."""

import dataclasses

import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import RigDetector, batched_detect_fn, build_detect_fn
from isaac_ros_apriltag_tpu_torch import capture
from isaac_ros_apriltag_tpu_torch.capture import GraphedCall
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import build_batched_detect_fn
from isaac_ros_apriltag_tpu_torch.ops.cuda import LAUNCH_COUNTERS, launch_counts, set_launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel

H, W = 240, 320
TAG_SIZE = 0.16
N_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class StubGraph:
    """A CUDAGraph stand-in: replay() reruns fn on the static input, writes
    the result into the outputs of the capture and leaves the launch
    counters as they were (no Python runs in a real replay)."""

    def __init__(self, fn, x, fail_replay=False):
        self.fn, self.x, self.fail_replay = fn, x, fail_replay
        self.out = fn(x)
        self.replays = 0

    def replay(self):
        if self.fail_replay:
            raise RuntimeError("replay failed")
        before = launch_counts()
        for static, new in zip(capture._tensors(self.out), capture._tensors(self.fn(self.x))):
            static.copy_(new)
        set_launch_counts(before)
        self.replays += 1


class StubStream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_event(self, event):
        self.log.append(("wait", self.name, event.stream.name))


class StubEvent:
    stream = None

    def record(self, stream):
        self.stream = stream


class StubCuda:
    """The runtime GraphedCall takes: capture, streams, events, sync."""

    def __init__(self, fail_capture=False, fail_replay=False):
        self.fail_capture, self.fail_replay = fail_capture, fail_replay
        self.log, self.graphs, self.syncs = [], [], 0
        self.stream = StubStream("main", self.log)

    def capture(self, fn, x):
        if self.fail_capture:
            fn(x)
            raise RuntimeError("capture failed")
        g = StubGraph(fn, x, self.fail_replay)
        self.graphs.append(g)
        return g, g.out

    def current_stream(self, device):
        return self.stream

    def event(self):
        return StubEvent()

    def synchronize(self, device):
        self.syncs += 1


def _frame_tags(b):
    fam = J.get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.2 + 0.03 * b, -0.1), (0.2, 0.1 - 0.04 * b)]):
        t = np.array([x, y, 1.0])
        tags.append(dict(family=fam, id=7 * i + 3 + b, R=upright_pose(t, 0.1 * i + 0.05 * b),
                         t=t, tag_size=TAG_SIZE))
    return tags


@pytest.fixture(scope="module")
def scene():
    cam_j = J.CameraModel.create(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=W, height=H)
    cam_t = camera_from_reference(np.asarray(cam_j.K), np.asarray(cam_j.dist), W, H)
    imgs = np.stack([render_tags(np.asarray(cam_j.K), (H, W), _frame_tags(b), noise=2.0, seed=b)
                     for b in range(N_FRAMES)])
    cfg = J.DetectorConfig(backend="interpret", tag_size=TAG_SIZE)
    port_cfg = config_from_reference(dataclasses.asdict(cfg), backend="torch")
    fn = build_batched_detect_fn(port_cfg, cam_t, "mono8", capture=False)
    eager = [fn(torch.from_numpy(imgs[b:b + 1])) for b in range(N_FRAMES)]
    return dict(cam_j=cam_j, cam_t=cam_t, cfg=cfg, port_cfg=port_cfg, imgs=imgs, fn=fn,
                eager=eager)


def _frames(scene, *idx):
    """Frames idx of the scene as one (len(idx), H, W) uint8 tensor."""
    return torch.from_numpy(scene["imgs"][list(idx)])


def _leaves(result):
    return capture._tensors(result)


def _assert_identical(a, b):
    """Every tensor equal, dtype and shape too; NaN == NaN (masked float
    lanes may hold NaN)."""
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() else x == y
        assert bool(same.all())


def _storages(result):
    return {t.untyped_storage().data_ptr() for t in _leaves(result)}


def test_replays_return_fresh_results(scene):
    """Frames 0, 1, 2, then 0 again: an eager call, then one capture and
    three replays, each result the eager call's bit for bit and in storage
    of its own."""
    rt = StubCuda()
    fn = GraphedCall(scene["fn"], runtime=rt)
    order = (0, 1, 2, 0)
    outs = [fn(_frames(scene, b)) for b in order]
    assert len(rt.graphs) == 1 and rt.graphs[0].replays == 3
    static = _storages(rt.graphs[0].out)
    seen = set()
    for b, out in zip(order, outs):
        _assert_identical(out, scene["eager"][b])
        assert not _storages(out) & (seen | static)
        seen |= _storages(out)


def test_replays_match_reference(scene):
    """Replayed results against the JAX package's Detector, frame by frame."""
    det_j = J.Detector(scene["cfg"], scene["cam_j"])
    fn = GraphedCall(scene["fn"], runtime=StubCuda())
    outs = [fn(_frames(scene, b)) for b in (0, 1, 2)]
    for b, (det, stats) in enumerate(outs):
        dj, sj = det_j.detect_with_stats(scene["imgs"][b], encoding="mono8")
        rj = {r["id"]: r for r in dj.to_list()}
        rt = {r["id"]: r for r in det.frame(0).to_list()}
        assert sorted(rj) == sorted(rt) == sorted(t["id"] for t in _frame_tags(b))
        for i in rj:
            np.testing.assert_allclose(rt[i]["corners"], rj[i]["corners"], atol=0.1)
            np.testing.assert_allclose(rt[i]["translation"], rj[i]["translation"], atol=0.01)
            np.testing.assert_allclose(rt[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
            assert rt[i]["hamming"] == rj[i]["hamming"]
        for f in ("num_edge_points", "num_clusters", "num_detections", "edge_stride",
                  "ccl_converged"):
            assert int(getattr(sj, f)) == int(getattr(stats, f)[0]), f


def test_one_call_of_a_shape_captures_nothing(scene):
    """A shape called once runs eagerly: no graph, no sync, no stream work;
    the result is the eager call's."""
    rt = StubCuda()
    fn = GraphedCall(scene["fn"], runtime=rt)
    out = fn(_frames(scene, 1))
    assert not rt.graphs and not fn.graphs and rt.syncs == 0 and rt.log == []
    _assert_identical(out, scene["eager"][1])


def test_second_shape_captures_second_graph(scene):
    rt = StubCuda()
    fn = GraphedCall(scene["fn"], runtime=rt)
    one, pair = fn(_frames(scene, 0)), fn(_frames(scene, 1, 2))
    assert not rt.graphs
    again, pair2 = fn(_frames(scene, 2)), fn(_frames(scene, 0, 1))
    assert len(rt.graphs) == 2 and list(fn.graphs) == [
        ((1, H, W), torch.uint8, torch.device("cpu")), ((2, H, W), torch.uint8, torch.device("cpu"))]
    last, pair3 = fn(_frames(scene, 1)), fn(_frames(scene, 2, 1))
    assert [g.replays for g in rt.graphs] == [2, 2]
    _assert_identical(one, scene["eager"][0])
    _assert_identical(again, scene["eager"][2])
    _assert_identical(last, scene["eager"][1])
    _assert_identical(pair, scene["fn"](_frames(scene, 1, 2)))
    _assert_identical(pair2, scene["fn"](_frames(scene, 0, 1)))
    _assert_identical(pair3, scene["fn"](_frames(scene, 2, 1)))


def test_non_contiguous_input_is_copied_in(scene):
    """A (2, H, W) view with swapped strides, at capture and at replay."""
    rt = StubCuda()
    fn = GraphedCall(scene["fn"], runtime=rt)

    def strided(*idx):
        x = _frames(scene, *idx).transpose(0, 1).contiguous().transpose(0, 1)
        assert not x.is_contiguous()
        return x

    first, second, third = fn(strided(0, 1)), fn(strided(2, 0)), fn(strided(1, 2))
    assert rt.graphs[0].x.is_contiguous() and rt.graphs[0].replays == 2
    _assert_identical(first, scene["fn"](_frames(scene, 0, 1)))
    _assert_identical(second, scene["fn"](_frames(scene, 2, 0)))
    _assert_identical(third, scene["fn"](_frames(scene, 1, 2)))


def _scaled(x):
    """A cheap function of one tensor, for the wrapper's bookkeeping."""
    return (x * 2, (x.sum(-1),))


def test_least_recently_used_graph_is_dropped():
    rt = StubCuda()
    fn = GraphedCall(_scaled, runtime=rt)
    n = capture.MAX_GRAPHS
    xs = [torch.ones(k + 1, 3) for k in range(n + 2)]
    for x in xs[:n] * 2:                     # each shape: an eager call, then a capture
        fn(x)
    fn(xs[0])                                # xs[0] is now the most recently used
    assert len(rt.graphs) == n and rt.syncs == 0
    fn(xs[n])                                # called once: eager, nothing dropped
    assert len(rt.graphs) == n and rt.syncs == 0
    fn(xs[n])                                # drops xs[1]'s graph, after a device sync
    assert [k[0][0] for k in fn.graphs] == [*range(3, n + 1), 1, n + 1] and rt.syncs == 1
    fn(xs[0])
    assert len(rt.graphs) == n + 1 and rt.graphs[0].replays == 3
    out = fn(xs[1])                          # dropped: eager, as a shape never seen
    assert len(rt.graphs) == n + 1 and rt.syncs == 1
    assert torch.equal(out[0], xs[1] * 2)
    out = fn(xs[1])                          # captured anew; drops xs[2]'s
    assert len(rt.graphs) == n + 2 and rt.syncs == 2
    assert [k[0][0] for k in fn.graphs] == [*range(4, n + 2), 1, 2]
    assert torch.equal(out[0], xs[1] * 2)
    assert torch.equal(fn(xs[1] * 3)[1][0], (xs[1] * 3).sum(-1))


def test_shapes_called_once_are_forgotten_oldest_first():
    """The last MAX_GRAPHS shapes called once are remembered: a shape pushed
    out of that list runs eagerly again at its next call."""
    rt = StubCuda()
    fn = GraphedCall(_scaled, runtime=rt)
    n = capture.MAX_GRAPHS
    xs = [torch.ones(k + 1, 3) for k in range(n + 1)]
    for x in xs:
        fn(x)
    assert [k[0][0] for k in fn.once] == list(range(2, n + 2)) and not rt.graphs
    fn(xs[0])                                # forgotten: eager again
    assert not rt.graphs
    fn(xs[n])                                # remembered: captured
    assert len(rt.graphs) == 1 and (n + 1, 3) not in [k[0] for k in fn.once]


def test_capture_error_reaches_caller(monkeypatch):
    for module, name in LAUNCH_COUNTERS.values():
        monkeypatch.setattr(module, name, 0)

    def launching(x):
        thr_kernel.launches += 1
        return _scaled(x)

    fn = GraphedCall(launching, runtime=StubCuda(fail_capture=True))
    fn(torch.ones(2, 2))
    with pytest.raises(RuntimeError, match="capture failed"):
        fn(torch.ones(2, 2))
    assert not fn.graphs
    # The eager call counts its launch; the failed capture's is taken back.
    assert launch_counts() == {**{k: 0 for k in LAUNCH_COUNTERS}, "threshold": 1}


def test_replay_error_reaches_caller():
    fn = GraphedCall(_scaled, runtime=StubCuda(fail_replay=True))
    fn(torch.ones(2, 2))
    with pytest.raises(RuntimeError, match="replay failed"):
        fn(torch.ones(2, 2))


def test_replays_count_the_captured_launches(monkeypatch):
    """An eager call and a replay each add 1 / 14 / 14 and one launch of
    each cluster kernel; a capture adds none."""
    for module, name in LAUNCH_COUNTERS.values():
        monkeypatch.setattr(module, name, 0)
    per_call = {**{k: 1 for k in LAUNCH_COUNTERS}, "row": 14, "col": 14}

    def launching(x):
        for k, (module, name) in LAUNCH_COUNTERS.items():
            setattr(module, name, getattr(module, name) + per_call[k])
        return _scaled(x)

    rt = StubCuda()
    fn = GraphedCall(launching, runtime=rt)
    fn(torch.ones(2, 2))
    assert launch_counts() == per_call and not rt.graphs
    fn(torch.zeros(2, 2))                      # the capture, then its first replay
    assert launch_counts() == {k: 2 * n for k, n in per_call.items()} and len(rt.graphs) == 1
    fn(torch.ones(2, 2))
    assert launch_counts() == {k: 3 * n for k, n in per_call.items()}
    assert rt.graphs[0].replays == 2


def test_other_stream_waits_on_the_last_replay():
    rt = StubCuda()
    fn = GraphedCall(_scaled, runtime=rt)
    x = torch.ones(2, 2)
    fn(x), fn(x)                               # capture, then a replay on "main"
    assert rt.log == []
    rt.stream = StubStream("side", rt.log)
    fn(x), fn(x)
    assert rt.log == [("wait", "side", "main")]
    rt.stream = StubStream("third", rt.log)
    fn(torch.ones(3, 3))                       # a new signature: eager, no wait
    fn(x)
    assert rt.log == [("wait", "side", "main"), ("wait", "third", "side")]


def test_cpu_builders_capture_nothing(scene):
    """On a CPU device the builders return the eager function, with or
    without capture, and it gives what capture=False gives."""
    cfg, cam = scene["port_cfg"], scene["cam_t"]
    x = _frames(scene, 1)
    for fn in (build_batched_detect_fn(cfg, cam, "mono8"), batched_detect_fn(cfg, cam),
               batched_detect_fn(cfg, cam, capture=False)):
        assert not isinstance(fn, GraphedCall)
        _assert_identical(fn(x), scene["eager"][1])
    one = build_detect_fn(cfg, cam, "mono8")
    _assert_identical(one(x[0]), [t[0] for t in _leaves(scene["eager"][1])])
    rig = RigDetector(cfg, cam, 2, device="cpu")
    assert not isinstance(rig._fn, GraphedCall)
