"""Tests of the PyTorch port that need a CUDA device: each hand-written
kernel against its plain twin, bit for bit, on one frame and on a batch of
different frames (where it must also equal itself run on each frame alone),
the two backends against each other end to end: one frame, a batch, and
the rectify -> resize -> detect graph; and the serving layer on the card:
the streaming runner's upload ring against a slow reader, the rig's launch
counts, no host sync on the detect path, and detect_checked; the captured
detect call (CUDA graph replay) against the eager call; the CCL flow
with pointer jumps, bundle adjustment of a 10k-tag map against the CPU, and
the rig over a world of one NCCL process. They skip without a card.

The adversarial inputs of the threshold and scan kernels are chip_smoke.py's,
so the smoke run and these tests hold the kernels to the same cases. This file imports
neither jax nor the JAX package, so it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (CAPTURE_CASES, CLUSTER_CASE_NAMES, CLUSTER_KERNELS, LONG_SHAPES,
                        SCAN_CASES, THRESH_CASES, THRESH_MIN_DIFF, bench_inputs,
                        check_cluster_case, cluster_cases, edge_batch, free_port, map_problem,
                        scan_batch, scan_case, scan_case_id, thresh_case_id, thresh_input)
from isaac_ros_apriltag_tpu_torch import (CameraModel, Detector, DetectorConfig, GraphPipeline,
                                          RigDetector, SpatialDetector, StreamingRunner,
                                          batched_detect_fn, build_spatial_front_fn,
                                          connected_components, get_family,
                                          make_distributed_solver, partition_problem, run_stream)
from isaac_ros_apriltag_tpu_torch.parallel.slam import ba
from isaac_ros_apriltag_tpu_torch import detector as tdetector
from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl, launch_counts, set_launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cluster_kernels
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import distort_image, render_tags, upright_pose

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("ts", thr_kernel.TILE_SIZES)
@pytest.mark.parametrize("shape", [(544, 960), (64, 2048), (32, 32)])
def test_threshold_kernel_bit_exact(cuda, ts, shape):
    rng = np.random.default_rng(3)
    g = rng.uniform(0, 255, shape).astype(np.float32)
    g[:16, :16] = 100.0
    g = torch.from_numpy(g).to(cuda)
    assert torch.equal(thr_kernel.adaptive_threshold(g, ts, 5), adaptive_threshold(g, ts, 5))


@pytest.mark.parametrize("case", THRESH_CASES, ids=thresh_case_id)
def test_threshold_kernel_cases(cuda, case):
    """chip_smoke's threshold cases; offsets off 16 bytes and W = 2 mod 4
    take the kernel's scalar path, the others its vector path."""
    ts, shape, _, offset = case
    g = thresh_input(case, cuda)
    assert (g.data_ptr() % 16 == 0) == (offset % 4 == 0)
    out = thr_kernel.adaptive_threshold(g, ts, THRESH_MIN_DIFF)
    assert torch.equal(out, adaptive_threshold(g, ts, THRESH_MIN_DIFF))
    for b in range(shape[0] if len(shape) == 3 else 0):
        assert torch.equal(out[b], thr_kernel.adaptive_threshold(g[b], ts, THRESH_MIN_DIFF))


_RANDOM_SCANS = tuple((shape, "random", "perm")
                      for shape in [(540, 960), (37, 2047), (300, 1), (1, 4096), (4096, 3),
                                    (1, 4097), (7, 12345), (12345, 7)])


@pytest.mark.parametrize("case", _RANDOM_SCANS + SCAN_CASES, ids=scan_case_id)
def test_scan_kernels_bit_exact(cuda, case):
    """Random lines, and chip_smoke's lines built to break a chunked scan,
    rows and columns past 4096 pixels among them."""
    tri, lab = (torch.from_numpy(a).to(cuda) for a in scan_case(*case))
    assert torch.equal(ccl.row_scan(tri, lab), ccl.row_scan_plain(tri, lab))
    assert torch.equal(ccl.col_diag_scan(tri, lab), ccl.col_diag_scan_plain(tri, lab))
    a = ccl.ccl_scan(tri, 8, backend="cuda")
    b = ccl.ccl_scan(tri, 8, backend="torch")
    assert torch.equal(a[0], b[0]) and bool(a[1]) == bool(b[1])


@pytest.mark.parametrize("shape", LONG_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fill,labels", [("random", "perm"), ("all255", "desc"),
                                         ("stripes32", "desc"), ("lone127", "top")])
def test_scan_kernels_long_lines_batched(cuda, shape, fill, labels):
    """Lines past 4096 pixels at batch 3 of different frames: bit-exact with
    the twins and with each frame alone."""
    tri, lab = (torch.from_numpy(a).to(cuda) for a in scan_batch(shape, fill, labels))
    for kern, twin in ((ccl.row_scan, ccl.row_scan_plain),
                       (ccl.col_diag_scan, ccl.col_diag_scan_plain)):
        out = kern(tri, lab)
        assert torch.equal(out, twin(tri, lab))
        for b in range(3):
            assert torch.equal(out[b], kern(tri[b].contiguous(), lab[b].contiguous()))


@pytest.mark.parametrize("shape", [(2, 3, 5000), (1, 5000, 40)])
def test_ccl_scan_long_lines(cuda, shape):
    """The op: 8 rounds on a noisy trinary with lines past 4096 pixels give the
    twins' labels and flags."""
    rng = np.random.default_rng(5)
    tri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                                      p=[0.3, 0.2, 0.5])).to(cuda)
    a, ca = ccl.ccl_scan(tri, 8, backend="cuda")
    b, cb = ccl.ccl_scan(tri, 8, backend="torch")
    assert torch.equal(a, b) and torch.equal(ca, cb)


def test_wrappers_check_arguments(cuda):
    """Wrong shapes and types raise; no line length does."""
    g = torch.zeros((30, 30), device=cuda)
    with pytest.raises(ValueError):
        thr_kernel.adaptive_threshold(g, 4, 5)            # 30 is not a multiple of 4
    with pytest.raises(ValueError):
        thr_kernel.adaptive_threshold(g.double(), 2, 5)
    tri = torch.zeros((8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        ccl.row_scan(tri, torch.zeros((8, 8), dtype=torch.int64, device=cuda))
    for shape in ((2, 5000), (5000, 2)):
        tri = torch.zeros(shape, dtype=torch.uint8, device=cuda)
        lab = torch.arange(10000, dtype=torch.int32, device=cuda).reshape(shape)
        assert torch.equal(ccl.row_scan(tri, lab), ccl.row_scan_plain(tri, lab))
        assert torch.equal(ccl.col_diag_scan(tri, lab), ccl.col_diag_scan_plain(tri, lab))


def test_detector_turns_tf32_off(cuda):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    Detector(DetectorConfig(backend="torch"), cam, device=cuda)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _tags(shift=0, z=1.1):
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18)]):
        t = np.array([x, y, z])
        tags.append(dict(family=fam, id=5 * i + 2 + shift, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    return tags


def _assert_same(x, y):
    """Every field of two (Detections, FrameStats) pairs equal, NaN == NaN."""
    for a, b in [(getattr(x[i], f.name), getattr(y[i], f.name))
                 for i in range(2) for f in dataclasses.fields(x[i])]:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        assert bool(same.all())


def test_backends_identical_end_to_end(cuda):
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    img = torch.from_numpy(render_tags(cam.K.numpy(), (480, 640), _tags(), noise=2.0)).to(cuda)
    cfg = DetectorConfig(tag_size=0.16)
    dc, sc = Detector(cfg, cam, device=cuda).detect_with_stats(img, "mono8")
    dt, st = Detector(dataclasses.replace(cfg, backend="torch"), cam,
                      device=cuda).detect_with_stats(img, "mono8")
    assert sorted(r["id"] for r in dc.to_list()) == [2, 7, 12]
    _assert_same((dc, sc), (dt, st))


def _batch3(seed=0):
    """Three frames that differ: other contents, other labels."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, (3, 136, 200)).astype(np.float32)
    g[1] = 90.0 + 0.01 * g[1]
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=(3, 137, 203), p=[0.3, 0.2, 0.5])
    lab = np.stack([rng.permutation(137 * 203).astype(np.int32).reshape(137, 203)
                    for _ in range(3)])
    return g, tri, lab


@pytest.mark.parametrize("ts", thr_kernel.TILE_SIZES[:3])
def test_batched_threshold_kernel_bit_exact(cuda, ts):
    g = torch.from_numpy(_batch3()[0]).to(cuda)
    out = thr_kernel.adaptive_threshold(g, ts, 5)
    assert torch.equal(out, adaptive_threshold(g, ts, 5))
    for b in range(3):
        assert torch.equal(out[b], thr_kernel.adaptive_threshold(g[b].contiguous(), ts, 5))


def test_batched_scan_kernels_bit_exact(cuda):
    _, tri, lab = _batch3(1)
    tri, lab = torch.from_numpy(tri).to(cuda), torch.from_numpy(lab).to(cuda)
    for kern, twin in ((ccl.row_scan, ccl.row_scan_plain),
                       (ccl.col_diag_scan, ccl.col_diag_scan_plain)):
        out = kern(tri, lab)
        assert torch.equal(out, twin(tri, lab))
        for b in range(3):
            assert torch.equal(out[b], kern(tri[b].contiguous(), lab[b].contiguous()))
    a, ca = ccl.ccl_scan(tri, 8, backend="cuda")
    t, ct = ccl.ccl_scan(tri, 8, backend="torch")
    assert torch.equal(a, t) and torch.equal(ca, ct) and ca.shape == (3,)
    for b in range(3):
        assert torch.equal(a[b], ccl.ccl_scan(tri[b], 8, backend="cuda")[0])


@pytest.mark.parametrize("shape", [(1, 33), (33, 31), (540, 960)])
def test_scan_kernels_frames_differ_in_edge_rows(cuda, shape):
    tri, lab = (torch.from_numpy(a).to(cuda) for a in edge_batch(*shape))
    for kern, twin in ((ccl.row_scan, ccl.row_scan_plain),
                       (ccl.col_diag_scan, ccl.col_diag_scan_plain)):
        out = kern(tri, lab)
        assert torch.equal(out, twin(tri, lab))
        for b in range(tri.shape[0]):
            assert torch.equal(out[b], kern(tri[b].contiguous(), lab[b].contiguous()))


def test_batched_detect_backends_identical(cuda):
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    imgs = np.stack([render_tags(cam.K.numpy(), (480, 640), _tags(b, 1.1 + 0.05 * b),
                                 noise=2.0, seed=b) for b in range(3)])
    imgs = torch.from_numpy(imgs).to(cuda)
    cfg = DetectorConfig(tag_size=0.16)
    cam = cam.to(cuda)
    got = batched_detect_fn(cfg, cam, "mono8")(imgs)
    _assert_same(got, batched_detect_fn(dataclasses.replace(cfg, backend="torch"), cam,
                                        "mono8")(imgs))
    for b in range(3):
        assert sorted(r["id"] for r in got[0].frame(b).to_list()) == [2 + b, 7 + b, 12 + b]


def test_graph_backends_identical(cuda):
    """The reference calibration scaled to 640x360, one distorted frame."""
    s = 0.5
    cam = CameraModel.create(fx=942.53242 * s, fy=946.21221 * s, cx=642.81122 * s,
                             cy=346.71313 * s, width=640, height=360,
                             dist=[0.065725, -0.096954, 0.002318, 0.004110, 0.0])
    tags = _tags(z=1.6)[:2]
    img = distort_image(render_tags(cam.K.numpy(), (360, 640), tags), cam)
    cfg = DetectorConfig(tag_size=0.16)
    got = GraphPipeline(cfg, cam, encoding="mono8", device=cuda)(img)
    want = GraphPipeline(dataclasses.replace(cfg, backend="torch"), cam, encoding="mono8",
                         device=cuda)(img)
    _assert_same(got, want)
    assert sorted(r["id"] for r in got[0].to_list()) == [t["id"] for t in tags]


def _rig(n, size=(240, 320)):
    """n cameras with their own intrinsics, each rendering three tags through
    its own K (noise 1, seed c): cameras and (n, H, W) uint8 frames."""
    cams, frames = [], []
    for c in range(n):
        f = 210.0 * (1.0 + 0.02 * c)
        cam = CameraModel.create(fx=f, fy=f, cx=size[1] / 2 + c - n / 2, cy=size[0] / 2 - c / 2,
                                 width=size[1], height=size[0])
        frames.append(render_tags(cam.K.numpy(), size, _tags(c, 0.8), noise=1.0, seed=c))
        cams.append(cam)
    return cams, np.stack(frames)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_slow_reader_gets_its_own_frame(cuda, depth):
    """A function that sleeps on the card before it reads its input: every
    result is its own frame's pixels, so no upload overwrote a slot that a
    queued compute had still to read."""
    rng = np.random.default_rng(depth)
    frames = [rng.integers(0, 256, (240, 320), dtype=np.uint8) for _ in range(9)]

    def slow_copy(x):
        torch.cuda._sleep(int(2e9 * 0.003))
        return x.clone()

    got = run_stream(slow_copy, frames, depth=depth, device=cuda)
    assert len(got) == len(frames)
    for g, f in zip(got, frames):
        assert torch.equal(g.cpu(), torch.from_numpy(f))


def test_streaming_detect_equals_direct_calls(cuda):
    cams, frames = _rig(4)
    det = Detector(DetectorConfig(tag_size=0.16), cams[0], device=cuda)
    fn = lambda x: det.detect_with_stats(x, "mono8")     # noqa: E731
    for depth in (1, 2, 3):
        for got, f in zip(run_stream(fn, list(frames), depth=depth, device=cuda), frames):
            _assert_same(got, det.detect_with_stats(f, "mono8"))


def test_rig_launches_once_for_16_cameras(cuda):
    cams, frames = _rig(16)
    rig = RigDetector(DetectorConfig(tag_size=0.16), cams[0], 16, device=cuda, cameras=cams)
    x = torch.from_numpy(frames).to(cuda)
    torch.cuda.synchronize()
    thr_kernel.launches = ccl.row_launches = ccl.col_diag_launches = 0
    det, _ = rig.detect(x)
    torch.cuda.synchronize()
    assert (thr_kernel.launches, ccl.row_launches, ccl.col_diag_launches) == (1, 14, 14)
    for c in range(16):
        assert sorted(r["id"] for r in det.frame(c).to_list()) == [2 + c, 7 + c, 12 + c]


def test_detect_path_makes_no_host_sync(cuda):
    """Detector, batched detect, the per-camera rig and the streaming runner
    under sync debug mode 'error': a hidden host sync would raise. On the
    card the second call of each captures its graph and the third replays
    it."""
    cams, frames = _rig(3)
    cfg = DetectorConfig(tag_size=0.16)
    det = Detector(cfg, cams[0], device=cuda)
    bfn = batched_detect_fn(cfg, cams[0].to(cuda), "mono8")
    rig = RigDetector(cfg, cams[0], 3, device=cuda, cameras=cams)
    x = torch.from_numpy(frames).to(cuda)
    fn = lambda f: det.detect_with_stats(f, "mono8")     # noqa: E731
    fn(x[0]), bfn(x), rig.detect(x)                      # first calls upload constant tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            fn(x[0])
            bfn(x)
            rig.detect(x)
        for _ in StreamingRunner(fn, 2, cuda).run(list(frames)):
            pass
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _storages(result):
    return {t.untyped_storage().data_ptr() for r in result
            for t in (getattr(r, f.name) for f in dataclasses.fields(r))}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("config,batch", CAPTURE_CASES, ids=lambda v: str(v))
def test_replay_equals_eager_call(cuda, config, batch, backend):
    """Five calls of the captured function on five different inputs, all
    kept, then each held bit for bit against the eager call (capture=False)
    on its own input: a replay that handed out its static outputs would show
    here as results overwritten by later calls."""
    from isaac_ros_apriltag_tpu_torch.capture import GraphedCall

    cfg, cam, inputs = bench_inputs(config, batch, cuda)
    cfg = dataclasses.replace(cfg, backend=backend)
    fn = batched_detect_fn(cfg, cam, "mono8")
    eager = batched_detect_fn(cfg, cam, "mono8", capture=False)
    assert isinstance(fn, GraphedCall) and not isinstance(eager, GraphedCall)
    outs = [fn(x) for x in inputs]                # eager, then a capture, then replays
    assert len(fn.graphs) == 1
    seen = set()
    for x, out in zip(inputs, outs):
        assert not _storages(out) & seen
        seen |= _storages(out)
        _assert_same(out, eager(x))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_replay_counts_launches(cuda, backend):
    """A replay adds the launches its capture recorded: 1 / 14 / 14 and one
    of each cluster kernel for backend 'cuda', none for the twins; the
    capture itself adds none."""
    cfg, cam, inputs = bench_inputs(*CAPTURE_CASES[0], cuda, calls=3)
    fn = batched_detect_fn(dataclasses.replace(cfg, backend=backend), cam, "mono8")
    n = 1 if backend == "cuda" else 0
    for x in inputs:                               # eager, capture + replay, replay
        torch.cuda.synchronize()
        set_launch_counts({k: 0 for k in launch_counts()})
        fn(x)
        torch.cuda.synchronize()
        assert launch_counts() == {"threshold": n, "row": 14 * n, "col": 14 * n,
                                   **{k: n for k in CLUSTER_KERNELS}}


def test_streaming_over_captured_call_equals_eager(cuda):
    """StreamingRunner at depth 3 over the captured batch-of-one function,
    against the eager function on each frame."""
    cfg, cam, inputs = bench_inputs(*CAPTURE_CASES[0], cuda, calls=6)
    fn = batched_detect_fn(cfg, cam, "mono8")
    eager = batched_detect_fn(cfg, cam, "mono8", capture=False)
    host = [x[0].cpu().numpy() for x in inputs]
    got = run_stream(lambda f: fn(f[None]), host, depth=3, device=cuda)
    assert len(got) == len(inputs)
    for out, x in zip(got, inputs):
        _assert_same(out, eager(x))


def test_replay_from_another_stream(cuda):
    """Calls alternating between the default stream and a side stream, all
    kept: each equals the eager call on its input."""
    cfg, cam, inputs = bench_inputs(*CAPTURE_CASES[0], cuda, calls=4)
    fn = batched_detect_fn(cfg, cam, "mono8")
    eager = batched_detect_fn(cfg, cam, "mono8", capture=False)
    side = torch.cuda.Stream()
    outs = []
    for k, x in enumerate(inputs):
        if k % 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                outs.append(fn(x))
            torch.cuda.current_stream().wait_stream(side)
        else:
            outs.append(fn(x))
    for out, x in zip(outs, inputs):
        _assert_same(out, eager(x))


_NCCL_RIG = """
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from isaac_ros_apriltag_tpu_torch import DetectorConfig, RigDetector, make_mesh
from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh
from test_torch_gpu import _assert_same, _rig

pmesh.initialize_multihost(sys.argv[1], 1, 0)
try:
    assert dist.get_backend() == "nccl", dist.get_backend()
    group = make_mesh(1, 1).get_group("cam")
    cams, frames = _rig(4)
    x = torch.from_numpy(frames).cuda()
    cfg = DetectorConfig(tag_size=0.16)
    _assert_same(RigDetector(cfg, cams[0], 4, cameras=cams, group=group).detect(x),
                 RigDetector(cfg, cams[0], 4, cameras=cams).detect(x))
finally:
    dist.destroy_process_group()
"""


def test_rig_over_a_world_of_one_nccl_process(cuda, tmp_path):
    """RigDetector(group=) over the 'cam' group of a world of one NCCL
    process equals the rig without a group on every field. It runs in a
    child process, since a process group is global to its process."""
    script = tmp_path / "nccl_rig.py"
    script.write_text(_NCCL_RIG.format(root=ROOT, tests=os.path.join(ROOT, "tests")))
    out = subprocess.run([sys.executable, str(script), f"127.0.0.1:{free_port()}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_detect_checked_on_the_card(cuda, backend, monkeypatch):
    cams, frames = _rig(1, (480, 640))
    det = Detector(DetectorConfig(tag_size=0.16, backend=backend), cams[0], device=cuda)
    x = torch.from_numpy(frames[0]).to(cuda)
    _assert_same(det.detect_checked(x, "mono8"), det.detect_with_stats(x, "mono8"))
    good, stats = det.detect_with_stats(x, "mono8")
    bad = dataclasses.replace(good, quaternion=good.quaternion * 2.0)
    monkeypatch.setattr(tdetector, "build_detect_fn", lambda *a, **k: lambda img: (bad, stats))
    det = Detector(DetectorConfig(tag_size=0.16, backend=backend), cams[0], device=cuda)
    with pytest.raises(RuntimeError, match="unnormalized quaternions on valid detections"):
        det.detect_checked(x, "mono8")


def _four_tags(noise):
    """tests/test_torch_spatial.py's 640x480 scene: ids 1, 4, 7, 10."""
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18), (0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=3 * i + 1, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    return cam, render_tags(cam.K.numpy(), (480, 640), tags, noise=noise)


@pytest.mark.parametrize("noise", [0.0, 1.5])
def test_spatial_backends_identical(cuda, noise):
    """SpatialDetector on 4 bands: 'cuda' equals 'torch' on the card, front
    and detections; the front launches K1 once and K2 and K3 3 x 8 times."""
    cam, img = _four_tags(noise)
    cfg = DetectorConfig(tag_size=0.16)
    x = torch.from_numpy(img).to(cuda)
    torch.cuda.synchronize()
    thr_kernel.launches = ccl.row_launches = ccl.col_diag_launches = 0
    front = build_spatial_front_fn(cfg, cam, 4)(x)
    torch.cuda.synchronize()
    assert (thr_kernel.launches, ccl.row_launches, ccl.col_diag_launches) == (1, 24, 24)
    plain = build_spatial_front_fn(dataclasses.replace(cfg, backend="torch"), cam, 4)(x)
    assert torch.equal(front[0], plain[0]) and torch.equal(front[1], plain[1])
    got = SpatialDetector(cfg, cam, 4, device=cuda).detect_with_stats(x)
    want = SpatialDetector(dataclasses.replace(cfg, backend="torch"), cam, 4,
                           device=cuda).detect_with_stats(x)
    _assert_same(got, want)
    assert sorted(r["id"] for r in got[0].to_list()) == [1, 4, 7, 10]


def test_flat_flow_backends_identical(cuda):
    """ccl_phase2_rounds=0 at batch 3: 'cuda' equals 'torch', launches 1 / 8 / 8."""
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    imgs = np.stack([render_tags(cam.K.numpy(), (480, 640), _tags(b, 1.1 + 0.05 * b),
                                 noise=2.0, seed=b) for b in range(3)])
    imgs = torch.from_numpy(imgs).to(cuda)
    cfg = DetectorConfig(tag_size=0.16, ccl_phase2_rounds=0)
    cam = cam.to(cuda)
    fn = batched_detect_fn(cfg, cam, "mono8")
    torch.cuda.synchronize()
    thr_kernel.launches = ccl.row_launches = ccl.col_diag_launches = 0
    got = fn(imgs)
    torch.cuda.synchronize()
    assert (thr_kernel.launches, ccl.row_launches, ccl.col_diag_launches) == (1, 8, 8)
    _assert_same(got, batched_detect_fn(dataclasses.replace(cfg, backend="torch"), cam,
                                        "mono8")(imgs))
    for b in range(3):
        assert sorted(r["id"] for r in got[0].frame(b).to_list()) == [2 + b, 7 + b, 12 + b]


@pytest.mark.parametrize("rounds,jumps,jump_every", [(8, 2, 4), (5, 2, 1), (6, 3, 2)])
def test_connected_components_jumps_backends_identical(cuda, rounds, jumps, jump_every):
    """The single-phase CCL with pointer jumps at batch 3 of different
    frames: 'cuda' equals 'torch', and each frame alone its batch entry."""
    rng = np.random.default_rng(rounds)
    tri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=(3, 137, 203),
                                      p=[0.4, 0.2, 0.4])).to(cuda)
    lab, conv = connected_components(tri, rounds, jumps, jump_every, backend="cuda",
                                     with_convergence=True)
    twin = connected_components(tri, rounds, jumps, jump_every, backend="torch",
                                with_convergence=True)
    assert torch.equal(lab, twin[0]) and torch.equal(conv, twin[1])
    for b in range(3):
        one, c1 = connected_components(tri[b], rounds, jumps, jump_every, backend="cuda",
                                       with_convergence=True)
        assert torch.equal(one, lab[b]) and bool(c1) == bool(conv[b])


def test_jumps_flow_backends_identical(cuda):
    """ccl_flow='jumps' at batch 3: 'cuda' equals 'torch', launches 1 / 8 / 8."""
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    imgs = np.stack([render_tags(cam.K.numpy(), (480, 640), _tags(b, 1.1 + 0.05 * b),
                                 noise=2.0, seed=b) for b in range(3)])
    imgs = torch.from_numpy(imgs).to(cuda)
    cfg = DetectorConfig(tag_size=0.16, ccl_flow="jumps")
    cam = cam.to(cuda)
    fn = batched_detect_fn(cfg, cam, "mono8")
    torch.cuda.synchronize()
    thr_kernel.launches = ccl.row_launches = ccl.col_diag_launches = 0
    got = fn(imgs)
    torch.cuda.synchronize()
    assert (thr_kernel.launches, ccl.row_launches, ccl.col_diag_launches) == (1, 8, 8)
    _assert_same(got, batched_detect_fn(dataclasses.replace(cfg, backend="torch"), cam,
                                        "mono8")(imgs))
    for b in range(3):
        assert sorted(r["id"] for r in got[0].frame(b).to_list()) == [2 + b, 7 + b, 12 + b]


def test_map_ba_on_card_matches_cpu(cuda):
    """BA of the 10k-tag map (K=16, L=10 000, O=40 000) on the card: the rms
    falls 5x to under 0.5 px, the cameras lie within 1e-3 m of the CPU's
    solve and of the 4-shard batched solver's (index_add_ adds with atomics
    on the card, so the match is to a tolerance, not bit for bit), and a
    Gauss-Newton step makes no host sync."""
    p = map_problem(device=cuda)
    solved, rms = ba.solve(p, 5)
    rms = rms.cpu().numpy()
    assert rms[-1] < 0.5 and rms[-1] <= rms[0] / 5
    cpu, _ = ba.solve(map_problem(device="cpu"), 5)
    np.testing.assert_allclose(solved.cam_t.cpu().numpy(), cpu.cam_t.numpy(), atol=1e-3)
    sharded, _ = make_distributed_solver(5, nshards=4)(partition_problem(p, 4))
    np.testing.assert_allclose(sharded.cam_t.cpu().numpy(), solved.cam_t.cpu().numpy(), atol=1e-3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba.gauss_newton_step(p)
    finally:
        torch.cuda.set_sync_debug_mode(0)


_CLUSTER_CASES = {}


@pytest.mark.parametrize("name", CLUSTER_CASE_NAMES)
def test_cluster_kernels_match_plain_version(cuda, name):
    """chip_smoke.py phase 23's checks on one case: the kernel path against
    the plain version (integer outputs, centroid and scale bit-exact, bin
    tables within one f32 ulp), one launch of each kernel, two calls and a
    captured replay equal, each kernel against its plain version."""
    if not _CLUSTER_CASES:
        _CLUSTER_CASES.update(cluster_cases(cuda))
    check_cluster_case(name, *_CLUSTER_CASES[name])


def test_cluster_kernels_refuse_what_they_do_not_take(cuda):
    tri = torch.zeros((1, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        cluster_kernels.edge_count(tri, tri.to(torch.int64))
    with pytest.raises(ValueError, match="same CUDA device"):
        cluster_kernels.edge_count(tri, tri.to(torch.int32).cpu())
    keys = torch.zeros((1, 1028), dtype=torch.int32, device=cuda)
    num_edge = torch.zeros(1, dtype=torch.int32, device=cuda)
    ovf = torch.zeros(1, dtype=torch.bool, device=cuda)
    kw = dict(E=512, E2=512, max_clusters=16, min_cluster_pixels=24, max_perimeter=128)
    with pytest.raises(ValueError, match="16-byte"):
        cluster_kernels.top_segments(keys[:, 1:1025], num_edge, ovf, **kw)
    with pytest.raises(ValueError, match="comp_overflow"):
        cluster_kernels.top_segments(keys[:, :1024], num_edge, ovf.to(torch.int32), **kw)
    with pytest.raises(ValueError, match="must hold max_clusters"):
        cluster_kernels.extract_cluster_moments(tri, tri.to(torch.int32), comp_overflow=ovf,
                                                max_edge_points=64, max_clusters=128,
                                                min_cluster_pixels=24)
