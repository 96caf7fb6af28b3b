"""Tests of the PyTorch port that need a CUDA device: each hand-written
kernel against its plain twin, bit for bit, on one frame and on a batch of
different frames (where it must also equal itself run on each frame alone),
and the two backends against each other end to end: one frame, a batch, and
the rectify -> resize -> detect graph. They skip without a card.

The adversarial inputs of the threshold and scan kernels are chip_smoke.py's,
so the smoke run and these tests hold the kernels to the same cases. This file imports
neither jax nor the JAX package, so it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (SCAN_CASES, THRESH_CASES, THRESH_MIN_DIFF, edge_batch, scan_case,
                        scan_case_id, thresh_case_id, thresh_input)
from isaac_ros_apriltag_tpu_torch import (CameraModel, Detector, DetectorConfig, GraphPipeline,
                                          batched_detect_fn, get_family)
from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import distort_image, render_tags, upright_pose

pytestmark = pytest.mark.gpu


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


_RANDOM_SCANS =tuple((shape, "random", "perm")
                      for shape in [(540, 960), (37, 2047), (300, 1), (1, 4096), (4096, 3)])


@pytest.mark.parametrize("case", _RANDOM_SCANS + SCAN_CASES, ids=scan_case_id)
def test_scan_kernels_bit_exact(cuda, case):
    """Random lines, and chip_smoke's lines built to break a chunked scan."""
    tri, lab = (torch.from_numpy(a).to(cuda) for a in scan_case(*case))
    assert torch.equal(ccl.row_scan(tri, lab), ccl.row_scan_plain(tri, lab))
    assert torch.equal(ccl.col_diag_scan(tri, lab), ccl.col_diag_scan_plain(tri, lab))
    a = ccl.ccl_scan(tri, 8, backend="cuda")
    b = ccl.ccl_scan(tri, 8, backend="torch")
    assert torch.equal(a[0], b[0]) and bool(a[1]) == bool(b[1])


def test_wrappers_check_arguments(cuda):
    g = torch.zeros((30, 30), device=cuda)
    with pytest.raises(ValueError):
        thr_kernel.adaptive_threshold(g, 4, 5)            # 30 is not a multiple of 4
    with pytest.raises(ValueError):
        thr_kernel.adaptive_threshold(g.double(), 2, 5)
    tri = torch.zeros((8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        ccl.row_scan(tri, torch.zeros((8, 8), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ccl.row_scan(torch.zeros((2, 5000), dtype=torch.uint8, device=cuda),
                     torch.zeros((2, 5000), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        ccl.col_diag_scan(torch.zeros((5000, 2), dtype=torch.uint8, device=cuda),
                          torch.zeros((5000, 2), dtype=torch.int32, device=cuda))


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
