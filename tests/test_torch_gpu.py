"""Tests of the PyTorch port that need a CUDA device: each hand-written
kernel against its plain twin, bit for bit, and the two backends against
each other end to end. They skip without a card.

This file imports neither jax nor the JAX package, so it runs where jax is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu_torch import CameraModel, Detector, DetectorConfig, get_family
from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

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


@pytest.mark.parametrize("shape", [(540, 960), (37, 2047), (300, 1), (1, 4096), (4096, 3)])
def test_scan_kernels_bit_exact(cuda, shape):
    rng = np.random.default_rng(5)
    tri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                                      p=[0.4, 0.2, 0.4])).to(cuda)
    lab = torch.from_numpy(rng.permutation(tri.numel()).astype(np.int32)
                           .reshape(shape)).to(cuda)
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


def test_backends_identical_end_to_end(cuda):
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=5 * i + 2, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    img = torch.from_numpy(render_tags(cam.K.numpy(), (480, 640), tags, noise=2.0)).to(cuda)
    cfg = DetectorConfig(tag_size=0.16)
    dc, sc = Detector(cfg, cam, device=cuda).detect_with_stats(img, "mono8")
    dt, st = Detector(dataclasses.replace(cfg, backend="torch"), cam,
                      device=cuda).detect_with_stats(img, "mono8")
    assert sorted(r["id"] for r in dc.to_list()) == [2, 7, 12]
    for a, b in [(getattr(dc, f.name), getattr(dt, f.name)) for f in dataclasses.fields(dc)] + \
                [(getattr(sc, f.name), getattr(st, f.name)) for f in dataclasses.fields(sc)]:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        assert bool(same.all())
