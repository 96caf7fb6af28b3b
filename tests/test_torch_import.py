"""The PyTorch port imports without jax and refuses to run its CUDA backend
where there is no CUDA: no fallback, no silent CPU path."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys
import isaac_ros_apriltag_tpu_torch
import isaac_ros_apriltag_tpu_torch.convert
import isaac_ros_apriltag_tpu_torch.detector
import isaac_ros_apriltag_tpu_torch.utils.render
from isaac_ros_apriltag_tpu_torch import get_family
get_family("tag36h11")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "isaac_ros_apriltag_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_backend_on_cpu_device_raises():
    from isaac_ros_apriltag_tpu_torch import CameraModel, Detector, DetectorConfig

    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Detector(DetectorConfig(backend="cuda"), cam, device="cpu")


def test_default_backend_is_cuda():
    from isaac_ros_apriltag_tpu_torch import BACKENDS, DetectorConfig

    assert BACKENDS == ("torch", "cuda")
    assert DetectorConfig().backend == "cuda"


def test_default_device_is_the_card_for_both_backends():
    """Only an explicit device='cpu' runs the port on the CPU."""
    from isaac_ros_apriltag_tpu_torch import DetectorConfig
    from isaac_ros_apriltag_tpu_torch.detector import device_for

    assert device_for(DetectorConfig(backend="torch"), None).type == "cuda"
    assert device_for(DetectorConfig(backend="torch"), "cpu").type == "cpu"


def test_wrappers_reject_other_devices():
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl, threshold

    g = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError):
        threshold.adaptive_threshold(g, 4, 5)
    tri = torch.zeros((8, 8), dtype=torch.uint8, device="meta")
    lab = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ccl.row_scan(tri, lab)
    with pytest.raises(ValueError):
        ccl.col_diag_scan(tri, lab)


def test_launch_status_raises():
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    _lib.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _lib.check(9, "apriltag_threshold")


def test_missing_nvcc_raises(monkeypatch):
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(_lib.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib._nvcc()


def test_build_hash_tracks_sources():
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    h = _lib._source_hash()
    assert h == _lib._source_hash() and len(h) == 16
    for name in _lib._SOURCES:
        assert os.path.exists(os.path.join(_lib._CSRC, name))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
@pytest.mark.parametrize("script", ["chip_smoke.py", "torch_stage_profile.py"])
def test_scripts_refuse_without_cuda(script):
    """Without a CUDA device the scripts exit non-zero and print no result."""
    out = subprocess.run([sys.executable, script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
