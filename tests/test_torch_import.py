"""The PyTorch port imports without jax and refuses to run its CUDA backend
where there is no CUDA: no fallback, no silent CPU path."""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import runpy
import sys
import isaac_ros_apriltag_tpu_torch
import isaac_ros_apriltag_tpu_torch.cli
import isaac_ros_apriltag_tpu_torch.convert
import isaac_ros_apriltag_tpu_torch.detector
import isaac_ros_apriltag_tpu_torch.ops.ccl
import isaac_ros_apriltag_tpu_torch.parallel.mesh
import isaac_ros_apriltag_tpu_torch.parallel.rig
import isaac_ros_apriltag_tpu_torch.parallel.slam.ba
import isaac_ros_apriltag_tpu_torch.parallel.slam.dba
import isaac_ros_apriltag_tpu_torch.parallel.slam.map
import isaac_ros_apriltag_tpu_torch.parallel.slam.posegraph
import isaac_ros_apriltag_tpu_torch.parallel.spatial
import isaac_ros_apriltag_tpu_torch.streaming
import isaac_ros_apriltag_tpu_torch.sync
import isaac_ros_apriltag_tpu_torch.utils.geometry
import isaac_ros_apriltag_tpu_torch.utils.render
import isaac_ros_apriltag_tpu_torch.utils.timing
import isaac_ros_apriltag_tpu_torch.utils.viz
from isaac_ros_apriltag_tpu_torch import (SpatialDetector, TagMapper, ate_rmse, ba_solve,
                                          build_spatial_front_fn, connected_components,
                                          get_family, make_distributed_solver, make_mesh,
                                          partition_problem, pose_graph_solve)
get_family("tag36h11")
for argv in (["--help"], ["slam", "--help"]):
    sys.argv = ["isaac_ros_apriltag_tpu_torch", *argv]
    try:
        runpy.run_module("isaac_ros_apriltag_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
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
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "usage: isaac_ros_apriltag_tpu_torch" in out.stdout


def test_port_has_its_own_codebooks():
    """The port reads the codebooks from inside its own package, and its
    copy is byte for byte the reference package's file."""
    from isaac_ros_apriltag_tpu_torch.models import families

    pkg = os.path.join(ROOT, "isaac_ros_apriltag_tpu_torch") + os.sep
    assert os.path.realpath(families._DATA_DIR).startswith(os.path.realpath(pkg))

    def sha256(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    ours = os.path.join(families._DATA_DIR, "codebooks.npz")
    ref = os.path.join(ROOT, "isaac_ros_apriltag_tpu", "models", "data", "codebooks.npz")
    assert sha256(ours) == sha256(ref)


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


def test_build_compiles_sources_together_then_links(monkeypatch, tmp_path):
    """One nvcc per source, then one link into the library; a failing nvcc
    raises. A stand-in nvcc logs its arguments and touches its output."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    log = tmp_path / "log"
    fake = tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_lib, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_lib, "build_seconds", None)
    out = tmp_path / "build" / "lib.so"
    _lib._build(str(out))
    assert out.exists() and _lib.build_seconds is not None
    calls = [c.split() for c in log.read_text().splitlines()]
    compiled = sorted(os.path.basename(c[c.index("-c") + 1]) for c in calls[:-1])
    assert compiled == sorted(_lib._SOURCES)
    assert "-shared" in calls[-1] and len(calls) == len(_lib._SOURCES) + 1
    fake.write_text("#!/bin/sh\necho refused >&2\nexit 2\n")
    with pytest.raises(RuntimeError, match="refused"):
        _lib._build(str(tmp_path / "build2" / "lib.so"))


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__7955fd17_12_threshold_cu_34adf34e\
16threshold_kernelILi32ELb0EEEvPKfPhiif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__7955fd17_12_threshold_cu_34adf34e\
16threshold_kernelILi32ELb0EEEvPKfPhiif
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 164 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__2b7c9e11_6_ccl_cu_1f0ec0a2\
15row_scan_kernelEPKhPKiPiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__2b7c9e11_6_ccl_cu_1f0ec0a2\
15row_scan_kernelEPKhPKiPiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 4000 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11col_kernelPKh' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 384 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_kernel():
    from chip_smoke import ptxas_usage

    assert ptxas_usage(_PTXAS_LOG) == {"threshold_kernel<32,0>": (166, 12, 164),
                                       "row_scan_kernel": (48, 0, 4000),
                                       "col_kernel": (30, 0, 0)}
    assert ptxas_usage("") == {}


@pytest.mark.parametrize("script", [["chip_smoke.py"], ["torch_stage_profile.py"],
                                    ["torch_kernel_times.py"], ["torch_bench.py"],
                                    ["torch_bench_memory.py"], ["torch_bench_latency.py"],
                                    ["-m", "isaac_ros_apriltag_tpu_torch", "bench"]],
                         ids=lambda a: a[-1])
def test_scripts_refuse_without_cuda(script):
    """Without a CUDA device the scripts, and the command line's bench at its
    default --device cuda, exit non-zero and print no result."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    out = subprocess.run([sys.executable, *script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
