"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, which is loaded with ``ctypes``. The library lives
in ``isaac_ros_apriltag_tpu_torch/_build/<source hash>/`` (git-ignored), so a
checkout builds everything from its own sources and rebuilds when a source
changes. A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("threshold.cu", "ccl.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

# (name, number of pointer args, number of int args); every entry point ends
# with the stream pointer and returns cudaGetLastError().
_ENTRY_POINTS = (("apriltag_threshold", 2, 4),
                 ("apriltag_ccl_row", 3, 2),
                 ("apriltag_ccl_col_diag", 3, 2))

build_seconds: float | None = None   # wall time of the last build (None = loaded from cache)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(out_path: str) -> None:
    global build_seconds
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out_path))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [os.path.join(_CSRC, s) for s in _SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out_path)
    build_seconds = time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    path = os.path.join(_BUILD, _source_hash(), "libapriltag_kernels.so")
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    for name, n_ptr, n_int in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
