"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source
and all at once, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library lives
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
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and spills
# (kept in build_log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

# (name, number of pointer args, number of int args); every entry point ends
# with the stream pointer and returns cudaGetLastError().
# Each takes the batch B first among its ints.
_ENTRY_POINTS = (("apriltag_threshold", 2, 5),
                 ("apriltag_ccl_row", 3, 3),
                 ("apriltag_ccl_col_diag", 3, 3))

MAX_BATCH = 65535   # frames a launch takes: the grid dimension that holds the frame

build_seconds: float | None = None   # wall time of the last build (None = loaded from cache)
build_log: str | None = None         # the compilers' output of the last build


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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once and return their output; raise with the
    output of the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def _build(out_path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out_path)) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in _SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, s), "-o", o]
                        for s, o in zip(_SOURCES, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out_path)
    build_seconds = time.perf_counter() - t0
    build_log = log


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
