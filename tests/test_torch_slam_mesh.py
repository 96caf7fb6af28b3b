"""The landmark-sharded BA over a process group on the CPU: four processes
joined by gloo on loopback (parallel/mesh.py), each solving one landmark
shard with psum as all_reduce, must give the cameras of the single solver,
of the one-device shard batch, and of JAX's solver on a (1, 4) mesh. The
children are plain scripts run by subprocess, and the whole run is bounded,
so a hung collective fails the test."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu.parallel.slam import dba as jdba
from isaac_ros_apriltag_tpu_torch import ba_solve, make_distributed_solver, partition_problem
from isaac_ros_apriltag_tpu_torch.convert import ba_problem_from_reference
from test_slam import make_problem

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ITERS = 6
TIMEOUT_S = 100
TOL_M = 1e-3

_CHILD = """
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {root!r})
from isaac_ros_apriltag_tpu_torch import make_distributed_solver, make_mesh, partition_problem
from isaac_ros_apriltag_tpu_torch.convert import ba_problem_from_reference
from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

addr, rank, problem, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
pmesh.initialize_multihost(addr, {world}, rank, backend="gloo")
try:
    group = make_mesh(1, {world}).get_group("map")
    with np.load(problem) as z:
        p = ba_problem_from_reference(**dict(z), device="cpu")
    solved, rms = make_distributed_solver({iters}, group=group)(partition_problem(p, {world}))
    np.savez(out, cam_t=solved.cam_t.numpy(), lm_t=solved.lm_t.numpy(), rms=rms.numpy())
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def problem():
    """tests/test_slam.py::test_distributed_ba_matches_single's problem."""
    pj, _ = make_problem(state_noise=0.02, seed=1)
    return pj, {k: np.asarray(v) for k, v in pj._asdict().items()}


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """Run the four ranks; their saved outputs, in rank order."""
    tmp = tmp_path_factory.mktemp("slam_mesh")
    np.savez(tmp / "problem.npz", **problem[1])
    script = tmp / "child.py"
    script.write_text(_CHILD.format(root=ROOT, world=WORLD, iters=ITERS))
    addr = f"127.0.0.1:{_free_port()}"
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(r), str(tmp / "problem.npz"),
                               str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(o)) for o in outs]


def test_ranks_agree(ranks):
    """Every rank holds the same cameras, landmarks and rms history."""
    for out in ranks[1:]:
        for k in ("cam_t", "lm_t", "rms"):
            np.testing.assert_allclose(out[k], ranks[0][k], atol=1e-6, err_msg=k)


def test_ranks_equal_single_solver_and_shard_batch(problem, ranks):
    p = ba_problem_from_reference(**problem[1], device="cpu")
    single, _ = ba_solve(p, iters=ITERS)
    batch, _ = make_distributed_solver(ITERS, nshards=WORLD)(partition_problem(p, WORLD))
    for out in ranks:
        np.testing.assert_allclose(out["cam_t"], single.cam_t.numpy(), atol=TOL_M)
        np.testing.assert_allclose(out["cam_t"], batch.cam_t.numpy(), atol=TOL_M)
        np.testing.assert_allclose(out["lm_t"], batch.lm_t.numpy(), atol=TOL_M)
        assert out["rms"][-1] < 1e-2


def test_ranks_equal_jax_mesh_solver(problem, ranks):
    """JAX's shard_map solver on a (1, 4) mesh of CPU devices."""
    mesh = jax.make_mesh((1, WORLD), ("cam", "map"))
    pp = jax.device_put(jdba.partition_problem(problem[0], WORLD), jdba.problem_shardings(mesh))
    solved, rms = jdba.make_distributed_solver(mesh, iters=ITERS)(pp)
    for out in ranks:
        np.testing.assert_allclose(out["cam_t"], np.asarray(solved.cam_t), atol=TOL_M)
        np.testing.assert_allclose(out["lm_t"], np.asarray(solved.lm_t), atol=TOL_M)
