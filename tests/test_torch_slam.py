"""The SLAM layer of the PyTorch port against the JAX package, on the CPU:
se3_exp and skew, BA's linearization, one Gauss-Newton step and a solve,
the PCG against jax.scipy's cg, the pose graph, partition_problem, the
shard-batched distributed BA, TagMapper fed the same detections, the map
checkpoint read across packages, and ate_rmse. Same numpy inputs, made from
seeds, go to both packages.

Tolerances: the Jacobians 1e-5 of their largest entry; states after a step
or a solve 1e-3 m (the reference's own distributed-vs-single bound); the
rms history 1e-3 relative plus 3e-5 px, one f32 ulp of a ~300 px corner
coordinate: the f32 residual is good to no more than that, and the
noise-free problem's rms falls to ~1e-5 px by its fourth step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import cg as jax_cg

from isaac_ros_apriltag_tpu import types as jtypes
from isaac_ros_apriltag_tpu.parallel.slam import ba as jba
from isaac_ros_apriltag_tpu.parallel.slam import dba as jdba
from isaac_ros_apriltag_tpu.parallel.slam import posegraph as jpg
from isaac_ros_apriltag_tpu.parallel.slam.map import TagMapper as JTagMapper
from isaac_ros_apriltag_tpu.parallel.slam.map import ate_rmse as j_ate_rmse
from isaac_ros_apriltag_tpu.utils import geometry as jgeo
from isaac_ros_apriltag_tpu_torch import (CameraModel, Detections, DetectorConfig, TagMapper,
                                          ate_rmse, batched_detect_fn, make_distributed_solver,
                                          partition_problem)
from isaac_ros_apriltag_tpu_torch.convert import (ba_problem_from_reference,
                                                  pose_graph_from_reference)
from isaac_ros_apriltag_tpu_torch.parallel.slam import ba, posegraph
from isaac_ros_apriltag_tpu_torch.parallel.slam.ba import _scatter_add
from isaac_ros_apriltag_tpu_torch.utils import geometry as tgeo
from chip_smoke import loop_graph
from test_slam import make_problem
from test_slam_e2e import N_FRAMES, N_TAGS, TAG_SIZE, gt_camera, render_frame

torch.set_num_threads(2)

# make_problem's arguments: tests/test_slam.py's noise-free and noisy scenes.
PROBLEMS = {"exact": dict(state_noise=0.03), "noisy": dict(noise_px=0.3, state_noise=0.02, seed=3)}
STATE_TOL_M = 1e-3
RMS_ATOL_PX = 3e-5


def _port(pj):
    """A JAX BAProblem as the port's, on the CPU."""
    return ba_problem_from_reference(**{k: np.asarray(v) for k, v in pj._asdict().items()},
                                     device="cpu")


def _check_rms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=RMS_ATOL_PX)


def test_se3_exp_and_skew_match_reference():
    rng = np.random.default_rng(0)
    tau = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    tau[0] = 0.0
    tau[1, :3] = 1e-8                       # the small-angle branch
    tau[2, :3] = [np.pi - 1e-3, 0.0, 0.0]
    Rj, tj = jgeo.se3_exp(jnp.asarray(tau))
    Rt, tt = tgeo.se3_exp(torch.from_numpy(tau))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    np.testing.assert_array_equal(tgeo.skew(torch.from_numpy(tau[:, :3])).numpy(),
                                  np.asarray(jgeo.skew(jnp.asarray(tau[:, :3]))))


def test_se3_exp_jacobian_at_zero_matches_reference():
    """The forward-mode Jacobian at tau = 0 goes through the small-angle
    where and is finite, and equal to JAX's."""
    z = np.zeros(6, np.float32)
    jj = jax.jacfwd(lambda x: jnp.concatenate([a.reshape(-1) for a in jgeo.se3_exp(x)]))(
        jnp.asarray(z))
    jt = torch.func.jacfwd(lambda x: torch.cat([a.reshape(-1) for a in tgeo.se3_exp(x)]))(
        torch.from_numpy(z))
    assert torch.isfinite(jt).all()
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=1e-6)


def test_scatter_add_sums_repeated_indices():
    """The case ``t[idx] += v`` gets wrong: repeated indices must sum, as
    JAX's ``.at[idx].add``."""
    e = np.array([0, 1, 1])
    v = np.arange(3 * 2, dtype=np.float32).reshape(3, 2) + 1.0
    want = np.asarray(jnp.zeros((2, 2)).at[jnp.asarray(e)].add(jnp.asarray(v)))
    got = _scatter_add(2, torch.from_numpy(e), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_linearize_matches_reference(name):
    pj, _ = make_problem(**PROBLEMS[name])
    for want, got in zip(jba._linearize(pj), ba._linearize(_port(pj))):
        want = np.asarray(want)
        assert torch.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_gauss_newton_step_matches_reference(name):
    pj, _ = make_problem(**PROBLEMS[name])
    sj, rj = jax.jit(jba.gauss_newton_step)(pj)
    st, rt = ba.gauss_newton_step(_port(pj))
    for f in ("cam_t", "lm_t", "cam_R", "lm_R"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   atol=STATE_TOL_M, err_msg=f)
    _check_rms(rt[None], np.asarray(rj)[None])


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_reference(name):
    pj, gt = make_problem(**PROBLEMS[name])
    sj, rj = jax.jit(lambda q: jba.solve(q, iters=8))(pj)
    st, rt = ba.solve(_port(pj), iters=8)
    assert rt.shape == (8,)
    for f in ("cam_t", "lm_t"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   atol=STATE_TOL_M, err_msg=f)
    _check_rms(rt, rj)
    assert ate_rmse(st.cam_t.numpy(), gt["kf_t"]) < (1e-3 if name == "exact" else 8e-3)


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-10), (200, 1e-10), (200, 1e-3)])
def test_cg_matches_jax(maxiter, tol):
    """The port's PCG against jax.scipy's cg on one SPD system and
    block-diagonal preconditioner: cut at maxiter, run to the f32 floor, and
    stopped early by tol."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(24, 24)).astype(np.float32)
    A = A @ A.T + 0.5 * np.eye(24, dtype=np.float32)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    blocks = np.stack([np.linalg.inv(A[6 * k:6 * k + 6, 6 * k:6 * k + 6]) for k in range(4)])
    xj = jax_cg(lambda x: (jnp.asarray(A) @ x.reshape(-1)).reshape(4, 6), jnp.asarray(b),
                M=lambda x: jnp.einsum("kij,kj->ki", jnp.asarray(blocks), x),
                maxiter=maxiter, tol=tol)[0]
    At, Mt = torch.from_numpy(A), torch.from_numpy(blocks)
    xt = ba.cg(lambda x: (At @ x.reshape(-1)).reshape(4, 6), torch.from_numpy(b),
               lambda x: torch.einsum("kij,kj->ki", Mt, x), maxiter=maxiter, tol=tol)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_posegraph_matches_reference():
    fields, t_gt = loop_graph()
    gj, rj = jax.jit(lambda q: jpg.solve(q, iters=10))(
        jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()}))
    gt_, rt = posegraph.solve(pose_graph_from_reference(**fields, device="cpu"), iters=10)
    np.testing.assert_allclose(gt_.t.numpy(), np.asarray(gj.t), atol=STATE_TOL_M)
    np.testing.assert_allclose(gt_.R.numpy(), np.asarray(gj.R), atol=STATE_TOL_M)
    assert float(rt[-1]) < 1e-3 and np.abs(gt_.t.numpy() - t_gt).max() < 1e-2
    _check_rms(rt, rj)
    # At the solution the rotation residuals sit at arccos's clip (cos = 1);
    # the Jacobians there are finite.
    r, Ji, Jj = posegraph._linearize(gt_)
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()


def test_posegraph_sums_repeated_edges():
    """Two copies of every edge give the normal equations of each edge with
    twice the weight: the same solution, H and b doubled."""
    fields, _ = loop_graph()
    twice = {k: np.concatenate([v, v]) if k.startswith("edge") else v for k, v in fields.items()}
    g1, _ = posegraph.gauss_newton_step(pose_graph_from_reference(**fields, device="cpu"), 0.0)
    g2, _ = posegraph.gauss_newton_step(pose_graph_from_reference(**twice, device="cpu"), 0.0)
    np.testing.assert_allclose(g2.t.numpy(), g1.t.numpy(), atol=1e-4)


def test_partition_problem_matches_reference():
    pj, _ = make_problem(state_noise=0.02, seed=1)
    want = jdba.partition_problem(pj, 4)
    got = partition_problem(_port(pj), 4)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_sharded_dba_matches_single():
    """Four landmark shards as a batch on one device: the cameras equal the
    single solver's and JAX's single solver's within 1e-3 m, and the rms
    converges (tests/test_slam.py::test_distributed_ba_matches_single)."""
    pj, _ = make_problem(state_noise=0.02, seed=1)
    p = _port(pj)
    sd, rd = make_distributed_solver(iters=6, nshards=4)(partition_problem(p, 4))
    ss, rs = ba.solve(p, iters=6)
    sj, _ = jax.jit(lambda q: jba.solve(q, iters=6))(pj)
    np.testing.assert_allclose(sd.cam_t.numpy(), ss.cam_t.numpy(), atol=STATE_TOL_M)
    np.testing.assert_allclose(sd.cam_t.numpy(), np.asarray(sj.cam_t), atol=STATE_TOL_M)
    _check_rms(rd, rs)
    assert float(rd[-1]) < 1e-2
    with pytest.raises(ValueError, match="nshards"):
        make_distributed_solver(iters=1)


@pytest.fixture(scope="module")
def orbit_detections():
    """The port's detections (CPU, the jumps flow) of tests/test_slam_e2e.py's
    six-frame orbit, one batched call, as numpy, frame by frame."""
    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    frames = np.stack([render_frame(cam, k) for k in range(N_FRAMES)])
    cfg = DetectorConfig(tag_size=TAG_SIZE, backend="torch", ccl_flow="jumps")
    det, _ = batched_detect_fn(cfg, cam, "mono8")(torch.from_numpy(frames))
    return cam, [{f.name: getattr(det.frame(k), f.name).numpy()
                  for f in dataclasses.fields(det)} for k in range(N_FRAMES)]


def _mappers(orbit_detections):
    """A port and a JAX TagMapper fed the same detections."""
    cam, dets = orbit_detections
    ours = TagMapper(K=cam.K.numpy(), tag_size=TAG_SIZE, device="cpu")
    ref = JTagMapper(K=cam.K.numpy(), tag_size=TAG_SIZE)
    for d in dets:
        ours.process_frame(_port_detections(d))
        ref.process_frame(jtypes.Detections(**{k: jnp.asarray(v) for k, v in d.items()}))
    return ours, ref


def _port_detections(d):
    return Detections(**{k: torch.from_numpy(v) for k, v in d.items()})


def test_tag_mapper_builds_reference_problem(orbit_detections):
    ours, ref = _mappers(orbit_detections)
    assert ours.lm_ids == ref.lm_ids and len(ours.lm_ids) == N_TAGS
    pt, pj = ours.build_problem(), ref.build_problem()
    for f in pj._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                      err_msg=f)
    # the e2e ATE bound of tests/test_slam_e2e.py::test_trajectory_ate
    solved, rms = ba.solve(pt, iters=8)
    ours.update_from_problem(solved)
    gt = np.stack([gt_camera(k)[1] for k in range(N_FRAMES)])
    assert float(rms[-1]) < 1.0 and ate_rmse(np.stack(ours.kf_t), gt) < 0.02


def test_map_checkpoint_loads_across_packages(orbit_detections, tmp_path):
    ours, ref = _mappers(orbit_detections)
    ours.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    into_ref = JTagMapper(K=np.zeros((3, 3)), tag_size=0.0)
    into_ref.load(str(tmp_path / "port.npz"))
    into_ours = TagMapper(K=np.zeros((3, 3)), tag_size=0.0, device="cpu")
    into_ours.load(str(tmp_path / "jax.npz"))
    assert into_ref.lm_ids == into_ours.lm_ids == ref.lm_ids
    assert into_ours.tag_size == into_ref.tag_size == TAG_SIZE
    pt, pj = into_ours.build_problem(), into_ref.build_problem()
    for f in pj._fields:
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                      err_msg=f)
    # a resumed mapper keeps accumulating
    k = into_ours.process_frame(_port_detections(orbit_detections[1][0]))
    assert k == N_FRAMES and len(into_ours.obs) > len(ours.obs)


def test_ate_rmse_matches_reference():
    rng = np.random.default_rng(5)
    traj = rng.normal(size=(20, 3))
    q = rng.normal(size=4)
    R = tgeo.rotmat_from_quat(torch.from_numpy(q / np.linalg.norm(q))).numpy()
    moved = traj @ R.T + np.array([1.0, -2.0, 0.5])
    noisy = moved + rng.normal(0, 0.01, moved.shape)
    assert ate_rmse(moved, traj) < 1e-6
    assert ate_rmse(noisy, traj) == j_ate_rmse(noisy, traj)
