"""Rank-space component resolution of the PyTorch port against the JAX
package: ``resolve_roots_rank`` (rank image, rank table, overflow flag) and
``resolve_components`` in rank-table mode (dense ids, n_eligible, overflow,
converged), all bit-exact. Mirrors tests/test_resolve.py's rank-flow and
area-gate cases."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu.ops import resolve as jres
from isaac_ros_apriltag_tpu.ops.ccl import connected_components
from isaac_ros_apriltag_tpu.ops.pallas.ccl_fused import ccl_scan_pallas
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan


def _speckle(shape=(64, 128), seed=3):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])


@functools.lru_cache(maxsize=None)
def _phase1(shape, rounds):
    """Phase-1 labels from the reference's Pallas scan, shared by the tests."""
    tri = _speckle(shape)
    lab, _ = ccl_scan_pallas(jnp.asarray(tri), rounds, interpret=True)
    return tri, np.array(lab)


def _t(a):
    return torch.from_numpy(np.array(a))


def _roots_rank_both(lab, valid, R, steps):
    a = jres.resolve_roots_rank(jnp.asarray(lab), jnp.asarray(valid),
                                max_components=R, chain_steps=steps)
    b = tres.resolve_roots_rank(_t(lab), _t(valid), max_components=R, chain_steps=steps)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


@pytest.mark.parametrize("R,steps", [(1024, 5), (4096, 1), (64, 2), (8192, 5)])
def test_resolve_roots_rank_bit_exact(R, steps):
    """Includes an over-capacity case (R=64: n_groups > R, sentinel ranks)."""
    tri, lab = _phase1((64, 128), 4)
    (ai, at, ao), (bi, bt, bo) = _roots_rank_both(lab, tri != 127, R, steps)
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_array_equal(at, bt)
    assert bool(ao) == bool(bo)
    if R == 64:
        assert bool(bo)


@pytest.mark.parametrize("R,steps,min_px", [(1024, 3, 4), (1024, 3, 25), (4096, 1, 4),
                                            (64, 2, 25)])
def test_rank_flow_resolve_components_bit_exact(R, steps, min_px):
    """resolve_roots_rank -> opaque phase-2 scan -> resolve_components with
    rank_table (tests/test_resolve.py::test_rank_flow_matches_flat_flow)."""
    tri, lab = _phase1((64, 128), 4)
    valid = tri != 127
    (ai, at, _), _ = _roots_rank_both(lab, valid, R, 5)
    lab2, _ = ccl_scan(_t(tri), 3, backend="torch", label0=_t(ai))
    lab2 = lab2.numpy()
    a = jres.resolve_components(jnp.asarray(lab2), jnp.asarray(valid),
                                min_component_pixels=min_px, max_components=R,
                                chain_steps=steps, rank_table=jnp.asarray(at))
    b = tres.resolve_components(_t(lab2), _t(valid), min_component_pixels=min_px,
                                max_components=R, chain_steps=steps, rank_table=_t(at))
    np.testing.assert_array_equal(np.asarray(a.dense), b.dense.numpy())
    assert int(a.n_eligible) == int(b.n_eligible)
    assert bool(a.overflow) == bool(b.overflow)
    assert bool(a.converged) == bool(b.converged)


def test_resolve_all_invalid():
    lab = np.arange(16 * 32, dtype=np.int32).reshape(16, 32)
    valid = np.zeros((16, 32), bool)
    (ai, at, ao), (bi, bt, bo) = _roots_rank_both(lab, valid, 64, 5)
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_array_equal(at, bt)
    b = tres.resolve_components(_t(bi), _t(valid), min_component_pixels=1,
                                max_components=64, rank_table=_t(bt))
    assert (b.dense.numpy() == tres._KMAX).all()
    assert int(b.n_eligible) == 0 and not bool(b.overflow)


def test_resolve_area_gate_and_overflow():
    """tests/test_resolve.py::test_resolve_area_gate_and_overflow, through
    the rank flow."""
    tri = np.full((32, 128), 127, np.uint8)
    tri[2:6, 2:10] = 0       # 32 px component
    tri[10:12, 2:4] = 0      # 4 px component (gated out at min 25)
    valid = tri != 127
    lab = np.asarray(connected_components(jnp.asarray(tri), 8, 2))
    for R in (256, 1):
        rank_img, table, ovf = tres.resolve_roots_rank(_t(lab), _t(valid), max_components=R)
        res = tres.resolve_components(rank_img, _t(valid), min_component_pixels=25,
                                      max_components=R, rank_table=table)
        d = res.dense.numpy()
        if R == 256:
            assert int(res.n_eligible) == 1 and not bool(res.overflow)
            assert (d[2:6, 2:10] == 0).all()
            assert (d[10:12, 2:4] == tres._KMAX).all()
        else:
            # The contraction drops the second group to the sentinel rank
            # and says so; the detector ORs this flag into FrameStats.
            assert bool(ovf) and int(res.n_eligible) == 1


def test_resolve_rejects_bad_capacity():
    lab = torch.zeros((300, 300), dtype=torch.int32)
    valid = torch.ones((300, 300), dtype=torch.bool)
    with pytest.raises(ValueError, match="65536"):
        tres.resolve_roots_rank(lab, valid, max_components=1 << 17)
    with pytest.raises(ValueError, match="capacity mismatch"):
        tres.resolve_components(lab, valid, min_component_pixels=1, max_components=64,
                                rank_table=torch.zeros(32, dtype=torch.int32))
