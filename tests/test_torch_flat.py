"""The flat-label CCL flow of the PyTorch port against the JAX package:
``resolve_components`` without a rank table (dense ids, n_eligible,
overflow, converged, and ``roots`` with ``with_roots``), ``resolve_roots``
and ``component_sizes``, all bit-exact; batched against frame by frame; the
port's flat flow against its rank flow; and the single-phase detector
(``ccl_phase2_rounds=0``) against JAX ``backend="interpret"``."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.detector import _decimate as j_decimate
from isaac_ros_apriltag_tpu.detector import _pad_to_tiles as j_pad
from isaac_ros_apriltag_tpu.ops import resolve as jres
from isaac_ros_apriltag_tpu.ops.ccl import component_sizes as j_component_sizes
from isaac_ros_apriltag_tpu.ops.ccl import connected_components
from isaac_ros_apriltag_tpu.ops.pallas.ccl_fused import ccl_scan_pallas
from isaac_ros_apriltag_tpu.ops.pallas.threshold import adaptive_threshold_pallas
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig, batched_detect_fn
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.ccl import component_sizes
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold

torch.set_num_threads(2)

TAG_SIZE = 0.16


def _speckle(shape=(64, 128), seed=3, ring=False):
    """tests/test_resolve.py's speckle scene, with its nested rings or not."""
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])
    if ring:
        tri[10:80, 12:100] = 255
        tri[14:76, 16:96] = 0
        tri[22:68, 24:88] = 255
    return tri


@functools.lru_cache(maxsize=None)
def _phase1(seed=3, rounds=4, ring=False):
    """(trinary, phase-1 labels of the reference's Pallas scan) on a 64x128
    speckle frame."""
    tri = _speckle(seed=seed, ring=ring)
    lab, _ = ccl_scan_pallas(jnp.asarray(tri), rounds, interpret=True)
    return tri, np.array(lab)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("R,steps,min_px", [(1024, 3, 4), (1024, 1, 25), (8192, 4, 1),
                                            (64, 2, 25)])
def test_flat_resolve_components_bit_exact(R, steps, min_px):
    """Includes an over-capacity case (R=64: n_groups > R, overflow set) and
    a chain too deep for one doubling (steps=1: not converged)."""
    tri, lab = _phase1()
    valid = tri != 127
    a = jres.resolve_components(jnp.asarray(lab), jnp.asarray(valid), min_component_pixels=min_px,
                                max_components=R, chain_steps=steps, with_roots=True)
    b = tres.resolve_components(_t(lab), _t(valid), min_component_pixels=min_px,
                                max_components=R, chain_steps=steps, with_roots=True)
    np.testing.assert_array_equal(np.asarray(a.dense), b.dense.numpy())
    np.testing.assert_array_equal(np.asarray(a.roots), b.roots.numpy())
    assert b.dense.dtype == b.roots.dtype == torch.int32
    assert int(a.n_eligible) == int(b.n_eligible)
    assert bool(a.overflow) == bool(b.overflow)
    assert bool(a.converged) == bool(b.converged)
    if R == 64:
        assert bool(b.overflow)
    c = tres.resolve_components(_t(lab), _t(valid), min_component_pixels=min_px,
                                max_components=R, chain_steps=steps)
    assert c._fields == tres.ResolvedComponents._fields and torch.equal(c.dense, b.dense)


def test_flat_resolve_area_gate_and_overflow():
    """tests/test_resolve.py::test_resolve_area_gate_and_overflow on the
    port's flat mode, against JAX on every field."""
    tri = np.full((32, 128), 127, np.uint8)
    tri[2:6, 2:10] = 0       # 32 px component
    tri[10:12, 2:4] = 0      # 4 px component (gated out at min 25)
    valid = tri != 127
    lab = np.asarray(connected_components(jnp.asarray(tri), 8, 2))
    for R in (1 << 16, 1):
        a = jres.resolve_components(jnp.asarray(lab), jnp.asarray(valid),
                                    min_component_pixels=25, max_components=R)
        b = tres.resolve_components(_t(lab), _t(valid), min_component_pixels=25,
                                    max_components=R)
        np.testing.assert_array_equal(np.asarray(a.dense), b.dense.numpy())
        assert (int(a.n_eligible), bool(a.overflow)) == (int(b.n_eligible), bool(b.overflow))
        assert bool(b.overflow) == (R == 1)
        if R > 1:
            d = b.dense.numpy()
            assert (d[2:6, 2:10] == 0).all() and (d[10:12, 2:4] == tres._KMAX).all()


@pytest.mark.parametrize("R,steps", [(1024, 5), (64, 2), (8192, 1)])
def test_resolve_roots_bit_exact(R, steps):
    tri, lab = _phase1()
    valid = tri != 127
    a = jres.resolve_roots(jnp.asarray(lab), jnp.asarray(valid), max_components=R,
                           chain_steps=steps)
    b = tres.resolve_roots(_t(lab), _t(valid), max_components=R, chain_steps=steps)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_component_sizes_bit_exact():
    tri, lab = _phase1()
    got = component_sizes(_t(lab))
    assert got.dtype == torch.int32 and got.shape == (lab.size,)
    np.testing.assert_array_equal(np.asarray(j_component_sizes(jnp.asarray(lab))), got.numpy())
    batch = np.stack([_phase1(seed)[1] for seed in (3, 4, 5)])
    sizes = component_sizes(_t(batch))
    assert sizes.shape == (3, lab.size) and int(sizes.sum()) == batch.size
    for b in range(3):
        assert torch.equal(sizes[b], component_sizes(_t(batch[b])))


def test_flat_resolve_batched_equals_frames():
    """B = 3 different frames at once equal each frame alone, on every field."""
    frames = [_phase1(seed) for seed in (3, 4, 5)]
    tri = np.stack([f[0] for f in frames])
    lab = _t(np.stack([f[1] for f in frames]))
    valid = _t(tri != 127)
    res = tres.resolve_components(lab, valid, min_component_pixels=4, max_components=1024,
                                  chain_steps=3, with_roots=True)
    roots = tres.resolve_roots(lab, valid, max_components=1024)
    assert res.dense.shape == res.roots.shape == (3, 64, 128) and res.converged.shape == (3,)
    for b in range(3):
        one = tres.resolve_components(lab[b], valid[b], min_component_pixels=4,
                                      max_components=1024, chain_steps=3, with_roots=True)
        for name in one._fields:
            assert torch.equal(getattr(res, name)[b], getattr(one, name)), name
        assert torch.equal(roots[b], tres.resolve_roots(lab[b], valid[b], max_components=1024))


def test_rank_flow_matches_flat_flow():
    """tests/test_resolve.py::test_rank_flow_matches_flat_flow on the port:
    resolve_roots -> phase-2 scan -> flat resolve gives the dense ids of
    resolve_roots_rank -> phase-2 scan -> rank-table resolve."""
    tri, lab1 = _phase1(ring=True)
    tri, lab1, valid = _t(tri), _t(lab1), _t(tri != 127)
    R = 1024
    roots = tres.resolve_roots(lab1, valid, max_components=R)
    lab2f, _ = ccl_scan(tri, 3, backend="torch", label0=roots)
    flat = tres.resolve_components(lab2f, valid, min_component_pixels=4, max_components=R,
                                   chain_steps=3)
    rank_img, table, ovf = tres.resolve_roots_rank(lab1, valid, max_components=R)
    lab2r, _ = ccl_scan(tri, 3, backend="torch", label0=rank_img)
    rank = tres.resolve_components(lab2r, valid, min_component_pixels=4, max_components=R,
                                   chain_steps=3, rank_table=table)
    assert torch.equal(flat.dense, rank.dense)
    assert int(flat.n_eligible) == int(rank.n_eligible)
    assert not bool(ovf)


def test_resolve_rejects_bad_arguments():
    lab = torch.zeros((300, 300), dtype=torch.int32)
    valid = torch.ones((300, 300), dtype=torch.bool)
    with pytest.raises(ValueError, match="65536"):
        tres.resolve_components(lab, valid, min_component_pixels=1, max_components=1 << 17)
    with pytest.raises(ValueError, match="65536"):
        tres.resolve_roots(lab, valid, max_components=1 << 17)
    with pytest.raises(ValueError, match="with_roots"):
        tres.resolve_components(lab, valid, min_component_pixels=1, max_components=64,
                                with_roots=True, rank_table=torch.zeros(64, dtype=torch.int32))


# --- the single-phase detector ------------------------------------------------


def _three_noisy():
    fam = J.get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=5 * i + 2, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=TAG_SIZE))
    return tags


@pytest.fixture(scope="module")
def single_phase():
    """JAX Detector(backend='interpret', ccl_phase2_rounds=0) and the port's
    Detector at the same config on one 480x640 noisy scene."""
    cam_j = J.CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    cam_t = camera_from_reference(np.asarray(cam_j.K), np.asarray(cam_j.dist), 640, 480)
    cfg_j = J.DetectorConfig(backend="interpret", tag_size=TAG_SIZE, ccl_phase2_rounds=0)
    cfg_t = config_from_reference(dataclasses.asdict(cfg_j), backend="torch")
    tags = _three_noisy()
    img = render_tags(np.asarray(cam_j.K), (480, 640), tags, noise=2.0)
    det_t = Detector(cfg_t, cam_t, device="cpu")
    return dict(cfg=cfg_t, tags=tags, img=img, det_t=det_t,
                ref=J.Detector(cfg_j, cam_j).detect_with_stats(img, encoding="mono8"),
                got=det_t.detect_with_stats(img, encoding="mono8"))


def test_single_phase_front_bit_exact(single_phase):
    """Trinary, phase-1 labels and dense ids of the flat flow against the
    reference's Pallas kernels in interpret mode and its flat resolve."""
    cfg, img = single_phase["cfg"], single_phase["img"]
    gray_j = jnp.asarray(img, jnp.float32)
    seg_j = j_pad(j_decimate(gray_j, cfg.quad_decimate), cfg.tile_size)
    tri_j = adaptive_threshold_pallas(seg_j, cfg.tile_size, cfg.min_white_black_diff,
                                      interpret=True)
    lab_j, conv_j = ccl_scan_pallas(tri_j, cfg.ccl_scan_rounds, interpret=True)
    R = cfg.effective_capacities(*tri_j.shape)[1]
    res_j = jres.resolve_components(lab_j, tri_j != 127, min_component_pixels=cfg.min_component_pixels,
                                    max_components=R, chain_steps=cfg.ccl_resolve_steps)

    seg = _pad_to_tiles(_decimate(torch.from_numpy(img).float(), cfg.quad_decimate), cfg.tile_size)
    tri = adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    lab, conv = ccl_scan(tri, cfg.ccl_scan_rounds, backend="torch")
    res = tres.resolve_components(lab, tri != 127, min_component_pixels=cfg.min_component_pixels,
                                  max_components=R, chain_steps=cfg.ccl_resolve_steps)
    np.testing.assert_array_equal(np.asarray(tri_j), tri.numpy())
    np.testing.assert_array_equal(np.asarray(lab_j), lab.numpy())
    assert bool(conv_j) == bool(conv)
    np.testing.assert_array_equal(np.asarray(res_j.dense), res.dense.numpy())
    assert int(res_j.n_eligible) == int(res.n_eligible)
    assert (bool(res_j.overflow), bool(res_j.converged)) == (bool(res.overflow),
                                                            bool(res.converged))


def test_single_phase_detections_match_reference(single_phase):
    (dj, sj), (dt, st) = single_phase["ref"], single_phase["got"]
    rj = {r["id"]: r for r in dj.to_list()}
    rt = {r["id"]: r for r in dt.to_list()}
    assert sorted(rj) == sorted(rt) == sorted(t["id"] for t in single_phase["tags"])
    for i in rj:
        np.testing.assert_allclose(rt[i]["corners"], rj[i]["corners"], atol=0.1)
        np.testing.assert_allclose(rt[i]["translation"], rj[i]["translation"], atol=0.01)
        np.testing.assert_allclose(rt[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
        assert rt[i]["hamming"] == rj[i]["hamming"]
    for f in ("num_edge_points", "num_clusters", "edge_stride", "ccl_converged", "overflow"):
        assert int(getattr(sj, f)) == int(getattr(st, f)), f


def test_single_phase_batched_equals_detector(single_phase):
    """batched_detect_fn at ccl_phase2_rounds=0 on a batch of two frames (the
    scene and an empty one) equals the Detector on each."""
    det_t, img = single_phase["det_t"], single_phase["img"]
    frames = np.stack([img, np.full_like(img, 140)])
    det, stats = batched_detect_fn(det_t.config, det_t.camera, "mono8")(torch.from_numpy(frames))
    for b in range(2):
        d1, s1 = det_t.detect_with_stats(frames[b], encoding="mono8")
        db, sb = det.frame(b), stats.frame(b)
        for f in dataclasses.fields(s1):
            assert torch.equal(getattr(sb, f.name), getattr(s1, f.name)), f.name
        assert torch.equal(db.valid, d1.valid) and torch.equal(db.id, d1.id)
        np.testing.assert_allclose(db.corners[d1.valid].numpy(), d1.corners[d1.valid].numpy(),
                                   atol=1e-3)
    assert det.count.tolist() == [3, 0]
