"""The oracle flow of the PyTorch port against the JAX package: the
single-phase CCL with pointer jumps (``connected_components``) bit-exact
with JAX's ``ops/ccl.py::connected_components`` and, in padded index space,
with its Pallas flow; the detector at ``ccl_flow='jumps'`` against JAX
``Detector(backend='xla')`` (front bit-exact, the float tail in the
ROADMAP tolerances); the flow through every batched entry point; and the
row-sharded front, which ignores the flow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
from isaac_ros_apriltag_tpu.detector import _decimate as j_decimate
from isaac_ros_apriltag_tpu.detector import _pad_to_tiles as j_pad
from isaac_ros_apriltag_tpu.ops import ccl as jccl
from isaac_ros_apriltag_tpu.ops.pallas.ccl import connected_components_pallas
from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold as j_threshold
from isaac_ros_apriltag_tpu_torch import (Detector, GraphPipeline, RigDetector, StreamingRunner,
                                          batched_detect_fn, build_spatial_front_fn,
                                          connected_components)
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from test_slam_e2e import TAG_SIZE, render_frame

torch.set_num_threads(2)

# JAX's connected_components, compiled once per shape and schedule (eager,
# its associative scans compile op by op, at many times the cost).
_jax_cc = jax.jit(jccl.connected_components, static_argnums=(1, 2, 3),
                  static_argnames=("with_convergence",))


def _ring_speckle(shape=(96, 128), seed=3):
    """tests/test_pallas.py::test_ccl_parity's frame: speckle at percolation
    density and three nested rings."""
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])
    tri[10:min(80, shape[0] - 4), 12:min(100, shape[1] - 4)] = 255
    tri[14:min(76, shape[0] - 8), 16:min(96, shape[1] - 8)] = 0
    tri[22:min(68, shape[0] - 16), 24:min(88, shape[1] - 16)] = 255
    return tri


def _two_blobs():
    img = np.full((32, 32), 127, np.uint8)
    img[2:10, 2:10] = 255
    img[20:30, 20:30] = 255
    img[2:10, 20:30] = 0
    return img


def _concave():
    img = np.full((24, 24), 127, np.uint8)
    img[4:20, 4:8] = 0
    img[16:20, 4:20] = 0
    img[4:20, 16:20] = 0
    return img


def _ring():
    img = np.full((64, 64), 127, np.uint8)
    img[8:56, 8:56] = 0
    img[12:52, 12:52] = 127
    return img


def _percolation():
    rng = np.random.default_rng(7)
    return rng.choice(np.array([0, 127, 255], np.uint8), size=(96, 96), p=[0.35, 0.3, 0.35])


# (frame, rounds, jumps): tests/test_pallas.py:49-73 and tests/test_ops.py:34-95.
CASES = {
    "ring_speckle": (_ring_speckle, 16, 2),
    "two_blobs": (_two_blobs, 4, 2),
    "concave": (_concave, 6, 2),
    "ring": (_ring, 6, 2),
    "percolation": (_percolation, 8, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_connected_components_matches_reference(case):
    make, rounds, jumps = CASES[case]
    tri = make()
    want = np.asarray(_jax_cc(jnp.asarray(tri), rounds, jumps))
    got = connected_components(torch.from_numpy(tri), rounds, jumps, backend="torch")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounds,jumps,jump_every",
                         [(5, 0, 1), (5, 2, 1), (5, 3, 2), (6, 2, 4), (7, 3, 4), (16, 2, 2)])
def test_connected_components_jump_schedule_and_convergence(rounds, jumps, jump_every):
    """Jumps 0/2/3 every 1/2/4 rounds, before convergence and after it, with
    with_convergence: JAX's labels and flag."""
    tri = _ring_speckle()
    lab_j, conv_j = _jax_cc(jnp.asarray(tri), rounds, jumps, jump_every, with_convergence=True)
    lab, conv = connected_components(torch.from_numpy(tri), rounds, jumps, jump_every,
                                     backend="torch", with_convergence=True)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    assert bool(conv) == bool(conv_j)


def test_connected_components_batch_equals_frames():
    """A batch of three different frames equals each frame alone and JAX's
    labels of each frame: the jumps gather stays inside its frame."""
    frames = np.stack([_ring_speckle(seed=s) for s in (3, 4, 5)])
    lab, conv = connected_components(torch.from_numpy(frames), 5, 2, 2, backend="torch",
                                     with_convergence=True)
    assert lab.shape == frames.shape and conv.shape == (3,)
    for b in range(3):
        one, conv1 = connected_components(torch.from_numpy(frames[b]), 5, 2, 2, backend="torch",
                                          with_convergence=True)
        want, conv_j = _jax_cc(jnp.asarray(frames[b]), 5, 2, 2, with_convergence=True)
        np.testing.assert_array_equal(lab[b].numpy(), one.numpy())
        np.testing.assert_array_equal(lab[b].numpy(), np.asarray(want))
        assert bool(conv[b]) == bool(conv1) == bool(conv_j)


def test_jumps_in_unpadded_space_match_padded_pallas():
    """The reference's Pallas flow jumps in padded flat-index space; the
    port jumps in unpadded space. On a frame that the Pallas flow pads
    (37x50) and before convergence, the labels are the same."""
    tri = _ring_speckle(shape=(37, 50), seed=9)
    want = np.asarray(connected_components_pallas(jnp.asarray(tri), 3, 2, 1, interpret=True))
    got = connected_components(torch.from_numpy(tri), 3, 2, 1, backend="torch")
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, np.asarray(_jax_cc(jnp.asarray(tri), 16, 2, 1))), \
        "3 rounds must stop short of convergence"


def test_connected_components_rejects_bad_arguments():
    tri = torch.from_numpy(_two_blobs())
    with pytest.raises(ValueError, match="rounds"):
        connected_components(tri, 0, 2, backend="torch")
    with pytest.raises(ValueError, match="label0"):
        connected_components(tri, 2, 2, backend="torch", label0=torch.zeros_like(tri, dtype=torch.int32))
    with pytest.raises(ValueError, match="backend"):
        connected_components(tri, 2, 2, backend="xla")


@pytest.fixture(scope="module")
def oracle():
    """JAX Detector(backend='xla') and the port's Detector(ccl_flow='jumps')
    on frame 1 of tests/test_slam_e2e.py's orbit (480x640, six tags)."""
    cam_j = J.CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    cam_t = camera_from_reference(np.asarray(cam_j.K), np.asarray(cam_j.dist), 640, 480)
    cfg_j = J.DetectorConfig(backend="xla", tag_size=TAG_SIZE)
    cfg_t = config_from_reference(dataclasses.asdict(cfg_j), backend="torch")
    img = render_frame(cam_j, 1)
    det_t = Detector(cfg_t, cam_t, device="cpu")
    return dict(cfg=cfg_t, img=img, det_t=det_t,
                ref=J.Detector(cfg_j, cam_j).detect_with_stats(img, encoding="mono8"),
                got=det_t.detect_with_stats(img, encoding="mono8"))


def test_jumps_flow_front_bit_exact(oracle):
    """Trinary, labels and converged of the jumps flow against the
    reference's xla front."""
    cfg, img = oracle["cfg"], oracle["img"]
    seg_j = j_pad(j_decimate(jnp.asarray(img, jnp.float32), cfg.quad_decimate), cfg.tile_size)
    tri_j = j_threshold(seg_j, cfg.tile_size, cfg.min_white_black_diff)
    lab_j, conv_j = _jax_cc(tri_j, cfg.ccl_rounds, cfg.ccl_jumps, cfg.ccl_jump_every,
                            with_convergence=True)
    seg = _pad_to_tiles(_decimate(torch.from_numpy(img).float(), cfg.quad_decimate), cfg.tile_size)
    tri = adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    lab, conv = connected_components(tri, cfg.ccl_rounds, cfg.ccl_jumps, cfg.ccl_jump_every,
                                     backend="torch", with_convergence=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(tri_j))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    assert bool(conv) == bool(conv_j)
    assert bool(oracle["got"][1].ccl_converged) == bool(oracle["ref"][1].ccl_converged)


def test_jumps_flow_detections_match_reference(oracle):
    (dj, sj), (dt, st) = oracle["ref"], oracle["got"]
    rj = {r["id"]: r for r in dj.to_list()}
    rt = {r["id"]: r for r in dt.to_list()}
    assert sorted(rj) == sorted(rt) == [1, 4, 7, 10, 13, 16]
    for i in rj:
        np.testing.assert_allclose(rt[i]["corners"], rj[i]["corners"], atol=0.1)
        np.testing.assert_allclose(rt[i]["translation"], rj[i]["translation"], atol=0.01)
        np.testing.assert_allclose(rt[i]["quaternion"], rj[i]["quaternion"], atol=0.01)
        assert rt[i]["hamming"] == rj[i]["hamming"]
    for f in ("num_edge_points", "num_clusters", "edge_stride", "ccl_converged", "overflow"):
        assert int(getattr(sj, f)) == int(getattr(st, f)), f


def test_jumps_flow_through_batched_entry_points(oracle):
    """batched_detect_fn, RigDetector, GraphPipeline (no distortion, no
    downscale) and StreamingRunner at ccl_flow='jumps' equal the Detector
    frame by frame, on the scene and an empty frame."""
    det_t, img = oracle["det_t"], oracle["img"]
    cfg, cam = det_t.config, det_t.camera
    frames = np.stack([img, np.full_like(img, 140)])
    singles = [det_t.detect_with_stats(f, encoding="mono8") for f in frames]
    outs = {
        "batched": batched_detect_fn(cfg, cam, "mono8")(torch.from_numpy(frames)),
        "rig": RigDetector(cfg, cam, 2, device="cpu").detect(frames),
        "graph": GraphPipeline(cfg, cam, encoding="mono8", device="cpu").batched(
            torch.from_numpy(frames)),
    }
    streamed = list(StreamingRunner(lambda x: det_t.detect_with_stats(x, "mono8"), 2,
                                    device="cpu").run(list(frames)))
    for name, (det, stats) in outs.items():
        for b, (d1, s1) in enumerate(singles):
            db, sb = det.frame(b), stats.frame(b)
            for f in dataclasses.fields(s1):
                assert torch.equal(getattr(sb, f.name), getattr(s1, f.name)), (name, f.name)
            assert torch.equal(db.valid, d1.valid) and torch.equal(db.id, d1.id), name
            np.testing.assert_allclose(db.corners[d1.valid].numpy(),
                                       d1.corners[d1.valid].numpy(), atol=1e-3)
    for (ds, ss), (d1, s1) in zip(streamed, singles):
        assert torch.equal(ds.id, d1.id) and torch.equal(ss.num_detections, s1.num_detections)
    assert outs["batched"][0].count.tolist() == [6, 0]


def test_spatial_front_ignores_ccl_flow(oracle):
    """The row-sharded front runs its own scan rounds, no jumps, whatever
    ccl_flow says, as the reference's does whatever its backend."""
    det_t, img = oracle["det_t"], oracle["img"]
    frame = torch.from_numpy(img)
    scan = dataclasses.replace(det_t.config, ccl_flow="scan")
    tri_j, lab_j = build_spatial_front_fn(det_t.config, det_t.camera, 4)(frame)
    tri_s, lab_s = build_spatial_front_fn(scan, det_t.camera, 4)(frame)
    assert torch.equal(tri_j, tri_s) and torch.equal(lab_j, lab_s)
