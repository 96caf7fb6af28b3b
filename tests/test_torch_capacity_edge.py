"""A frame at a capacity edge: distinct frame 23 of torch_bench.py's
node-720p-b1 cell at --seed 1 (720p, the six bench tags with ids 23 + k,
noise seed 24).

Both detectors miss id 59 there: the reference's Pallas flow
(Detector(backend='interpret'), the kernels on the CPU) and the port's
default flow find ids 24, 31, 38, 45 and 52, with the frame over capacity
(overflow) and the scan unconverged. So the miss is the reference's
behaviour on this frame, not a fault of the port. The integer front and the
cluster stage's integer outputs and centroids are equal; the count of
fitted quads differs by one (32 against 31), which the float moments'
documented spread explains (ops/cluster_moments.py): binned with the
reference's f32-summed scale, the port's moments give the reference's count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isaac_ros_apriltag_tpu as J
import torch_bench
from isaac_ros_apriltag_tpu.ops import cluster_moments as jcm
from isaac_ros_apriltag_tpu_torch import Detector
from isaac_ros_apriltag_tpu_torch.convert import config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as tcm
from isaac_ros_apriltag_tpu_torch.ops import quadfit as tqf
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold

torch.set_num_threads(2)

CELL_CONFIG, FRAME, SEED = "tag36h11-720p-node", 23, 1
INT_FIELDS = ("count", "valid", "dark_inside", "centroid", "num_clusters", "num_eligible",
              "num_edge_points", "edge_stride", "overflow")


@pytest.fixture(scope="module")
def edge():
    spec = torch_bench.load_spec()["configs"][CELL_CONFIG]
    cam_t = torch_bench.config_camera(spec)
    _, img = torch_bench.render_frame(cam_t, FRAME, SEED)
    k = spec["camera"]
    cam_j = J.CameraModel.create(fx=k["fx"], fy=k["fy"], cx=k["cx"], cy=k["cy"],
                                 width=spec["width"], height=spec["height"])
    cfg_j = J.DetectorConfig(backend="interpret", **spec["detector"])
    cfg = config_from_reference(dataclasses.asdict(cfg_j), backend="torch")
    ref = J.Detector(cfg_j, cam_j).detect_with_stats(img, encoding="mono8")
    got = Detector(cfg, cam_t, device="cpu").detect_with_stats(img, encoding="mono8")
    # The cluster stage's inputs, through the port's front (held bit-exact
    # with the reference's by tests/test_torch_{front,ccl,resolve}.py).
    seg = _pad_to_tiles(_decimate(torch.from_numpy(img).to(torch.float32), cfg.quad_decimate),
                        cfg.tile_size)
    tri = adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    valid = tri != 127
    E, R = cfg.effective_capacities(*tri.shape)
    lab, _ = ccl_scan(tri, cfg.ccl_scan_rounds, backend="torch")
    rank_img, table, ovf = resolve_roots_rank(lab, valid, max_components=R,
                                              chain_steps=cfg.ccl_contraction_steps)
    lab, _ = ccl_scan(tri, cfg.ccl_phase2_rounds, backend="torch", label0=rank_img)
    res = resolve_components(lab, valid, min_component_pixels=cfg.min_component_pixels,
                             max_components=R, chain_steps=cfg.ccl_resolve_steps,
                             rank_table=table)
    kw = dict(max_edge_points=E, max_clusters=cfg.max_clusters,
              min_cluster_pixels=cfg.min_cluster_pixels,
              max_cluster_points=cfg.max_cluster_points)
    inputs = dict(trinary=tri, dense=res.dense, comp_overflow=res.overflow | ovf)
    mj = jcm.extract_cluster_moments(jnp.asarray(tri.numpy()), jnp.asarray(res.dense.numpy()),
                                     comp_overflow=jnp.asarray(bool(inputs["comp_overflow"])),
                                     **kw)
    return dict(cfg=cfg, ref=ref, got=got, inputs=inputs, kw=kw, mj=mj)


def _quads(cfg, moments) -> int:
    q = tqf.fit_quads_from_moments(moments, min_area=64.0 / cfg.quad_decimate ** 2)
    return int((q.valid & q.dark_inside).sum())


def test_both_miss_the_same_tag(edge):
    (dj, sj), (dt, st) = edge["ref"], edge["got"]
    ids = sorted(r["id"] for r in dt.to_list())
    assert ids == sorted(r["id"] for r in dj.to_list()) == [24, 31, 38, 45, 52]
    for f in ("overflow", "ccl_converged", "num_edge_points", "num_clusters"):
        assert int(getattr(st, f)) == int(getattr(sj, f)), f
    assert bool(st.overflow) and not bool(st.ccl_converged)


def test_cluster_integer_outputs_equal(edge):
    mt = tcm.extract_cluster_moments(**edge["inputs"], **edge["kw"])
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(edge["mj"], f)),
                                      getattr(mt, f).numpy(), err_msg=f)


def test_quad_count_gap_is_the_scale_spread(edge, monkeypatch):
    """The reference fits one quad more; the port's moments binned with the
    reference's scale fit the same count, and the port's fit on the
    reference's moments too."""
    cfg, mj = edge["cfg"], edge["mj"]
    ref_scale = torch.from_numpy(np.array(mj.scale))
    ref_moments = tcm.ClusterMoments(*[torch.from_numpy(np.array(v)) for v in mj])
    assert int(edge["ref"][1].num_quads) == _quads(cfg, ref_moments) == 32
    assert int(edge["got"][1].num_quads) == 31
    stats = tcm._cluster_stats

    def with_ref_scale(ctot64):
        ccx, ccy, _, scale, dark = stats(ctot64)
        s = ref_scale.reshape(scale.shape)
        return ccx, ccy, s * s, s, dark

    monkeypatch.setattr(tcm, "_cluster_stats", with_ref_scale)
    assert _quads(cfg, tcm.extract_cluster_moments(**edge["inputs"], **edge["kw"])) == 32
