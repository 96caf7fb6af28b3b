"""The detection tail's refinement, quad-fit epilogue and per-frame picks:
the plain versions of csrc/tail.cu's refine_kernel (the top-2T pick and
refine in one launch, ops/tail.py::select_and_refine, and its two halves,
select_candidates and ops/refine.py::refine_edges) and tail_finish_kernel
and of the epilogue of csrc/quadfit.cu's fitting launch, on the CPU.

Each plain version (ops/refine.py::refine_edges, ops/quadfit.py::
fit_epilogue, ops/tail.py::select_candidates and finish_detections) is
held to the parent's torch form (chip_smoke.py's parent_*_form, kept as the
yardstick) and to the JAX package's code through jax.jit, on chip_smoke.py
phase 27's synthetic cases (NaN and inf corners, no valid quad, tied scores
and margins, duplicate ids at equal margins, max_tags < C/2, quad_decimate
1 and 3, a batch of 3) and on rendered frames; refine also at search
ranges 7.5 and 40 (profiles past the kernel's staged chunk) and on quads
across the frame's edges, against JAX. Ids, indices and every
boolean are exact. Coordinates agree with the parent's form within 1e-5 px
or 5e-7 of their size (one float32 ulp is 3e-5 at 300 px, and the two sum
in other orders), and with JAX at tests/test_torch_tail.py's tolerances
(refine 1e-3 px, quad corners 0.1 px). The whole tail, from the moments
of rendered frames to Detections and FrameStats, is held to the JAX
package's own _detect_from_clusters at tests/test_torch_detector.py's
gates. A batch equals each frame alone. A numpy mirror of
tail_finish_kernel's mask formulation (the dedupe and rank over the
valid candidates' set bits, a -inf candidate ranked by counts) equals
finish_detections on those cases and on chip_smoke.FINISH_CASE_NAMES
(+-inf and NaN margins, a gate of -inf, one id on 128 valid candidates,
N 100 with k 7, NaN edges), which the plain version also holds to JAX. A
numpy mirror of select_rank (the pick's rank over the masks of the quads
scored above -inf) equals select_candidates on the synthetic cases, and
the pick and refine equals JAX's pick, then its refine. The wrappers run
the plain versions on CPU tensors, launch nothing, and refuse what their
kernels do not take."""

import dataclasses
import functools
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import isaac_ros_apriltag_tpu as J
from chip_smoke import GLUE_CASE_NAMES, glue_synthetic, refine_synthetic, tail_frame
from isaac_ros_apriltag_tpu import detector as jdet
from isaac_ros_apriltag_tpu.ops import cluster_moments as jcm
from isaac_ros_apriltag_tpu.ops import pose as jpose
from isaac_ros_apriltag_tpu.ops import quadfit as jqf
from isaac_ros_apriltag_tpu.ops import refine as jref
from isaac_ros_apriltag_tpu.utils import geometry as jgeo
from isaac_ros_apriltag_tpu_torch.config import DetectorConfig
from isaac_ros_apriltag_tpu_torch.convert import camera_from_reference, config_from_reference
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _detect_from_clusters, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as tcm
from isaac_ros_apriltag_tpu_torch.ops import pose as tpose
from isaac_ros_apriltag_tpu_torch.ops import quadfit as tqf
from isaac_ros_apriltag_tpu_torch.ops import refine as tref
from isaac_ros_apriltag_tpu_torch.ops import tail as ttail
from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib, launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as quadfit_kernel
from isaac_ros_apriltag_tpu_torch.ops.cuda import refine as refine_kernel
from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tail_kernels
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.decode import DecodeResult
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold

torch.set_num_threads(2)

SYNTHETIC = GLUE_CASE_NAMES[len(chip_smoke.CAPTURE_CASES):]
PX_ATOL, PX_RTOL = 1e-5, 5e-7        # against the parent's form
STAGES = {"select_refine": ttail.select_and_refine, "refine": tref.refine_edges,
          "tail_select": ttail.select_candidates, "tail_finish": ttail.finish_detections}


@functools.lru_cache(maxsize=None)
def case(name: str) -> dict:
    return glue_synthetic(name, torch.device("cpu"))


FINISH_CASES = SYNTHETIC + chip_smoke.FINISH_CASE_NAMES


@functools.lru_cache(maxsize=None)
def finish_case(name: str) -> tuple:
    if name in chip_smoke.FINISH_CASE_NAMES:
        return chip_smoke.finish_synthetic(name, torch.device("cpu"))["tail_finish"]
    return case(name)["tail_finish"]


def fields(x) -> tuple:
    return tuple(x) if isinstance(x, tuple) else (x,)


def assert_px_close(got, want, what=""):
    """Float fields within PX_ATOL + PX_RTOL |want| (NaN where NaN, inf
    where inf); every other field exact."""
    for i, (a, b) in enumerate(zip(fields(got), fields(want))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=PX_RTOL, atol=PX_ATOL, err_msg=f"{what} {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {i}")


def assert_same(got, want):
    """Bit for bit (NaN equal to NaN)."""
    for a, b in zip(fields(got), fields(want)):
        assert chip_smoke._same(a, b)


# --- the plain versions against the parent's torch form ---------------------

@pytest.mark.parametrize("name", SYNTHETIC)
def test_refine_plain_equals_parent_form(name):
    args, kw = case(name)["refine"]
    got = tref.refine_edges(*args, **kw)
    assert_px_close(got, chip_smoke.parent_refine_form(*args, **kw), name)
    moved = (got - args[1]).abs().nan_to_num(0.0).amax((-2, -1))
    assert (moved[:, 0] > 0).all(), "the tag's quad is refined"


@pytest.mark.parametrize("name", SYNTHETIC)
def test_select_plain_equals_parent_form(name):
    args, kw = case(name)["tail_select"]
    got = ttail.select_candidates(*args, **kw)
    assert_px_close(got, chip_smoke.parent_select_form(*args, **kw), name)
    if name == "no valid quad":
        assert not got.pre_valid.any() and (got.num_quads == 0).all()
    else:
        assert got.pre_valid.any()


@pytest.mark.parametrize("name", SYNTHETIC)
def test_finish_plain_equals_parent_form(name):
    args, kw = case(name)["tail_finish"]
    got = ttail.finish_detections(*args, **kw)
    assert_px_close(got, chip_smoke.parent_finish_form(*args, **kw), name)
    assert torch.equal(got.num_detections, got.valid.sum(-1).to(torch.int32))
    if name == "no valid quad":
        assert not got.valid.any()


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("name", ["a batch of 3 frames", "NaN and inf corners"])
def test_batch_equals_each_frame_alone(stage, name):
    args, kw = case(name)[stage]
    got = STAGES[stage](*args, **kw)
    B = fields(got)[0].shape[0]
    for b in range(B):
        one = STAGES[stage](*chip_smoke._frame_of(args, b), **kw)
        for x, y in zip(fields(one), fields(got)):
            assert chip_smoke._same(x, y[b:b + 1]), (stage, b)


def test_select_ties_go_to_the_lower_index():
    """Equal scores (integer squares, fit errors in quarters) keep their
    index order, and NaN scores come first, as torch.sort(stable=True) and
    lax.top_k take them."""
    corners = torch.tensor([[[0, 0], [8, 0], [8, 8], [0, 8]]], dtype=torch.float32)
    corners = (corners + torch.arange(6.0)[:, None, None] * 10)[None]     # (1, 6, 4, 2)
    corners[0, 4, 1, 0] = torch.nan
    valid = torch.ones((1, 6), dtype=torch.bool)
    fit_err = torch.tensor([[0.5, 0.25, 0.5, 0.25, 0.0, 0.5]])
    got = ttail.select_candidates(corners, valid, valid, fit_err, want_dark=True, k=5,
                                  decimate=1)
    # Scores 32/1.5, 32/1.25, 32/1.5, 32/1.25, NaN, 32/1.5: NaN, then 1, 3, then 0, 2
    # (quad i has its first corner at (10 i, 10 i)).
    assert got.corners[0, :, 0, 1].tolist() == [40.0, 10.0, 30.0, 0.0, 20.0]
    assert got.pre_valid[0].tolist() == [False, True, True, True, True]
    assert int(got.num_quads[0]) == 6


def test_finish_duplicate_ids_keep_the_lower_index():
    """Two candidates of one id, near each other, at equal margins: the one
    at the lower index stays; at a larger margin the later one wins."""
    sq = torch.tensor([[0, 0], [40, 0], [40, 40], [0, 40]], dtype=torch.float32)
    corners = torch.stack([sq, sq + 2.0, sq + 100.0])[None]
    ones = torch.ones((1, 3), dtype=torch.bool)
    for margins, kept in (([20.0, 20.0, 15.0], [0, 2]), ([20.0, 25.0, 15.0], [1, 2])):
        dec = DecodeResult(valid=ones, id=torch.tensor([[7, 7, 7]], dtype=torch.int32),
                           hamming=torch.zeros((1, 3), dtype=torch.int32),
                           margin=torch.tensor([margins]),
                           rotation=torch.zeros((1, 3), dtype=torch.int32), corners=corners)
        got = ttail.finish_detections(dec, ones, torch.tensor([3], dtype=torch.int32),
                                      torch.tensor([False]), k=3, min_decision_margin=10.0)
        want = corners[0, kept]
        order = sorted(range(len(kept)), key=lambda i: -margins[kept[i]])
        assert got.valid[0].tolist() == [True, True, False]
        assert torch.equal(got.corners[0, :2], want[order])
        assert int(got.num_detections[0]) == 2 and not bool(got.overflow[0])


def test_epilogue_plain_equals_parent_form():
    """The plain fit (search_plain, then fit_epilogue) against the parent's
    torch epilogue on chip_smoke.py phase 25's synthetic clusters (ties,
    few candidates, bin 63, an empty slot, NaN and inf) and on the clusters
    of two rendered frames."""
    for m in (chip_smoke.quadfit_synthetic(torch.device("cpu")), scene_moments()):
        for min_area in (16.0, 64.0 / 9):
            got = tqf.fit_quads_from_moments(m, min_area=min_area)
            assert_px_close(got, chip_smoke.parent_fit_form(m, min_area=min_area))
        assert got.gates.any() and not got.gates.all()
    assert got.valid.any()


# --- the plain versions against the JAX package -----------------------------

def _frames(seeds):
    """tail_frame's one-tag frames, their quads with the tag's moved ~0.7
    px, and a dark inside for each quad."""
    frames = [tail_frame("tag36h11", seed=s) for s in seeds]
    rng = np.random.default_rng(7)
    quads = np.stack([q for _, q in frames])
    quads[:, 0] += rng.normal(0, 0.7, quads[:, 0].shape).astype(np.float32)
    dark = np.ones(quads.shape[:2], bool)
    dark[:, 1:] = rng.random((len(seeds), quads.shape[1] - 1)) < 0.5
    return np.stack([g for g, _ in frames]), quads, dark


@pytest.mark.parametrize("decimate", [1, 2, 3])
def test_refine_matches_reference(decimate):
    """search_range = quad_decimate + 1: profiles of 13, 17 and 21 samples."""
    gray, quads, dark = _frames((0, 1))
    sr = decimate + 1.0
    ref = jax.jit(jax.vmap(lambda g, c, d: jref.refine_edges(g, c, d, search_range=sr)))
    want = np.asarray(ref(jnp.asarray(gray), jnp.asarray(quads), jnp.asarray(dark)))
    got = tref.refine_edges(torch.from_numpy(gray), torch.from_numpy(quads),
                            torch.from_numpy(dark), search_range=sr).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert (np.abs(got[:, 0] - quads[:, 0]).max((-2, -1)) > 0.05).all()


def test_refine_long_range_matches_reference():
    """search_range 7.5: profiles of 35 samples, past the 24 that
    refine_kernel stages at once."""
    gray, quads, dark = _frames((0, 1))
    ref = jax.jit(jax.vmap(lambda g, c, d: jref.refine_edges(g, c, d, search_range=7.5)))
    want = np.asarray(ref(jnp.asarray(gray), jnp.asarray(quads), jnp.asarray(dark)))
    got = tref.refine_edges(torch.from_numpy(gray), torch.from_numpy(quads),
                            torch.from_numpy(dark), search_range=7.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert (np.abs(got[:, 0] - quads[:, 0]).max((-2, -1)) > 0.05).all()


@pytest.mark.parametrize("name", ["search range 40", "profiles leaving the frame"])
def test_refine_only_cases_match_reference(name):
    """chip_smoke.py phase 27's refine-only cases: 165 samples a profile,
    and quads across the frame's edges."""
    (gray, corners, dark), kw = refine_synthetic(name, torch.device("cpu"))["refine"]
    ref = jax.jit(jax.vmap(lambda g, c, d: jref.refine_edges(g, c, d, **kw)))
    want = np.asarray(ref(*(jnp.asarray(t.numpy()) for t in (gray, corners, dark))))
    got = tref.refine_edges(gray, corners, dark, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("P", [0, 7, 13, 17, 21, 24, 25, 48, 165])
def test_refine_kernel_stages_each_sample_once(P):
    """csrc/tail.cu::refine_kernel's staging, in Python: chunks of up to
    REFINE_CHUNK samples a point, lane l holding i = l + 32 r of a chunk's
    12 len samples (sample j of point s at i = 12 j + s), REFINE_ROUNDS
    rounds a lane; every (point, sample) of the profile is staged once, and
    lanes 0-11 read them back in j order."""
    with open(os.path.join(_lib._CSRC, "tail.cu")) as f:
        src = f.read()
    chunk = int(re.search(r"constexpr int REFINE_CHUNK = (\d+);", src).group(1))
    rounds = 12 * chunk // 32
    seen = []
    for j0 in range(0, P, chunk):
        ln = min(chunk, P - j0)
        staged = {}
        for lane in range(32):
            for r in range(rounds):
                i = lane + 32 * r
                if i < 12 * ln:
                    assert (i % 12, i // 12) not in staged
                    staged[(i % 12, i // 12)] = (i % 12, j0 + i // 12)
        assert len(staged) == 12 * ln
        seen += [staged[(s, jj)] for s in range(12) for jj in range(ln)]
    assert sorted(seen) == [(s, j) for s in range(12) for j in range(P)]


@pytest.mark.parametrize("name", ["NaN and inf corners", "quad_decimate 3"])
def test_refine_cases_match_reference(name):
    (gray, corners, dark), kw = case(name)["refine"]
    ref = jax.jit(jax.vmap(lambda g, c, d: jref.refine_edges(g, c, d, **kw)))
    want = np.asarray(ref(*(jnp.asarray(t.numpy()) for t in (gray, corners, dark))))
    got = tref.refine_edges(gray, corners, dark, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


@functools.lru_cache(maxsize=None)
def scene_moments():
    """The port's plain cluster moments of a batch of two one-tag frames
    (the front on backend 'torch', quad_decimate 2)."""
    gray, _, _ = _frames((3, 4))
    cfg = DetectorConfig(backend="torch")
    seg = _pad_to_tiles(_decimate(torch.from_numpy(gray), 2), 4)
    tri = adaptive_threshold(seg, 4, 5)
    valid = tri != 127
    _, R = cfg.effective_capacities(*tri.shape[-2:])
    lab, _ = ccl_scan(tri, 8, backend="torch")
    rank_img, table, _ = resolve_roots_rank(lab, valid, max_components=R)
    lab, _ = ccl_scan(tri, 6, backend="torch", label0=rank_img)
    res = resolve_components(lab, valid, min_component_pixels=25, max_components=R,
                             chain_steps=3, rank_table=table)
    E = cfg.effective_capacities(*tri.shape[-2:])[0]
    return tcm.extract_cluster_moments(tri, res.dense, comp_overflow=torch.zeros(2, dtype=bool),
                                       max_edge_points=E, max_clusters=128,
                                       min_cluster_pixels=24, max_cluster_points=1024)


def test_fit_matches_reference():
    """The plain fit against the JAX package's fit_quads_from_moments on the
    same moments, frame by frame: validity exact; on the quads valid in
    either, gates exact and corners within 0.1 px; the gates of at most 2%
    of the other (noise) clusters may differ, where a near-collinear
    corner's angle or area gate turns on less than the two packages' sums
    in other orders (tests/test_torch_quadfit.py::NOISE_SHARE; measured 2
    of 256)."""
    m = scene_moments()
    got = tqf.fit_quads_from_moments(m, min_area=16.0)
    fit = jax.jit(lambda mm: jqf.fit_quads_from_moments(mm, min_area=16.0))
    n_differ = 0
    for b in range(2):
        want = fit(jcm.ClusterMoments(*(jnp.asarray(x[b].numpy()) for x in m)))
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid[b].numpy(), v)
        assert v.sum() >= 1
        same = (got.gates[b].numpy() == np.asarray(want.gates)).all(-1)
        assert same[v].all()
        n_differ += int((~same).sum())
        np.testing.assert_allclose(got.corners[b].numpy()[v], np.asarray(want.corners)[v],
                                   atol=0.1)
    assert n_differ <= 0.02 * got.valid.numel()


def _jax_select(corners, valid, dark, fit_err, *, want_dark, k, decimate):
    """isaac_ros_apriltag_tpu/detector.py:230-245 on one frame."""
    qvalid = valid & (dark == want_dark)
    perim = jnp.sum(jnp.linalg.norm(corners - jnp.roll(corners, 1, 1), axis=-1), axis=-1)
    top_qs, top_i = jax.lax.top_k(jnp.where(qvalid, perim / (1.0 + fit_err), -jnp.inf), k)
    return (jdet._upscale_coords(corners[top_i], decimate), dark[top_i], jnp.isfinite(top_qs),
            jnp.sum(qvalid.astype(jnp.int32)))


def _jax_finish(dvalid, ids, ham, margin, corners, pre_valid, n_quads, overflow, *, k,
                min_decision_margin):
    """isaac_ros_apriltag_tpu/detector.py:254-310 on one frame: the dedupe
    (_dedupe), the top-k by margin, the takes, the center and the counts."""
    dec_valid = jdet._dedupe(pre_valid & dvalid & (margin >= min_decision_margin), ids,
                             margin, corners)
    top_fs, top_f = jax.lax.top_k(jnp.where(dec_valid, margin, -jnp.inf), k)
    sel_valid = jnp.isfinite(top_fs)
    sel = corners[top_f]
    center = jgeo.line_intersection(sel[:, 0], sel[:, 2] - sel[:, 0], sel[:, 1],
                                    sel[:, 3] - sel[:, 1])
    return (sel_valid, jnp.where(sel_valid, ids[top_f], -1), ham[top_f], margin[top_f], center,
            sel, jnp.sum(sel_valid.astype(jnp.int32)),
            overflow | (n_quads > pre_valid.shape[0]))


@pytest.mark.parametrize("name", SYNTHETIC)
def test_select_matches_reference(name):
    (corners, valid, dark, fit_err), kw = case(name)["tail_select"]
    ref = jax.jit(jax.vmap(functools.partial(_jax_select, **kw)))
    want = ref(*(jnp.asarray(t.numpy()) for t in (corners, valid, dark, fit_err)))
    got = ttail.select_candidates(corners, valid, dark, fit_err, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5,
                                   err_msg=f"{name} {got._fields[i]}")


@pytest.mark.parametrize("name", SYNTHETIC)
def test_select_and_refine_matches_reference(name):
    """The detect path's pick and refine (ops/tail.py::select_and_refine,
    the plain version of refine_kernel) against the JAX package's
    pick, then its refine_edges, of the 128 quads on the one-tag frames:
    the picks exact, the refined corners within 1e-3 px."""
    (gray, corners, valid, dark, fit_err), kw = case(name)["select_refine"]
    skw = {k: v for k, v in kw.items() if k != "search_range"}
    jsel = jax.jit(jax.vmap(functools.partial(_jax_select, **skw)))
    jc, jd, jpre, jn = jsel(*(jnp.asarray(t.numpy()) for t in (corners, valid, dark, fit_err)))
    ref = jax.jit(jax.vmap(lambda g, c, d: jref.refine_edges(g, c, d,
                                                             search_range=kw["search_range"])))
    want = np.asarray(ref(jnp.asarray(gray.numpy()), jc, jd))
    got = ttail.select_and_refine(gray, corners, valid, dark, fit_err, **kw)
    np.testing.assert_array_equal(got.pre_valid.numpy(), np.asarray(jpre), err_msg=name)
    np.testing.assert_array_equal(got.num_quads.numpy(), np.asarray(jn), err_msg=name)
    np.testing.assert_allclose(got.corners.numpy(), want, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("name", FINISH_CASES)
def test_finish_matches_reference(name):
    (dec, pre_valid, n_quads, overflow), kw = finish_case(name)
    ref = jax.jit(jax.vmap(functools.partial(_jax_finish, **kw)))
    want = ref(*(jnp.asarray(t.numpy()) for t in (
        dec.valid, dec.id, dec.hamming, dec.margin, dec.corners, pre_valid, n_quads, overflow)))
    got = ttail.finish_detections(dec, pre_valid, n_quads, overflow, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4,
                                   err_msg=f"{name} {got._fields[i]}")


def test_tail_matches_reference_detect_from_clusters():
    """The port's tail on backend 'torch' (detector.py::_detect_from_clusters:
    fit, select, refine, decode, finish, pose) against the JAX package's
    _detect_from_clusters, jitted, on the same moments of two rendered
    one-tag frames, so no step is a transcription made for the test. Ids
    (-1 past the detections), validity and every FrameStats field are
    exact; on the detections, hamming is exact, corners and
    centers within 0.1 px, translation within 1 cm and quaternion within
    0.01 (tests/test_torch_detector.py's gates), the margin as
    tests/test_torch_tail.py's decode."""
    m = scene_moments()
    gray, _, _ = _frames((3, 4))
    H, W = gray.shape[-2:]
    K = np.array(chip_smoke.TAIL_K, np.float32)
    cfg_j = J.DetectorConfig(tag_size=chip_smoke.TAIL_TAG_SIZE)
    cam_j = J.CameraModel.create(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W,
                                 height=H)
    cfg_t = config_from_reference(dataclasses.asdict(cfg_j), backend="torch")
    cam_t = camera_from_reference(np.asarray(cam_j.K), np.asarray(cam_j.dist), W, H)
    got, got_stats = _detect_from_clusters(cfg_t, cam_t, get_family("tag36h11"),
                                           torch.from_numpy(gray), m,
                                           torch.ones(2, dtype=torch.bool))
    fam_j = J.get_family("tag36h11")
    ref = jax.jit(lambda g, cl: jdet._detect_from_clusters(cfg_j, cam_j, fam_j, g, cl,
                                                           jnp.asarray(True)))
    for b in range(2):
        want, want_stats = ref(jnp.asarray(gray[b]),
                               jcm.ClusterMoments(*(jnp.asarray(x[b].numpy()) for x in m)))
        v = np.asarray(want.valid)
        assert v.sum() >= 1
        for f in ("valid", "id"):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(got.hamming[b].numpy()[v], np.asarray(want.hamming)[v])
        for f, atol in (("corners", 0.1), ("center", 0.1), ("translation", 0.01),
                        ("quaternion", 0.01)):
            np.testing.assert_allclose(getattr(got, f)[b].numpy()[v],
                                       np.asarray(getattr(want, f))[v], atol=atol, err_msg=f)
        np.testing.assert_allclose(got.decision_margin[b].numpy()[v],
                                   np.asarray(want.decision_margin)[v], rtol=1e-4, atol=1e-3)
        for f in (f.name for f in dataclasses.fields(got_stats)):
            assert int(getattr(got_stats, f)[b]) == int(getattr(want_stats, f)), f


@pytest.mark.parametrize("name", ["a batch of 3 frames", "quad_decimate 3"])
def test_refine_bound_reads_each_pixel_once(name):
    """chip_smoke.py's byte bound of refine_kernel (the pick and refine)
    counts each pixel the picked quads' samples' taps read once: the plain
    bilinear taps of an image that holds each pixel's own index name the
    same pixels, and they are fewer than four taps a sample; the quads and
    the outputs once each."""
    args, kw = case(name)["select_refine"]
    got = ttail.select_and_refine(*args, **kw)
    gray, *quads = args
    picked = ttail.select_candidates(
        *quads, **{k: v for k, v in kw.items() if k != "search_range"}).corners
    B, H, W = gray.shape
    index = torch.arange(B * H * W, dtype=torch.float64).view(B, H, W)
    taps = tref.bilinear_taps(index, *tref.sample_points(picked, kw["search_range"]))[:4]
    pixels = torch.unique(torch.stack(taps)).numel()
    rest = sum(t.numel() * t.element_size() for t in (*quads, *got))
    assert chip_smoke.select_refine_bytes(args, kw, got) == pixels * 4 + rest
    assert pixels < taps[0].numel() * 4


# --- the finish kernel's mask formulation, in numpy --------------------------

def _finish_mirror(dec, pre_valid, num_quads, overflow, *, k, min_decision_margin,
                   rank_valid=False):
    """tail_finish_kernel in numpy, frame by frame: the valid candidates as
    four 32-bit masks; the dedupe walking their set bits in index order; the
    rank of a candidate scored above -inf by compares over those only, of any
    other by their count plus its -inf predecessors; then the top-k's
    fields, center and counts. With `rank_valid` (a wrong mirror) every
    valid candidate is ranked by compares, -inf scores too."""
    from isaac_ros_apriltag_tpu_torch.utils.geometry import line_intersection

    c = dec.corners.numpy()
    m, ids = dec.margin.numpy(), dec.id.numpy()
    B, N = m.shape
    K = min(k, N)
    f32 = np.float32
    v = pre_valid.numpy() & dec.valid.numpy() & (m >= f32(min_decision_margin))
    pick = np.zeros((B, K), np.int64)
    scores = np.zeros((B, K), f32)
    with np.errstate(invalid="ignore", over="ignore"):
        cx = (((c[..., 0, 0] + c[..., 1, 0]) + c[..., 2, 0]) + c[..., 3, 0]) * f32(0.25)
        cy = (((c[..., 0, 1] + c[..., 1, 1]) + c[..., 2, 1]) + c[..., 3, 1]) * f32(0.25)
        e = c - np.roll(c, 1, -2)
        n = np.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])
        edge = (((n[..., 0] + n[..., 1]) + n[..., 2]) + n[..., 3]) * f32(0.25)
        for b in range(B):
            masks = [sum(1 << L for L in range(32) if 32 * u + L < N and v[b, 32 * u + L])
                     for u in range(4)]
            bits = [32 * u + L for u in range(4) for L in range(32) if masks[u] >> L & 1]
            keep = v[b].copy()
            for j in bits:
                for i in bits:
                    mi, mj = m[b, i], m[b, j]
                    if ids[b, i] != ids[b, j] or not (mi > mj or (mi == mj and i < j)):
                        continue
                    dx, dy = cx[b, i] - cx[b, j], cy[b, i] - cy[b, j]
                    ei, ej = edge[b, i], edge[b, j]
                    reach = ei + ej if np.isnan(ei) or np.isnan(ej) else max(ei, ej)
                    if np.sqrt(dx * dx + dy * dy) < f32(0.75) * reach:
                        keep[j] = False
                        break
            score = np.where(keep, m[b], -np.inf).astype(f32)
            ranked = keep if rank_valid else score > -np.inf
            above = int(ranked.sum())
            for j in range(N):
                if ranked[j]:
                    r = sum(int(score[i] > score[j] or (score[i] == score[j] and i < j))
                            for i in np.flatnonzero(ranked))
                else:
                    r = above + j - int(ranked[:j].sum())
                if r < K:
                    pick[b, r], scores[b, r] = j, score[j]
    take = torch.from_numpy(pick)
    sel_valid = torch.from_numpy(np.isfinite(scores))
    corners = ttail.take(dec.corners, take)
    c0, c1, c2, c3 = corners.unbind(-2)
    return ttail.Selection(
        valid=sel_valid, id=torch.where(sel_valid, ttail.take(dec.id, take), -1),
        hamming=ttail.take(dec.hamming, take), margin=ttail.take(dec.margin, take),
        center=line_intersection(c0, c2 - c0, c1, c3 - c1), corners=corners,
        num_detections=sel_valid.sum(-1).to(torch.int32), overflow=overflow | (num_quads > N))


@pytest.mark.parametrize("name", FINISH_CASES)
def test_finish_kernel_mirror_equals_finish_detections(name):
    """The finish kernel's formulation equals finish_detections bit for bit
    on every Selection field, on phase 27's synthetic cases and
    FINISH_CASE_NAMES (tied margins, +-inf and NaN margins, a gate of -inf,
    NaN edges, one id on 128 valid candidates, no valid candidate, N not a
    multiple of 32, k < N / 2)."""
    (dec, pre_valid, n_quads, overflow), kw = finish_case(name)
    want = ttail.finish_detections(dec, pre_valid, n_quads, overflow, **kw)
    assert_same(_finish_mirror(dec, pre_valid, n_quads, overflow, **kw), want)
    if name == "no valid quad":
        assert not want.valid.any()
    if name == "one id, 128 valid candidates":
        assert int(want.num_detections.sum()) < pre_valid.numel() // 4


def test_finish_kernel_mirror_is_held_by_the_cases():
    """A mirror that ranks every valid candidate by compares, -inf scores
    among them, picks other candidates than finish_detections on the -inf
    gate's case."""
    (dec, pre_valid, n_quads, overflow), kw = finish_case("min_decision_margin -inf")
    want = ttail.finish_detections(dec, pre_valid, n_quads, overflow, **kw)
    got = _finish_mirror(dec, pre_valid, n_quads, overflow, rank_valid=True, **kw)
    assert not chip_smoke._same(got.corners, want.corners)


# --- the pick's rank over the masks of the quads scored above -inf, in numpy --

def _precedes(u, i, v, j, nan_first=True):
    """csrc/tail.cu::precedes: (u at i) before (v at j) in
    torch.sort(descending=True, stable=True). Without `nan_first` (a wrong
    mirror) a NaN is compared as a number: it precedes nothing and nothing
    precedes it."""
    if nan_first and (np.isnan(u) or np.isnan(v)):
        return bool(np.isnan(u) and (not np.isnan(v) or i < j))
    return bool(u > v or (u == v and i < j))


def _select_mirror(corners, valid, dark, fit_err, *, want_dark, k, decimate, nan_first=True):
    """csrc/tail.cu's select_rank frame by frame, as refine_kernel runs it: the quads scored above -inf (NaN among them)
    as four 32-bit masks; such a quad's rank by precedes over the masks'
    set bits only; a -inf quad's rank their count plus the -inf quads below
    it; then the quads of rank < k, their corners upscaled, dark side and
    pre_valid, and the frame's valid count."""
    B, C = valid.shape
    qvalid = valid & (dark == want_dark)
    score = torch.where(qvalid, ttail._sum4(ttail._edge_lengths(corners)) / (1.0 + fit_err),
                        -torch.inf).numpy()
    pick = np.zeros((B, k), np.int64)
    for b in range(B):
        s = score[b]
        ranked = ~(s == -np.inf)
        masks = [sum(1 << L for L in range(32) if 32 * u + L < C and ranked[32 * u + L])
                 for u in range(4)]
        bits = [32 * u + L for u in range(4) for L in range(32) if masks[u] >> L & 1]
        above = len(bits)
        for i in range(C):
            if ranked[i]:
                r = sum(_precedes(s[j], j, s[i], i, nan_first) for j in bits)
            else:
                r = above + i - sum(j < i for j in bits)
            if r < k:
                pick[b, r] = i
    idx = torch.from_numpy(pick)
    return ttail.Candidates(
        corners=ttail.upscale_coords(ttail.take(corners, idx), decimate),
        dark_inside=ttail.take(dark, idx),
        pre_valid=torch.isfinite(torch.gather(torch.from_numpy(score), 1, idx)),
        num_quads=qvalid.sum(-1).to(torch.int32))


@pytest.mark.parametrize("name", SYNTHETIC)
def test_select_rank_mirror_equals_select_candidates(name):
    """select_rank's formulation equals select_candidates bit for bit on
    every Candidates field on phase 27's synthetic cases (NaN and inf
    corners, no valid quad, tied scores, max_tags < C/2, quad_decimate 1 and
    3, a batch of 3), and so does the pick that select_and_refine refines."""
    args, kw = case(name)["tail_select"]
    want = ttail.select_candidates(*args, **kw)
    assert_same(_select_mirror(*args, **kw), want)
    gargs, gkw = case(name)["select_refine"]
    mirror = _select_mirror(*gargs[1:], **{k: v for k, v in gkw.items() if k != "search_range"})
    assert_same(ttail.select_and_refine(*gargs, **gkw),
                (tref.refine_edges(gargs[0], mirror.corners, mirror.dark_inside,
                                   search_range=gkw["search_range"]),
                 mirror.pre_valid, mirror.num_quads))


def test_select_rank_mirror_is_held_by_the_cases():
    """A mirror that compares NaN scores as numbers picks other quads than
    select_candidates on the NaN case."""
    args, kw = case("NaN and inf corners")["tail_select"]
    got = _select_mirror(*args, nan_first=False, **kw)
    assert not chip_smoke._same(got.corners, ttail.select_candidates(*args, **kw).corners)


# --- the wrappers on the CPU ------------------------------------------------

def test_wrappers_run_the_plain_versions_on_the_cpu():
    before = launch_counts()
    c = case("a batch of 3 frames")
    for stage, wrapper in (("select_refine", refine_kernel.select_and_refine),
                           ("tail_finish", tail_kernels.finish_detections)):
        args, kw = c[stage]
        assert_same(wrapper(*args, **kw), STAGES[stage](*args, **kw))
    m = scene_moments()
    assert_same(quadfit_kernel.fit_quads_from_moments(m, min_area=16.0),
                tqf.fit_quads_from_moments(m, min_area=16.0))
    assert_same(quadfit_kernel.quad_fit(tqf.prefix_tables(m), m, min_area=16.0),
                tqf.fit_quads_from_moments(m, min_area=16.0))
    assert launch_counts() == before


def test_build_hash_tracks_the_shared_header(monkeypatch, tmp_path):
    """quadfit.cu and tail.cu take their torch-semantics helpers from one
    header, csrc/torch_math.cuh, and a change to it rebuilds the kernels."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    csrc = tmp_path / "csrc"
    shutil.copytree(_lib._CSRC, csrc)
    for name in ("quadfit.cu", "tail.cu"):
        assert '#include "torch_math.cuh"' in (csrc / name).read_text()
    monkeypatch.setattr(_lib, "_CSRC", str(csrc))
    before = _lib._source_hash()
    header = csrc / "torch_math.cuh"
    header.write_text(header.read_text() + "\n")
    assert _lib._source_hash() != before


def test_refine_wrapper_refuses_what_its_kernel_does_not_take():
    """The pick and refine's wrapper refuses a gray it cannot refine on."""
    (g, c, v, d, f), kw = case("a batch of 3 frames")["select_refine"]
    for bad in ((g.double(), c, v, d, f), (g[0], c, v, d, f), (g[:2], c, v, d, f),
                (g.transpose(1, 2), c, v, d, f), (g[:, :0], c, v, d, f),
                (g.to("meta"), c, v, d, f)):
        with pytest.raises(ValueError):
            refine_kernel.select_and_refine(*bad, **kw)


def test_select_and_refine_wrapper_refuses_what_its_kernel_does_not_take():
    """The pick and refine's wrapper refuses quads it cannot pick from."""
    (g, c, v, d, f), kw = case("a batch of 3 frames")["select_refine"]
    for bad in ((g, c.double(), v, d, f), (g, c, v.int(), d, f), (g, c, v, d[:, :5], f),
                (g, c[0], v, d, f), (g, c[..., :1], v, d, f),
                (g, c, v, d, f.transpose(0, 1).contiguous().transpose(0, 1)),
                (g, c, v, d, f[:2]), (g, c[:, :0], v[:, :0], d[:, :0], f[:, :0])):
        with pytest.raises(ValueError):
            refine_kernel.select_and_refine(*bad, **kw)
    big = torch.zeros((3, 129, 4, 2))
    with pytest.raises(ValueError, match="128"):
        refine_kernel.select_and_refine(g, big, *(torch.zeros((3, 129), dtype=torch.bool),) * 2,
                                        torch.zeros((3, 129)), **kw)
    for k, d_ in ((0, 2), (c.shape[1] + 1, 2), (4, 0)):
        with pytest.raises(ValueError):
            refine_kernel.select_and_refine(g, c, v, d, f, **{**kw, "k": k, "decimate": d_})


def test_pick_wrappers_refuse_what_their_kernels_do_not_take():
    (dec, pre, nq, ovf), kw = case("a batch of 3 frames")["tail_finish"]
    for bad in ((dec._replace(id=dec.id.long()), pre, nq, ovf),
                (dec._replace(margin=dec.margin[:, :3]), pre, nq, ovf),
                (dec._replace(corners=dec.corners.double()), pre, nq, ovf),
                (dec, pre.int(), nq, ovf), (dec, pre, nq.long(), ovf), (dec, pre, nq[:1], ovf),
                (dec, pre, nq, ovf[None])):
        with pytest.raises(ValueError):
            tail_kernels.finish_detections(*bad, **kw)
    with pytest.raises(ValueError):
        tail_kernels.finish_detections(dec, pre, nq, ovf, **{**kw, "k": 0})


def test_fit_wrapper_refuses_what_its_kernel_does_not_take():
    m = scene_moments()
    S = tqf.prefix_tables(m)
    for bad in (m._replace(scale=m.scale.double()), m._replace(count=m.count.long()),
                m._replace(valid=m.valid[:1]), m._replace(centroid=m.centroid[..., :1])):
        with pytest.raises(ValueError):
            quadfit_kernel.quad_fit(S, bad)
    with pytest.raises(ValueError):
        quadfit_kernel.quad_fit(S[:5], m)


@pytest.mark.parametrize("batched_k", [False, True])
@pytest.mark.parametrize("name", FINISH_CASES)
def test_finish_and_pose_matches_reference(name, batched_k):
    """The detect path's finish and pose in one call (ops/cuda/tail.py::
    finish_and_pose; on the card one launch of finish_pose_kernel) on CPU
    tensors: finish_detections, then estimate_poses of its corners, bit for
    bit, with K shared or one a frame; against the reference's finish
    (detector.py:254-310) and estimate_poses on the valid tags with finite
    corners (1e-4 as tests/test_torch_decode_pose.py's pose)."""
    (dec, pre_valid, n_quads, overflow), kw = finish_case(name)
    B = pre_valid.shape[0]
    K1 = np.array(chip_smoke.TAIL_K, np.float32)
    Ks = np.stack([K1 * np.array([[1 + 0.1 * b], [1 + 0.1 * b], [1]], np.float32)
                   for b in range(B)])
    Kt = torch.from_numpy(Ks if batched_k else K1)
    before = launch_counts()
    sel, poses = tail_kernels.finish_and_pose(dec, pre_valid, n_quads, overflow, Kt,
                                              chip_smoke.TAIL_TAG_SIZE, **kw)
    assert launch_counts() == before
    want_sel = ttail.finish_detections(dec, pre_valid, n_quads, overflow, **kw)
    want_pose = tpose.estimate_poses(want_sel.corners, Kt, chip_smoke.TAIL_TAG_SIZE)
    for a, b in zip((*sel, *poses), (*want_sel, *want_pose)):
        assert torch.equal(a, b) or (a.dtype.is_floating_point and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a.nan_to_num(), b.nan_to_num()))
    ref = jax.jit(jax.vmap(functools.partial(_jax_finish, **kw)))
    jsel = ref(*(jnp.asarray(t.numpy()) for t in (
        dec.valid, dec.id, dec.hamming, dec.margin, dec.corners, pre_valid, n_quads, overflow)))
    jc = np.asarray(jsel[5])
    jp = jax.vmap(lambda c, k: jpose.estimate_poses(c, k, chip_smoke.TAIL_TAG_SIZE),
                  (0, 0 if batched_k else None))(jnp.asarray(jc), jnp.asarray(Kt.numpy()))
    ok = np.asarray(jsel[0]) & np.isfinite(jc).all((-1, -2))
    for f in ("translation", "quaternion", "rotation"):
        np.testing.assert_allclose(getattr(poses, f).numpy()[ok], np.asarray(getattr(jp, f))[ok],
                                   rtol=1e-5, atol=1e-4, err_msg=f"{name} {f}")



def test_finish_and_pose_refuses_what_its_kernel_does_not_take():
    """finish_and_pose checks K before it runs anything: float32, contiguous,
    (3, 3) or one a frame, on the candidates' device."""
    (dec, pre_valid, n_quads, overflow), kw = finish_case("a batch of 3 frames")
    K = torch.from_numpy(np.array(chip_smoke.TAIL_K, np.float32))
    B = pre_valid.shape[0]
    for bad in (K.double(), K.t(), K[:2], K.expand(B + 1, 3, 3).contiguous(), K.reshape(9),
                K.to("meta")):
        with pytest.raises(ValueError):
            tail_kernels.finish_and_pose(dec, pre_valid, n_quads, overflow, bad,
                                         chip_smoke.TAIL_TAG_SIZE, **kw)
