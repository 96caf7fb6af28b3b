"""The quad fit's search (ops/quadfit.py: prefix_tables, _arc_sums,
candidates, search_plain, the plain version of csrc/quadfit.cu) on the CPU:
the fit against the JAX package's fit_quads_from_moments on the same
moments (the reference's extract_cluster_moments) under the float-tail gate
of tests/test_torch_tail.py::test_quadfit_matches, on that file's scene and
on torch_bench.py's noisy 720p scene at batch 2; every arc the fit can
form against a float64 sum of its bins; the selection rules on synthetic
moments (tied maxima, too few candidates, all-invalid clusters, tied
combos); numpy mirrors of the kernel's rank rule and argmin order against
the torch ops they replace; the kernel's combo table; its arc table (each
arc between two candidates fitted once) against the plain search's
per-combo fits; and the wrapper ops/cuda/quadfit.py on CPU tensors."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_bench
from isaac_ros_apriltag_tpu.models.families import get_family as jget_family
from isaac_ros_apriltag_tpu.ops import cluster_moments as jcm
from isaac_ros_apriltag_tpu.ops import quadfit as jqf
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch import CameraModel, Detector, DetectorConfig
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as tcm
from isaac_ros_apriltag_tpu_torch.ops import quadfit as tqf
from isaac_ros_apriltag_tpu_torch.ops.cuda import launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import project_corners

torch.set_num_threads(2)

K = 64
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "isaac_ros_apriltag_tpu_torch", "csrc", "quadfit.cu")
# An arc's f32 sum is two f32 prefix sums of at most K bins, subtracted (and
# a third added when it wraps): each prefix is off the exact sum by at most
# K ulps of the bins' absolute sum, so the arc by at most (4K + 2) of them.
ARC_ULPS = 4 * K + 2


def _moments(frames, cfg):
    """The reference's extract_cluster_moments of each (H, W) uint8 frame
    (op by op), its trinary and dense ids through the port's front and CCL
    twins (held bit-exact with the reference's by tests/test_torch_{front,
    ccl,resolve}.py). Returns the JAX ClusterMoments of each frame."""
    gray = grayscale(torch.from_numpy(np.stack(frames)), "mono8", batched=True)
    tri = adaptive_threshold(_pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size),
                             cfg.tile_size, cfg.min_white_black_diff)
    valid = tri != 127
    E, R = cfg.effective_capacities(*tri.shape[-2:])
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
    overflow = (res.overflow | ovf).numpy()
    return [jcm.extract_cluster_moments(jnp.asarray(tri[b].numpy()),
                                        jnp.asarray(res.dense[b].numpy()),
                                        comp_overflow=jnp.asarray(bool(overflow[b])), **kw)
            for b in range(len(frames))]


def _tail_scene():
    """tests/test_torch_tail.py's scene (three tags at 1.1 m, noise 2,
    480x640): ([frame], [its tags' corners])."""
    Kc = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]], np.float32)
    fam = jget_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.2, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=5 * i + 2, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    frame = render_tags(Kc, (480, 640), tags, noise=2.0)
    return [frame], [[project_corners(Kc, g["R"], g["t"], g["tag_size"]) for g in tags]]


def _bench_scene():
    """torch_bench.py's node-720p-b1 frames 0 and 1 at seed 0 (720x1280, six
    tags each, noise 2): (frames, each frame's tags' corners)."""
    cam = torch_bench.config_camera(torch_bench.load_spec()["configs"]["tag36h11-720p-node"])
    K_ = cam.K.numpy()
    frames, truths = [], []
    for b in range(2):
        tags, frame = torch_bench.render_frame(cam, b, 0)
        frames.append(frame)
        truths.append([project_corners(K_, g["R"], g["t"], g["tag_size"]) for g in tags])
    return frames, truths


SCENES = {"tail": _tail_scene, "bench720p_b2": _bench_scene}

# Clusters of a scene whose quads may differ from the reference's: none on
# the tail scene; on the bench scene's noise, 2% of the clusters. There a
# local maximum of the window error, or the tenth candidate, turns on less
# than the two packages' rounding (the arc sums and line fits add in other
# orders), and the two fits take candidate sets one bin apart (measured: 4
# of 256 clusters, 2 differing in gates and 3 in the corners of valid
# quads, these with fit errors of 7.8-12.3 px^2; the fit before the gather
# form differed from the reference on the same clusters).
NOISE_SHARE = {"tail": 0.0, "bench720p_b2": 0.02}
TAG_PX = 3.0      # a quad at a tag: every corner within 3 px of the tag's


def _at_tag(corners: np.ndarray, truth: list) -> np.ndarray:
    """(C,) bool: quads (segmentation coordinates, 2x decimated) with every
    corner within TAG_PX of a corner of one truth tag (full resolution)."""
    full = corners * 2 + 0.5
    out = np.zeros(len(corners), bool)
    for gt in truth:
        d = np.linalg.norm(full[:, :, None] - gt[None, None], axis=-1).min(-1).max(-1)
        out |= d < TAG_PX
    return out


@functools.lru_cache(maxsize=None)
def _scene_moments(scene: str):
    """(the reference's ClusterMoments of each frame of a scene, each
    frame's truth)."""
    frames, truths = SCENES[scene]()
    return _moments(frames, DetectorConfig(tag_size=0.16, backend="torch")), truths


@pytest.fixture(scope="module", params=sorted(SCENES))
def fits(request):
    """(scene, JAX quads of each frame, the port's quads of the batch, each
    frame's truth) on the same moments, min_area 64 / 2^2 as the detector
    passes it."""
    mj, truths = _scene_moments(request.param)
    fit = jax.jit(lambda m: jqf.fit_quads_from_moments(m, min_area=16.0))
    want = [fit(m) for m in mj]
    mt = tcm.ClusterMoments(*[torch.from_numpy(np.stack([np.asarray(getattr(m, f)) for m in mj]))
                              for f in tcm.ClusterMoments._fields])
    return request.param, want, tqf.fit_quads_from_moments(mt, min_area=16.0), truths


def test_fit_matches_jax(fits):
    """The float-tail gate of test_quadfit_matches: gates and validity
    equal, and on valid quads corners within 0.1 px and fit errors within
    0.05 px^2, on every quad at a tag and on all but NOISE_SHARE of the
    other clusters. Every tag has a valid quad."""
    scene, want, got, truths = fits
    assert got.valid.shape[0] == len(want)
    n_differ = n_clusters = 0
    for b, (a, truth) in enumerate(zip(want, truths)):
        gates, valid, corners = np.asarray(a.gates), np.asarray(a.valid), np.asarray(a.corners)
        tag = _at_tag(corners, truth) & valid
        assert sum(_at_tag(corners[valid], [gt]).any() for gt in truth) == len(truth)
        with np.errstate(invalid="ignore"):      # invalid quads' corners may be inf
            close = ((gates == got.gates[b].numpy()).all(-1)
                     & (~valid | ((np.abs(got.corners[b].numpy() - corners) <= 0.1).all((-1, -2))
                                  & (np.abs(got.fit_err[b].numpy() - np.asarray(a.fit_err))
                                     <= 0.05))))
        assert close[tag].all(), np.nonzero(tag & ~close)
        n_differ += int((~close).sum())
        n_clusters += len(close)
    assert n_differ <= NOISE_SHARE[scene] * n_clusters


def _periodic(seed: int, period: int = 4) -> np.ndarray:
    """(6, K) f32 integer bins repeating every `period` bins: windows and
    arcs `period` bins apart tie exactly (chip_smoke.periodic_bins)."""
    return chip_smoke.periodic_bins(seed, period, K).astype(np.float32)


ARC_CASES = {"direct": (3, 20), "direct to K - 1": (10, K - 1), "wrapped": (60, K + 2),
             "wrapped long": (5, K + 3), "empty": (12, 11), "empty at K": (K, K - 1),
             "ia == K": (K, K + 7), "iw == ia": (9, 9 + K - 1)}


@pytest.mark.parametrize("case", sorted(ARC_CASES))
def test_arc_sums_against_float64(case):
    """Each arc against the float64 sum of its bins within ARC_ULPS of the
    bins' absolute sum; the two coincidences exactly the table entry the
    reference's selector keeps (S[iw] where ia == K, S[K] where iw == ia)."""
    a, b = ARC_CASES[case]
    rng = np.random.default_rng(7)
    bins = rng.normal(0.0, 3.0, (4, 6, K)).astype(np.float32)
    S = chip_smoke.prefix_of_bins(bins)
    got = torch.stack(tqf._arc_sums(S, torch.tensor([[a]]), torch.tensor([[b]])), 1)[..., 0]
    idx = np.arange(a, b + 1) % K
    want = bins[..., idx].astype(np.float64).sum(-1)
    tol = ARC_ULPS * 2.0 ** -24 * np.abs(bins.astype(np.float64)).sum(-1)
    assert (np.abs(got.numpy() - want) <= tol).all()
    if case == "ia == K":
        assert torch.equal(got, S[..., b - K + 1])
    if case == "iw == ia":
        assert torch.equal(got, S[..., K])
    if case.startswith("empty"):
        assert not got.any()


def test_tied_maxima_take_the_lower_bins():
    """Sixteen local maxima of one value (bins repeating every 4): the
    candidates are the ten at the lowest bins."""
    S = chip_smoke.prefix_of_bins(_periodic(0)[None])
    kb = torch.arange(K)[None]
    Wn, *msums = tqf._arc_sums(S, (kb - 2) % K, (kb - 2) % K + 4)
    errs = tqf._line_fit(tuple(msums), Wn)[-1][0]
    first = int(torch.argmax(errs))
    assert torch.equal(errs.reshape(-1, 4), errs[:4].expand(16, 4))   # exact ties
    assert tqf.candidates(S)[0].tolist() == list(range(first, first + 40, 4))


def test_tied_combos_take_the_first():
    """The winning 4-subset ties with the subset one candidate later (the
    same arcs, 4 bins on): the lower combo wins."""
    S = chip_smoke.prefix_of_bins(_periodic(0)[None])
    r = tqf.search_plain(S)
    cand = tqf.candidates(S)[0]
    combo = torch.as_tensor(tqf._COMBOS[int(r.best)])
    assert int(combo[-1]) < 9
    cidx = cand[combo + 1][None]
    c1 = torch.roll(cidx, -1, -1) + torch.tensor([0, 0, 0, K])
    Wn, *msums = tqf._arc_sums(S, cidx + 1, c1 - 1)
    a0, a1, a2, a3 = tqf._line_fit(tuple(msums), Wn)[-1][0]
    later = int(np.nonzero((tqf._COMBOS == (combo + 1).numpy()).all(-1))[0][0])
    assert later > int(r.best) and torch.isfinite(r.best_err)
    assert torch.equal(((a0 + a1) + a2) + a3, r.best_err[0])


def _few_candidates():
    """Flat bins with three bins moved: one to three candidates a cluster."""
    return np.stack([chip_smoke.moved_bins(seed, K) for seed in range(8)]).astype(np.float32)


def _synthetic_moments(bins, valid, count):
    N = bins.shape[0]
    b = torch.from_numpy(bins)
    z = torch.zeros(N)
    return tcm.ClusterMoments(
        *b.unbind(1), count=torch.full((N,), count, dtype=torch.int32),
        centroid=torch.full((N, 2), 50.0), scale=torch.full((N,), 10.0),
        dark_inside=torch.ones(N, dtype=torch.bool), valid=torch.full((N,), valid),
        num_clusters=z, num_eligible=z, num_edge_points=z, edge_stride=z, overflow=z.bool())


def test_too_few_candidates_have_no_combo():
    bins = _few_candidates()
    S = chip_smoke.prefix_of_bins(bins)
    n_cand = (tqf.candidates(S) < K).sum(-1)
    assert ((n_cand >= 1) & (n_cand < 4)).all() and (n_cand == 3).any()
    r = tqf.search_plain(S)
    assert (r.best == 0).all() and torch.isinf(r.best_err).all()
    q = tqf.fit_quads_from_moments(_synthetic_moments(bins, True, 128))
    assert not q.gates[:, 0].any() and not q.valid.any()


def test_all_invalid_clusters():
    """Empty slots (zero bins, count 0, not valid): no candidate, no combo,
    no quad."""
    bins = np.zeros((3, 6, K), np.float32)
    S = chip_smoke.prefix_of_bins(bins)
    assert (tqf.candidates(S) == 2 * K).all()
    r = tqf.search_plain(S)
    assert (r.best == 0).all() and torch.isinf(r.best_err).all()
    q = tqf.fit_quads_from_moments(_synthetic_moments(bins, False, 0))
    assert not q.valid.any() and not q.gates[:, [0, 5, 6]].any()


def _rank_candidates(max_errs: np.ndarray) -> np.ndarray:
    """csrc/quadfit.cu's phase A selection, in numpy: at most 10 finite
    bins are all candidates; else bin k is one when finite and fewer than
    10 finite bins are greater, or equal at a lower bin (the kernel counts
    over the maxima's bits only: every other bin is -inf); the candidates
    ascending, 2K past the last."""
    out = np.full((max_errs.shape[0], tqf._MAXIMA), 2 * K)
    for n, v in enumerate(max_errs):
        finite = np.nonzero(np.isfinite(v))[0]
        if len(finite) <= tqf._MAXIMA:
            cand = finite
        else:
            rank = np.array([sum((v[j] > v[k]) | ((v[j] == v[k]) & (j < k)) for j in finite)
                             for k in range(K)])
            cand = np.nonzero(np.isfinite(v) & (rank < tqf._MAXIMA))[0]
        out[n, :len(cand)] = cand
    return out


def test_rank_rule_equals_the_stable_sort():
    """The kernel's rank rule picks what candidates' stable descending sort
    picks, on rows with many ties, -inf and signed zeros."""
    rng = np.random.default_rng(11)
    vals = np.array([-np.inf, -0.0, 0.0, 1.5, 2.0, 3.25], np.float32)
    rows = vals[rng.choice(len(vals), (200, K), p=[0.5, 0.1, 0.1, 0.1, 0.1, 0.1])]
    m = torch.from_numpy(rows)
    top_vals, top_idx = torch.sort(m, dim=-1, descending=True, stable=True)
    want = torch.sort(torch.where(torch.isfinite(top_vals[:, :tqf._MAXIMA]),
                                  top_idx[:, :tqf._MAXIMA], 2 * K), -1).values
    np.testing.assert_array_equal(_rank_candidates(rows), want.numpy())


def _before(v, i, w, j) -> bool:
    """csrc/quadfit.cu's argmin order: NaN first, then the least, ties to
    the lower index."""
    if np.isnan(v) or np.isnan(w):
        return bool(np.isnan(v) and (not np.isnan(w) or i < j))
    return bool(v < w or (v == w and i < j))


def _block_argmin(row, valid=None) -> int:
    """csrc/quadfit.cu's block argmin, in Python: thread t of 128 starts at
    (inf, combo 0) and takes combos t and t + 128 in turn where valid (all
    where `valid` is None), then a shuffle-xor tree in each warp of 32, then
    warp 0 over warps 1-3 in order."""
    threads = []
    for t in range(128):
        bv, bi = np.float32(np.inf), 0
        for u in range(t, len(row), 128):
            if (valid is None or valid[u]) and _before(row[u], u, bv, bi):
                bv, bi = row[u], u
        threads.append((bv, bi))
    warps = []
    for w in range(4):
        lanes = threads[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[lane ^ off] if _before(*lanes[lane ^ off], *lanes[lane])
                     else lanes[lane] for lane in range(32)]
        assert len(set(i for _, i in lanes)) == 1
        warps.append(lanes[0])
    bv, bi = warps[0]
    for wv, wi in warps[1:]:
        if _before(wv, wi, bv, bi):
            bv, bi = wv, wi
    return bi


def test_argmin_order_equals_torch_argmin():
    """The kernel's block argmin picks torch.argmin's index on rows of 210
    combo errors with NaN, inf, ties and signed zeros."""
    rng = np.random.default_rng(5)
    vals = np.array([np.nan, np.inf, -0.0, 0.0, 0.5, 0.5, 7.0], np.float32)
    for p_nan in (0.0, 0.01, 0.2):
        p = np.array([p_nan, 0.4, 0.1, 0.1, 0.1, 0.1, 0.2 - p_nan])
        rows = vals[rng.choice(len(vals), (40, tqf._COMBOS.shape[0]), p=p / p.sum())]
        want = torch.argmin(torch.from_numpy(rows), -1).numpy()
        assert [_block_argmin(r) for r in rows] == want.tolist()


def test_kernel_combo_table_is_COMBOS():
    """csrc/quadfit.cu's kCombos holds _COMBOS in order, candidate j in byte j."""
    with open(CSRC) as f:
        body = re.search(r"kCombos\[NCOMB\] = \{(.*?)\};", f.read(), re.S).group(1)
    words = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body)]
    got = np.array([[(w >> (8 * j)) & 0xFF for j in range(4)] for w in words])
    np.testing.assert_array_equal(got, tqf._COMBOS)


def test_wrapper_on_cpu_runs_the_plain_version():
    S = chip_smoke.prefix_of_bins(np.concatenate([_periodic(0)[None], _few_candidates()]))
    before = launch_counts()
    got, want = qk.quad_search(S), tqf.search_plain(S)
    assert launch_counts() == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    m = _synthetic_moments(_periodic(1)[None], True, 128)
    for a, b in zip(qk.fit_quads_from_moments(m), tqf.fit_quads_from_moments(m)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "empty", "meta"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    S = chip_smoke.prefix_of_bins(_periodic(0)[None].repeat(2, 0))
    S = {"float64": S.double(), "shape": S[..., :K], "strided": S.transpose(0, 1).contiguous()
         .transpose(0, 1), "empty": S[:0], "meta": S.to("meta")}[bad]
    with pytest.raises(ValueError):
        qk.quad_search(S)


def test_cuda_backend_on_the_cpu_raises():
    cam = CameraModel.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    with pytest.raises(ValueError):
        Detector(DetectorConfig(backend="cuda"), cam, device="cpu")


def test_chip_smoke_synthetic_cases_cover_the_rules():
    """chip_smoke.py phase 25's synthetic clusters, fitted here by the plain
    version: ten candidates from tied maxima, one to three candidates, a
    valid 4-subset through a candidate at bin 63 (an arc from ia == K), an
    empty invalid slot, and best errors of -inf and NaN."""
    m = chip_smoke.quadfit_synthetic(torch.device("cpu"))
    S = tqf.prefix_tables(m)
    cand, r = tqf.candidates(S), tqf.search_plain(S)
    n_cand = (cand < K).sum(-1)
    finite = torch.isfinite(r.best_err)
    assert (n_cand[:4] == 10).all() and finite[:4].all()
    assert ((n_cand >= 1) & (n_cand < 4)).any()
    assert ((cand == K - 1).any(-1) & finite).any()
    assert ((n_cand == 0) & ~m.valid).any()
    assert (r.best_err == -torch.inf).any() and torch.isnan(r.best_err).any()
    for a, b in zip(qk.quad_search(S), r):
        assert ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()


def test_combo_error_adds_the_arcs_in_order():
    """best_err is ((a0 + a1) + a2) + a3 of the winner's arc errors, bit for
    bit (the kernel adds in that order), on clusters where another order
    rounds elsewhere."""
    r = tqf.search_plain(tqf.prefix_tables(chip_smoke.quadfit_synthetic(torch.device("cpu"))))
    a0, a1, a2, a3 = r.aerr.unbind(-1)
    ok = torch.isfinite(r.best_err)
    assert torch.equal((((a0 + a1) + a2) + a3)[ok], r.best_err[ok])
    assert ((a0 + (a1 + (a2 + a3)))[ok] != r.best_err[ok]).any()


# --- the kernel's arc table --------------------------------------------------

def _arc_of(u: int, A: int) -> tuple[int, int, bool]:
    """csrc/quadfit.cu's arc_of: arc u of n (n - 1) -> (row, col, wrapped)
    of its table cell: pair u (u < A) or u - A in colex order, its q
    unranked by an f32 square root as the kernel does."""
    wrapped = u >= A
    t = u - A if wrapped else u
    q = int(np.float32((np.float32(1) + np.sqrt(np.float32(1) + np.float32(8) * np.float32(t)))
                       * np.float32(0.5)))
    q -= q * (q - 1) // 2 > t
    q += (q + 1) * q // 2 <= t
    p = t - q * (q - 1) // 2
    return (q, p, True) if wrapped else (p, q, False)


def _table_search(S):
    """The kernel's search by its arc table, in torch ops: the candidates,
    each of the n (n - 1) arcs between them summed (_arc_sums) and fitted
    (_line_fit) once into a 10 x 10 error and arc_ok table, each combo's
    error from four cells in the kernel's add order, its validity from the
    four cells' arc_ok and every candidate below K. Returns (per-combo
    error, inf where not valid; valid; winner by _block_argmin; its error)."""
    M = tqf._MAXIMA
    cand = tqf.candidates(S)
    N = S.shape[0]
    err = torch.full((N, M, M), torch.nan)
    ok = torch.zeros((N, M, M), dtype=torch.bool)
    for c in range(N):
        n = int((cand[c] < K).sum())
        A = n * (n - 1) // 2
        cells = [_arc_of(u, A) for u in range(2 * A)]
        if not cells:
            continue
        row = torch.tensor([r for r, _, _ in cells])
        col = torch.tensor([q for _, q, _ in cells])
        wrap = torch.tensor([w for _, _, w in cells])
        a = cand[c, row] + 1
        b = torch.where(wrap, cand[c, col] + K, cand[c, col]) - 1
        Wn, *ms = tqf._arc_sums(S[c:c + 1], a[None], b[None])
        err[c, row, col] = tqf._line_fit(tuple(ms), Wn)[-1][0]
        ok[c, row, col] = ((b - a + 1 >= 1) & (Wn[0] >= 3.0))
    i0, i1, i2, i3 = torch.as_tensor(tqf._COMBOS).unbind(-1)
    e = ((err[:, i0, i1] + err[:, i1, i2]) + err[:, i2, i3]) + err[:, i3, i0]
    valid = ((cand[:, i3] < K) & ok[:, i0, i1] & ok[:, i1, i2] & ok[:, i2, i3]
             & ok[:, i3, i0])
    combo_err = torch.where(valid, e, torch.inf)
    best = torch.tensor([_block_argmin(r, v) for r, v in zip(combo_err.numpy(),
                                                             valid.numpy())])
    return combo_err, valid, best, combo_err[torch.arange(N), best]


def _combo_search(S):
    """ops/quadfit.py::search_plain's per-combo step, written out: each
    combo's four arcs summed and fitted, (per-combo error, inf where not
    valid; valid)."""
    cidx = tqf.candidates(S)[:, tqf._combos(S.device)]
    c1 = torch.roll(cidx, -1, -1) + torch.where(torch.arange(4) == 3, K, 0)
    a, b = cidx + 1, c1 - 1
    Wn, *ms = tqf._arc_sums(S, a, b)
    aerr = tqf._line_fit(tuple(ms), Wn)[-1]
    valid = torch.all(cidx < K, -1) & torch.all((b - a + 1 >= 1) & (Wn >= 3.0), -1)
    a0, a1, a2, a3 = aerr.unbind(-1)
    return torch.where(valid, ((a0 + a1) + a2) + a3, torch.inf), valid


def _phase_a_max_errs(S) -> np.ndarray:
    """(N, K) window errors at the circular local maxima, -inf elsewhere,
    as the kernel's phase A finds them (a lane's two bins, its neighbour
    lanes' errors)."""
    kb = torch.arange(K)[None]
    Wn, *ms = tqf._arc_sums(S, (kb - 2) % K, (kb - 2) % K + 4)
    e = torch.where(Wn >= 4.0, tqf._line_fit(tuple(ms), Wn)[-1], -torch.inf).numpy()
    with np.errstate(invalid="ignore"):
        is_max = (e > np.roll(e, 1, -1)) & (e >= np.roll(e, -1, -1)) & np.isfinite(e)
    return np.where(is_max, e, -np.inf)


def _table_cases() -> dict:
    rows = chip_smoke.quadfit_synthetic_rows(np.random.default_rng(9), K)
    rows["4, 5 and 10 candidates, bins 0 and 63, ties, NaN and inf"] = chip_smoke.quadfit_counted(K)
    return rows


TABLE_CASES = ("ties", "bin 63", "few candidates", "empty", "random", "NaN and inf",
               "4, 5 and 10 candidates, bins 0 and 63, ties, NaN and inf", "node-720p frame 0")


@pytest.mark.parametrize("case", TABLE_CASES)
def test_arc_table_equals_the_plain_search(case):
    """The kernel's arc table (90 arcs at most, fitted once each) gives
    every combo's error and validity, the winner and its error bit for bit
    as the plain search's fits of each combo's four arcs do, on
    chip_smoke.py phase 25's synthetic clusters and node-720p-b1's frame 0
    (the cluster stage's moments, here the reference's)."""
    if case == "node-720p frame 0":
        m = _scene_moments("bench720p_b2")[0][0]
        S = chip_smoke.prefix_of_bins(np.stack([np.asarray(getattr(m, f)) for f in
                                                ("bw", "bx", "by", "bxx", "bxy", "byy")], 1))
    else:
        S = chip_smoke.prefix_of_bins(_table_cases()[case])
    got_err, got_ok, best, best_err = _table_search(S)
    want_err, want_ok = _combo_search(S)
    assert torch.equal(got_ok, want_ok)
    assert chip_smoke._same(got_err, want_err)
    r = tqf.search_plain(S)
    assert torch.equal(best, r.best) and chip_smoke._same(best_err, r.best_err)
    max_errs = _phase_a_max_errs(S)
    np.testing.assert_array_equal(_rank_candidates(max_errs), tqf.candidates(S).numpy())
