"""The resolve stage's table formulation (ops/resolve.py: count_plain,
tile_sums_plain, scan_plain, map_plain composed by
resolve_roots_rank_tables and resolve_components_tables, the plain versions
of the kernels in csrc/resolve.cu) against the twin (resolve_roots_rank,
resolve_components) bit for bit on every field and dtype, in rank mode and
flat mode: real CCL labels of small rendered scenes (one frame and a batch
of 3), noise, all-invalid frames, several capacities and chain steps, the
twin's two behaviours on frames of more than R groups (slot R - 1's size,
the 16-bit group-rank clamp at R = 65536), labels that read out of range;
a subset against the JAX package; a numpy mirror of resolve_scan_kernel's
blocked scan against scan_plain on chip_smoke.SCAN_ROWS; and the CUDA
wrappers (ops/cuda/resolve.py) routing CPU tensors to the plain
versions."""

import functools

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu.ops import resolve as jres
from isaac_ros_apriltag_tpu_torch import CameraModel, get_family
from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
from isaac_ros_apriltag_tpu_torch.ops import resolve as tres
from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib, launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
from isaac_ros_apriltag_tpu_torch.ops.cuda.ccl import ccl_scan
from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

torch.set_num_threads(2)

_KMAX = (1 << 15) - 1
_SIDE = 300                      # the synthetic flat frames: 300 x 300, labels = flat index


def _scene(seed: int, noise: float = 1.0) -> np.ndarray:
    """A 240x320 frame with two tags (ids 3 + seed, 9 + seed) at 0.9 m."""
    cam = CameraModel.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    fam = get_family("tag36h11")
    tags = []
    for i, x in enumerate((-0.12, 0.13)):
        t = np.array([x, 0.02 * seed, 0.9])
        tags.append(dict(family=fam, id=3 + 6 * i + seed, R=upright_pose(t, 0.2 * i + 0.1 * seed),
                         t=t, tag_size=0.16))
    return render_tags(cam.K.numpy(), (240, 320), tags, noise=noise, seed=seed)


@functools.lru_cache(maxsize=None)
def _front(seeds: tuple, noise: float = 1.0, rounds: int = 4):
    """(trinary, phase-1 labels) of the scenes as the detector's front makes
    them (2x decimation, tile 4), numpy."""
    frames = torch.from_numpy(np.stack([_scene(s, noise) for s in seeds]))
    gray = grayscale(frames, "mono8", batched=True)
    tri = adaptive_threshold(_pad_to_tiles(_decimate(gray, 2), 4).contiguous(), 4, 5)
    lab, _ = ccl_scan(tri, rounds, backend="torch")
    return tri.numpy(), lab.numpy()


def _speckle(shape, seed=3):
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])
    lab, _ = ccl_scan(torch.from_numpy(tri), 4, backend="torch")
    return tri, lab.numpy()


def _same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), f"field {i} differs"


def _all_calls(tri, lab, R, steps_c, steps_r, min_px=25, rounds2=3):
    """The contraction, the rank-mode resolve after a phase-2 scan, and the
    flat-mode resolve, by the tables and by the twin; returns the twin's
    contraction."""
    tri, lab = torch.from_numpy(tri), torch.from_numpy(lab)
    valid = tri != 127
    want = tres.resolve_roots_rank(lab, valid, max_components=R, chain_steps=steps_c)
    _same(tres.resolve_roots_rank_tables(lab, valid, max_components=R, chain_steps=steps_c),
          want)
    lab2, _ = ccl_scan(tri, rounds2, backend="torch", label0=want[0])
    kw = dict(min_component_pixels=min_px, max_components=R, chain_steps=steps_r)
    rank = tres.resolve_components(lab2, valid, rank_table=want[1], **kw)
    _same(tres.resolve_components_tables(lab2, valid, rank_table=want[1], **kw), rank)
    flat = tres.resolve_components(lab, valid, **kw)
    _same(tres.resolve_components_tables(lab, valid, **kw), flat)
    return want, rank, flat


@pytest.mark.parametrize("seeds,noise,R,steps_c,steps_r", [
    ((0,), 1.0, 64, 5, 3), ((0,), 3.0, 256, 1, 1), ((0,), 3.0, 1 << 16, 5, 3),
    ((0,), 1.0, 1 << 16, 2, 4), ((1, 2, 3), 3.0, 64, 5, 3), ((1, 2, 3), 1.0, 256, 3, 2),
    ((1, 2, 3), 3.0, 1 << 16, 5, 3), ((1, 2, 3), 1.0, 8, 5, 3)])
def test_tables_match_twin_on_scenes(seeds, noise, R, steps_c, steps_r):
    """Real CCL labels of rendered scenes, one frame and a batch of 3; a
    frame of more than R phase-1 groups overflows the contraction and the
    flat resolve."""
    tri, lab = _front(seeds, noise)
    groups = [len(np.unique(lab[b][tri[b] != 127])) for b in range(len(seeds))]
    if len(seeds) == 1:
        tri, lab = tri[0], lab[0]
    roots, rank, flat = _all_calls(tri, lab, R, steps_c, steps_r)
    assert roots[2].reshape(-1).tolist() == [g > R for g in groups]
    assert flat.overflow.reshape(-1).tolist() == [g > R for g in groups]


def test_tables_match_twin_on_noise():
    """A noisy scene and speckle whose phase-1 groups pass R = N / 8 (both
    overflowed: the contraction's rank R pixels, the flat resolve's
    overflow)."""
    tri, lab = _front((4, 5), noise=6.0)
    _all_calls(tri, lab, 1 << 16, 5, 3)
    tri, lab = _speckle((2, 96, 160))
    roots, rank, flat = _all_calls(tri, lab, 96 * 160 // 8, 5, 3)
    assert bool(roots[2].all()) and bool(flat.overflow.all())
    assert not bool(rank.overflow.any())


def test_tables_all_invalid_frames():
    """A batch whose middle frame is all invalid and a frame with no valid
    pixel: no groups, everything at its fill."""
    tri, lab = _front((0, 1, 2))
    tri = tri.copy()
    tri[1] = 127
    roots, rank, flat = _all_calls(tri, lab, 256, 5, 3)
    assert bool((roots[0][1] == 256).all()) and bool((roots[1][1] == 240 * 320 // 4).all())
    assert bool((flat.dense[1] == _KMAX).all()) and int(flat.n_eligible[1]) == 0
    _all_calls(np.full((40, 48), 127, np.uint8), np.arange(40 * 48, dtype=np.int32)
               .reshape(40, 48), 64, 3, 3)


def _doubled(g: int) -> torch.Tensor:
    lab = torch.arange(_SIDE * _SIDE, dtype=torch.int32)
    lab[g + 1] = g
    return lab.reshape(_SIDE, _SIDE)


@pytest.mark.parametrize("g,eligible", [(64999, 0), (64998, 1)])
def test_slot_r_minus_1_is_never_eligible(g, eligible):
    """More than R groups (flat labels, each pixel its own group) and one
    group of two pixels: the twin sizes slot R - 1 against the zero pad of
    its start positions, so a doubled group in that slot is not eligible;
    one slot lower it is."""
    lab, valid = _doubled(g), torch.ones((_SIDE, _SIDE), dtype=torch.bool)
    kw = dict(min_component_pixels=2, max_components=65000, chain_steps=3)
    want = tres.resolve_components(lab, valid, **kw)
    _same(tres.resolve_components_tables(lab, valid, **kw), want)
    assert int(want.n_eligible) == eligible and bool(want.overflow)
    rkw = dict(max_components=65000, chain_steps=3)
    _same(tres.resolve_roots_rank_tables(lab, valid, **rkw),
          tres.resolve_roots_rank(lab, valid, **rkw))


def test_group_ranks_clamp_at_65535():
    """R = 65536 and one chain of 89999 groups (labels max(p - 1, 0)) that
    17 doublings resolve to one root: with min_component_pixels 0 the
    component's size is 0 (slot R - 1's negative size cancels the rest), so
    it is eligible with dense id 0, and the pixels of groups past 65535
    take group 65535's id as the twin's clamped 16-bit ranks give it, not
    _KMAX."""
    lab = (torch.arange(_SIDE * _SIDE, dtype=torch.int32) - 1).clamp(min=0).reshape(_SIDE, _SIDE)
    valid = torch.ones((_SIDE, _SIDE), dtype=torch.bool)
    kw = dict(min_component_pixels=0, max_components=1 << 16, chain_steps=17)
    want = tres.resolve_components(lab, valid, **kw)
    _same(tres.resolve_components_tables(lab, valid, **kw), want)
    assert bool((want.dense == 0).all()) and int(want.n_eligible) == 1
    rkw = dict(max_components=1 << 16, chain_steps=17)
    _same(tres.resolve_roots_rank_tables(lab, valid, **rkw),
          tres.resolve_roots_rank(lab, valid, **rkw))


def test_contraction_carries_16_bits():
    """R = 65536 and more groups: group 5 (pixel 6's label) has its parent
    at pixel 5, labelled 80000, a group past R, so its slot's parent is R =
    65536; the twin's packed broadcast carries its low 16 bits, 0, to the
    group's pixels, and so do the tables."""
    lab = torch.arange(_SIDE * _SIDE, dtype=torch.int32)
    lab[5], lab[6] = 80000, 5
    lab, valid = lab.reshape(_SIDE, _SIDE), torch.ones((_SIDE, _SIDE), dtype=torch.bool)
    kw = dict(max_components=1 << 16, chain_steps=5)
    want = tres.resolve_roots_rank(lab, valid, **kw)
    _same(tres.resolve_roots_rank_tables(lab, valid, **kw), want)
    assert int(want[0][0, 6]) == 0 and bool(want[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_tables_match_twin_on_labels_that_read_out_of_range(seed):
    """Labels that point anywhere: flat labels at invalid pixels (whose own
    labels are garbage, read by the parents), ranks with a rank table that
    holds indices past the frame and negative ones."""
    rng = np.random.default_rng(seed)
    B, H, W = 2, 24, 40
    N = H * W
    valid = torch.from_numpy(rng.random((B, H, W)) < 0.7)
    lab = torch.from_numpy(rng.integers(0, N, (B, H, W), dtype=np.int32))
    lab = torch.where(valid, lab, torch.from_numpy(rng.integers(-5, 3 * N, (B, H, W),
                                                                dtype=np.int32)))
    for R, steps in ((64, 3), (N, 2)):
        kw = dict(min_component_pixels=1, max_components=R, chain_steps=steps)
        _same(tres.resolve_components_tables(lab, valid, **kw),
              tres.resolve_components(lab, valid, **kw))
        rkw = dict(max_components=R, chain_steps=steps)
        _same(tres.resolve_roots_rank_tables(lab, valid, **rkw),
              tres.resolve_roots_rank(lab, valid, **rkw))
    R = 64
    ranks = torch.from_numpy(rng.integers(0, R + 1, (B, H, W), dtype=np.int32))
    table = torch.from_numpy(rng.integers(-3, N + 4, (B, R), dtype=np.int64)).to(torch.int32)
    kw = dict(min_component_pixels=2, max_components=R, chain_steps=3, rank_table=table)
    _same(tres.resolve_components_tables(ranks, valid, **kw),
          tres.resolve_components(ranks, valid, **kw))


def test_plain_passes_on_a_small_table():
    """count, tile sums, scan and map by hand: labels 5, 5, 2 valid, one
    label out of range, one pixel invalid."""
    label = torch.tensor([[5, 5, 2, 9, 7]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True, True, False]])
    cnt = tres.count_plain(label, valid, 8)
    assert cnt.tolist() == [[0, 0, 1, 0, 0, 2, 0, 0]] and cnt.dtype == torch.int32
    assert tres.tile_sums_plain(cnt).tolist() == [[2]]
    inv, D, n_groups = tres.scan_plain(cnt, 1)
    assert inv.tolist() == [[1, 1, 0, 1, 1, 1, 1, 1, 1]]
    assert D.tolist() == [[2]] and n_groups.tolist() == [2]
    inv, D, n_groups = tres.scan_plain(cnt, 4)
    assert inv.tolist() == [[4, 4, 0, 4, 4, 1, 4, 4, 4]] and D.tolist() == [[2, 5, 8, 8]]
    assert all(t.dtype == torch.int32 for t in (inv, D, n_groups))
    out = tres.map_plain(label, valid, inv, torch.tensor([[10, 11, 12, 13, 14]],
                                                        dtype=torch.int32), -1)
    assert out.tolist() == [[11, 11, 10, -1, -1]] and out.dtype == torch.int32
    big = torch.ones((2, 2 * tres.SCAN_TILE), dtype=torch.int32)
    assert tres.tile_sums_plain(big).tolist() == [[tres.SCAN_TILE] * 2 + [0]] * 2


@pytest.mark.parametrize("R,steps", [(1024, 5), (64, 2)])
def test_tables_match_jax(R, steps):
    """The plain composition against the JAX package's resolve_roots_rank
    and its rank-mode and flat-mode resolve_components."""
    tri, lab = _front((0,))
    tri, lab = tri[0], lab[0]
    valid = tri != 127
    a = jres.resolve_roots_rank(jnp.asarray(lab), jnp.asarray(valid), max_components=R,
                                chain_steps=steps)
    b = tres.resolve_roots_rank_tables(torch.from_numpy(lab), torch.from_numpy(valid),
                                       max_components=R, chain_steps=steps)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    lab2, _ = ccl_scan(torch.from_numpy(tri), 3, backend="torch", label0=b[0])
    for labels, table in ((lab2.numpy(), np.array(a[1])), (lab, None)):
        kw = dict(min_component_pixels=25, max_components=R, chain_steps=3)
        ja = jres.resolve_components(jnp.asarray(labels), jnp.asarray(valid), **kw,
                                     rank_table=None if table is None else jnp.asarray(table))
        tb = tres.resolve_components_tables(
            torch.from_numpy(labels), torch.from_numpy(valid), **kw,
            rank_table=None if table is None else torch.from_numpy(table))
        np.testing.assert_array_equal(np.asarray(ja.dense), tb.dense.numpy())
        assert int(ja.n_eligible) == int(tb.n_eligible)
        assert bool(ja.overflow) == bool(tb.overflow)
        assert bool(ja.converged) == bool(tb.converged)


def test_cuda_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain passes: no kernel is built
    or counted, and the stage functions equal the twin."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_lib, "library", no_library)
    before = launch_counts()
    tri, lab = _front((1, 2, 3))
    tri, lab = torch.from_numpy(tri), torch.from_numpy(lab)
    valid = tri != 127
    flat_l, flat_v = lab.reshape(3, -1), valid.reshape(3, -1)
    cnt = rk.count(flat_l, flat_v, flat_l.shape[1])
    assert torch.equal(cnt, tres.count_plain(flat_l, flat_v, flat_l.shape[1]))
    assert torch.equal(rk.tile_sums(cnt), tres.tile_sums_plain(cnt))
    _same(rk.scan(cnt, 256), tres.scan_plain(cnt, 256))
    _same(rk.scan_ranks(cnt, rk.tile_sums(cnt), 256), tres.scan_plain(cnt, 256))
    inv = rk.scan(cnt, 256)[0]
    table = torch.arange(257, dtype=torch.int32).expand(3, -1).contiguous()
    assert torch.equal(rk.map_pixels(flat_l, flat_v, inv, table, -1),
                       tres.map_plain(flat_l, flat_v, inv, table, -1))
    roots = rk.resolve_roots_rank(lab, valid, max_components=256, chain_steps=5)
    _same(roots, tres.resolve_roots_rank(lab, valid, max_components=256, chain_steps=5))
    kw = dict(min_component_pixels=25, max_components=256, chain_steps=3)
    _same(rk.resolve_components(lab, valid, **kw), tres.resolve_components(lab, valid, **kw))
    _same(rk.resolve_components(lab[0], valid[0], **kw),
          tres.resolve_components(lab[0], valid[0], **kw))
    assert launch_counts() == before


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises: no fallback."""
    label = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    valid = torch.zeros((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.count(label, valid, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rk.scan(label, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rk.map_pixels(label, valid, label, label, 0)


def test_tables_reject_bad_capacity():
    lab = torch.zeros((300, 300), dtype=torch.int32)
    valid = torch.ones((300, 300), dtype=torch.bool)
    with pytest.raises(ValueError, match="65536"):
        tres.resolve_components_tables(lab, valid, min_component_pixels=1,
                                       max_components=(1 << 16) + 1)
    with pytest.raises(ValueError, match="capacity mismatch"):
        tres.resolve_components_tables(lab, valid, min_component_pixels=1, max_components=64,
                                       rank_table=torch.zeros(32, dtype=torch.int32))


# --- the scan kernel's blocked formulation, in numpy -------------------------

_SCAN_TILE, _SCAN_THREADS, _SCAN_PER_THREAD = 4096, 256, 16    # csrc/resolve.cu
_SCAN_WARPS = _SCAN_THREADS // 32


def _scan_mirror(cnt: np.ndarray, R: int, round_major: bool = True):
    """resolve_scan_kernel in numpy, a block a (frame, tile): thread t's j-th
    entry is tile * 4096 + 256 j + t; a ballot a (round j, warp w); the
    (round, warp) counts at 8 j + w (round-major; warp-major when not
    `round_major`, a wrong mirror), four a lane, scanned over the lanes; a
    warp's round j takes its offset from lane 2 j + (w >> 2), element
    w & 3; the tile's offset and the frame's group count from the tile
    sums. Returns (inv, D, n_groups) as int32 arrays."""
    B, S = cnt.shape
    T = -(-(S + 1) // _SCAN_TILE)
    present = np.zeros((B, T * _SCAN_TILE), bool)
    present[:, :S] = cnt > 0
    tile_sum = present.reshape(B, T, _SCAN_TILE).sum(-1)
    inv = np.full((B, S + 1), R, np.int64)
    D = np.full((B, R), S, np.int64)
    lanes, warps = np.arange(32), np.arange(_SCAN_WARPS)
    for b in range(B):
        for tile in range(T):
            before = int(tile_sum[b, :tile].sum())
            p = present[b, tile * _SCAN_TILE:(tile + 1) * _SCAN_TILE]
            m = p.reshape(_SCAN_PER_THREAD, _SCAN_WARPS, 32)                 # [j, w, lane]
            counts = m.sum(-1)
            flat = counts.reshape(-1) if round_major else counts.T.reshape(-1)
            x = np.cumsum(flat.reshape(32, 4), 1)                              # x1 .. x4 a lane
            excl = np.cumsum(x[:, 3]) - x[:, 3]
            part = np.concatenate([np.zeros((32, 1), np.int64), x[:, :3]], 1)
            pre = before + excl[None, :] + part[:, warps & 3].T                # [w, lane]
            src = 2 * np.arange(_SCAN_PER_THREAD)[:, None] + (warps >> 2)[None, :]
            base = pre[warps[None, :], src]                                    # [j, w]
            rank = base[..., None] + np.cumsum(m, -1) - m
            e = (tile * _SCAN_TILE + _SCAN_THREADS * np.arange(_SCAN_PER_THREAD)[:, None, None]
                 + 32 * warps[None, :, None] + lanes[None, None, :])
            inside = e <= S
            inv[b, e[inside]] = np.where(m, np.minimum(rank, R), R)[inside]
            put = m & (rank < R)
            D[b, rank[put]] = e[put]
    return inv.astype(np.int32), D.astype(np.int32), tile_sum.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _scan_rows():
    return chip_smoke.scan_rows()


@pytest.mark.parametrize("name", list(chip_smoke.SCAN_ROWS))
def test_scan_kernel_mirror_equals_scan_plain(name):
    """The scan kernel's formulation equals scan_plain on every field of
    chip_smoke.py's SCAN_ROWS (S not a multiple of 4, S + 1 on a tile's end
    and one past it, groups past R at R not a multiple of 256, an empty
    frame beside a full one, every entry present, three frames of odd
    S + 1), and so does the wrapper on CPU tensors."""
    cnt, R = _scan_rows()[name]
    want = tres.scan_plain(torch.from_numpy(cnt), R)
    for got in (_scan_mirror(cnt, R), rk.scan(torch.from_numpy(cnt), R)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    if "past R" in name:
        assert (want[2] > R).all()


def test_scan_kernel_mirror_is_held_by_the_rows():
    """A mirror that scans the (round, warp) counts warp-major, not in
    entry order, differs from scan_plain on a row of SCAN_ROWS."""
    wrong = []
    for name, (cnt, R) in _scan_rows().items():
        want = tres.scan_plain(torch.from_numpy(cnt), R)
        got = _scan_mirror(cnt, R, round_major=False)
        wrong.append(not all(np.array_equal(a, b.numpy()) for a, b in zip(got, want)))
    assert any(wrong)
