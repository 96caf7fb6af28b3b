"""Decode and pose: the plain versions of the tail kernels (csrc/tail.cu)
against the JAX package, and their 8x8 solve.

ops/decode.py::decode_quads and ops/pose.py::estimate_poses are written in
the kernels' order (elementwise torch ops, each float sum in one fixed
order), so the kernels match them bit for bit on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 26). Here the same inputs,
made with seeded numpy, go through them and through the reference's
decode_quads / estimate_poses (op by op on the CPU): ids, hamming, rotation
and the rotated corners are equal, margins and poses agree within
tests/test_torch_tail.py's tolerances (sums taken in another order). The
wrappers run the plain versions on CPU tensors and launch nothing."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import TAIL_EXTRA_QUADS, TAIL_K, TAIL_TAG_SIZE, tail_frame, tail_pose_corners
from isaac_ros_apriltag_tpu.models.families import get_family as jget_family
from isaac_ros_apriltag_tpu.ops import decode as jdec
from isaac_ros_apriltag_tpu.ops import pose as jpose
from isaac_ros_apriltag_tpu.utils import geometry as jgeo
from isaac_ros_apriltag_tpu_torch.models.families import family_names, get_family
from isaac_ros_apriltag_tpu_torch.ops import decode as tdec
from isaac_ros_apriltag_tpu_torch.ops import pose as tpose
from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as decode_kernel
from isaac_ros_apriltag_tpu_torch.ops.cuda import launch_counts
from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pose_kernel
from isaac_ros_apriltag_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(2)

K = np.array(TAIL_K, np.float32)
TAG_SIZE = TAIL_TAG_SIZE
# tail_frame's quads come without the quad wholly outside the frame: it
# samples one clamped pixel, so its bits are the sign of rounding noise,
# which another order of sums may flip (the card's tests hold the kernel to
# the plain version there).
NAN_QUAD, COLLINEAR_QUAD = (np.array(q, np.float32) for q in TAIL_EXTRA_QUADS[1:])


@functools.lru_cache(maxsize=None)
def _reference_decode(name: str, max_hamming: int = 2, decode_sharpening: float = 0.25):
    """The reference's decode_quads of family `name`, jitted (each case's
    shapes compile once)."""
    fam = jget_family(name)
    return jax.jit(lambda g, c: jdec.decode_quads(g, c, fam, max_hamming=max_hamming,
                                                  decode_sharpening=decode_sharpening))


def decode_both(gray, corners, name: str, **kw):
    """The reference's decode and the plain version's, on the same inputs."""
    want = _reference_decode(name, **kw)(jnp.asarray(gray), jnp.asarray(corners))
    got = tdec.decode_quads(torch.from_numpy(gray), torch.from_numpy(corners), get_family(name),
                            **kw)
    return want, got


def assert_decode_matches(want, got):
    """Ids, hamming, rotation, valid and the rotated corners equal (NaN equal
    to NaN); margins within rtol 1e-4, atol 1e-3 (sums in another order)."""
    for f in ("valid", "id", "hamming", "rotation", "corners"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.margin.numpy(), np.asarray(want.margin), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("name", family_names())
def test_decode_matches_reference_on_every_family(name):
    """One tag of each family (tagStandard41h12 and tagStandard52h13 put
    bit cells on the sharpening grid's edge, where torch.roll wraps)."""
    want, got = decode_both(*tail_frame(name), name)
    assert_decode_matches(want, got)
    assert bool(got.valid[0]) and int(got.id[0]) == 3


@pytest.mark.parametrize("name", ["tag36h11", "tagStandard41h12"])
def test_decode_without_sharpening(name):
    want, got = decode_both(*tail_frame(name, seed=1), name, decode_sharpening=0.0)
    assert_decode_matches(want, got)
    assert int(got.id[0]) == 3


@pytest.mark.parametrize("name", ["tag36h11", "tag16h5", "tagCircle49h12"])
@pytest.mark.parametrize("largest", [False, True])
def test_decode_max_hamming(name, largest):
    """A code word with the family's largest correctable count of bits
    flipped, (min_hamming - 1) // 2: valid under that max_hamming, not
    under 0."""
    flip = (get_family(name).min_hamming - 1) // 2
    max_hamming = flip if largest else 0
    want, got = decode_both(*tail_frame(name, flip=flip, seed=2), name, max_hamming=max_hamming)
    assert_decode_matches(want, got)
    assert int(got.hamming[0]) == flip and int(got.id[0]) == 3
    assert bool(got.valid[0]) == largest


@pytest.mark.parametrize("kind", list(chip_smoke.LARGE_CODEBOOKS))
def test_decode_past_the_staged_codes_matches_reference(kind):
    """chip_smoke.py phase 26's codebooks of 5000 codes (the decode kernel
    stages 4096 in shared memory and reads the rest from global memory):
    the tag decodes as the case expects (the first minimum, wherever it
    lies), equal to the reference given the same codebook."""
    fam = chip_smoke.large_codebook_family(kind)
    jfam = chip_smoke.large_codebook_family(kind, jget_family("tag36h11"))
    gray, corners = tail_frame("tag36h11")
    want = jax.jit(lambda g, c: jdec.decode_quads(g, c, jfam))(jnp.asarray(gray),
                                                               jnp.asarray(corners))
    got = tdec.decode_quads(torch.from_numpy(gray), torch.from_numpy(corners), fam)
    assert_decode_matches(want, got)
    assert (int(got.id[0]), int(got.hamming[0])) == chip_smoke.LARGE_CODEBOOKS[kind][1]


@pytest.mark.parametrize("quad", ["nan", "collinear"])
def test_decode_degenerate_quads(quad):
    """A quad with NaN and infinite corners, and a collinear one, whose
    homography is singular: non-finite H, valid False, no read out of the
    frame (torch.gather raises on an index past it), the tag's lane
    untouched."""
    gray, corners = tail_frame("tag36h11", seed=3)
    bad = NAN_QUAD if quad == "nan" else COLLINEAR_QUAD
    both = np.concatenate([corners[:1], bad[None], corners[2:]])
    H = tgeo.homography_from_correspondences(
        torch.from_numpy(tdec._SQUARE).expand(1, 4, 2), torch.from_numpy(bad[None]))
    assert not torch.isfinite(H).all()
    want, got = decode_both(gray, both, "tag36h11")
    assert_decode_matches(want, got)
    assert not bool(got.valid[1]) and bool(got.valid[0])
    _, one = decode_both(gray, corners, "tag36h11")
    for f in got._fields:
        for i in (0, 2):
            assert torch.equal(getattr(got, f)[i], getattr(one, f)[i]), f


def test_decode_batch_equals_each_frame():
    """(B, C, 4, 2) against (B, H, W): each frame's quads sample their own
    frame, bit for bit as that frame alone, and as the reference frame by
    frame."""
    frames = [tail_frame("tag36h11", seed=s, tag_id=s + 3) for s in range(3)]
    gray = np.stack([g for g, _ in frames])
    corners = np.stack([c for _, c in frames])
    got = tdec.decode_quads(torch.from_numpy(gray), torch.from_numpy(corners),
                            get_family("tag36h11"))
    for b, (g, c) in enumerate(frames):
        want, one = decode_both(g, c, "tag36h11")
        for f in got._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f
        assert_decode_matches(want, one)
        assert int(one.id[0]) == b + 3


_reference_pose = jax.jit(lambda c, k: jpose.estimate_poses(c, k, TAG_SIZE))


def assert_pose_matches(want, got):
    for f in ("translation", "quaternion", "rotation"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


def test_pose_shared_k_matches_reference():
    corners = tail_pose_corners([K] * 3, 4)
    got = tpose.estimate_poses(torch.from_numpy(corners), torch.from_numpy(K), TAG_SIZE)
    for b in range(3):
        want = _reference_pose(jnp.asarray(corners[b]), jnp.asarray(K))
        assert_pose_matches(want, Poses_at(got, b))
        one = tpose.estimate_poses(torch.from_numpy(corners[b]), torch.from_numpy(K), TAG_SIZE)
        for f in got._fields:
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


def Poses_at(p, b):
    return type(p)(*(x[b] for x in p))


def test_pose_batched_k_matches_reference():
    """K (B, 3, 3), one per frame of corners (B, T, 4, 2), against jax.vmap
    of the reference's estimate_poses."""
    Ks = np.stack([K * np.array([[1 + 0.1 * b], [1 + 0.1 * b], [1]], np.float32)
                   for b in range(3)])
    corners = tail_pose_corners(Ks, 4, seed=6)
    want = jax.jit(jax.vmap(_reference_pose))(jnp.asarray(corners), jnp.asarray(Ks))
    got = tpose.estimate_poses(torch.from_numpy(corners), torch.from_numpy(Ks), TAG_SIZE)
    assert_pose_matches(want, got)


def _mirror_solve(A, b, pick: str = "first", pivots: list | None = None):
    """numpy float32 mirror of utils/geometry.py::solve_pivoted with the
    pivot on ties taken from the first (its rule) or the last row; the
    pivot rows go to `pivots` where given."""
    A, b = A.astype(np.float32).copy(), b.astype(np.float32).copy()
    n = len(b)
    for k in range(n):
        col = np.abs(A[k:, k])
        top = col.max()
        rows = np.flatnonzero(col == top) if top == top else [0]
        p = k + (rows[0] if pick == "first" else rows[-1])
        if pivots is not None:
            pivots.append(int(p))
        A[[k, p]], b[[k, p]] = A[[p, k]], b[[p, k]]
        for i in range(k + 1, n):
            f = A[i, k] / A[k, k]
            A[i, k + 1:] = A[i, k + 1:] - f * A[k, k + 1:]
            b[i] = b[i] - f * b[k]
    x = np.zeros(n, np.float32)
    for j in range(n - 1, -1, -1):
        x[j] = b[j] / A[j, j]
        b[:j] = b[:j] - A[:j, j] * x[j]
    return x


def _dlt_systems(n: int, seed: int):
    """The Hartley-normalized 8x8 DLT systems of n random quads."""
    rng = np.random.default_rng(seed)
    src = np.broadcast_to(tdec._SQUARE, (n, 4, 2))
    dst = (tdec._SQUARE * rng.uniform(10, 80, (n, 1, 1)) + rng.normal(0, 8, (n, 4, 2))
           + rng.uniform(50, 900, (n, 1, 2))).astype(np.float32)
    c = dst.mean(1, keepdims=True)
    s = np.abs(dst - c).mean((1, 2))[:, None, None]
    u, v = ((dst - c) / s).transpose(2, 0, 1)
    x, y = src[..., 0], src[..., 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    A = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                        np.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], 1)
    return A.astype(np.float32), np.concatenate([u, v], 1).astype(np.float32)


@pytest.mark.parametrize("kind", ["dlt", "random"])
def test_solve_pivoted_matches_linalg_solve(kind):
    """On well-posed systems the explicit elimination equals
    torch.linalg.solve to 1e-5 relative (both in f32, against the f64
    solution), and the numpy mirror bit for bit."""
    rng = np.random.default_rng(11)
    if kind == "dlt":
        A, b = _dlt_systems(64, 12)
    else:
        A = (rng.normal(0, 1, (64, 8, 8)) + 4 * np.eye(8)).astype(np.float32)
        b = rng.normal(0, 1, (64, 8)).astype(np.float32)
    got = tgeo.solve_pivoted(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    lib = torch.linalg.solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    scale = np.linalg.norm(exact, axis=-1)
    assert (np.linalg.norm(got - exact, axis=-1) <= 1e-5 * scale).all()
    assert (np.linalg.norm(got - lib, axis=-1) <= 1e-5 * scale).all()
    for i in range(8):
        np.testing.assert_array_equal(got[i], _mirror_solve(A[i], b[i]))


def test_solve_pivoted_takes_the_first_largest_pivot():
    """Columns whose largest |entry| is tied between rows (3 and -3 below
    the diagonal): the elimination equals the mirror that pivots on the
    first of them, bit for bit, and not the one that takes the last."""
    rng = np.random.default_rng(13)
    A = rng.integers(-9, 10, (32, 8, 8)).astype(np.float32) + rng.normal(0, 1e-3, (32, 8, 8))
    A[:, :, 0] = [1.0, 3.0, 2.0, -3.0, 0.5, 1.5, -1.0, 2.5]
    A = A.astype(np.float32)
    b = rng.normal(0, 1, (32, 8)).astype(np.float32)
    got = tgeo.solve_pivoted(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    differs = 0
    for i in range(len(A)):
        np.testing.assert_array_equal(got[i], _mirror_solve(A[i], b[i], "first"))
        differs += not np.array_equal(got[i], _mirror_solve(A[i], b[i], "last"))
    assert differs > 0


def test_solve_pivoted_takes_the_first_largest_pivot_after_a_swap():
    """Column 1 tied, after column 0's pivot moved row 0 to place 3,
    between the row at place 1 (-4) and row 0 (4): the elimination takes
    place 1, as the first-tie mirror does, and not the last."""
    rng = np.random.default_rng(23)
    A = rng.normal(0, 1, (32, 8, 8)).astype(np.float32)
    A[:, :, 0] = 0.0
    A[:, 3, 0] = 5.0
    A[:, 0, 1], A[:, 1, 1], A[:, 2, 1] = 4.0, -4.0, 1.0
    A[:, 4:, 1] = np.clip(A[:, 4:, 1], -3.0, 3.0)
    b = rng.normal(0, 1, (32, 8)).astype(np.float32)
    got = tgeo.solve_pivoted(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    differs = 0
    for i in range(len(A)):
        np.testing.assert_array_equal(got[i], _mirror_solve(A[i], b[i], "first"))
        differs += not np.array_equal(got[i], _mirror_solve(A[i], b[i], "last"))
    assert differs > 0


def test_homography_matches_reference():
    """The homography of the DLT quads against the reference's (an LU solve
    in another order)."""
    rng = np.random.default_rng(14)
    dst = (tdec._SQUARE * 40 + rng.normal(0, 6, (32, 4, 2)) + 300).astype(np.float32)
    src = np.broadcast_to(tdec._SQUARE, dst.shape).copy()
    want = np.asarray(jgeo.homography_from_correspondences(jnp.asarray(src), jnp.asarray(dst)))
    got = tgeo.homography_from_correspondences(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_parent_forms_compute_the_same_function():
    """chip_smoke.py phase 26's yardsticks, the parent's torch ops for
    decode and pose, against the plain versions: ids, hamming, rotation and
    corners equal, margins and poses within the reference's tolerances."""
    gray, corners = tail_frame("tagStandard41h12", seed=5)
    fam = get_family("tagStandard41h12")
    g, c = torch.from_numpy(gray), torch.from_numpy(corners)
    assert_decode_matches(chip_smoke.parent_decode_form(g, c, fam), tdec.decode_quads(g, c, fam))
    pc, Kt = torch.from_numpy(tail_pose_corners([K, K], 3)), torch.from_numpy(K)
    assert_pose_matches(chip_smoke.parent_pose_form(pc, Kt, TAG_SIZE),
                        tpose.estimate_poses(pc, Kt, TAG_SIZE))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the kernels' wrappers return the plain versions'
    results and launch nothing."""
    before = launch_counts()
    gray, corners = tail_frame("tag25h9", seed=4)
    g, c, fam = torch.from_numpy(gray), torch.from_numpy(corners), get_family("tag25h9")
    for a, b in zip(decode_kernel.decode_quads(g, c, fam), tdec.decode_quads(g, c, fam)):
        assert torch.equal(a, b)
    pc = torch.from_numpy(tail_pose_corners([K, K], 3))
    for a, b in zip(pose_kernel.estimate_poses(pc, torch.from_numpy(K), TAG_SIZE),
                    tpose.estimate_poses(pc, torch.from_numpy(K), TAG_SIZE)):
        assert torch.equal(a, b)
    assert launch_counts() == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    fam = get_family("tag36h11")
    g = torch.zeros(2, 40, 50)
    c = torch.zeros(2, 3, 4, 2)
    for bad_g, bad_c in ((g.double(), c), (g, c.double()), (g, c[..., :1]), (g[0], c),
                         (g[:1], c), (g.transpose(1, 2), c), (g, c.transpose(1, 2)),
                         (g[:, :0], c), (g, c[:, :0])):
        with pytest.raises(ValueError):
            decode_kernel.decode_quads(bad_g, bad_c, fam)
    big = dataclasses.replace(fam, width_at_border=16, total_width=18)
    with pytest.raises(ValueError, match="past the kernel"):
        decode_kernel.decode_quads(g, c, big)
    Kt = torch.from_numpy(K)
    for bad_c, bad_k in ((c.double(), Kt), (c, Kt.double()), (c[..., :1], Kt), (c, Kt[:2]),
                         (c, Kt.expand(3, 3, 3).contiguous()), (c[0], Kt.expand(2, 3, 3)),
                         (c, Kt.t()), (c[:, :0], Kt)):
        with pytest.raises(ValueError):
            pose_kernel.estimate_poses(bad_c, bad_k, TAG_SIZE)


def _pose_system(dst, half: float):
    """The 8x8 system of the tag-plane homography of quad `dst` (4, 2)
    (utils/geometry.py::homography_from_correspondences: the tag's corners
    TAG_CORNERS * half, the quad Hartley-normalized)."""
    from isaac_ros_apriltag_tpu_torch.utils.render import TAG_CORNERS

    src = (np.asarray(TAG_CORNERS, np.float32) * np.float32(half)).astype(np.float32)
    c = ((dst[0] + dst[1]) + dst[2]) + dst[3]
    c = (c * np.float32(0.25)).astype(np.float32)
    e = (dst - c).astype(np.float32)
    s = np.float32(max(np.float32(np.abs(e).reshape(-1).sum() * np.float32(0.125)), 1e-6))
    u, v = (e / s).astype(np.float32).T
    x, y = src[:, 0], src[:, 1]
    z, o = np.zeros(4, np.float32), np.ones(4, np.float32)
    A = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                        np.stack([z, z, z, x, y, o, -v * x, -v * y], -1)])
    return A.astype(np.float32), np.concatenate([u, v]).astype(np.float32)


def _pivots(A, b, pick: str = "first"):
    """The rows _mirror_solve pivots on, column by column."""
    got = []
    _mirror_solve(A, b, pick, pivots=got)
    return got


HALF_SIZES = (TAG_SIZE / 2, 0.08, 0.5, 1e-3, 1e-40, -0.08, 3e38, 0.0, float("inf"),
              float("nan"))


@pytest.mark.parametrize("half", HALF_SIZES)
def test_standard_pivots_follow_the_elimination(half):
    """ops/cuda/pose.py::standard_pivots(half) (the host's choice of the
    pose kernels' fixed pivots) says whether the elimination of the tag's
    homography pivots on STANDARD_PIVOTS in columns 0-5, ties to the first
    row, also after the swap at column 3; those pivots do not depend on
    the quad, NaN corners and collinear ones included. At a normal size a
    mirror that takes the last of a tie pivots elsewhere."""
    rng = np.random.default_rng(31)
    quads = [(np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32) * rng.uniform(8, 60)
              + rng.normal(0, 4, (4, 2)) + rng.uniform(40, 600, 2)).astype(np.float32)
             for _ in range(6)]
    quads += [NAN_QUAD, COLLINEAR_QUAD]
    std = pose_kernel.standard_pivots(half)
    assert std == (half == TAG_SIZE / 2 or 0 < abs(half) < 1e38)
    for q in quads:
        with np.errstate(all="ignore"):
            A, b = _pose_system(q, half)
            first, last = _pivots(A, b), _pivots(A, b, "last")
        assert (tuple(first[:6]) == pose_kernel.STANDARD_PIVOTS) == std
        assert not std or tuple(last[:6]) != pose_kernel.STANDARD_PIVOTS


POSE_CASES = ("a NaN corner", "collinear corners", "per-frame K, a NaN and a collinear quad")


@pytest.mark.parametrize("name", POSE_CASES)
def test_pose_degenerate_quads_match_reference(name):
    """estimate_poses with a quad of NaN and infinite corners or a collinear
    one (a singular homography) beside well-posed tags, with a shared K and
    one a frame: the well-posed tags as the reference poses them and bit for
    bit as posed without the bad quad; the bad quad's translation not
    finite in either."""
    Ks = np.stack([K * np.array([[1 + 0.1 * b], [1 + 0.1 * b], [1]], np.float32)
                   for b in range(2)])
    batched = name.startswith("per-frame")
    corners = tail_pose_corners(Ks if batched else [K], 3, seed=8)
    bad = np.zeros(corners.shape[:2], bool)
    if batched:
        corners[0, 1], corners[1, 2] = NAN_QUAD, COLLINEAR_QUAD
        bad[0, 1] = bad[1, 2] = True
        Kin = Ks
        want = jax.jit(jax.vmap(_reference_pose))(jnp.asarray(corners), jnp.asarray(Ks))
    else:
        corners[0, 1] = NAN_QUAD if name == "a NaN corner" else COLLINEAR_QUAD
        bad[0, 1] = True
        Kin = K
        want = jax.jit(jax.vmap(_reference_pose, (0, None)))(jnp.asarray(corners), jnp.asarray(K))
    got = tpose.estimate_poses(torch.from_numpy(corners), torch.from_numpy(Kin), TAG_SIZE)
    good = ~bad
    for f in ("translation", "quaternion", "rotation"):
        np.testing.assert_allclose(getattr(got, f).numpy()[good], np.asarray(getattr(want, f))[good],
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    assert not np.isfinite(got.translation.numpy()[bad]).all(axis=-1).any()
    assert not np.isfinite(np.asarray(want.translation)[bad]).all(axis=-1).any()
    clean = corners.copy()
    clean[bad] = corners[good][0]
    alone = tpose.estimate_poses(torch.from_numpy(clean), torch.from_numpy(Kin), TAG_SIZE)
    for f in got._fields:
        assert torch.equal(getattr(got, f)[torch.from_numpy(good)],
                           getattr(alone, f)[torch.from_numpy(good)]), f


def _fixed_mirror(A, b, consts, swap6: bool = True):
    """numpy float32 mirror of csrc/tail.cu::solve8_fixed on a tag-plane
    system (A, b in solve_pivoted's row order): the data columns 6 and 7
    and b in PIVOT_ROWS' order, eliminated by pose_constants' multipliers,
    column 6's pivot between rows 6 and 7 (`swap6` False: never swapped, a
    wrong mirror), and the back substitution with u for columns 0-5."""
    order = [4 * v + k for v, k in pose_kernel.PIVOT_ROWS]
    c6, c7, bb = A[order, 6].copy(), A[order, 7].copy(), b[order].copy()
    f, u = consts[:27], consts[27:]
    m = 0
    for k in range(6):
        for i in range(k + 1, 8):
            c6[i] = c6[i] - f[m] * c6[k]
            c7[i] = c7[i] - f[m] * c7[k]
            bb[i] = bb[i] - f[m] * bb[k]
            m += 1
    if swap6 and abs(c6[7]) > abs(c6[6]):
        c6[[6, 7]], c7[[6, 7]], bb[[6, 7]] = c6[[7, 6]], c7[[7, 6]], bb[[7, 6]]
    g = c6[7] / c6[6]
    c7[7] = c7[7] - g * c7[6]
    bb[7] = bb[7] - g * bb[6]
    x = np.zeros(8, np.float32)
    x[7] = bb[7] / c7[7]
    bb[:7] = bb[:7] - c7[:7] * x[7]
    x[6] = bb[6] / c6[6]
    bb[:6] = bb[:6] - c6[:6] * x[6]
    for j in range(5, -1, -1):
        x[j] = bb[j] / u[j * (13 - j) // 2]
        for i in range(j):
            bb[i] = bb[i] - u[i * (13 - i) // 2 + j - i] * x[j]
    return x


@pytest.mark.parametrize("half", HALF_SIZES)
def test_fixed_elimination_equals_solve_pivoted(half):
    """The pose kernels' elimination with the host's constants
    (pose_constants: the tag's columns 0-5 reduced once, in float32) gives
    solve_pivoted's solution bit for bit, NaN for NaN, on random quads, a
    quad with NaN and infinite corners and a collinear one, and where the
    size has no constants (0, a subnormal, 3e38, inf, NaN) it is None. A
    mirror without column 6's pivot differs on some quad."""
    consts = pose_kernel.pose_constants(half)
    normal = np.isfinite(np.float32(half)) and np.finfo(np.float32).tiny <= abs(np.float32(half))
    assert (consts is not None) == (pose_kernel.standard_pivots(half) and normal)
    if consts is None:
        return
    assert consts.shape == (48,) and consts.dtype == np.float32
    rng = np.random.default_rng(37)
    quads = [(np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32) * rng.uniform(4, 90)
              + rng.normal(0, 9, (4, 2)) + rng.uniform(20, 900, 2)).astype(np.float32)
             for _ in range(24)]
    quads += [NAN_QUAD, COLLINEAR_QUAD, np.roll(quads[0], 1, 0), quads[1][::-1].copy()]
    swapped = 0
    for q in quads:
        with np.errstate(all="ignore"):
            A, b = _pose_system(q, half)
            got = _fixed_mirror(A, b, consts)
            wrong = _fixed_mirror(A, b, consts, swap6=False)
        want = tgeo.solve_pivoted(torch.from_numpy(A)[None], torch.from_numpy(b)[None])[0]
        np.testing.assert_array_equal(got, want.numpy())
        swapped += not np.array_equal(wrong, want.numpy())
    assert swapped > 0
