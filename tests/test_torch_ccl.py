"""Scan CCL of the PyTorch port against the JAX package's Pallas CCL.

The round loop with the plain twins of CUDA kernels K2 (row scan) and K3
(diagonal hop + column scan) must be bit-exact with
``ccl_scan_pallas(..., interpret=True)`` in labels and in the converged
flag: flat mode, flat ``label0`` mode and rank ``label0`` mode (the
reference's opaque mode), on a speckle image and on a noisy rendered scene.
The Pallas version pads the image to 64x128 tiles and the port does not;
equality shows the padding changes nothing, whatever the seed labels."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SCAN_CASES, scan_case, scan_case_id
from isaac_ros_apriltag_tpu.models.families import get_family
from isaac_ros_apriltag_tpu.ops.pallas.ccl_fused import ccl_scan_pallas
from isaac_ros_apriltag_tpu.ops.resolve import resolve_roots, resolve_roots_rank
from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold as jthreshold
from isaac_ros_apriltag_tpu.utils.render import render_tags, upright_pose
from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl


def _speckle(shape=(96, 128), seed=3):
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])
    tri[10:80, 12:100] = 255
    tri[14:76, 16:96] = 0
    tri[22:68, 24:88] = 255
    return tri


@pytest.fixture(scope="module")
def noisy_scene_trinary():
    fam = get_family("tag36h11")
    K = np.array([[210.0, 0, 160], [0, 210.0, 120], [0, 0, 1]])
    tags = []
    for i, (x, y) in enumerate([(-0.2, -0.1), (0.2, 0.1)]):
        t = np.array([x, y, 1.0])
        tags.append(dict(family=fam, id=4 * i + 3, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    img = render_tags(K, (240, 320), tags, noise=2.0).astype(np.float32)
    return np.array(jthreshold(jnp.asarray(img), 4, 5))   # writable copy for torch


def _port(tri, rounds, backend="torch", **kw):
    lab, conv = ccl.ccl_scan(torch.from_numpy(tri), rounds, backend=backend, **kw)
    return lab.numpy(), bool(conv)


@functools.lru_cache(maxsize=None)
def _pallas_speckle(rounds):
    """The reference's result, shared by the tests of this module."""
    a, ca = ccl_scan_pallas(jnp.asarray(_speckle()), rounds, interpret=True)
    return np.asarray(a), bool(ca)


@pytest.mark.parametrize("rounds", [1, 4, 8])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_scan_rounds_bit_exact_flat(rounds, backend):
    """backend 'cuda' on CPU tensors goes through the kernel wrappers, which
    take the twins for CPU tensors."""
    a, ca = _pallas_speckle(rounds)
    b, cb = _port(_speckle(), rounds, backend)
    np.testing.assert_array_equal(np.asarray(a), b)
    assert bool(ca) == cb


def test_convergence_flag():
    tri = np.full((16, 128), 127, np.uint8)
    tri[4:12, 8:120] = 0
    assert not _port(tri, 1)[1]
    assert _port(tri, 4)[1]
    assert bool(ccl_scan_pallas(jnp.asarray(tri), 4, interpret=True)[1])


def test_flat_label0_bit_exact():
    tri = _speckle(shape=(64, 128))
    lab1, _ = ccl_scan_pallas(jnp.asarray(tri), 4, interpret=True)
    roots = resolve_roots(lab1, jnp.asarray(tri != 127))
    a, ca = ccl_scan_pallas(jnp.asarray(tri), 4, interpret=True, label0=roots)
    b, cb = _port(tri, 4, label0=torch.from_numpy(np.array(roots)))
    np.testing.assert_array_equal(np.asarray(a), b)
    assert bool(ca) == cb


def test_two_phase_opaque_bit_exact_speckle():
    tri = _speckle()
    lab1, _ = _pallas_speckle(8)
    rank_img, _, _ = resolve_roots_rank(jnp.asarray(lab1), jnp.asarray(tri != 127),
                                        max_components=1536)
    a, ca = ccl_scan_pallas(jnp.asarray(tri), 6, interpret=True, label0=rank_img, opaque=True)
    b, cb = _port(tri, 6, label0=torch.from_numpy(np.array(rank_img)))
    np.testing.assert_array_equal(np.asarray(a), b)
    assert bool(ca) == cb


def test_two_phase_bit_exact_noisy_scene(noisy_scene_trinary):
    """Production round counts (8 + 6) on a 240x320 noisy scene."""
    tri = noisy_scene_trinary
    lab1, c1 = ccl_scan_pallas(jnp.asarray(tri), 8, interpret=True)
    b1, cb1 = _port(tri, 8)
    np.testing.assert_array_equal(np.asarray(lab1), b1)
    assert bool(c1) == cb1
    rank_img, _, _ = resolve_roots_rank(lab1, jnp.asarray(tri != 127),
                                        max_components=(240 * 320) // 8)
    a, ca = ccl_scan_pallas(jnp.asarray(tri), 6, interpret=True, label0=rank_img, opaque=True)
    b, cb = _port(tri, 6, label0=torch.from_numpy(np.array(rank_img)))
    np.testing.assert_array_equal(np.asarray(a), b)
    assert bool(ca) == cb


def _naive_round(tri, lab):
    """Sequential reference of one round (row scans, diagonal hop, column
    scans), written loop by loop."""
    H, W = tri.shape
    lab = lab.copy()

    def run_min_1d(t, l):
        out = l.copy()
        i = 0
        n = len(t)
        while i < n:
            j = i + 1
            if t[i] != 127:
                while j < n and t[j] == t[i]:
                    j += 1
                out[i:j] = l[i:j].min()
            i = j
        return out

    for y in range(H):
        lab[y] = run_min_1d(tri[y], lab[y])
    hop = lab.copy()
    for y in range(H):
        for x in range(W):
            if tri[y, x] != 255:
                continue
            for dy in (-1, 1):
                for dx in (-1, 1):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < H and 0 <= nx < W and tri[ny, nx] == 255:
                        hop[y, x] = min(hop[y, x], lab[ny, nx])
    for x in range(W):
        hop[:, x] = run_min_1d(tri[:, x], hop[:, x])
    return hop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twins_match_sequential_round(seed):
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=(17, 23), p=[0.35, 0.3, 0.35])
    lab = rng.permutation(17 * 23).astype(np.int32).reshape(17, 23)
    t, l = torch.from_numpy(tri), torch.from_numpy(lab)
    got = ccl.col_diag_scan_plain(t, ccl.row_scan_plain(t, l)).numpy()
    np.testing.assert_array_equal(got, _naive_round(tri, lab))


@pytest.mark.parametrize("case", [c for c in SCAN_CASES if max(c[0]) <= 33], ids=scan_case_id)
def test_twins_match_sequential_round_adversarial(case):
    """chip_smoke's lines that break a chunked scan, at the small shapes:
    the twins the CUDA kernels are held to on the card equal the naive
    round, labels up to INT32_MAX included."""
    tri, lab = scan_case(*case)
    t, l = torch.from_numpy(tri), torch.from_numpy(lab)
    got = ccl.col_diag_scan_plain(t, ccl.row_scan_plain(t, l)).numpy()
    np.testing.assert_array_equal(got, _naive_round(tri, lab))


def test_scan_rejects_bad_arguments():
    tri = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rounds"):
        ccl.ccl_scan(tri, 0, backend="torch")
    with pytest.raises(ValueError, match="backend"):
        ccl.ccl_scan(tri, 1, backend="xla")
