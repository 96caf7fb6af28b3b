"""Front of the PyTorch port against the JAX package: grayscale, decimation
and the adaptive threshold (the twin of CUDA kernel K1), all bit-exact.

Inputs are made with seeded numpy and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import THRESH_CASES, THRESH_MIN_DIFF, THRESH_TILES, thresh_case, thresh_case_id
from isaac_ros_apriltag_tpu import detector as jdet
from isaac_ros_apriltag_tpu.models.families import get_family as jget_family
from isaac_ros_apriltag_tpu.ops.grayscale import grayscale as jgrayscale
from isaac_ros_apriltag_tpu.ops.pallas.threshold import adaptive_threshold_pallas
from isaac_ros_apriltag_tpu.ops.threshold import adaptive_threshold as jadaptive_threshold
from isaac_ros_apriltag_tpu.utils.render import render_tags as jrender
from isaac_ros_apriltag_tpu.utils.render import upright_pose
from isaac_ros_apriltag_tpu_torch import detector as tdet
from isaac_ros_apriltag_tpu_torch.models.families import get_family
from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
from isaac_ros_apriltag_tpu_torch.ops.grayscale import ENCODINGS, grayscale
from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_grayscale_bit_exact(encoding):
    rng = np.random.default_rng(11)
    ch = 4 if encoding in ("rgba8", "bgra8") else 3
    img = rng.integers(0, 256, (123, 211, ch), dtype=np.uint8)
    if encoding == "mono8":
        img = img[..., 0]
    a = np.asarray(jgrayscale(jnp.asarray(img), encoding))
    b = grayscale(torch.from_numpy(img), encoding)
    assert b.dtype == torch.float32
    np.testing.assert_array_equal(a, b.numpy())


def test_grayscale_rejects_unknown_encoding():
    with pytest.raises(ValueError, match="Unsupported image encoding"):
        grayscale(torch.zeros((4, 4, 3), dtype=torch.uint8), "yuv422")


@pytest.mark.parametrize("shape", [(480, 640), (101, 203)])
def test_decimate_and_pad_bit_exact(shape):
    """d=2: strided adds of exact halves == the reference's pooling matmuls."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 256, shape).astype(np.float32)
    for d in (1, 2):
        a = np.asarray(jdet._decimate(jnp.asarray(g), d))
        b = tdet._decimate(torch.from_numpy(g), d).numpy()
        np.testing.assert_array_equal(a, b)
    for ts in (4, 8):
        a = np.asarray(jdet._pad_to_tiles(jnp.asarray(g), ts))
        b = tdet._pad_to_tiles(torch.from_numpy(g), ts).numpy()
        np.testing.assert_array_equal(a, b)
    xy = rng.uniform(0, 300, (7, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jdet._upscale_coords(jnp.asarray(xy), 2)),
                                  tdet._upscale_coords(torch.from_numpy(xy), 2).numpy())


@pytest.mark.parametrize("shape,ts", [((480, 640), 4), ((96, 128), 4),
                                      ((200, 256), 8), ((64, 128), 2),
                                      ((128, 256), 16), ((128, 256), 32)])
def test_threshold_twin_bit_exact_random(shape, ts):
    rng = np.random.default_rng(7)
    g = rng.uniform(0, 255, shape).astype(np.float32)
    g[10:40, 20:90] = 100.0   # flat low-contrast region
    a = np.asarray(adaptive_threshold_pallas(jnp.asarray(g), ts, 5, interpret=True))
    b = adaptive_threshold(torch.from_numpy(g), ts, 5)
    assert b.dtype == torch.uint8
    np.testing.assert_array_equal(a, b.numpy())
    # The kernel's wrapper takes the twin for a CPU tensor.
    np.testing.assert_array_equal(a, thr_kernel.adaptive_threshold(torch.from_numpy(g), ts, 5))


def test_threshold_twin_bit_exact_scene():
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    t = np.array([0.0, 0.05, 0.8])
    img = jrender(K, (480, 640), [dict(family=jget_family("tag36h11"), id=3,
                                       R=upright_pose(t), t=t, tag_size=0.16)],
                  noise=3.0).astype(np.float32)
    a = np.asarray(adaptive_threshold_pallas(jnp.asarray(img), 4, 5, interpret=True))
    np.testing.assert_array_equal(a, adaptive_threshold(torch.from_numpy(img), 4, 5).numpy())


def test_threshold_cases_cover_every_tile_size():
    assert THRESH_TILES == thr_kernel.TILE_SIZES


@pytest.mark.parametrize("case", THRESH_CASES, ids=thresh_case_id)
def test_threshold_twin_bit_exact_kernel_cases(case):
    """chip_smoke's threshold cases (the ones the kernel is held to on the
    card): the twin against the JAX XLA threshold frame by frame, and against
    the Pallas kernel in interpret mode on the first frame."""
    ts, shape, _, _ = case
    g = thresh_case(case)
    frames = g.reshape(-1, *shape[-2:])
    got = adaptive_threshold(torch.from_numpy(g), ts, THRESH_MIN_DIFF).numpy()
    got = got.reshape(frames.shape)
    for b, f in enumerate(frames):
        np.testing.assert_array_equal(
            got[b], np.asarray(jadaptive_threshold(jnp.asarray(f), ts, THRESH_MIN_DIFF)))
    np.testing.assert_array_equal(got[0], np.asarray(adaptive_threshold_pallas(
        jnp.asarray(frames[0]), ts, THRESH_MIN_DIFF, interpret=True)))


def test_threshold_rejects_ragged_shape():
    with pytest.raises(ValueError, match="multiple of tile_size"):
        adaptive_threshold(torch.zeros((10, 12)), 4, 5)


def test_renderer_matches_reference():
    """The port's numpy renderer draws the same uint8 image as the JAX
    package's, noise included."""
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    t = np.array([0.03, -0.02, 0.9])
    R = upright_pose(t, 0.3)
    a = jrender(K, (240, 320), [dict(family=jget_family("tag36h11"), id=9, R=R, t=t,
                                     tag_size=0.16)], noise=2.0, seed=4)
    b = render_tags(K, (240, 320), [dict(family=get_family("tag36h11"), id=9, R=R, t=t,
                                         tag_size=0.16)], noise=2.0, seed=4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["tag36h11", "tag16h5", "tagStandard41h12",
                                  "tagCustom48h12"])
def test_families_match_reference(name):
    a, b = jget_family(name), get_family(name)
    for f in ("nbits", "min_hamming", "total_width", "width_at_border",
              "reversed_border", "exact"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("bit_x", "bit_y", "codes", "rotation_perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.code_grid(int(a.codes[5])), b.code_grid(int(b.codes[5])))
