"""Synthetic tag-scene renderer (numpy; tests, smoke runs and benchmarks).

A copy of ``isaac_ros_apriltag_tpu/utils/render.py`` that takes this
package's ``TagFamily`` and ``CameraModel``, so scenes can be rendered where jax is absent. Given
the same arguments it produces the same uint8 image. The only randomness is
the sensor noise, drawn from ``numpy.random.default_rng(seed)``.

Frame conventions match ops/pose.py: for R = diag(-1,-1,1) the tag appears
upright; tag x points left in the bitmap, tag y up, tag z into the scene.
"""

from __future__ import annotations

import numpy as np

from ..models.families import TagFamily, get_family

# Tag-frame (x, y) of detection corners, in units of tag_size/2.
TAG_CORNERS = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
                       np.float32)


def render_tags(camera_K: np.ndarray, size: tuple[int, int],
                tags: list[dict], *, background: float = 160.0,
                supersample: int = 3, white: float = 255.0,
                black: float = 10.0, noise: float = 0.0,
                seed: int = 0) -> np.ndarray:
    """Render tags onto a (H, W) grayscale uint8 image.

    Each tag dict: {family: TagFamily, id: int, R: (3,3), t: (3,),
    tag_size: float}. Pixel (i, j) has center (x=j, y=i). Each tag is
    rasterized only inside its projected bounding box (padded by one pixel).
    """
    H, W = size
    S = supersample
    K = np.asarray(camera_K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    img = np.full((H * S, W * S), np.float32(background), np.float32)
    depth = np.full((H * S, W * S), np.inf, np.float32)

    for tag in tags:
        fam: TagFamily = tag["family"]
        grid = fam.code_grid(int(fam.codes[tag["id"]]))
        tw, wb = fam.total_width, fam.width_at_border
        off = (tw - wb) / 2.0
        cell = tag["tag_size"] / wb
        R = np.asarray(tag["R"], np.float64)
        t = np.asarray(tag["t"], np.float64)
        Rt = R.T

        half = cell * tw / 2.0
        obj = np.array([[-half, -half, 0], [half, -half, 0],
                        [half, half, 0], [-half, half, 0]], np.float64)
        cc = obj @ R.T + t
        if np.all(cc[:, 2] > 1e-6):
            u_px = fx * cc[:, 0] / cc[:, 2] + cx
            v_px = fy * cc[:, 1] / cc[:, 2] + cy
            j0 = max(int(np.floor(u_px.min())) - 1, 0)
            j1 = min(int(np.ceil(u_px.max())) + 2, W)
            i0 = max(int(np.floor(v_px.min())) - 1, 0)
            i1 = min(int(np.ceil(v_px.max())) + 2, H)
        else:
            j0, j1, i0, i1 = 0, W, 0, H
        if j1 <= j0 or i1 <= i0:
            continue

        js = ((np.arange(j0 * S, j1 * S, dtype=np.float32) + 0.5) / S - 0.5)
        is_ = ((np.arange(i0 * S, i1 * S, dtype=np.float32) + 0.5) / S - 0.5)
        dirx = ((js - cx) / fx).astype(np.float32)[None, :]
        diry = ((is_ - cy) / fy).astype(np.float32)[:, None]

        # Ray-plane intersection in tag frame: p_tag = R^T (lam*d - t), z=0.
        r = Rt.astype(np.float32)
        dz = r[2, 0] * dirx + r[2, 1] * diry + r[2, 2]
        tz = np.float32(Rt[2] @ t)
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = tz / dz
        px = lam * (r[0, 0] * dirx + r[0, 1] * diry + r[0, 2]) - np.float32(Rt[0] @ t)
        py = lam * (r[1, 0] * dirx + r[1, 1] * diry + r[1, 2]) - np.float32(Rt[1] @ t)

        u = wb / 2.0 - px / cell + off
        v = wb / 2.0 - py / cell + off
        ui = np.floor(u).astype(np.int32)
        vi = np.floor(v).astype(np.int32)
        inside = (lam > 0) & (ui >= 0) & (ui < tw) & (vi >= 0) & (vi < tw)
        vals = np.where(grid[np.clip(vi, 0, tw - 1), np.clip(ui, 0, tw - 1)] > 0,
                        np.float32(white), np.float32(black))
        win_img = img[i0 * S:i1 * S, j0 * S:j1 * S]
        win_depth = depth[i0 * S:i1 * S, j0 * S:j1 * S]
        closer = inside & (lam < win_depth)
        img[i0 * S:i1 * S, j0 * S:j1 * S] = np.where(closer, vals, win_img)
        depth[i0 * S:i1 * S, j0 * S:j1 * S] = np.where(closer, lam, win_depth)

    img = img.reshape(H, S, W, S).mean(axis=(1, 3), dtype=np.float32)
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def project_corners(camera_K: np.ndarray, R: np.ndarray, t: np.ndarray,
                    tag_size: float) -> np.ndarray:
    """Ground-truth detection corners (4, 2) for a rendered tag."""
    obj = np.concatenate([TAG_CORNERS * tag_size / 2.0,
                          np.zeros((4, 1), np.float32)], -1)
    cam = obj @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    K = np.asarray(camera_K, np.float64)
    x = K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2]
    y = K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]
    return np.stack([x, y], -1)


def rotz(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def upright_pose(t: np.ndarray, inplane: float = 0.0) -> np.ndarray:
    """R_camera_tag for an upright fronto-parallel tag, optionally rotated
    in-plane by `inplane` radians. inplane=0 gives diag(-1,-1,1)."""
    return rotz(np.pi + inplane)


GOLDEN = dict(
    # The reference's proof-of-life fixture: tag 0 of tag36h11 at this pose,
    # camera and image size, with the POL test's expected detection.
    family="tag36h11", id=0,
    center=np.array([926.0, 547.0]),
    corners=np.array([[1044.0, 665.0], [808.0, 665.0],
                      [808.0, 429.0], [1044.0, 429.0]]),
    translation=np.array([0.255342, 0.098358, 0.403961]),
    quaternion_wxyz=np.array([0.0, 0.0, 0.0, 1.0]),
    tag_size=0.22,
    K=np.array([[434.943999, 0.0, 651.073921],
                [0.0, 431.741273, 441.878037],
                [0.0, 0.0, 1.0]]),
    size=(1080, 1920),
)


def golden_scene() -> np.ndarray:
    """The GOLDEN fixture rendered: one tag, no noise, (1080, 1920) uint8."""
    g = GOLDEN
    return render_tags(g["K"], g["size"],
                       [dict(family=get_family(g["family"]), id=g["id"],
                             R=upright_pose(g["translation"]), t=g["translation"],
                             tag_size=g["tag_size"])])


def distort_image(ideal: np.ndarray, camera) -> np.ndarray:
    """Synthesize the DISTORTED sensor image from an ideal pinhole render.

    Distorted pixel (ud, vd) images the ray the ideal camera sees at
    K @ undistort(K^-1 (ud, vd)); undistort inverts the plumb_bob forward
    model by fixed-point iteration (coefficients are small). The inverse of
    camera.rectify_map()'s forward model; `camera` is this package's
    CameraModel.
    """
    K = camera.K.detach().cpu().numpy().astype(np.float64)
    k1, k2, p1, p2, k3 = camera.dist.detach().cpu().numpy().astype(np.float64)
    H, W = ideal.shape
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    xd = (u - K[0, 2]) / K[0, 0]
    yd = (v - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(12):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    su = np.clip(K[0, 0] * x + K[0, 2], 0, W - 1.001)
    sv = np.clip(K[1, 1] * y + K[1, 2], 0, H - 1.001)
    u0 = np.floor(su).astype(np.int64)
    v0 = np.floor(sv).astype(np.int64)
    fu, fv = su - u0, sv - v0
    im = ideal.astype(np.float64)
    out = (im[v0, u0] * (1 - fu) * (1 - fv) + im[v0, u0 + 1] * fu * (1 - fv)
           + im[v0 + 1, u0] * (1 - fu) * fv + im[v0 + 1, u0 + 1] * fu * fv)
    return np.clip(out, 0, 255).astype(np.uint8)
