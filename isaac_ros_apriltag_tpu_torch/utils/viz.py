"""Detection overlay rendering (host-side, numpy).

A copy of ``isaac_ros_apriltag_tpu/utils/viz.py`` that takes this package's
``Detections`` (tensors on any device): draws corners, edges, center and
axes projected from the estimated pose onto an RGB copy of the frame, for
quick inspection (the reference shows the same in rviz).
"""

from __future__ import annotations

import numpy as np

from ..types import Detections

_EDGE_COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]


def _draw_line(img, p0, p1, color):
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(max(2, np.ceil(np.abs(p1 - p0).max() * 2)))
    ts = np.linspace(0.0, 1.0, n)
    pts = p0[None] + ts[:, None] * (p1 - p0)[None]
    xs = np.clip(np.round(pts[:, 0]).astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.round(pts[:, 1]).astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = color


def draw_detections(image, det: Detections, K=None,
                    tag_size: float | None = None) -> np.ndarray:
    """Return an RGB copy of `image` (numpy, (H, W) or (H, W, 3)) with the
    overlays of one frame's detections; with K and tag_size, also each
    tag's axes."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img.copy()
    valid = det.valid.cpu().numpy()
    corners = det.corners.cpu().numpy()
    centers = det.center.cpu().numpy()
    rotation = det.rotation.cpu().numpy()
    translation = det.translation.cpu().numpy()
    if K is not None:
        K = K.cpu().numpy() if hasattr(K, "cpu") else np.asarray(K)
    for i in np.nonzero(valid)[0]:
        c = corners[i]
        for e in range(4):
            _draw_line(img, c[e], c[(e + 1) % 4], _EDGE_COLORS[e])
        cx, cy = centers[i]
        _draw_line(img, (cx - 3, cy), (cx + 3, cy), (255, 0, 255))
        _draw_line(img, (cx, cy - 3), (cx, cy + 3), (255, 0, 255))
        if K is not None and tag_size is not None:
            R, t = rotation[i], translation[i]
            for axis, color in zip(np.eye(3) * tag_size * 0.5,
                                   [(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
                p = R @ axis + t
                uv = (K[0, 0] * p[0] / p[2] + K[0, 2],
                      K[1, 1] * p[1] / p[2] + K[1, 2])
                _draw_line(img, (cx, cy), uv, color)
    return img
