"""Batched geometry primitives: quaternions, homographies, small solves.

``isaac_ros_apriltag_tpu/utils/geometry.py`` ported as written: Shepperd
quaternion conversion, the exact 4-point DLT homography (an 8x8 solve on
Hartley-normalized coordinates, no SVD), the closed-form 3x3 inverse, the
Newton polar projection onto SO(3), and the se(3) exponential and skew
matrix of the SLAM layer. All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z);
    the largest-magnitude component is made positive."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], -2)      # (..., 4 candidates, 4)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = torch.argmax(pivots, -1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    lead = torch.gather(q, -1, torch.argmax(q.abs(), -1, keepdim=True))
    return q * torch.where(lead < 0, -1.0, 1.0)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def homography_from_correspondences(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homography src -> dst with H[2, 2] = 1. src, dst:
    (..., 4, 2). A singular system gives non-finite entries, not an error."""
    c = dst.mean(-2, keepdim=True)
    s = torch.clamp((dst - c).abs().mean((-2, -1)), min=1e-6)
    dstn = (dst - c) / s[..., None, None]
    x, y = src[..., 0], src[..., 1]
    u, v = dstn[..., 0], dstn[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([rows_u, rows_v], -2)                # (..., 8, 8)
    b = torch.cat([u, v], -1)[..., None]               # (..., 8, 1)
    h = torch.linalg.solve_ex(A, b).result[..., 0]     # (..., 8)
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)
    cx, cy = c[..., 0, 0], c[..., 0, 1]
    row01 = Hn[..., :2, :] * s[..., None, None]
    row01 = row01 + torch.stack([cx, cy], -1)[..., None] * Hn[..., 2:3, :]
    return torch.cat([row01, Hn[..., 2:3, :]], -2)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = torch.einsum("...ij,...nj->...ni", H, ph)
    return q[..., :2] / q[..., 2:3]


def line_intersection(p1: torch.Tensor, d1: torch.Tensor, p2: torch.Tensor,
                      d2: torch.Tensor) -> torch.Tensor:
    """Intersect lines (point p, direction d); all (..., 2). Parallel pairs
    return the midpoint of p1, p2."""
    det = d1[..., 0] * (-d2[..., 1]) - (-d2[..., 0]) * d1[..., 1]
    rhs = p2 - p1
    degenerate = det.abs() < 1e-9
    t = (rhs[..., 0] * (-d2[..., 1]) - (-d2[..., 0]) * rhs[..., 1]) / torch.where(
        degenerate, 1.0, det)
    pt = p1 + t[..., None] * d1
    mid = 0.5 * (p1 + p2)
    return torch.where(degenerate[..., None], mid, pt)


def inverse3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hh = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, Hh, I], -1)], -2)
    return adj * inv_det[..., None, None]


def orthonormalize_rotation(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Project (..., 3, 3) with det > 0 onto SO(3): Newton polar iteration
    X <- (X + X^-T) / 2."""
    X = M
    for _ in range(iters):
        X = 0.5 * (X + inverse3x3(X).transpose(-1, -2))
    return X


def se3_exp(tau: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) exponential. tau: (..., 6) = (omega, v). Returns (R, t). Below
    an angle of 1e-6 rad, R = I + skew(omega) and t = v, selected with
    torch.where, so forward-mode derivatives at tau = 0 are finite."""
    omega, v = tau[..., :3], tau[..., 3:]
    theta = torch.clamp(torch.linalg.vector_norm(omega, dim=-1, keepdim=True), min=1e-12)
    K = skew(omega / theta)
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    I = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(K.shape)
    KK = torch.einsum("...ij,...jk->...ik", K, K)
    R = I + st * K + (1 - ct) * KK
    th = theta[..., None]
    V = I + ((1 - ct) / th) * K + ((th - st) / th) * KK
    small = (theta < 1e-6)[..., None]
    R = torch.where(small, I + skew(omega), R)
    t = torch.where(small[..., 0], v, torch.einsum("...ij,...j->...i", V, v))
    return R, t


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)
