"""Batched geometry primitives: quaternions, homographies, small solves.

``isaac_ros_apriltag_tpu/utils/geometry.py`` ported: Shepperd quaternion
conversion, the exact 4-point DLT homography (an 8x8 solve on
Hartley-normalized coordinates, no SVD), the closed-form 3x3 inverse, the
Newton polar projection onto SO(3), and the se(3) exponential and skew
matrix of the SLAM layer. All functions broadcast over leading batch dims.

The homography, its 8x8 solve, ``apply_homography`` and
``quat_from_rotmat`` are the plain versions of the decode and pose kernels'
steps (csrc/tail.cu): every float sum is written out in the one order the
kernels take, with elementwise torch ops only (no einsum, matmul, norm,
mean or LAPACK solve, whose order on a GPU is not fixed), so the kernels
match them bit for bit.
"""

from __future__ import annotations

import torch


def first_argmax(vals: list[torch.Tensor]) -> torch.Tensor:
    """Index of the largest of `vals` (tensors of one shape), as torch.argmax
    takes it: NaN counts as the largest, ties go to the lower index."""
    best = torch.zeros(vals[0].shape, dtype=torch.int64, device=vals[0].device)
    top = vals[0]
    for i, v in enumerate(vals[1:], 1):
        take = (v > top) | (torch.isnan(v) & ~torch.isnan(top))
        best = torch.where(take, i, best)
        top = torch.where(take, v, top)
    return best


def _pick(vals: list[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """vals[idx] elementwise."""
    out = vals[0]
    for i, v in enumerate(vals[1:], 1):
        out = torch.where(idx == i, v, out)
    return out


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z);
    the largest-magnitude component is made positive."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = (m00 + m11) + m22
    pivots = [1.0 + tr, ((1.0 + m00) - m11) - m22, ((1.0 - m00) + m11) - m22,
              ((1.0 - m00) - m11) + m22]
    cands = [[pivots[0], m21 - m12, m02 - m20, m10 - m01],
             [m21 - m12, pivots[1], m01 + m10, m02 + m20],
             [m02 - m20, m01 + m10, pivots[2], m12 + m21],
             [m10 - m01, m02 + m20, m12 + m21, pivots[3]]]
    best = first_argmax(pivots)
    q = [_pick([c[k] for c in cands], best) for k in range(4)]
    n = torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3])
    q = [qk / n for qk in q]
    lead = _pick(q, first_argmax([qk.abs() for qk in q]))
    sign = torch.where(lead < 0, -1.0, 1.0)
    return torch.stack([qk * sign for qk in q], -1)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def solve_pivoted(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for (..., n, n) A and (..., n) b, by Gaussian
    elimination with partial pivoting: the pivot of column k is the first
    row i >= k of largest |A[i, k]| (LAPACK's getrf rule; a NaN is taken
    only where it comes first). Row k's multiple f = A[i, k] / A[k, k] is
    taken off each row i > k as A[i, j] - f * A[k, j], then back
    substitution runs column by column from the last: x[j] = b[j] / A[j, j],
    b[i] - A[i, j] * x[j] for i < j. A zero pivot gives non-finite entries,
    not an error."""
    n = A.shape[-1]
    A, b = A.clone(), b.clone()
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = A[..., k:, k].abs()
        p = torch.zeros(col.shape[:-1], dtype=torch.int64, device=A.device)
        top = col[..., 0]
        for i in range(1, n - k):
            take = col[..., i] > top
            p = torch.where(take, i, p)
            top = torch.where(take, col[..., i], top)
        p = (p + k)[..., None]
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        A = torch.gather(A, -2, perm[..., None].expand(A.shape))
        b = torch.gather(b, -1, perm)
        f = A[..., k + 1:, k] / A[..., k, k, None]
        A[..., k + 1:, k + 1:] = A[..., k + 1:, k + 1:] - f[..., None] * A[..., k, None, k + 1:]
        b[..., k + 1:] = b[..., k + 1:] - f * b[..., k, None]
    x = [None] * n
    for j in range(n - 1, -1, -1):
        x[j] = b[..., j] / A[..., j, j]
        b[..., :j] = b[..., :j] - A[..., :j, j] * x[j][..., None]
    return torch.stack(x, -1)


def homography_from_correspondences(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homography src -> dst with H[2, 2] = 1. src, dst:
    (..., 4, 2). dst is centred on its mean and scaled by its mean absolute
    deviation (Hartley normalization); the 8x8 DLT system is solved by
    solve_pivoted. A singular system gives non-finite entries, not an
    error."""
    d = dst.unbind(-2)
    c = (((d[0] + d[1]) + d[2]) + d[3]) * 0.25                  # (..., 2)
    e = dst - c[..., None, :]
    a = e.abs().flatten(-2).unbind(-1)                          # |x0|, |y0|, |x1|, ...
    s = a[0]
    for ai in a[1:]:
        s = s + ai
    s = torch.clamp(s * 0.125, min=1e-6)
    dstn = e / s[..., None, None]
    x, y = src[..., 0], src[..., 1]
    u, v = dstn[..., 0], dstn[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([rows_u, rows_v], -2)                # (..., 8, 8)
    h = solve_pivoted(A, torch.cat([u, v], -1))        # (..., 8)
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)
    row01 = Hn[..., :2, :] * s[..., None, None] + c[..., :, None] * Hn[..., 2:3, :]
    return torch.cat([row01, Hn[..., 2:3, :]], -2)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2); each coordinate is
    (H[i, 0] * x + H[i, 1] * y) + H[i, 2], divided by the third."""
    x, y = pts[..., 0], pts[..., 1]
    q = [(H[..., i, 0, None] * x + H[..., i, 1, None] * y) + H[..., i, 2, None]
         for i in range(3)]
    return torch.stack([q[0] / q[2], q[1] / q[2]], -1)


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3), each entry (A[i, 0] B[0, j] + A[i, 1]
    B[1, j]) + A[i, 2] B[2, j]."""
    return ((A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :])
            + A[..., :, 2:3] * B[..., 2:3, :])


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
    inv_det = torch.reciprocal(torch.where(det.abs() < 1e-20, 1e-20, det))
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
