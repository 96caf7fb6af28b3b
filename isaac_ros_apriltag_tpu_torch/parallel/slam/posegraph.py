"""Pose-graph optimization over keyframe poses (SE(3) relative-pose factors).

Counterpart of ``isaac_ros_apriltag_tpu/parallel/slam/posegraph.py``: nodes
are keyframe poses, edges relative transforms (loop closures, tag
co-observations). Dense damped Gauss-Newton: the keyframe count is small,
so the 6K x 6K normal system is one dense solve.

The reference adds each edge's 6x6 blocks with ``H.at[ei, :, ej, :]``, whose
two advanced indices are split by a slice, so numpy's rule puts the edge
axis first. Here H is built as (6K, 6K) from explicit flat row and column
indices with ``index_put_(accumulate=True)``, which sums repeated entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ...detector import no_tf32
from ...utils.geometry import se3_exp


class PoseGraph(NamedTuple):
    R: torch.Tensor           # (K, 3, 3) float32 node rotations R_world_node
    t: torch.Tensor           # (K, 3)
    edge_i: torch.Tensor      # (E,) int64
    edge_j: torch.Tensor      # (E,) int64
    edge_R: torch.Tensor      # (E, 3, 3) measured R_i_j
    edge_t: torch.Tensor      # (E, 3) measured t_i_j
    edge_valid: torch.Tensor  # (E,) bool


def _log_so3(R):
    """SO(3) log map (..., 3, 3) -> (..., 3), safe near identity. At the
    identity the cosine is clipped at 1, where arccos has no derivative; the
    angle's branch is then not selected (theta < 1e-6), so forward-mode
    Jacobians stay finite."""
    # The angle keeps a trailing dim of 1: under torch.func.jacfwd a 0-dim
    # per-sample tensor combined with a Python scalar gets a float64 tangent.
    tr = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.where(theta < 1e-6, torch.full_like(theta, 0.5),
                    theta / (2.0 * torch.sin(torch.clamp(theta, min=1e-6))))
    return w * s


def _edge_residual(xi, xj, Ri, ti, Rj, tj, Rm, tm):
    """12 -> 6 residual: log( (T_i dXi)^-1 (T_j dXj) ) - measurement."""
    dRi, dti = se3_exp(xi)
    dRj, dtj = se3_exp(xj)
    Ri2 = Ri @ dRi
    ti2 = ti + Ri @ dti
    Rj2 = Rj @ dRj
    tj2 = tj + Rj @ dtj
    Rij = Ri2.mT @ Rj2
    tij = Ri2.mT @ (tj2 - ti2)
    r_rot = _log_so3(Rm.mT @ Rij)
    r_t = tij - tm
    return torch.cat([r_rot, r_t])


def _linearize(g: PoseGraph):
    """Per-edge residuals r (E, 6) and Jacobians Ji, Jj (E, 6, 6) at the zero
    increment, masked by edge_valid."""
    Ri, ti = g.R[g.edge_i], g.t[g.edge_i]
    Rj, tj = g.R[g.edge_j], g.t[g.edge_j]

    def rfun(xi, xj, *rest):
        r = _edge_residual(xi, xj, *rest)
        return r, r

    z6 = torch.zeros(6, dtype=g.t.dtype, device=g.t.device)
    (Ji, Jj), r = vmap(jacfwd(rfun, argnums=(0, 1), has_aux=True),
                       in_dims=(None, None, 0, 0, 0, 0, 0, 0))(z6, z6, Ri, ti, Rj, tj,
                                                               g.edge_R, g.edge_t)
    m = g.edge_valid.to(r.dtype)
    return r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None]


def _add_blocks(H: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                blocks: torch.Tensor) -> None:
    """H (6K, 6K) += each (6, 6) block at block row rows[e], column cols[e];
    repeated blocks sum."""
    a = torch.arange(6, device=H.device)
    r = (rows[:, None, None] * 6 + a[None, :, None]).expand_as(blocks)
    c = (cols[:, None, None] * 6 + a[None, None, :]).expand_as(blocks)
    H.index_put_((r.reshape(-1), c.reshape(-1)), blocks.reshape(-1), accumulate=True)


def gauss_newton_step(g: PoseGraph, damping: float = 1e-6):
    if g.t.is_cuda:
        no_tf32()
    r, Ji, Jj = _linearize(g)
    Kn = g.R.shape[0]
    H = torch.zeros((Kn * 6, Kn * 6), dtype=r.dtype, device=r.device)
    _add_blocks(H, g.edge_i, g.edge_i, torch.einsum("eij,eik->ejk", Ji, Ji))
    _add_blocks(H, g.edge_j, g.edge_j, torch.einsum("eij,eik->ejk", Jj, Jj))
    _add_blocks(H, g.edge_i, g.edge_j, torch.einsum("eij,eik->ejk", Ji, Jj))
    _add_blocks(H, g.edge_j, g.edge_i, torch.einsum("eij,eik->ejk", Jj, Ji))
    b = torch.zeros((Kn, 6), dtype=r.dtype, device=r.device)
    b.index_add_(0, g.edge_i, torch.einsum("eij,ei->ej", Ji, r))
    b.index_add_(0, g.edge_j, torch.einsum("eij,ei->ej", Jj, r))

    H = H + damping * torch.eye(Kn * 6, dtype=r.dtype, device=r.device)
    # gauge: pin node 0
    H[:6, :6] += 1e8 * torch.eye(6, dtype=r.dtype, device=r.device)

    dx = torch.linalg.solve(H, -b.reshape(Kn * 6)).reshape(Kn, 6)
    dR, dt = se3_exp(dx)
    new = g._replace(R=torch.einsum("kij,kjm->kim", g.R, dR),
                     t=g.t + torch.einsum("kij,kj->ki", g.R, dt))
    nedge = torch.clamp(g.edge_valid.sum(), min=1)
    rms = torch.sqrt((r * r).sum() / (6.0 * nedge))
    return new, rms


def solve(g: PoseGraph, iters: int = 10, damping: float = 1e-6):
    """Run `iters` GN steps; returns the graph and the (iters,) rms."""
    rms = []
    for _ in range(iters):
        g, r = gauss_newton_step(g, damping)
        rms.append(r)
    return g, torch.stack(rms)
