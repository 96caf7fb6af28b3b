"""Tag-map bundle adjustment: batched Gauss-Newton with Schur elimination.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/slam/ba.py``, run eagerly
on the problem's device. The problem:

  states:  keyframe camera poses T_w_cam (K of them) and tag landmark poses
           T_w_tag (L of them), both as (R, t); increments in se(3);
  factors: one observation = the 4 corners of one tag seen from one
           keyframe; residual = the 8-dim reprojection error, with the
           detector's corner convention (utils/render.TAG_CORNERS).

The normal equations are bipartite, H = [[Hcc, W], [W^T, Hll]] with
block-diagonal Hcc (6x6 a keyframe) and Hll (6x6 a landmark). The landmarks
are eliminated by the Schur complement S = Hcc - W Hll^-1 W^T, which is only
ever applied to vectors: per-observation gathers, einsums and scatter-adds
over the observation list, so a matvec costs O(O) whatever K * L. It is
solved by block-Jacobi preconditioned CG; the landmark updates
back-substitute. Observations are a capacity-O list with a valid mask.

How the port computes what the reference's XLA does:
  - Jacobians: torch.func.vmap(torch.func.jacfwd(...)) of the
    per-observation residual at the zero increment (forward mode, as the
    reference's jax.vmap(jax.jacfwd(...))).
  - Every scatter-add ``zeros.at[idx].add(x)`` is ``index_add_``, which sums
    repeated indices. ``t[idx] += x`` would keep one of each repeated index,
    and every observation list repeats keyframes and landmarks.
  - The CG is ``jax.scipy.sparse.linalg.cg``'s recurrence and stopping rule
    (``cg``). It always runs cg_iters iterations and freezes its state with
    torch.where once the rule is met, so no Gauss-Newton step reads a value
    back to the host.
  - f32 throughout, as the reference runs without x64; the 6x6 blocks are
    inverted explicitly (torch.linalg.inv_ex: inv without its host-side
    error check). TF32 is turned off on the card (detector.no_tf32).
  - ``index_add_`` on CUDA adds with atomics in no fixed order, so the card's
    BA is held to tolerances, not bit for bit, and two runs on the card may
    differ in the last bits.

The camera-side sums go through ``CamSlots``, so the landmark-sharded solver
(dba.py) runs these same functions with its per-shard sums and their psum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from ...detector import no_tf32
from ...ops.pose import _tag_corners
from ...utils.geometry import se3_exp


class BAProblem(NamedTuple):
    # states
    cam_R: torch.Tensor      # (K, 3, 3) float32 R_world_cam
    cam_t: torch.Tensor      # (K, 3)
    lm_R: torch.Tensor       # (L, 3, 3) R_world_tag
    lm_t: torch.Tensor       # (L, 3)
    # observations (fixed capacity O)
    obs_kf: torch.Tensor     # (O,) int64 keyframe index
    obs_lm: torch.Tensor     # (O,) int64 landmark index
    obs_uv: torch.Tensor     # (O, 4, 2) float32 observed corners (pixels)
    obs_valid: torch.Tensor  # (O,) bool
    # calibration
    K: torch.Tensor          # (3, 3) float32 intrinsics
    tag_size: torch.Tensor   # () float32


class CamSlots(NamedTuple):
    """Where per-observation camera terms are summed: into `count` local
    camera slots at `index` (O,); `psum` reduces the (count, ...) local sums
    to the (K, ...) totals. One problem: index obs_kf, count K, psum the
    identity; dba.py builds the landmark-sharded kinds."""
    index: torch.Tensor
    count: int
    psum: Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _slots(obs_kf: torch.Tensor, Kn: int, cam: CamSlots | None) -> CamSlots:
    return CamSlots(obs_kf, Kn, _identity) if cam is None else cam


def _scatter_add(n: int, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """zeros((n, ...)).at[idx].add(v): repeated indices sum."""
    return torch.zeros((n, *v.shape[1:]), dtype=v.dtype, device=v.device).index_add_(0, idx, v)


def _project(K, pts_cam):
    z = torch.clamp(pts_cam[..., 2:3], min=1e-6)
    uv = pts_cam[..., :2] / z
    return torch.stack([K[0, 0] * uv[..., 0] + K[0, 2],
                        K[1, 1] * uv[..., 1] + K[1, 2]], -1)


def _obs_residual(cam_inc, lm_inc, cam_R, cam_t, lm_R, lm_t, uv, K, tag_size):
    """8-dim reprojection residual for one observation, as a function of the
    se(3) increments (linearization point at zero)."""
    dRc, dtc = se3_exp(cam_inc)
    dRl, dtl = se3_exp(lm_inc)
    Rc = cam_R @ dRc
    tc = cam_t + cam_R @ dtc
    Rl = lm_R @ dRl
    tl = lm_t + lm_R @ dtl
    corners = _tag_corners(uv.device) * (tag_size * 0.5)
    corners_tag = torch.cat([corners, torch.zeros_like(corners[:, :1])], -1)
    p_w = corners_tag @ Rl.mT + tl                     # (4, 3)
    p_c = (p_w - tc) @ Rc                              # R_c^T (p - t): (4, 3)
    return (_project(K, p_c) - uv).reshape(8)


def _linearize(p: BAProblem):
    """Per-observation residuals + Jacobians at the current linearization
    point. Returns r (O, 8), Jc (O, 8, 6), Jl (O, 8, 6), masked."""
    cam_R = p.cam_R[p.obs_kf]
    cam_t = p.cam_t[p.obs_kf]
    lm_R = p.lm_R[p.obs_lm]
    lm_t = p.lm_t[p.obs_lm]

    def rfun(ci, li, CR, Ct, LR, Lt, uv):
        r = _obs_residual(ci, li, CR, Ct, LR, Lt, uv, p.K, p.tag_size)
        return r, r

    z6 = torch.zeros(6, dtype=p.cam_t.dtype, device=p.cam_t.device)
    (Jc, Jl), r = vmap(jacfwd(rfun, argnums=(0, 1), has_aux=True),
                       in_dims=(None, None, 0, 0, 0, 0, 0))(z6, z6, cam_R, cam_t, lm_R, lm_t,
                                                            p.obs_uv)
    m = p.obs_valid.to(r.dtype)
    return r * m[:, None], Jc * m[:, None, None], Jl * m[:, None, None]


def _sparse_terms(p: BAProblem, r, Jc, Jl, damping, cam: CamSlots | None = None):
    """Block-diagonal Hcc (in `cam`'s local slots) and Hll, the gradients,
    and the PER-OBSERVATION W blocks Wo (O, 6, 6): the (K, L, 6, 6) cross
    table is never materialized, since the observation list is exactly its
    nonzero support."""
    cam = _slots(p.obs_kf, p.cam_R.shape[0], cam)
    Ln = p.lm_R.shape[0]
    Hcc = _scatter_add(cam.count, cam.index, torch.einsum("oij,oik->ojk", Jc, Jc))
    gc = _scatter_add(cam.count, cam.index, torch.einsum("oij,oi->oj", Jc, r))
    Hll = _scatter_add(Ln, p.obs_lm, torch.einsum("oij,oik->ojk", Jl, Jl))
    gl = _scatter_add(Ln, p.obs_lm, torch.einsum("oij,oi->oj", Jl, r))
    Wo = torch.einsum("oij,oik->ojk", Jc, Jl)             # (O, 6, 6)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    return Hcc + damping * eye, gc, Hll + damping * eye, gl, Wo


_GAUGE = 1e8  # prior stiffness pinning keyframe 0 (gauge freedom)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum()


def cg(matvec, b: torch.Tensor, precond, maxiter: int, tol: float = 1e-5) -> torch.Tensor:
    """Solve A x = b by preconditioned CG from x = 0, with the recurrence and
    stopping rule of ``jax.scipy.sparse.linalg.cg(matvec, b, M=precond,
    maxiter=maxiter, tol=tol)``: iterate while |r|^2 > tol^2 |b|^2 and fewer
    than maxiter iterations ran. All maxiter iterations are computed; once
    the rule is met, x, r, gamma and p stay as they were (torch.where), so
    the result is JAX's without a read back to the host."""
    atol2 = tol * tol * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = precond(r)
    gamma = _vdot(r, p)
    for _ in range(maxiter):
        go = _vdot(r, r) > atol2
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond(r_)
        gamma_ = _vdot(r_, z_)
        p_ = z_ + (gamma_ / gamma) * p
        x, r, p = torch.where(go, x_, x), torch.where(go, r_, r), torch.where(go, p_, p)
        gamma = torch.where(go, gamma_, gamma)
    return x


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the host-side error check (a singular block
    gives non-finite entries, as in the reference)."""
    return torch.linalg.inv_ex(A).inverse


def _solve_reduced(Hcc_tot, gc_tot, Hll, gl, Wo, obs_kf, obs_lm, *,
                   fix_first_cam: bool, cg_iters: int, cam: CamSlots | None = None):
    """Solve the Schur-reduced camera system S dx_c = -b MATRIX-FREE, by
    block-Jacobi PCG (the Hcc block inverses). The observation sums on the
    camera side go through `cam` (psum-reduced across landmark shards;
    Hcc_tot and gc_tot must already be reduced). Returns (dx_c, Hll_inv)."""
    Kn = Hcc_tot.shape[0]
    cam = _slots(obs_kf, Kn, cam)
    Hll_inv = _inv(Hll)                                   # (L, 6, 6) local
    gauge = torch.zeros_like(Hcc_tot)
    if fix_first_cam:
        gauge[0] = _GAUGE * torch.eye(6, dtype=gauge.dtype, device=gauge.device)
    Hcc_g = Hcc_tot + gauge
    Ln = gl.shape[0]

    def matvec(x):                                        # x (K, 6)
        y = torch.einsum("oij,oi->oj", Wo, x[obs_kf])     # W^T x per obs
        z = torch.einsum("lij,lj->li", Hll_inv, _scatter_add(Ln, obs_lm, y))
        u = torch.einsum("oij,oj->oi", Wo, z[obs_lm])     # W z per obs
        wsum = cam.psum(_scatter_add(cam.count, cam.index, u))
        return torch.einsum("kij,kj->ki", Hcc_g, x) - wsum

    # b = gc - W Hll^-1 gl
    ygl = torch.einsum("lij,lj->li", Hll_inv, gl)
    b = gc_tot - cam.psum(_scatter_add(cam.count, cam.index,
                                       torch.einsum("oij,oj->oi", Wo, ygl[obs_lm])))
    Minv = _inv(Hcc_g)                                    # block-Jacobi

    def precond(x):
        return torch.einsum("kij,kj->ki", Minv, x)

    return cg(matvec, -b, precond, maxiter=cg_iters, tol=1e-10), Hll_inv


def _apply_step(p: BAProblem, dx_c, dx_l) -> BAProblem:
    dRc, dtc = se3_exp(dx_c)
    dRl, dtl = se3_exp(dx_l)
    return p._replace(
        cam_R=torch.einsum("kij,kjm->kim", p.cam_R, dRc),
        cam_t=p.cam_t + torch.einsum("kij,kj->ki", p.cam_R, dtc),
        lm_R=torch.einsum("lij,ljm->lim", p.lm_R, dRl),
        lm_t=p.lm_t + torch.einsum("lij,lj->li", p.lm_R, dtl),
    )


def _back_substitute(Hll_inv, gl, Wo, obs_lm, obs_kf, dx_c):
    """Hll dx_l = -gl - W^T dx_c, per-observation scatter (local shard)."""
    y = torch.einsum("oij,oi->oj", Wo, dx_c[obs_kf])     # (O, 6)
    rhs = -gl - _scatter_add(gl.shape[0], obs_lm, y)
    return torch.einsum("lij,lj->li", Hll_inv, rhs)


def gauss_newton_step(p: BAProblem, damping: float = 1e-4, fix_first_cam: bool = True,
                      cg_iters: int = 64) -> tuple[BAProblem, torch.Tensor]:
    """One damped GN step with matrix-free Schur elimination; returns the
    updated problem and the step's 0-dim rms residual (pixels)."""
    if p.cam_R.is_cuda:
        no_tf32()
    r, Jc, Jl = _linearize(p)
    Hcc, gc, Hll, gl, Wo = _sparse_terms(p, r, Jc, Jl, damping)
    dx_c, Hll_inv = _solve_reduced(Hcc, gc, Hll, gl, Wo, p.obs_kf, p.obs_lm,
                                   fix_first_cam=fix_first_cam, cg_iters=cg_iters)
    dx_l = _back_substitute(Hll_inv, gl, Wo, p.obs_lm, p.obs_kf, dx_c)
    new = _apply_step(p, dx_c, dx_l)
    nobs = torch.clamp(p.obs_valid.sum(), min=1)
    rms = torch.sqrt((r * r).sum() / (8.0 * nobs))
    return new, rms


def solve(p: BAProblem, iters: int = 10, damping: float = 1e-4
          ) -> tuple[BAProblem, torch.Tensor]:
    """Run `iters` GN steps; returns the problem and the (iters,) rms of
    each step (taken at the step's linearization point)."""
    rms = []
    for _ in range(iters):
        p, r = gauss_newton_step(p, damping)
        rms.append(r)
    return p, torch.stack(rms)
