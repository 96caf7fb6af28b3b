"""Distributed bundle adjustment: landmark shards + Schur reduction by psum.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/slam/dba.py``. Tag
landmarks and their observations are partitioned into map blocks; each
shard linearizes only its local factors and computes its additive part of
the reduced camera system, and a psum over the shards reduces it. The
cameras are replicated: every shard solves the small 6K system (matrix-free
PCG, ba._solve_reduced, whose every matvec psums its camera-side sum), then
back-substitutes its own landmarks. Nothing larger than (K, 6, 6) is summed
across shards.

The reference runs the shards under ``shard_map`` over the 'map' mesh axis.
Here, two ways:
  - without a group, the shards are a leading batch dimension on one
    device: the landmarks and observations of shard s are the s-th equal
    block of the partitioned arrays, each shard sums its observations into
    its own (K, ...) slots, and psum is a sum over the shard dimension;
  - with a ``torch.distributed`` group (the 'map' group of
    ``parallel/mesh.make_mesh``), one shard is one rank and psum is
    ``all_reduce``.

Observation partitioning invariant: every observation lives on the shard
that owns its landmark (obs_lm indexes shard-LOCAL landmark slots);
``partition_problem`` lays a problem out so.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ...detector import no_tf32
from .ba import (BAProblem, CamSlots, _apply_step, _back_substitute, _identity, _linearize,
                 _solve_reduced, _sparse_terms)


def _local_step(p: BAProblem, damping: float, cam: CamSlots, nshards: int, psum_scalar,
                cg_iters: int = 64):
    """One GN step of the shards in `p` (local landmarks and observations,
    replicated cameras); `cam` sums camera terms per shard and psums them."""
    r, Jc, Jl = _linearize(p)
    Hcc, gc, Hll, gl, Wo = _sparse_terms(p, r, Jc, Jl, damping, cam)

    # Hcc/gc accumulate per shard (every obs contributes) -> psum.
    # NB damping*I was added per shard; renormalize after psum.
    extra = (nshards - 1) * damping
    Hcc_sum = cam.psum(Hcc) - extra * torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    gc_sum = cam.psum(gc)

    dx_c, Hll_inv = _solve_reduced(Hcc_sum, gc_sum, Hll, gl, Wo, p.obs_kf, p.obs_lm,
                                   fix_first_cam=True, cg_iters=cg_iters, cam=cam)
    dx_l = _back_substitute(Hll_inv, gl, Wo, p.obs_lm, p.obs_kf, dx_c)
    new = _apply_step(p, dx_c, dx_l)
    nobs = torch.clamp(psum_scalar(p.obs_valid.sum()), min=1)
    rms = torch.sqrt(psum_scalar((r * r).sum()) / (8.0 * nobs))
    return new, rms


def _all_reduce(group):
    def psum(v: torch.Tensor) -> torch.Tensor:
        v = v.clone()
        dist.all_reduce(v, group=group)
        return v
    return psum


def make_distributed_solver(iters: int = 10, damping: float = 1e-4, *,
                            nshards: int | None = None, group=None):
    """A landmark-sharded BA solver: solver(p) -> (p, (iters,) rms).

    `p` is ``partition_problem(problem, n)``'s layout, the same on every
    rank, on the device the solver runs on; the result has that layout too,
    with every landmark (with a group, the ranks' landmarks are all-gathered
    at the end). Without `group` the n = nshards shards are a batch on p's
    device; with `group`, n is the group's size and each rank solves its
    own shard."""
    if group is None:
        if nshards is None or nshards < 1:
            raise ValueError("nshards must be >= 1 without a group")
    elif nshards is not None and nshards != dist.get_world_size(group):
        raise ValueError(f"nshards={nshards} but the group has "
                         f"{dist.get_world_size(group)} ranks")

    def solver(p: BAProblem) -> tuple[BAProblem, torch.Tensor]:
        if p.cam_R.is_cuda:
            no_tf32()
        Kn = p.cam_R.shape[0]
        if group is None:
            n = nshards
            per_L, per_O = p.lm_R.shape[0] // n, p.obs_kf.shape[0] // n
            shard = torch.arange(p.obs_kf.shape[0], device=p.obs_kf.device) // per_O
            local = p._replace(obs_lm=p.obs_lm + shard * per_L)    # shard-batch slots
            cam = CamSlots(shard * Kn + p.obs_kf, n * Kn,
                           lambda v: v.reshape(n, Kn, *v.shape[1:]).sum(0))
            psum_scalar = _identity      # the batch's sums already span every shard
        else:
            n, rank = dist.get_world_size(group), dist.get_rank(group)
            per_L, per_O = p.lm_R.shape[0] // n, p.obs_kf.shape[0] // n
            L0, O0 = rank * per_L, rank * per_O
            local = p._replace(lm_R=p.lm_R[L0:L0 + per_L], lm_t=p.lm_t[L0:L0 + per_L],
                               obs_kf=p.obs_kf[O0:O0 + per_O], obs_lm=p.obs_lm[O0:O0 + per_O],
                               obs_uv=p.obs_uv[O0:O0 + per_O],
                               obs_valid=p.obs_valid[O0:O0 + per_O])
            cam = CamSlots(local.obs_kf, Kn, _all_reduce(group))
            psum_scalar = cam.psum
        rms = []
        for _ in range(iters):
            local, r = _local_step(local, damping, cam, n, psum_scalar)
            rms.append(r)
        if group is None:
            out = local._replace(obs_lm=p.obs_lm)
        else:
            gather = _all_gather(group)
            out = p._replace(cam_R=local.cam_R, cam_t=local.cam_t,
                             lm_R=gather(local.lm_R), lm_t=gather(local.lm_t))
        return out, torch.stack(rms)

    return solver


def _all_gather(group):
    def gather(v: torch.Tensor) -> torch.Tensor:
        out = torch.empty((dist.get_world_size(group) * v.shape[0], *v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        dist.all_gather_into_tensor(out, v.contiguous(), group=group)
        return out
    return gather


def partition_problem(p: BAProblem, nshards: int) -> BAProblem:
    """Host-side re-layout: pad landmarks/observations to shard multiples and
    re-index observations to (shard-local landmark slots), ordered so that a
    plain equal split over the leading axis respects the ownership invariant.
    A numpy copy of the reference's; the result lies on p's device."""
    dev = p.cam_R.device
    Ln = p.lm_R.shape[0]
    O = p.obs_kf.shape[0]
    Lpad = -(-Ln // nshards) * nshards
    per_shard_L = Lpad // nshards

    lm_R = np.zeros((Lpad, 3, 3), np.float32)
    lm_R[:, ] = np.eye(3)
    lm_R[:Ln] = p.lm_R.cpu().numpy()
    lm_t = np.zeros((Lpad, 3), np.float32)
    lm_t[:Ln] = p.lm_t.cpu().numpy()

    obs_kf = p.obs_kf.cpu().numpy()
    obs_lm = p.obs_lm.cpu().numpy()
    obs_uv = p.obs_uv.cpu().numpy()
    obs_valid = p.obs_valid.cpu().numpy()

    # landmark l lives on shard l // per_shard_L (contiguous blocks)
    owner = obs_lm // per_shard_L
    per_shard_O = int(max((np.bincount(owner[obs_valid], minlength=nshards)).max()
                          if obs_valid.any() else 1, 1))
    kf2 = np.zeros((nshards, per_shard_O), np.int64)
    lm2 = np.zeros((nshards, per_shard_O), np.int64)
    uv2 = np.zeros((nshards, per_shard_O, 4, 2), np.float32)
    va2 = np.zeros((nshards, per_shard_O), bool)
    fill = np.zeros(nshards, np.int64)
    for o in range(O):
        if not obs_valid[o]:
            continue
        s = int(owner[o])
        i = int(fill[s])
        kf2[s, i] = obs_kf[o]
        lm2[s, i] = obs_lm[o] % per_shard_L  # local slot
        uv2[s, i] = obs_uv[o]
        va2[s, i] = True
        fill[s] += 1
    return p._replace(
        lm_R=torch.from_numpy(lm_R).to(dev), lm_t=torch.from_numpy(lm_t).to(dev),
        obs_kf=torch.from_numpy(kf2.reshape(-1)).to(dev),
        obs_lm=torch.from_numpy(lm2.reshape(-1)).to(dev),
        obs_uv=torch.from_numpy(uv2.reshape(-1, 4, 2)).to(dev),
        obs_valid=torch.from_numpy(va2.reshape(-1)).to(dev),
    )
