"""Carry the reference package's parameters across to this one.

The detector has no learned weights: its parameters are the camera, the tag
family and the config, and the graph pipeline's rectification plan; the
SLAM layer's state is its problem (a BA problem, a pose graph). These
functions build the port's objects from plain values and numpy arrays, so a
caller holding the reference package's objects
(``np.asarray(cam.K)``, ``dataclasses.asdict(cfg)``, a ``TagFamily``'s fields)
runs both packages on exactly the same parameters. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .camera.model import CameraModel
from .config import DetectorConfig
from .models.families import TagFamily
from .ops.remap import SeparableRectify
from .parallel.slam.ba import BAProblem
from .parallel.slam.posegraph import PoseGraph


def camera_from_reference(K, dist, width: int, height: int) -> CameraModel:
    """(3, 3) intrinsics + (5,) plumb_bob coefficients -> CameraModel."""
    K = np.asarray(K, np.float32).reshape(3, 3)
    dist = np.asarray(dist, np.float32).reshape(5)
    return CameraModel(K=torch.from_numpy(K.copy()), dist=torch.from_numpy(dist.copy()),
                       width=int(width), height=int(height))


def family_from_reference(name: str, nbits: int, min_hamming: int, total_width: int,
                          width_at_border: int, reversed_border: bool, bit_x, bit_y,
                          codes, exact: bool) -> TagFamily:
    """A tag family's fields -> TagFamily (register it with register_family
    to make a Detector use it)."""
    return TagFamily(name=str(name), nbits=int(nbits), min_hamming=int(min_hamming),
                     total_width=int(total_width), width_at_border=int(width_at_border),
                     reversed_border=bool(reversed_border),
                     bit_x=np.asarray(bit_x, np.int32), bit_y=np.asarray(bit_y, np.int32),
                     codes=np.asarray(codes).astype(np.uint64), exact=bool(exact))


def config_from_reference(fields: dict, backend: str = "cuda") -> DetectorConfig:
    """The reference config's fields (dataclasses.asdict) -> DetectorConfig
    with this package's `backend`; a reference backend 'xla' (its oracle
    flow) becomes ccl_flow='jumps', any other 'scan'. Unknown fields raise."""
    names = {f.name for f in dataclasses.fields(DetectorConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"fields unknown to this package's DetectorConfig: {sorted(unknown)}")
    flow = "jumps" if fields.get("backend") == "xla" else "scan"
    return DetectorConfig(**{"ccl_flow": flow, **fields, "backend": backend})


def ba_problem_from_reference(cam_R, cam_t, lm_R, lm_t, obs_kf, obs_lm, obs_uv, obs_valid, K,
                              tag_size, device: torch.device | str = "cuda") -> BAProblem:
    """A reference BAProblem's fields (numpy, e.g. ``{k: np.asarray(v) for
    k, v in p._asdict().items()}``) -> the port's BAProblem on `device`:
    float32 states and observations, int64 indices, a bool mask."""
    f32, idx, mask = (functools.partial(_tensor, dtype=d, device=device)
                      for d in (np.float32, np.int64, bool))
    return BAProblem(cam_R=f32(cam_R), cam_t=f32(cam_t), lm_R=f32(lm_R), lm_t=f32(lm_t),
                     obs_kf=idx(obs_kf), obs_lm=idx(obs_lm), obs_uv=f32(obs_uv),
                     obs_valid=mask(obs_valid), K=f32(K), tag_size=f32(tag_size))


def pose_graph_from_reference(R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                              device: torch.device | str = "cuda") -> PoseGraph:
    """A reference PoseGraph's fields (numpy) -> the port's PoseGraph on
    `device`."""
    f32, idx, mask = (functools.partial(_tensor, dtype=d, device=device)
                      for d in (np.float32, np.int64, bool))
    return PoseGraph(R=f32(R), t=f32(t), edge_i=idx(edge_i), edge_j=idx(edge_j),
                     edge_R=f32(edge_R), edge_t=f32(edge_t), edge_valid=mask(edge_valid))


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(device)


def rectify_from_reference(sx2, sy2, dx_range, dy_range) -> SeparableRectify:
    """A reference SeparableRectify plan's arrays and band ranges ->
    SeparableRectify, so both packages resample with the same plan."""
    return SeparableRectify(sx2=torch.from_numpy(np.array(sx2, np.float32)),
                            sy2=torch.from_numpy(np.array(sy2, np.float32)),
                            dx_range=tuple(int(d) for d in dx_range),
                            dy_range=tuple(int(d) for d in dy_range))
