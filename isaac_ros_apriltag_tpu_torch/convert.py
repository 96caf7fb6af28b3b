"""Carry the reference package's parameters across to this one.

The detector has no learned weights: its parameters are the camera, the tag
family and the config, and the graph pipeline's rectification plan. These
functions build the port's objects from plain values and numpy arrays, so a
caller holding the reference package's objects
(``np.asarray(cam.K)``, ``dataclasses.asdict(cfg)``, a ``TagFamily``'s fields)
runs both packages on exactly the same parameters. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera.model import CameraModel
from .config import DetectorConfig
from .models.families import TagFamily
from .ops.remap import SeparableRectify


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
    with this package's `backend`. Unknown fields raise."""
    names = {f.name for f in dataclasses.fields(DetectorConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"fields unknown to this package's DetectorConfig: {sorted(unknown)}")
    return DetectorConfig(**{**fields, "backend": backend})


def rectify_from_reference(sx2, sy2, dx_range, dy_range) -> SeparableRectify:
    """A reference SeparableRectify plan's arrays and band ranges ->
    SeparableRectify, so both packages resample with the same plan."""
    return SeparableRectify(sx2=torch.from_numpy(np.array(sx2, np.float32)),
                            sy2=torch.from_numpy(np.array(sy2, np.float32)),
                            dx_range=tuple(int(d) for d in dx_range),
                            dy_range=tuple(int(d) for d in dy_range))
