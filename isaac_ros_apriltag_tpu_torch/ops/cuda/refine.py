"""Wrapper of the edge refinement kernel (csrc/tail.cu::refine_kernel).

``refine_edges`` checks its input, then on CPU tensors runs the plain
version (ops/refine.py::refine_edges); on CUDA tensors it launches the
kernel or raises and adds one to ``launches``. One launch refines every
quad of the call, on the current stream, into an output allocated here by
torch.empty, with no host sync, so a detect call that runs it can be
captured in a CUDA graph. The kernel stages the profiles in chunks and
carries each point's sums from chunk to chunk, so it takes any search
range the plain version takes.
"""

from __future__ import annotations

import torch

from .. import refine as plain
from . import _lib

launches = 0    # refine_kernel launches made by refine_edges


def refine_edges(gray: torch.Tensor, corners: torch.Tensor, dark_inside: torch.Tensor, *,
                 search_range: float = 2.0) -> torch.Tensor:
    """The plain version's signature and results, bit for bit: gray (H, W)
    float32 with corners (C, 4, 2) float32 and dark_inside (C,) bool, or a
    batch of each, (B, H, W), (B, C, 4, 2) and (B, C); all contiguous."""
    global launches
    if gray.dtype != torch.float32 or corners.dtype != torch.float32 or (
            dark_inside.dtype != torch.bool):
        raise ValueError(f"gray and corners must be float32 and dark_inside bool, got "
                         f"{gray.dtype}, {corners.dtype} and {dark_inside.dtype}")
    if corners.ndim not in (3, 4) or corners.shape[-2:] != (4, 2) or (
            gray.ndim != corners.ndim - 1 or gray.shape[:-2] != corners.shape[:-3]
            or dark_inside.shape != corners.shape[:-2]):
        raise ValueError("corners must be (C, 4, 2) with an (H, W) gray and (C,) dark_inside, "
                         "or (B, C, 4, 2) with (B, H, W) and (B, C); got "
                         f"{tuple(corners.shape)}, {tuple(gray.shape)} and "
                         f"{tuple(dark_inside.shape)}")
    if not (gray.is_contiguous() and corners.is_contiguous() and dark_inside.is_contiguous()):
        raise ValueError("gray, corners and dark_inside must be contiguous")
    if not gray.device == corners.device == dark_inside.device:
        raise ValueError(f"gray on {gray.device}, corners on {corners.device}, dark_inside on "
                         f"{dark_inside.device}")
    H, W = gray.shape[-2:]
    B = gray.shape[0] if gray.ndim == 3 else 1
    C = corners.shape[-3]
    first, P = plain.profile(search_range)
    if not (1 <= B * C < 2 ** 31 and H >= 1 and W >= 1 and P < 2 ** 24):
        raise ValueError(f"the kernel takes 1 to 2^31 - 1 quads, a non-empty image and fewer "
                         f"than 2^24 profile samples; got {B * C} quads, {H}x{W} and {P}")
    if corners.device.type == "cpu":
        return plain.refine_edges(gray, corners, dark_inside, search_range=search_range)
    if corners.device.type != "cuda":
        raise ValueError(f"unsupported device {corners.device}")
    out = torch.empty_like(corners)
    with torch.cuda.device(corners.device):
        status = _lib.library().apriltag_refine(
            gray.data_ptr(), corners.data_ptr(), dark_inside.data_ptr(), out.data_ptr(), B, C,
            H, W, P, _lib.float_bits(first), _lib.float_bits(search_range + 0.5),
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_refine")
    launches += 1
    return out
