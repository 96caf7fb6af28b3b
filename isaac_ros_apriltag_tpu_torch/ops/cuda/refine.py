"""Wrapper of the top-2T pick and edge refinement kernel
(csrc/tail.cu::refine_kernel).

``select_and_refine`` (the detect path's: the top-2T pick and refine in one
launch, each block picking its frame's quad of its rank, then refining it)
checks its input, then on CPU tensors runs the plain version (ops/tail.py::
select_and_refine: ops/tail.py::select_candidates, then ops/refine.py::
refine_edges); on CUDA tensors it launches the kernel or raises and adds
one to ``launches``. One launch picks and refines every quad of the call,
on the current stream, into outputs allocated here by torch.empty, with no
host sync, so a detect call that runs it can be captured in a CUDA graph. The kernel stages the profiles in chunks and
carries each point's sums from chunk to chunk, so it takes any search
range the plain version takes.
"""

from __future__ import annotations

import torch

from .. import refine as plain
from .. import tail as plain_tail
from ..tail import RefinedCandidates
from . import _lib
from .tail import _check

launches = 0   # refine_kernel launches made by select_and_refine


def select_and_refine(gray: torch.Tensor, corners: torch.Tensor, valid: torch.Tensor,
                      dark_inside: torch.Tensor, fit_err: torch.Tensor, *, want_dark: bool,
                      k: int, decimate: int, search_range: float) -> RefinedCandidates:
    """The plain version's signature and results, bit for bit: (B, H, W)
    float32 gray frames, (B, C, 4, 2) float32 corners in the decimated image,
    (B, C) valid and dark_inside (bool) and fit_err (float32); 1 <= k <= C,
    decimate >= 1. One block a picked quad, B k blocks."""
    global launches
    if corners.ndim != 4:
        raise ValueError(f"corners must be (B, C, 4, 2), got {tuple(corners.shape)}")
    B, C = corners.shape[:2]
    dev = _check({"corners": (corners, torch.float32, (4, 2)),
                  "valid": (valid, torch.bool, ()), "dark_inside": (dark_inside, torch.bool, ()),
                  "fit_err": (fit_err, torch.float32, ())}, B, C, "select_and_refine")
    if (gray.dtype != torch.float32 or gray.ndim != 3 or gray.shape[0] != B
            or not gray.is_contiguous() or gray.device != dev):
        raise ValueError(f"select_and_refine: gray must be a contiguous float32 ({B}, H, W) "
                         f"tensor on {dev}, got {gray.dtype} {tuple(gray.shape)} on {gray.device}")
    H, W = gray.shape[1:]
    first, P = plain.profile(search_range)
    if not (1 <= k <= C and decimate >= 1 and B * k < 2 ** 31 and H >= 1 and W >= 1
            and P < 2 ** 24):
        raise ValueError(f"select_and_refine: k must be in [1, {C}], decimate >= 1, the image "
                         f"non-empty and fewer than 2^24 profile samples; got k {k}, decimate "
                         f"{decimate}, {H}x{W} and {P}")
    kw = dict(want_dark=want_dark, k=k, decimate=decimate, search_range=search_range)
    if dev.type == "cpu":
        return plain_tail.select_and_refine(gray, corners, valid, dark_inside, fit_err, **kw)
    out = RefinedCandidates(corners=torch.empty((B, k, 4, 2), dtype=torch.float32, device=dev),
                            pre_valid=torch.empty((B, k), dtype=torch.bool, device=dev),
                            num_quads=torch.empty(B, dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_select_refine(
            gray.data_ptr(), corners.data_ptr(), valid.data_ptr(), dark_inside.data_ptr(),
            fit_err.data_ptr(), *(t.data_ptr() for t in out), B, C, k, H, W, P,
            _lib.float_bits(first), _lib.float_bits(search_range + 0.5), int(want_dark),
            decimate, torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_select_refine")
    launches += 1
    return out
