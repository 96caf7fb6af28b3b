"""The leading batch dimension of the port.

Every stage runs on a batch of frames, (B, ...), with the frames independent
of each other; a single frame is a batch of one. A stage that is also called
with one frame uses `batch_first` to add the dimension and `first_frame` to
take it off its result again, so there is one implementation of each stage.
"""

from __future__ import annotations

import torch


def batch_first(x: torch.Tensor, frame_ndim: int) -> tuple[torch.Tensor, bool]:
    """(x with a leading batch dim, whether one was added): a tensor of
    `frame_ndim` dims is one frame and becomes a batch of one."""
    if x.ndim == frame_ndim:
        return x[None], True
    if x.ndim != frame_ndim + 1:
        raise ValueError(f"expected a frame of {frame_ndim} dims or a batch of them, "
                         f"got shape {tuple(x.shape)}")
    return x, False


def first_frame(out):
    """Frame 0 of every tensor in `out` (a tensor, a tuple or a NamedTuple)."""
    if isinstance(out, torch.Tensor):
        return out[0]
    if isinstance(out, tuple):
        vals = [first_frame(v) for v in out]
        return type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
    raise TypeError(f"cannot take a frame of {type(out).__name__}")
