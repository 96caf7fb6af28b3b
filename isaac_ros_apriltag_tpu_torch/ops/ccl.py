"""Component sizes of a CCL labeling.

Counterpart of ``isaac_ros_apriltag_tpu/ops/ccl.py::component_sizes``. The
scan-only labeling itself (kernels K2 and K3 and their twins) is
ops/cuda/ccl.py; the reference's single-phase labeling with pointer jumps
(``connected_components`` with jumps > 0) is not ported.
"""

from __future__ import annotations

import torch

from .batch import batch_first


def component_sizes(label: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int labels -> (B, H*W) int32: entry i of frame b counts the
    pixels of frame b labelled i; one frame, (H, W), gives (H*W,). One
    scatter-add over every pixel of the batch; labels outside [0, H*W) are
    dropped, as the reference's scatter drops them."""
    label, single = batch_first(label, 2)
    B, H, W = label.shape
    N = H * W
    flat = label.reshape(B, N).to(torch.int64)
    inb = (flat >= 0) & (flat < N)
    idx = torch.where(inb, flat + N * torch.arange(B, device=label.device)[:, None], B * N)
    sizes = torch.zeros(B * N + 1, dtype=torch.int32, device=label.device)
    sizes.scatter_add_(0, idx.reshape(-1), torch.ones(B * N, dtype=torch.int32,
                                                      device=label.device))
    out = sizes[:B * N].reshape(B, N)
    return out[0] if single else out
