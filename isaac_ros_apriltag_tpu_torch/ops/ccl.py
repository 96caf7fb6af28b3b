"""The single-phase CCL with pointer jumps, and component sizes.

Counterparts of ``isaac_ros_apriltag_tpu/ops/ccl.py::connected_components``
(the reference's oracle flow, which its 'xla' backend runs) and
``::component_sizes``. The scan rounds themselves (kernels K2 and K3 and
their twins) and the jumps between them are ops/cuda/ccl.py::ccl_scan.
"""

from __future__ import annotations

import torch

from .batch import batch_first
from .cuda.ccl import ccl_scan


def connected_components(trinary: torch.Tensor, rounds: int = 6, jumps: int = 2,
                         jump_every: int = 1, *, backend: str,
                         label0: torch.Tensor | None = None, with_convergence: bool = False):
    """(B, H, W) or (H, W) uint8 trinary {0, 127, 255} -> int32 component
    labels of the same shape: valid pixels get the min flat index of their
    component within their frame, 127 pixels their own index.

    `rounds` scan rounds; after round r, when (r + 1) % jump_every == 0,
    `jumps` pointer-jump passes (label <- label[label]). `label0` seeds the
    labels (jumps must then be 0). With `with_convergence` it returns
    (labels, converged): converged is True iff the final round, its jumps
    included, changed nothing ((B,) for a batch). backend 'cuda' runs the
    kernels K2 and K3, 'torch' their plain twins."""
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    label, converged = ccl_scan(trinary, rounds, backend=backend, label0=label0,
                                jumps=jumps, jump_every=jump_every)
    return (label, converged) if with_convergence else label


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
