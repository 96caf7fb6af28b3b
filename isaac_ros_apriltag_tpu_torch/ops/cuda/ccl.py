"""Scan connected-component labeling: the round loop, the two kernels'
wrappers (csrc/ccl.cu) and their plain PyTorch twins.

Counterpart of ``isaac_ros_apriltag_tpu/ops/pallas/ccl.py`` (pointer jumps
between rounds included) and ``ops/pallas/ccl_fused.py::ccl_scan_pallas``.
One round is a row scan (K2) then a diagonal hop + column scan (K3); both
are bit-exact with their twins, and the round loop is bit-identical round
for round with the reference's.

Every function takes a batch of frames, (B, H, W), or one frame, (H, W); the
frames of a batch never touch. Labels start as the flat pixel index within
the frame (min-propagation assigns each component its min flat index) or as
a caller's seed ``label0``. The reference padded
the image to 64x128 tiles with 127 pixels and remapped the indices, and took
an ``opaque`` flag for seeds that are not flat indices; this port does not
pad and needs no flag. Padded and unpadded flat indices are both
lexicographic in (y, x) and 127 pixels never join a segment, so the labels
are identical for flat indices and for any order-isomorphic seed such as
resolve_roots_rank's ranks (tests/test_torch_ccl.py).
"""

from __future__ import annotations

import torch

from . import _lib

row_launches = 0        # K2 launches made by row_scan
col_diag_launches = 0   # K3 launches made by col_diag_scan


def _run_min(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Each maximal run of equal non-127 values along the last axis takes
    the run's min label; 127 pixels keep theirs. This is exactly what the
    forward + backward segmented min-scans compute. Every line along the
    last axis, of every frame, starts a new run, so lines never mix."""
    shape = tri.shape
    tri = tri.reshape(-1, shape[-1])
    starts = torch.ones(tri.shape, dtype=torch.bool, device=tri.device)
    starts[:, 1:] = tri[:, 1:] != tri[:, :-1]
    starts |= tri == 127
    run = torch.cumsum(starts.reshape(-1), 0) - 1
    mins = torch.full((tri.numel(),), torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=tri.device)
    mins.scatter_reduce_(0, run, label.reshape(-1), reduce="amin")
    return mins[run].reshape(shape)


def row_scan_plain(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """K2's plain twin: segmented min-scans along rows."""
    return _run_min(tri, label)


def _diag_hop(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """White-only diagonal hop; all four neighbours read from `label`. Each
    frame is padded on its own, so no pixel reaches into another frame."""
    *lead, H, W = tri.shape
    tp = torch.full((*lead, H + 2, W + 2), 127, dtype=tri.dtype, device=tri.device)
    tp[..., 1:-1, 1:-1] = tri
    lp = torch.zeros((*lead, H + 2, W + 2), dtype=label.dtype, device=label.device)
    lp[..., 1:-1, 1:-1] = label
    white = tri == 255
    m = label
    for dy in (1, -1):
        for dx in (1, -1):
            ntri = tp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            nlab = lp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            m = torch.minimum(m, torch.where(white & (ntri == tri), nlab, label))
    return m


def col_diag_scan_plain(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """K3's plain twin: diagonal hop, then segmented min-scans down columns."""
    m = _diag_hop(tri, label)
    return _run_min(tri.mT.contiguous(), m.mT.contiguous()).mT.contiguous()


def _check(tri: torch.Tensor, label: torch.Tensor) -> tuple[int, int, int]:
    """Raise on what the kernels do not take; return (B, H, W)."""
    if tri.device.type != "cuda" or label.device != tri.device:
        raise ValueError("tri and label must lie on the same CUDA device")
    if tri.dtype != torch.uint8 or label.dtype != torch.int32:
        raise ValueError("tri must be uint8 and label int32")
    if tri.ndim not in (2, 3) or tri.shape != label.shape or tri.numel() == 0:
        raise ValueError("tri and label must be non-empty (B, H, W) or (H, W) tensors "
                         "of one shape")
    if not (tri.is_contiguous() and label.is_contiguous()):
        raise ValueError("tri and label must be contiguous")
    B, H, W = tri.shape if tri.ndim == 3 else (1, *tri.shape)
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    return B, H, W


def row_scan(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """K2: (B, H, W) or (H, W) uint8 trinary + int32 labels -> row-scanned
    labels; one launch for the batch, rows of any length."""
    global row_launches
    if tri.device.type == "cpu":
        return row_scan_plain(tri, label)
    B, H, W = _check(tri, label)
    out = torch.empty_like(label)
    with torch.cuda.device(tri.device):
        status = _lib.library().apriltag_ccl_row(
            tri.data_ptr(), label.data_ptr(), out.data_ptr(), B, H, W,
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_ccl_row")
    row_launches += 1
    return out


def col_diag_scan(tri: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """K3: diagonal hop + column scans on (B, H, W) or (H, W); reads `label`,
    writes a new tensor; one launch for the batch, columns of any length."""
    global col_diag_launches
    if tri.device.type == "cpu":
        return col_diag_scan_plain(tri, label)
    B, H, W = _check(tri, label)
    out = torch.empty_like(label)
    with torch.cuda.device(tri.device):
        status = _lib.library().apriltag_ccl_col_diag(
            tri.data_ptr(), label.data_ptr(), out.data_ptr(), B, H, W,
            torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_ccl_col_diag")
    col_diag_launches += 1
    return out


def _jump(label: torch.Tensor, jumps: int) -> torch.Tensor:
    """label <- label[label], `jumps` times, within each frame: a gather
    along the last dim of the (B, H*W) view, so frames never mix."""
    H, W = label.shape[-2:]
    flat = label.reshape(-1, H * W)
    for _ in range(jumps):
        flat = torch.gather(flat, 1, flat.long())
    return flat.reshape(label.shape)


def ccl_scan(trinary: torch.Tensor, rounds: int, *, backend: str,
             label0: torch.Tensor | None = None, jumps: int = 0,
             jump_every: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) uint8 trinary -> ((B, H, W) int32 labels, (B,) converged);
    one frame, (H, W), gives (H, W) labels and a 0-dim flag.

    `converged[b]` is True iff the final round, its jumps included, changed
    nothing in frame b. `label0` seeds the labels (flat indices, or any
    order-isomorphic int32 labeling such as resolve_roots_rank's ranks);
    without it each pixel starts at its flat index within its frame. backend
    'cuda' runs the kernels, 'torch' their plain twins; either way a round
    is one call of each for the whole batch.

    `jumps` > 0 is the reference's single-phase flow
    (``isaac_ros_apriltag_tpu/ops/ccl.py::connected_components``): after
    round r, when (r + 1) % jump_every == 0, label <- label[label] `jumps`
    times, a torch gather per frame (the reference's gather is XLA, not a
    kernel). The reference's Pallas flow jumps in padded flat-index space;
    the jumps here are in unpadded space. Both are lexicographic in (y, x)
    and labels only ever point at pixels of the frame, so the two are
    order-isomorphic round for round (tests/test_torch_oracle.py). Jumps
    need flat-index labels, so they refuse a seed `label0`.
    """
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if jumps < 0 or jump_every < 1:
        raise ValueError("jumps must be >= 0 and jump_every >= 1")
    if jumps and label0 is not None:
        raise ValueError("jumps need flat-index labels: label0 must be None when jumps > 0")
    if backend == "cuda":
        row, col = row_scan, col_diag_scan
    elif backend == "torch":
        row, col = row_scan_plain, col_diag_scan_plain
    else:
        raise ValueError(f"unknown backend {backend!r}")
    tri = trinary.contiguous()
    *lead, H, W = tri.shape
    if label0 is None:
        label = torch.arange(H * W, dtype=torch.int32, device=tri.device).reshape(H, W)
        label = label.expand(tri.shape).contiguous()
    else:
        label = label0.to(torch.int32).contiguous()
    prev = label
    for r in range(rounds):
        prev = label
        label = col(tri, row(tri, label))
        if jumps and (r + 1) % jump_every == 0:
            label = _jump(label, jumps)
    return label, ~torch.any((label != prev).reshape(*lead, H * W), -1)
