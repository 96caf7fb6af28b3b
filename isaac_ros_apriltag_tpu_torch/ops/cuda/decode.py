"""Wrapper of the decode kernel (csrc/tail.cu::decode_kernel).

``decode_quads`` checks its input, then on CPU tensors runs the plain
version (ops/decode.py::decode_quads); on CUDA tensors it launches the
kernel or raises and adds one to ``launches``. One launch decodes every
quad of the call, one warp a quad and two quads a block, on the current
stream, into outputs allocated here by torch.empty, with no host
sync, so a detect call that runs it can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from ...models.families import TagFamily
from .. import decode as plain
from ..decode import DecodeResult
from . import _lib

launches = 0    # decode_kernel launches made by decode_quads

_MAX_GRID = 128          # total_width^2 the kernel's shared grid holds
_MAX_CODES = 1 << 24     # codebook entries a warp-min key holds


def decode_quads(gray: torch.Tensor, corners: torch.Tensor, family: TagFamily, *,
                 max_hamming: int = 2, decode_sharpening: float = 0.25) -> DecodeResult:
    """The plain version's signature and results, bit for bit: gray (H, W)
    float32 with corners (C, 4, 2) float32, or (B, H, W) with (B, C, 4, 2),
    both contiguous."""
    global launches
    if gray.dtype != torch.float32 or corners.dtype != torch.float32:
        raise ValueError(f"gray and corners must be float32, got {gray.dtype} and "
                         f"{corners.dtype}")
    if corners.ndim not in (3, 4) or corners.shape[-2:] != (4, 2) or (
            gray.ndim != corners.ndim - 1 or gray.shape[:-2] != corners.shape[:-3]):
        raise ValueError("corners must be (C, 4, 2) with an (H, W) gray, or (B, C, 4, 2) "
                         f"with a (B, H, W) gray; got {tuple(corners.shape)} and "
                         f"{tuple(gray.shape)}")
    if not (gray.is_contiguous() and corners.is_contiguous()):
        raise ValueError("gray and corners must be contiguous")
    if gray.device != corners.device:
        raise ValueError(f"gray on {gray.device}, corners on {corners.device}")
    wb, tw = family.width_at_border, family.total_width
    if max(4 * (wb + 1), family.nbits) > plain.MAX_CELLS or tw * tw > _MAX_GRID or not (
            1 <= family.ncodes < _MAX_CODES):
        raise ValueError(f"family {family.name} is past the kernel's sizes: "
                         f"{plain.MAX_CELLS} cells a set, {_MAX_GRID} grid cells, "
                         f"{_MAX_CODES} codes")
    H, W = gray.shape[-2:]
    B = gray.shape[0] if gray.ndim == 3 else 1
    C = corners.shape[-3]
    if not (1 <= B * C < 2 ** 31 and H >= 1 and W >= 1):
        raise ValueError(f"the kernel takes 1 to 2^31 - 1 quads and a non-empty image, got "
                         f"{B * C} quads and {H}x{W}")
    if corners.device.type == "cpu":
        return plain.decode_quads(gray, corners, family, max_hamming=max_hamming,
                                  decode_sharpening=decode_sharpening)
    if corners.device.type != "cuda":
        raise ValueError(f"unsupported device {corners.device}")
    dev = corners.device
    tab = plain._tables(family, dev)
    lead = corners.shape[:-2]
    out = DecodeResult(valid=torch.empty(lead, dtype=torch.bool, device=dev),
                       id=torch.empty(lead, dtype=torch.int32, device=dev),
                       hamming=torch.empty(lead, dtype=torch.int32, device=dev),
                       margin=torch.empty(lead, dtype=torch.float32, device=dev),
                       rotation=torch.empty(lead, dtype=torch.int32, device=dev),
                       corners=torch.empty_like(corners))
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_decode(
            gray.data_ptr(), corners.data_ptr(), tab.floats.data_ptr(), tab.ints.data_ptr(),
            tab.codes.data_ptr(), *(t.data_ptr() for t in out), B, C, H, W,
            tab.uv_border.shape[0], tab.uv_outer.shape[0], family.nbits, tw, family.ncodes,
            max(-1, min(max_hamming, 64)), int(decode_sharpening > 0),
            _lib.float_bits(decode_sharpening), torch.cuda.current_stream().cuda_stream)
    _lib.check(status, "apriltag_decode")
    launches += 1
    return out
