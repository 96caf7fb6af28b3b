"""Color -> grayscale conversion (BT.601), five encodings.

Counterpart of ``isaac_ros_apriltag_tpu/ops/grayscale.py``. mono8 is an exact
cast. The colour channels are accumulated in channel order as a chain of
fused multiply-adds (one f32 rounding per step), which reproduces the
reference's f32 einsum on the CPU bit for bit (tests/test_torch_front.py pins
it on random uint8 images).
"""

from __future__ import annotations

import torch

ENCODINGS = ("rgb8", "bgr8", "rgba8", "bgra8", "mono8")

_BT601 = (0.299, 0.587, 0.114)


def grayscale(image: torch.Tensor, encoding: str = "rgb8", *,
              batched: bool = False) -> torch.Tensor:
    """(H, W, C) or (H, W) uint8 -> (H, W) float32 grayscale in [0, 255];
    with `batched`, (B, H, W, C) or (B, H, W) -> (B, H, W)."""
    if encoding not in ENCODINGS:
        raise ValueError(f"Unsupported image encoding {encoding!r}; expected {ENCODINGS}")
    if encoding == "mono8":
        if image.ndim == 3 + batched:
            image = image[..., 0]
        return image.to(torch.float32)
    r, g, b = _BT601
    w = (b, g, r) if encoding in ("bgr8", "bgra8") else (r, g, b)
    # f32 weights, widened: each uint8 * weight product is exact in f64, and
    # so is each f32 + product sum, so rounding to f32 after every step is
    # one rounding per fused multiply-add, as in the reference's dot. The
    # weights are Python floats (the f32 values exactly), so nothing is
    # copied to the device.
    w = torch.tensor(w, dtype=torch.float32).tolist()
    x = image[..., :3].to(torch.float64)
    acc = (x[..., 0] * w[0]).to(torch.float32)
    for c in (1, 2):
        acc = (acc.to(torch.float64) + x[..., c] * w[c]).to(torch.float32)
    return acc
