"""Tag decoding: quad corners -> (id, hamming, decision margin, rotation).

Counterpart of ``isaac_ros_apriltag_tpu/ops/decode.py``: homography from the
unit square to each quad, bilinear samples of every bit cell and of two
reference rings, per-quad linear gray models (a + b*u + c*v) for a spatially
varying threshold, optional sharpening, and a codebook match under all four
rotations. Codes stay below 2^52, so the reference's pair of uint32 halves
becomes one int64 word, and popcount is a SWAR bit count on int64.

Decodes one frame's quads, (C, 4, 2) against an (H, W) image, or a batch,
(B, C, 4, 2) against (B, H, W), each quad sampling its own frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.families import TagFamily
from ..utils.geometry import apply_homography, homography_from_correspondences, inverse3x3
from .refine import bilinear_taps

# uv of the quad's cyclic corners in the border frame ([-1,1]^2).
_SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], np.float32)


class DecodeResult(NamedTuple):
    valid: torch.Tensor      # ([B,] C) bool — codeword matched within max_hamming
    id: torch.Tensor         # (C,) int32
    hamming: torch.Tensor    # (C,) int32
    margin: torch.Tensor     # (C,) float32
    rotation: torch.Tensor   # (C,) int32 in [0, 4)
    corners: torch.Tensor    # (C, 4, 2) float32 — rotation-corrected cyclic order


def _ring_cells(lo: int, hi: int) -> np.ndarray:
    cells = []
    for x in range(lo, hi + 1):
        cells.append((x, lo))
        cells.append((x, hi))
    for y in range(lo + 1, hi):
        cells.append((lo, y))
        cells.append((hi, y))
    return np.array(cells, np.float32)


def _cell_uv(cells: np.ndarray, wb: int) -> np.ndarray:
    """Cell coords -> border-frame uv in [-1, 1] (cell centers)."""
    return ((cells + 0.5) / wb * 2.0 - 1.0).astype(np.float32)


def _bilinear(gray: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at pts (..., 2), associated as in decode.py."""
    v00, v01, v10, v11, fx, fy = bilinear_taps(gray, pts[..., 0], pts[..., 1])
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _fit_gray_model(uv: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Least-squares fit vals ~ a + b*u + c*v; uv (..., N, 2), vals (..., N)."""
    A = torch.cat([torch.ones_like(uv[..., :1]), uv], -1)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    AtA = AtA + 1e-6 * torch.eye(3, dtype=A.dtype, device=A.device)
    Atb = torch.einsum("...ni,...n->...i", A, vals)
    return torch.einsum("...ij,...j->...i", inverse3x3(AtA), Atb)


def _eval_gray_model(model: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return model[..., 0:1] + model[..., 1:2] * uv[..., 0] + model[..., 2:3] * uv[..., 1]


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values (SWAR)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56 & 0xFF


class _Tables(NamedTuple):
    """A family's decode tables on one device."""
    square: torch.Tensor     # (4, 2) _SQUARE
    uv_bits: torch.Tensor    # (nbits, 2) bit-cell centers
    uv_border: torch.Tensor  # border-ring cell centers
    uv_outer: torch.Tensor   # outer-ring cell centers
    lin: torch.Tensor        # (nbits,) int64 flat bit cells in the total_width grid
    perms: torch.Tensor      # (4, nbits) int64 rotation_perm
    weights: torch.Tensor    # (nbits,) int64 bit weights, MSB first
    codes: torch.Tensor      # (ncodes,) int64 codebook


def _tables(family: TagFamily, dev: torch.device) -> _Tables:
    """The family's tables on `dev`, uploaded once per device and kept on
    the family (family.device_tables)."""
    key = ("decode", dev)
    if key not in family.device_tables:
        wb, tw, nbits = family.width_at_border, family.total_width, family.nbits
        off = (tw - wb) // 2
        bit_cells = np.stack([family.bit_x, family.bit_y], -1).astype(np.float32)
        arrays = (_SQUARE, _cell_uv(bit_cells, wb), _cell_uv(_ring_cells(0, wb - 1), wb),
                  _cell_uv(_ring_cells(-1, wb), wb),
                  (family.bit_y + off).astype(np.int64) * tw + (family.bit_x + off).astype(np.int64),
                  family.rotation_perm.astype(np.int64),
                  np.left_shift(np.int64(1), nbits - 1 - np.arange(nbits, dtype=np.int64)),
                  family.codes.astype(np.int64))
        family.device_tables[key] = _Tables(*(torch.as_tensor(a, device=dev) for a in arrays))
    return family.device_tables[key]


def decode_quads(gray: torch.Tensor, corners: torch.Tensor, family: TagFamily, *,
                 max_hamming: int = 2, decode_sharpening: float = 0.25,
                 ) -> DecodeResult:
    """gray: (H, W) float32 and corners: (C, 4, 2) cyclic quad corners, or
    a batch of each, (B, H, W) and (B, C, 4, 2)."""
    dev = corners.device
    lead = corners.shape[:-2]
    tab = _tables(family, dev)
    uv_bits, uv_border, uv_outer = tab.uv_bits, tab.uv_border, tab.uv_outer

    H = homography_from_correspondences(tab.square.expand(*lead, 4, 2), corners)

    def sample(uv):
        return _bilinear(gray, apply_homography(H, uv.expand(lead + uv.shape)))

    v_border = sample(uv_border)
    v_outer = sample(uv_outer)
    v_bits = sample(uv_bits)

    model_in = _fit_gray_model(uv_border.expand(lead + uv_border.shape), v_border)
    model_out = _fit_gray_model(uv_outer.expand(lead + uv_outer.shape), v_outer)
    thresh = 0.5 * (_eval_gray_model(model_in, uv_bits)
                    + _eval_gray_model(model_out, uv_bits))

    if decode_sharpening > 0:
        tw = family.total_width
        lin = tab.lin
        grid = torch.zeros((*lead, tw * tw), dtype=v_bits.dtype, device=dev)
        grid[..., lin] = v_bits
        grid = grid.reshape(*lead, tw, tw)
        lap = (4.0 * grid
               - torch.roll(grid, 1, -2) - torch.roll(grid, -1, -2)
               - torch.roll(grid, 1, -1) - torch.roll(grid, -1, -1))
        grid = grid + decode_sharpening * lap
        v_bits = grid.reshape(*lead, tw * tw)[..., lin]

    deviation = v_bits - thresh
    bits = deviation > 0
    # Margin: the worse of the white and black class mean deviations.
    wmask = bits.to(torch.float32)
    bmask = 1.0 - wmask
    wcnt = wmask.sum(-1)
    bcnt = bmask.sum(-1)
    wmean = torch.where(wcnt > 0, (deviation * wmask).sum(-1) / torch.clamp(wcnt, min=1.0),
                        torch.inf)
    bmean = torch.where(bcnt > 0, (-deviation * bmask).sum(-1) / torch.clamp(bcnt, min=1.0),
                        torch.inf)
    margin = torch.minimum(wmean, bmean)

    # --- codebook match under 4 rotations ---------------------------------
    rbits = bits[..., tab.perms].to(torch.int64)               # (..., 4, nbits)
    code = (rbits * tab.weights).sum(-1)                       # (..., 4)
    ham = _popcount64(code[..., None] ^ tab.codes)             # (..., 4, ncodes)
    ham_min = ham.amin(-1)
    id_min = torch.argmin(ham, -1)       # first minimum, as jnp.argmin
    best_r = torch.argmin(ham_min, -1)
    best_h = torch.gather(ham_min, -1, best_r[..., None])[..., 0].to(torch.int32)
    best_id = torch.gather(id_min, -1, best_r[..., None])[..., 0].to(torch.int32)
    valid = best_h <= max_hamming

    # --- rotation-corrected corner order ----------------------------------
    roll = torch.remainder(2 - best_r, 4)
    idx = torch.remainder(torch.arange(4, device=dev) + roll[..., None], 4)
    corr = torch.gather(corners, -2, idx[..., None].expand(*lead, 4, 2))
    return DecodeResult(valid=valid, id=best_id, hamming=best_h, margin=margin,
                        rotation=best_r.to(torch.int32), corners=corr)
