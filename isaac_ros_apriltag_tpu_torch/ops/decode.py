"""Tag decoding: quad corners -> (id, hamming, decision margin, rotation).

Counterpart of ``isaac_ros_apriltag_tpu/ops/decode.py``: homography from the
unit square to each quad, bilinear samples of every bit cell and of two
reference rings, per-quad linear gray models (a + b*u + c*v) for a spatially
varying threshold, optional sharpening, and a codebook match under all four
rotations. Codes stay below 2^52, so the reference's pair of uint32 halves
becomes one int64 word, and popcount is a SWAR bit count on int64.

Decodes one frame's quads, (C, 4, 2) against an (H, W) image, or a batch,
(B, C, 4, 2) against (B, H, W), each quad sampling its own frame.

``decode_quads`` is the plain version of csrc/tail.cu's decode_kernel, bit
for bit: every float step is elementwise and in the kernel's order. A sum
over the cells of a sample set (at most 64) is the kernel's warp sum
(``_warp_sum``: padded with zeros to 64, then halves added pairwise); the
gray models' normal matrices depend on the family alone, so their inverses
are family tables (``_tables``), and the homography is the explicit 8x8
elimination of utils/geometry.py. The kernel reads the same tables.
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
_LANES = 32          # a warp: the kernel holds cell i and cell i + 32 in lane i
MAX_CELLS = 2 * _LANES


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


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (at most 64 entries) in the decode kernel's
    order: padded with zeros to 64, then x[:32] + x[32:], and so on down to
    one (a lane's two cells, then the warp's butterfly)."""
    x = torch.nn.functional.pad(x, (0, MAX_CELLS - x.shape[-1]))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _fit_gray_model(uv: torch.Tensor, minv: torch.Tensor,
                    vals: torch.Tensor) -> list[torch.Tensor]:
    """Least-squares fit vals ~ a + b*u + c*v over one sample set: uv (N, 2),
    minv (3, 3) the inverse of its normal matrix A^T A + 1e-6 I, vals
    (..., N). Returns (a, b, c), each (...)."""
    atb = [_warp_sum(vals), _warp_sum(uv[:, 0] * vals), _warp_sum(uv[:, 1] * vals)]
    return [(minv[i, 0] * atb[0] + minv[i, 1] * atb[1]) + minv[i, 2] * atb[2]
            for i in range(3)]


def _eval_gray_model(model: list[torch.Tensor], uv: torch.Tensor) -> torch.Tensor:
    return (model[0][..., None] + model[1][..., None] * uv[:, 0]) + model[2][..., None] * uv[:, 1]


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values (SWAR)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56 & 0xFF


class _Tables(NamedTuple):
    """A family's decode tables on one device. The kernel reads `floats`,
    `ints` and `codes`; the plain version the views and int64 copies."""
    square: torch.Tensor     # (4, 2) _SQUARE
    uv_border: torch.Tensor  # (nb, 2) border-ring cell centers  } views of
    uv_outer: torch.Tensor   # (no, 2) outer-ring cell centers   } `floats`,
    uv_bits: torch.Tensor    # (nbits, 2) bit-cell centers       } in this
    minv_in: torch.Tensor    # (3, 3) inverse normal matrix, border ring } order
    minv_out: torch.Tensor   # (3, 3) inverse normal matrix, outer ring  }
    lin: torch.Tensor        # (nbits,) int64 flat bit cells in the total_width grid
    perms: torch.Tensor      # (4, nbits) int64 rotation_perm
    weights: torch.Tensor    # (nbits,) int64 bit weights, MSB first
    codes: torch.Tensor      # (ncodes,) int64 codebook
    floats: torch.Tensor     # float32: uv_border, uv_outer, uv_bits, minv_in, minv_out
    ints: torch.Tensor       # int32: lin, then perms row by row


def _inverse_normal_matrix(uv: np.ndarray) -> np.ndarray:
    """inverse3x3(A^T A + 1e-6 I) of the design matrix A = [1, u, v] of a
    sample set, in float64, rounded to float32."""
    A = np.concatenate([np.ones((len(uv), 1)), uv.astype(np.float64)], 1)
    AtA = torch.from_numpy(A.T @ A + 1e-6 * np.eye(3))
    return inverse3x3(AtA).numpy().astype(np.float32)


def _tables(family: TagFamily, dev: torch.device) -> _Tables:
    """The family's tables on `dev`, uploaded once per device and kept on
    the family (family.device_tables)."""
    key = ("decode", dev)
    if key not in family.device_tables:
        wb, tw, nbits = family.width_at_border, family.total_width, family.nbits
        off = (tw - wb) // 2
        bit_cells = np.stack([family.bit_x, family.bit_y], -1).astype(np.float32)
        uvs = (_cell_uv(_ring_cells(0, wb - 1), wb), _cell_uv(_ring_cells(-1, wb), wb),
               _cell_uv(bit_cells, wb))
        minvs = tuple(_inverse_normal_matrix(uv) for uv in uvs[:2])
        floats = torch.as_tensor(np.concatenate([a.ravel() for a in uvs + minvs]), device=dev)
        views, at = [], 0
        for a in uvs + minvs:
            views.append(floats[at:at + a.size].view(a.shape))
            at += a.size
        lin = (family.bit_y + off).astype(np.int64) * tw + (family.bit_x + off).astype(np.int64)
        perms = family.rotation_perm.astype(np.int64)
        ints = np.concatenate([lin, perms.ravel()]).astype(np.int32)
        arrays = (lin, perms,
                  np.left_shift(np.int64(1), nbits - 1 - np.arange(nbits, dtype=np.int64)),
                  family.codes.astype(np.int64), ints)
        lin, perms, weights, codes, ints = (torch.as_tensor(a, device=dev) for a in arrays)
        family.device_tables[key] = _Tables(torch.as_tensor(_SQUARE, device=dev), *views, lin,
                                            perms, weights, codes, floats, ints)
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

    model_in = _fit_gray_model(uv_border, tab.minv_in, v_border)
    model_out = _fit_gray_model(uv_outer, tab.minv_out, v_outer)
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
    wcnt = wmask.sum(-1)         # integers: exact in any order
    bcnt = bmask.sum(-1)
    wmean = torch.where(wcnt > 0, _warp_sum(deviation * wmask) / torch.clamp(wcnt, min=1.0),
                        torch.inf)
    bmean = torch.where(bcnt > 0, _warp_sum(-deviation * bmask) / torch.clamp(bcnt, min=1.0),
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
