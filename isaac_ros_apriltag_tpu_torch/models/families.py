"""Tag family definitions: geometric bit layouts + codeword tables.

Pure numpy: the same layouts and codebooks as
``isaac_ros_apriltag_tpu/models/families.py``. The codebooks are this
package's own ``models/data/codebooks.npz``, a byte-for-byte copy of the
reference package's file (the tests hold the two to the same sha256), so the
port neither imports nor reads anything of the JAX package.

Coordinate convention: the border frame puts the outer edge of the tag's
border square at ``[0, width_at_border]^2`` in cell units; bit cell (bx, by)
is sampled at ``(bx + 0.5, by + 0.5)``. Code bit 0 is the MSB.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@dataclasses.dataclass(frozen=True)
class TagFamily:
    """A tag family as pure data (layout + codebook)."""

    name: str
    nbits: int
    min_hamming: int
    total_width: int        # cells across the printed tag incl. white margin
    width_at_border: int    # cells across the border square (quad boundary)
    reversed_border: bool   # True -> light border inside quad (dark outside)
    bit_x: np.ndarray       # (nbits,) int32 cell coords in border frame
    bit_y: np.ndarray       # (nbits,) int32
    codes: np.ndarray       # (ncodes,) uint64 codewords, bit 0 = MSB
    exact: bool             # True if the codebook matches the published family

    @property
    def ncodes(self) -> int:
        return int(self.codes.shape[0])

    @functools.cached_property
    def rotation_perm(self) -> np.ndarray:
        """(4, nbits) int32: perm[r, i] = index of the bit that lands on
        position i after rotating the tag by r*90 deg CCW; a 90 deg turn maps
        cell (x, y) -> (y, wb - 1 - x)."""
        wb = self.width_at_border
        coords = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(self.bit_x, self.bit_y))}
        perms = []
        bx, by = self.bit_x.copy(), self.bit_y.copy()
        for _ in range(4):
            perms.append(np.array([coords[(int(x), int(y))] for x, y in zip(bx, by)],
                                  np.int32))
            bx, by = by.copy(), (wb - 1 - bx).copy()
        out = np.stack(perms)
        for r in range(4):
            if not np.array_equal(np.sort(out[r]), np.arange(self.nbits)):
                raise ValueError("layout not 90deg-rotation closed")
        return out

    def code_grid(self, code: int) -> np.ndarray:
        """Render a codeword into a (total, total) {0,1} bitmap (1 = white)."""
        tw, wb = self.total_width, self.width_at_border
        off = (tw - wb) // 2
        img = np.zeros((tw, tw), np.uint8)
        if not self.reversed_border:
            img[:, :] = 1
            img[off:off + wb, off:off + wb] = 0
            img[off + 1:off + wb - 1, off + 1:off + wb - 1] = 1
        else:
            img[:, :] = 0
            img[off:off + wb, off:off + wb] = 1
            img[off + 1:off + wb - 1, off + 1:off + wb - 1] = 0
        n = self.nbits
        for i in range(n):
            img[int(self.bit_y[i]) + off, int(self.bit_x[i]) + off] = (code >> (n - 1 - i)) & 1
        return img


def _ring_coords(lo: int, hi: int) -> list[tuple[int, int]]:
    out = [(x, lo) for x in range(lo, hi + 1)]
    out += [(hi, y) for y in range(lo + 1, hi + 1)]
    out += [(x, hi) for x in range(hi - 1, lo - 1, -1)]
    out += [(lo, y) for y in range(hi - 1, lo, -1)]
    return out


def _grid_coords(lo: int, hi: int, skip=()) -> list[tuple[int, int]]:
    skip = set(skip)
    return [(x, y) for y in range(lo, hi + 1) for x in range(lo, hi + 1)
            if (x, y) not in skip]


def _layout(name: str) -> tuple[int, int, bool, np.ndarray, np.ndarray]:
    """Return (total_width, width_at_border, reversed_border, bit_x, bit_y)."""
    if name in ("tag36h11", "tag36h10"):
        cells, tw, wb, rev = _grid_coords(1, 6), 10, 8, False
    elif name == "tag16h5":
        cells, tw, wb, rev = _grid_coords(1, 4), 8, 6, False
    elif name == "tag25h9":
        cells, tw, wb, rev = _grid_coords(1, 5), 9, 7, False
    elif name == "tagCircle21h7":
        cells = _grid_coords(1, 5, skip=[(1, 1), (5, 1), (1, 5), (5, 5)])
        tw, wb, rev = 9, 7, False
    elif name == "tagCircle49h12":
        cells, tw, wb, rev = _grid_coords(1, 7), 11, 9, False
    elif name == "tagCustom48h12":
        cells, tw, wb, rev = _grid_coords(1, 7, skip=[(4, 4)]), 11, 9, True
    elif name == "tagStandard41h12":
        cells, tw, wb, rev = _grid_coords(1, 3) + _ring_coords(-2, 6), 9, 5, True
    elif name == "tagStandard52h13":
        cells, tw, wb, rev = _grid_coords(1, 4) + _ring_coords(-2, 7), 10, 6, True
    else:
        raise ValueError(f"unknown family layout: {name}")
    bx = np.array([c[0] for c in cells], np.int32)
    by = np.array([c[1] for c in cells], np.int32)
    return tw, wb, rev, bx, by


# (nbits, min_hamming, exact_source) per family.
FAMILY_SPECS = {
    "tag36h11": (36, 11, True),
    "tag36h10": (36, 10, True),
    "tag25h9": (25, 9, True),
    "tag16h5": (16, 5, True),
    "tagCircle21h7": (21, 7, False),
    "tagCircle49h12": (49, 12, False),
    "tagCustom48h12": (48, 12, False),
    "tagStandard41h12": (41, 12, False),
    "tagStandard52h13": (52, 13, False),
}

_REGISTRY: dict[str, TagFamily] = {}


def register_family(fam: TagFamily) -> None:
    _REGISTRY[fam.name] = fam


def family_names() -> list[str]:
    return list(FAMILY_SPECS.keys())


@functools.lru_cache(maxsize=None)
def _load_codebooks() -> dict[str, np.ndarray]:
    path = os.path.join(_DATA_DIR, "codebooks.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing — copy isaac_ros_apriltag_tpu/models/data/codebooks.npz "
            "(made by tools/gen_codebooks.py) there")
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def get_family(name: str) -> TagFamily:
    """Look up a family by name (registry first, then built-in tables)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name not in FAMILY_SPECS:
        raise ValueError(
            f"Invalid tag family {name!r}; expected one of {family_names()}")
    nbits, minh, exact = FAMILY_SPECS[name]
    tw, wb, rev, bx, by = _layout(name)
    if len(bx) != nbits:
        raise ValueError(f"{name}: layout has {len(bx)} cells, expected {nbits}")
    codes = _load_codebooks()[name].astype(np.uint64)
    fam = TagFamily(name=name, nbits=nbits, min_hamming=minh, total_width=tw,
                    width_at_border=wb, reversed_border=rev, bit_x=bx, bit_y=by,
                    codes=codes, exact=exact)
    register_family(fam)
    return fam
