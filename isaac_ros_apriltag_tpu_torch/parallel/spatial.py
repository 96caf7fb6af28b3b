"""Row-sharded detection of one frame: the segmentation image cut into
horizontal bands.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/spatial.py``, the answer to
the 8 MP workload: the pixel-heavy front half (decimate -> threshold -> CCL)
runs on bands of rows, and the data-light tail runs once on the gathered
trinary and labels.

  - threshold needs a halo of 2*tile_size rows on each side (tile stats and
    the 3x3 tile dilation): each band gets its neighbours' rows, or the
    frame's own edge rows replicated, and the result is bit-identical to the
    single-device threshold;
  - the CCL runs on GLOBAL flat-index labels. After each block of scan
    rounds every cut row is min-merged with the facing row of the band
    across the cut, by the scans' connectivity rule, so components that
    cross cuts converge to the same global min-index label as on one device
    (a component that crosses k cuts needs about k + 1 outer rounds);
  - the tail (resolve in flat-label mode -> clusters -> quads -> refine ->
    decode -> pose) takes the gathered labels, so the detections are the
    single-device detector's.

Without a process group all bands lie on one device as a batch: the halo
and cut rows are slices of the neighbouring batch entries, K1 runs once on
the (nshards, Hb + 4*tile_size, W) batch of padded bands, and each scan
round is one K2 and one K3 launch for all bands. With a group
(parallel/mesh.py) each rank holds one band, the rows travel by send and
receive, the bands are all-gathered and every rank runs the tail.

One difference from the reference: its cut merge (``_merge_cut``) blanks
the wrong edge lane after a roll, so a white pixel at x = 0 of a cut row
merges with one at x = W - 1 across the cut, and the diagonals at both ends
of the row are dropped. ``merge_cut`` here lets nothing connect across the
frame's left or right edge, as the scans do, so the sharded front equals
the single-device front, the contract the reference states.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..camera.model import CameraModel
from ..config import DetectorConfig
from ..detector import _decimate, _pad_to_tiles, detect_tail, device_for, to_device
from ..models.families import get_family
from ..ops.cuda import threshold as threshold_kernel
from ..ops.cuda.ccl import ccl_scan
from ..ops.grayscale import grayscale
from ..ops.threshold import adaptive_threshold
from ..types import Detections, FrameStats
from . import mesh


def _band_ids(nb: int, group, device) -> tuple[torch.Tensor, int]:
    """(global index of each local band, number of bands): the batch's own
    indices without a group, this rank's index with one."""
    if group is None:
        return torch.arange(nb, device=device), nb
    return torch.full((1,), dist.get_rank(group), device=device), dist.get_world_size(group)


def _neighbor_rows(bands: torch.Tensor, n_rows: int, group
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows from the band above, rows from the band below) of each band of
    (nb, Hb, W), each (nb, n_rows, W); the first band gets zeros from above
    and the last zeros from below."""
    if group is not None:
        return mesh.neighbor_rows(bands, n_rows, group)
    zero = torch.zeros_like(bands[:1, :n_rows])
    return (torch.cat([zero, bands[:-1, -n_rows:]]),
            torch.cat([bands[1:, :n_rows], zero]))


def pad_bands(gray_bands: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """(nb, Hb, W) bands -> (nb, Hb + 2 * halo, W): each band between `halo`
    rows of the band above and of the band below, the frame's first and
    last rows repeated past its top and bottom."""
    nb = gray_bands.shape[0]
    above, below = _neighbor_rows(gray_bands, halo, group)
    ids, nshards = _band_ids(nb, group, gray_bands.device)
    above = torch.where((ids == 0)[:, None, None], gray_bands[:, :1].expand_as(above), above)
    below = torch.where((ids == nshards - 1)[:, None, None],
                        gray_bands[:, -1:].expand_as(below), below)
    return torch.cat([above, gray_bands, below], 1).contiguous()


def spatial_threshold(gray_bands: torch.Tensor, ts: int, min_diff: int, *,
                      backend: str, group=None) -> torch.Tensor:
    """(nb, Hb, W) float32 bands of the segmentation image -> (nb, Hb, W)
    uint8 trinary, bit-identical to the threshold of the whole image. Hb
    must be a multiple of ts. Each band is padded with 2*ts rows on each side
    (pad_bands; the repeated edge rows are idempotent under the tile
    min/max), the adaptive threshold (K1 on backend 'cuda', its twin on
    'torch') runs once on the padded batch, and the padding is cropped."""
    halo = 2 * ts
    threshold = threshold_kernel.adaptive_threshold if backend == "cuda" else adaptive_threshold
    out = threshold(pad_bands(gray_bands, halo, group), ts, min_diff)
    return out[:, halo:halo + gray_bands.shape[1]].contiguous()


def _shift(x: torch.Tensor, dx: int, fill: int) -> torch.Tensor:
    """out[..., i] = x[..., i + dx] along the last dim, `fill` past its ends."""
    if dx == 0:
        return x
    pad = torch.full_like(x[..., :1], fill)
    return torch.cat([x[..., 1:], pad], -1) if dx == 1 else torch.cat([pad, x[..., :-1]], -1)


def merge_cut(tri_band: torch.Tensor, label_band: torch.Tensor, tri_nb: torch.Tensor,
              label_nb: torch.Tensor, side: str) -> torch.Tensor:
    """Min-merge the cut row of a band (side 'top': its first row, 'bottom':
    its last) with the facing row of the band across the cut.

    tri_band, label_band: (..., Hb, W); tri_nb, label_nb: (..., W). The CCL's
    connectivity rule: the pixel straight across for black and white, the
    two diagonals for white only; nothing connects across the frame's left
    or right edge. Returns new labels; the band's other rows are copied."""
    row = 0 if side == "top" else -1
    t0, l0 = tri_band[..., row, :], label_band[..., row, :]
    best = l0
    for dx in (-1, 0, 1):
        tn, ln = _shift(tri_nb, dx, 127), _shift(label_nb, dx, 0)
        conn = (tn == t0) & ((t0 != 127) if dx == 0 else (t0 == 255))
        best = torch.minimum(best, torch.where(conn, ln, l0))
    out = label_band.clone()
    out[..., row, :] = best
    return out


def spatial_ccl(tri_bands: torch.Tensor, y0: torch.Tensor, rounds: int, outer: int, *,
                backend: str, group=None) -> torch.Tensor:
    """(nb, Hb, W) uint8 trinary bands -> (nb, Hb, W) int32 labels in global
    flat indices of the whole image; y0: (nb,) each band's first global row.

    Labels start as (y0 + y) * W + x. Each of `outer` rounds runs `rounds`
    scan rounds on all bands at once (ccl_scan: one K2 and one K3 launch a
    round on backend 'cuda') and then merges every cut (merge_cut)."""
    nb, Hb, W = tri_bands.shape
    dev = tri_bands.device
    ys = y0[:, None, None] + torch.arange(Hb, device=dev)[None, :, None]
    label = (ys * W + torch.arange(W, device=dev)).to(torch.int32)
    ids, nshards = _band_ids(nb, group, dev)
    t_above, t_below = _neighbor_rows(tri_bands, 1, group)
    t_above = torch.where((ids == 0)[:, None], 127, t_above[:, 0]).to(torch.uint8)
    t_below = torch.where((ids == nshards - 1)[:, None], 127, t_below[:, 0]).to(torch.uint8)
    for _ in range(outer):
        label, _ = ccl_scan(tri_bands, rounds, backend=backend, label0=label)
        l_above, l_below = _neighbor_rows(label, 1, group)
        label = merge_cut(tri_bands, label, t_above, l_above[:, 0], "top")
        label = merge_cut(tri_bands, label, t_below, l_below[:, 0], "bottom")
    return label


def _build_front(config: DetectorConfig, camera: CameraModel, nshards: int,
                 encoding: str, outer_rounds: int | None, group):
    """The row-sharded front: (H, W[, C]) frame -> (gray, trinary, label), the
    last two of the single-device segmentation shape (Hp0, W)."""
    cfg = config
    ts = cfg.tile_size
    outer = max(3, nshards - 1) if outer_rounds is None else outer_rounds

    def front(frame: torch.Tensor):
        if tuple(frame.shape[:2]) != (camera.height, camera.width):
            raise ValueError(f"frame {tuple(frame.shape)} is not the camera's "
                             f"{camera.height}x{camera.width}")
        if cfg.backend == "cuda" and frame.device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got {frame.device}")
        gray = grayscale(frame, encoding)
        seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), ts)
        Hp0, W = seg.shape
        # Bands start on global tile rows, so the threshold is the
        # single-device one; a height that does not split so is padded with
        # its last row, and the padded rows are 127 before the CCL.
        Hp = -(-Hp0 // (nshards * ts)) * nshards * ts
        if Hp != Hp0:
            seg = torch.cat([seg, seg[-1:].expand(Hp - Hp0, W)])
        Hb = Hp // nshards
        bands = seg.reshape(nshards, Hb, W)
        ids, _ = _band_ids(nshards, group, seg.device)
        if group is not None:
            bands = bands[ids]
        tri = spatial_threshold(bands, ts, cfg.min_white_black_diff, backend=cfg.backend,
                                group=group)
        y0 = ids * Hb
        if Hp != Hp0:
            rows = y0[:, None, None] + torch.arange(Hb, device=seg.device)[None, :, None]
            tri = torch.where(rows < Hp0, tri, 127).to(torch.uint8)
        lab = spatial_ccl(tri, y0, cfg.ccl_rounds, outer, backend=cfg.backend, group=group)
        if group is not None:
            tri, lab = mesh.all_gather_bands(tri, group), mesh.all_gather_bands(lab, group)
        return gray, tri.reshape(Hp, W)[:Hp0], lab.reshape(Hp, W)[:Hp0]

    return front


def build_spatial_front_fn(config: DetectorConfig, camera: CameraModel, nshards: int = 4,
                           encoding: str = "mono8", outer_rounds: int | None = None,
                           group=None):
    """The row-sharded front half: an (H, W[, C]) frame tensor -> (trinary,
    label), both (Hp0, W) like the single-device segmentation image, the
    labels in global flat indices. It runs on the frame's device (backend
    'cuda' needs a CUDA one).

    nshards bands on one device, or with `group` one band on each of its
    ranks (nshards must then be the group's size; every rank passes the
    whole frame). outer_rounds: cut-merge rounds, default max(3, nshards - 1)
    (a component that crosses k cuts needs about k + 1)."""
    _check_shards(nshards, group)
    front = _build_front(config, camera, nshards, encoding, outer_rounds, group)
    return lambda frame: front(frame)[1:]


def _check_shards(nshards: int, group) -> None:
    if nshards < 1:
        raise ValueError("nshards must be >= 1")
    if group is not None and nshards != dist.get_world_size(group):
        raise ValueError(f"nshards={nshards} but the group has "
                         f"{dist.get_world_size(group)} ranks")


class SpatialDetector:
    """One frame detected by rows: the front half row-sharded into nshards
    bands (on one device as a batch, or one band on each rank of `group`),
    the tail on the gathered frame. Detections equal the single-device
    Detector's (tests/test_torch_spatial.py). device: default the card; pass
    device='cpu' to run backend 'torch' on the CPU.

    The front is its own whatever config.ccl_flow says, as the reference's
    is whatever its backend: ccl_rounds scan rounds per outer round and no
    pointer jumps, since the band labels are global flat indices that a
    band's gather table does not hold."""

    def __init__(self, config: DetectorConfig, camera: CameraModel, nshards: int = 4,
                 device: torch.device | str | None = None, encoding: str = "mono8",
                 outer_rounds: int | None = None, group=None):
        _check_shards(nshards, group)
        self.config = config
        self.device = device_for(config, device)
        self.camera = camera.to(self.device)
        self.family = get_family(config.tag_family)
        self._front = _build_front(config, self.camera, nshards, encoding, outer_rounds, group)

    def detect_with_stats(self, frame) -> tuple[Detections, FrameStats]:
        gray, tri, lab = self._front(to_device(frame, self.device))
        # The sharded CCL carries no convergence flag of its own; resolve's
        # chain fixpoint flag is this path's convergence telemetry.
        det, stats = detect_tail(self.config, self.camera, self.family, gray[None], tri[None],
                                 lab[None], torch.ones(1, dtype=torch.bool, device=self.device))
        return det.frame(0), stats.frame(0)

    def detect(self, frame) -> Detections:
        return self.detect_with_stats(frame)[0]
