"""AprilTag detector: config + camera + device -> detect(frame).

Counterpart of ``isaac_ros_apriltag_tpu/detector.py`` for one frame, run
eagerly. Stages: grayscale, quad_decimate mean-pool, adaptive threshold
(kernel K1), two-phase scan CCL (kernels K2 and K3, with the rank-space
contraction between the phases), resolve, cluster moments, quad fit, top-2T
by fit quality, edge refinement, decode, dedupe, top-T by decision margin,
center and pose. Backend 'cuda' runs the three kernels; 'torch' runs their
plain twins. Everything else is plain PyTorch on the detector's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.model import CameraModel
from .config import DetectorConfig
from .models.families import TagFamily, get_family
from .ops.cluster_moments import extract_cluster_moments
from .ops.cuda import ccl as ccl_ops
from .ops.cuda import threshold as threshold_kernel
from .ops.decode import decode_quads
from .ops.grayscale import grayscale
from .ops.pose import estimate_poses
from .ops.quadfit import fit_quads_from_moments
from .ops.refine import refine_edges
from .ops.resolve import resolve_components, resolve_roots_rank
from .ops.threshold import adaptive_threshold
from .types import Detections, FrameStats
from .utils.geometry import line_intersection


def _pad_to_tiles(gray: torch.Tensor, ts: int) -> torch.Tensor:
    """Edge-pad (H, W) up to multiples of ts."""
    H, W = gray.shape
    ph, pw = (-H) % ts, (-W) % ts
    if ph:
        gray = torch.cat([gray, gray[-1:].expand(ph, W)], 0)
    if pw:
        gray = torch.cat([gray, gray[:, -1:].expand(H + ph, pw)], 1)
    return gray


def _decimate(gray: torch.Tensor, d: int) -> torch.Tensor:
    """d x d mean-pool (AprilTag 3's quad_decimate). The reference pools with
    two f32 matmuls against banded 1/d operators; each output sums d nonzero
    products, added here in the same ascending order (for d = 2 the products
    are exact halves, so the result is bit-identical)."""
    if d == 1:
        return gray
    gray = _pad_to_tiles(gray, d)
    w = float(np.float32(1.0 / d))
    rows = gray[0::d] * w
    for k in range(1, d):
        rows = rows + gray[k::d] * w
    out = rows[:, 0::d] * w
    for k in range(1, d):
        out = out + rows[:, k::d] * w
    return out


def _upscale_coords(xy: torch.Tensor, d: int) -> torch.Tensor:
    """Decimated-image pixel coords -> full-resolution pixel coords."""
    if d == 1:
        return xy
    return xy * d + (d - 1) / 2.0


def _top(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k like lax.top_k: descending, ties to the lower index."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _dedupe(valid, ids, margin, corners):
    """Suppress duplicate detections of the same id with overlapping extent;
    the best decision margin wins (ties: lower index)."""
    center = corners.mean(1)
    edge = torch.linalg.vector_norm(corners - torch.roll(corners, 1, 1), dim=-1).mean(-1)
    d = torch.linalg.vector_norm(center[:, None] - center[None, :], dim=-1)
    near = d < 0.75 * torch.maximum(edge[:, None], edge[None, :])
    same = ids[:, None] == ids[None, :]
    both = valid[:, None] & valid[None, :]
    idx = torch.arange(ids.shape[0], device=ids.device)
    better = (margin[:, None] > margin[None, :]) | (
        (margin[:, None] == margin[None, :]) & (idx[:, None] < idx[None, :]))
    suppressed = torch.any(near & same & both & better, 0)
    return valid & ~suppressed


def detect_tail(cfg: DetectorConfig, camera: CameraModel, family: TagFamily,
                gray: torch.Tensor, trinary: torch.Tensor, label: torch.Tensor,
                scan_converged: torch.Tensor, *, rank_table: torch.Tensor,
                extra_overflow: torch.Tensor) -> tuple[Detections, FrameStats]:
    """The back half of the detector: rank-space CCL labels -> Detections."""
    E_eff, R_eff = cfg.effective_capacities(*trinary.shape)
    res = resolve_components(label, trinary != 127,
                             min_component_pixels=cfg.min_component_pixels,
                             max_components=R_eff,
                             chain_steps=cfg.ccl_resolve_steps,
                             rank_table=rank_table)
    clusters = extract_cluster_moments(
        trinary, res.dense,
        comp_overflow=res.overflow | extra_overflow,
        max_edge_points=E_eff,
        max_clusters=cfg.max_clusters,
        min_cluster_pixels=cfg.min_cluster_pixels,
        max_cluster_points=cfg.max_cluster_points)
    return _detect_from_clusters(cfg, camera, family, gray, clusters,
                                 scan_converged & res.converged)


def _detect_from_clusters(cfg, camera, family, gray, clusters, ccl_converged
                          ) -> tuple[Detections, FrameStats]:
    quads = fit_quads_from_moments(clusters, min_area=64.0 / (cfg.quad_decimate ** 2))
    want_dark = not family.reversed_border
    qvalid = quads.valid & (quads.dark_inside == want_dark)

    # Top-2T candidate quads by perimeter / (1 + fit error), decoded; then
    # the top-T by decision margin.
    T = cfg.max_tags
    T2 = min(2 * T, quads.valid.shape[0])
    perim = torch.linalg.vector_norm(
        quads.corners - torch.roll(quads.corners, 1, 1), dim=-1).sum(-1)
    qscore = torch.where(qvalid, perim / (1.0 + quads.fit_err), -torch.inf)
    top_qs, top_i = _top(qscore, T2)
    pre_valid = torch.isfinite(top_qs)
    corners = refine_edges(gray,
                           _upscale_coords(quads.corners[top_i], cfg.quad_decimate),
                           quads.dark_inside[top_i],
                           search_range=cfg.quad_decimate + 1.0)

    dec = decode_quads(gray, corners, family, max_hamming=cfg.max_hamming,
                       decode_sharpening=cfg.decode_sharpening)
    dec_valid = pre_valid & dec.valid & (dec.margin >= cfg.min_decision_margin)
    dec_valid = _dedupe(dec_valid, dec.id, dec.margin, dec.corners)

    fscore = torch.where(dec_valid, dec.margin, -torch.inf)
    top_fs, top_f = _top(fscore, T)
    sel_valid = torch.isfinite(top_fs)
    sel_corners = dec.corners[top_f]
    # Center = intersection of the two diagonals.
    center = line_intersection(
        sel_corners[:, 0], sel_corners[:, 2] - sel_corners[:, 0],
        sel_corners[:, 1], sel_corners[:, 3] - sel_corners[:, 1])

    poses = estimate_poses(sel_corners, camera.K, cfg.tag_size)

    det = Detections(
        valid=sel_valid,
        id=torch.where(sel_valid, dec.id[top_f], -1),
        hamming=dec.hamming[top_f],
        decision_margin=dec.margin[top_f],
        center=center,
        corners=sel_corners,
        translation=poses.translation,
        quaternion=poses.quaternion,
        rotation=poses.rotation,
    )
    n_quads = qvalid.sum().to(torch.int32)
    stats = FrameStats(
        num_edge_points=clusters.num_edge_points,
        num_clusters=clusters.num_clusters,
        num_quads=n_quads,
        num_detections=sel_valid.sum().to(torch.int32),
        edge_stride=clusters.edge_stride,
        ccl_converged=ccl_converged,
        overflow=clusters.overflow | (n_quads > T2),
    )
    return det, stats


def build_detect_fn(config: DetectorConfig, camera: CameraModel,
                    encoding: str = "rgb8"):
    """Returns a function image tensor -> (Detections, FrameStats). The image
    must already lie on the device the camera's tensors lie on."""
    family = get_family(config.tag_family)
    cfg = config
    if cfg.ccl_phase2_rounds < 1:
        # One scan phase ends in resolve's flat-label mode, not ported yet.
        raise ValueError("ccl_phase2_rounds=0 (single-phase CCL) is not supported "
                         "by this package yet")
    if cfg.backend == "cuda":
        threshold = threshold_kernel.adaptive_threshold
    else:
        threshold = adaptive_threshold

    def detect(image: torch.Tensor) -> tuple[Detections, FrameStats]:
        gray = grayscale(image, encoding).contiguous()
        seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
        trinary = threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
        valid = trinary != 127
        R_eff = cfg.effective_capacities(*trinary.shape)[1]
        label, scan_converged = ccl_ops.ccl_scan(trinary, cfg.ccl_scan_rounds,
                                                 backend=cfg.backend)
        # Rank-space contraction + a short second scan phase.
        rank_img, rank_table, extra_overflow = resolve_roots_rank(
            label, valid, max_components=R_eff,
            chain_steps=cfg.ccl_contraction_steps)
        label, scan_converged = ccl_ops.ccl_scan(
            trinary, cfg.ccl_phase2_rounds, backend=cfg.backend,
            label0=rank_img)
        return detect_tail(cfg, camera, family, gray, trinary, label,
                           scan_converged, rank_table=rank_table,
                           extra_overflow=extra_overflow)

    return detect


class Detector:
    """User-facing detector: validates the config and device at construction
    and builds one detect function per input encoding.

    A detector on a CUDA device turns TF32 off for the whole process when it
    is constructed (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 = False): the quad fit's arc sums, the
    decoder's least squares and the pose take f32 matmuls, which TF32 would
    round to 10 mantissa bits."""

    def __init__(self, config: DetectorConfig | None = None,
                 camera: CameraModel | None = None,
                 device: torch.device | str | None = None):
        self.config = config or DetectorConfig()
        if camera is None:
            raise ValueError("camera is required (CameraModel.create / from_camera_info)")
        if device is None:
            device = "cuda" if self.config.backend == "cuda" else "cpu"
        self.device = torch.device(device)
        if self.config.backend == "cuda":
            if self.device.type != "cuda":
                raise ValueError(f"backend 'cuda' needs a CUDA device, got {self.device}")
            if not torch.cuda.is_available():
                raise RuntimeError("backend 'cuda' needs CUDA, which is not available")
            from .ops.cuda import _lib
            _lib.library()          # build or load the kernels now; raises on failure
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.camera = camera.to(self.device)
        self.family: TagFamily = get_family(self.config.tag_family)
        self._fns: dict[str, object] = {}

    def _fn(self, encoding: str):
        if encoding not in self._fns:
            self._fns[encoding] = build_detect_fn(self.config, self.camera, encoding)
        return self._fns[encoding]

    def _image(self, image) -> torch.Tensor:
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        return image.to(self.device)

    def detect(self, image, encoding: str = "rgb8") -> Detections:
        return self.detect_with_stats(image, encoding)[0]

    def detect_with_stats(self, image, encoding: str = "rgb8"
                          ) -> tuple[Detections, FrameStats]:
        return self._fn(encoding)(self._image(image))
