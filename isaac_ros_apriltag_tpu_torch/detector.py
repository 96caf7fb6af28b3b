"""AprilTag detector: config + camera + device -> detect(frame).

Counterpart of ``isaac_ros_apriltag_tpu/detector.py``, on a batch of frames
with a leading batch dimension written through every stage (the
counterpart of ``jax.vmap`` of the reference's detect function); one frame
is a batch of one. The reference jits the detect function; here, on a CUDA
device, a call of an input shape seen before is one CUDA graph replay
(capture.py), and on the CPU it
runs op by op. A batch makes the same kernel launches as one
frame. Stages: grayscale, quad_decimate mean-pool, adaptive threshold
(kernel K1), two-phase scan CCL (kernels K2 and K3, with the rank-space
contraction between the phases; with ccl_phase2_rounds=0 one scan phase on
flat-index labels; with ccl_flow='jumps' one scan phase with pointer jumps
between rounds), resolve (ops/cuda/resolve.py, five kernels a call: count,
tile sums, scan, the chain walk and map; the contraction and the final
resolve), cluster moments (ops/cuda/cluster_moments.py, nine kernels: the
pair count, the kept pairs' histogram pass and four radix passes, two
segment kernels and the moments; no library sort), then the tail, one
kernel a stage or two: quad fit (the prefix tables, then the search and its
epilogue, ops/cuda/quadfit.py), top-2T by fit quality and edge refinement
in one launch (ops/cuda/refine.py::select_and_refine), decode
(ops/cuda/decode.py), and the dedupe and top-T by decision margin with the
center and the tags' pose in one launch (ops/cuda/tail.py::finish_and_pose;
with_pose=False: the finish alone). Backend 'cuda' runs the kernels;
'torch' runs their plain versions. Everything else is plain PyTorch on the
detector's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.model import CameraModel
from .capture import GraphedCall
from .config import DetectorConfig
from .models.families import TagFamily, get_family
from .ops.cluster_moments import extract_cluster_moments
from .ops.cuda import ccl as ccl_ops
from .ops.cuda import cluster_moments as cluster_kernels
from .ops.cuda import decode as decode_kernel
from .ops.cuda import quadfit as quadfit_kernel
from .ops.cuda import refine as refine_kernel
from .ops.cuda import resolve as resolve_kernels
from .ops.cuda import tail as tail_kernels
from .ops.cuda import threshold as threshold_kernel
from .ops.decode import decode_quads
from .ops.grayscale import grayscale
from .ops.pose import estimate_poses
from .ops.quadfit import fit_quads_from_moments
from .ops.resolve import resolve_components, resolve_roots_rank
from .ops.tail import finish_detections, select_and_refine
from .ops.tail import upscale_coords as _upscale_coords  # noqa: F401  (the reference's name)
from .ops.threshold import adaptive_threshold
from .types import Detections, FrameStats


def _pad_to_tiles(gray: torch.Tensor, ts: int) -> torch.Tensor:
    """Edge-pad (..., H, W) up to multiples of ts."""
    *lead, H, W = gray.shape
    ph, pw = (-H) % ts, (-W) % ts
    if ph:
        gray = torch.cat([gray, gray[..., -1:, :].expand(*lead, ph, W)], -2)
    if pw:
        gray = torch.cat([gray, gray[..., -1:].expand(*lead, H + ph, pw)], -1)
    return gray


def _decimate(gray: torch.Tensor, d: int) -> torch.Tensor:
    """d x d mean-pool of (..., H, W) (AprilTag 3's quad_decimate). The
    reference pools with two f32 matmuls against banded 1/d operators; each
    output sums d nonzero products, added here in the same ascending order
    (for d = 2 the products are exact halves, so the result is
    bit-identical)."""
    if d == 1:
        return gray
    gray = _pad_to_tiles(gray, d)
    w = float(np.float32(1.0 / d))
    rows = gray[..., 0::d, :] * w
    for k in range(1, d):
        rows = rows + gray[..., k::d, :] * w
    out = rows[..., 0::d] * w
    for k in range(1, d):
        out = out + rows[..., k::d] * w
    return out


def detect_tail(cfg: DetectorConfig, camera: CameraModel, family: TagFamily,
                gray: torch.Tensor, trinary: torch.Tensor, label: torch.Tensor,
                scan_converged: torch.Tensor, *, with_pose: bool = True,
                rank_table: torch.Tensor | None = None,
                extra_overflow: torch.Tensor | None = None
                ) -> tuple[Detections, FrameStats]:
    """The back half of the detector on a batch: (B, ...) CCL labels ->
    Detections and FrameStats with a leading B. Shared by the detector and
    the row-sharded front (parallel/spatial.py). Labels are flat indices, or
    compacted ranks with their `rank_table` (the two-phase flow);
    `extra_overflow` ORs an upstream capacity flag (the contraction's) into
    the cluster stage's overflow."""
    E_eff, R_eff = cfg.effective_capacities(*trinary.shape[-2:])
    resolve = (resolve_kernels.resolve_components if cfg.backend == "cuda"
               else resolve_components)
    res = resolve(label, trinary != 127,
                  min_component_pixels=cfg.min_component_pixels,
                  max_components=R_eff,
                  chain_steps=cfg.ccl_resolve_steps,
                  rank_table=rank_table)
    comp_overflow = res.overflow if extra_overflow is None else res.overflow | extra_overflow
    moments = (cluster_kernels.extract_cluster_moments if cfg.backend == "cuda"
               else extract_cluster_moments)
    clusters = moments(
        trinary, res.dense,
        comp_overflow=comp_overflow,
        max_edge_points=E_eff,
        max_clusters=cfg.max_clusters,
        min_cluster_pixels=cfg.min_cluster_pixels,
        max_cluster_points=cfg.max_cluster_points)
    return _detect_from_clusters(cfg, camera, family, gray, clusters,
                                 scan_converged & res.converged, with_pose=with_pose)


def _detect_from_clusters(cfg, camera, family, gray, clusters, ccl_converged, *,
                          with_pose: bool = True) -> tuple[Detections, FrameStats]:
    """(B, ...) cluster moments -> Detections and FrameStats. Quad fit,
    refine, decode and pose work per quad; the top-k picks and the dedupe
    work within each frame. On backend 'cuda' each stage is one kernel
    launch: the quad fit's search and epilogue, the top-2T pick with
    refine, decode, the dedupe and top-T pick with pose. with_pose=False leaves
    translation, quaternion and rotation zero (rotation too, not the
    identity)."""
    cuda = cfg.backend == "cuda"
    fit = quadfit_kernel.fit_quads_from_moments if cuda else fit_quads_from_moments
    select_refine = refine_kernel.select_and_refine if cuda else select_and_refine
    decode = decode_kernel.decode_quads if cuda else decode_quads
    finish = tail_kernels.finish_detections if cuda else finish_detections
    d = cfg.quad_decimate
    quads = fit(clusters, min_area=64.0 / (d ** 2))

    # Top-2T candidate quads by perimeter / (1 + fit error), refined and
    # decoded; then the top-T by decision margin.
    T2 = min(2 * cfg.max_tags, quads.valid.shape[1])
    cand = select_refine(gray, quads.corners, quads.valid, quads.dark_inside, quads.fit_err,
                         want_dark=not family.reversed_border, k=T2, decimate=d,
                         search_range=d + 1.0)
    dec = decode(gray, cand.corners, family, max_hamming=cfg.max_hamming,
                 decode_sharpening=cfg.decode_sharpening)
    fkw = dict(k=cfg.max_tags, min_decision_margin=cfg.min_decision_margin)
    if with_pose and cuda:      # the finish and the pose in one launch
        sel, poses = tail_kernels.finish_and_pose(dec, cand.pre_valid, cand.num_quads,
                                                  clusters.overflow, camera.K, cfg.tag_size,
                                                  **fkw)
    else:
        sel = finish(dec, cand.pre_valid, cand.num_quads, clusters.overflow, **fkw)
        poses = estimate_poses(sel.corners, camera.K, cfg.tag_size) if with_pose else None
    if poses is not None:
        translation, quaternion, rotation = poses.translation, poses.quaternion, poses.rotation
    else:
        lead = sel.corners.shape[:-2]
        translation, quaternion, rotation = (
            torch.zeros((*lead, *shape), dtype=torch.float32, device=sel.corners.device)
            for shape in ((3,), (4,), (3, 3)))

    det = Detections(valid=sel.valid, id=sel.id, hamming=sel.hamming,
                     decision_margin=sel.margin, center=sel.center, corners=sel.corners,
                     translation=translation, quaternion=quaternion, rotation=rotation)
    stats = FrameStats(
        num_edge_points=clusters.num_edge_points,
        num_clusters=clusters.num_clusters,
        num_quads=cand.num_quads,
        num_detections=sel.num_detections,
        edge_stride=clusters.edge_stride,
        ccl_converged=ccl_converged,
        overflow=sel.overflow,
    )
    return det, stats


def build_batched_detect_fn(config: DetectorConfig, camera: CameraModel,
                            encoding: str = "rgb8", *, with_pose: bool = True,
                            capture: bool = True):
    """Returns a function (B, H, W[, C]) image tensor -> (Detections,
    FrameStats), every field with a leading B. The images must lie on the
    device the camera's tensors lie on; backend 'cuda' needs that to be a
    CUDA device and raises otherwise. Whatever B, one call makes the same
    kernel launches: K1 once, K2 and K3 once per scan round
    (ccl_scan_rounds + ccl_phase2_rounds), each resolve kernel once per
    resolve call (the contraction and the final resolve) and each cluster
    kernel once. With ccl_phase2_rounds=0 the
    phase-1 labels go to the flat-label resolve, with no contraction. With
    ccl_flow='jumps' (the reference's 'xla' flow) the CCL is ccl_rounds
    scan rounds with ccl_jumps pointer jumps every ccl_jump_every rounds,
    and its labels go to the flat-label resolve: K2 and K3 ccl_rounds
    times each.

    with_pose=False skips the pose stage (translation, quaternion and
    rotation come back zero), for callers that pose the corners with their
    own intrinsics (parallel/rig.py), so no pose is computed twice.

    On a CUDA device the function is replayed from CUDA graphs
    (capture.GraphedCall): its first call with a new input shape and dtype
    runs eagerly; the second captures the call (a device sync) and replays
    it; each later call with that signature is one graph replay on the
    caller's current stream, whose results are fresh tensors.
    capture=False, or a CPU device, gives the eager function, op by op."""
    family = get_family(config.tag_family)
    cfg = config
    if cfg.backend == "cuda":
        if camera.K.device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got {camera.K.device}")
        threshold = threshold_kernel.adaptive_threshold
        contract = resolve_kernels.resolve_roots_rank
    else:
        threshold = adaptive_threshold
        contract = resolve_roots_rank

    def detect(images: torch.Tensor) -> tuple[Detections, FrameStats]:
        if images.device != camera.K.device:
            raise ValueError(f"images on {images.device}, the camera on {camera.K.device}")
        gray = grayscale(images, encoding, batched=True).contiguous()
        seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
        trinary = threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
        if cfg.ccl_flow == "jumps":
            label, scan_converged = ccl_ops.ccl_scan(
                trinary, cfg.ccl_rounds, backend=cfg.backend, jumps=cfg.ccl_jumps,
                jump_every=cfg.ccl_jump_every)
            return detect_tail(cfg, camera, family, gray, trinary, label,
                               scan_converged, with_pose=with_pose)
        label, scan_converged = ccl_ops.ccl_scan(trinary, cfg.ccl_scan_rounds,
                                                 backend=cfg.backend)
        if cfg.ccl_phase2_rounds == 0:
            return detect_tail(cfg, camera, family, gray, trinary, label,
                               scan_converged, with_pose=with_pose)
        # Rank-space contraction + a short second scan phase.
        R_eff = cfg.effective_capacities(*trinary.shape[-2:])[1]
        rank_img, rank_table, extra_overflow = contract(
            label, trinary != 127, max_components=R_eff,
            chain_steps=cfg.ccl_contraction_steps)
        label, scan_converged = ccl_ops.ccl_scan(
            trinary, cfg.ccl_phase2_rounds, backend=cfg.backend,
            label0=rank_img)
        return detect_tail(cfg, camera, family, gray, trinary, label,
                           scan_converged, rank_table=rank_table,
                           extra_overflow=extra_overflow, with_pose=with_pose)

    if capture and camera.K.device.type == "cuda":
        return GraphedCall(detect)
    return detect


def build_detect_fn(config: DetectorConfig, camera: CameraModel,
                    encoding: str = "rgb8", *, with_pose: bool = True):
    """Returns a function image tensor (H, W[, C]) -> (Detections,
    FrameStats) of one frame: the batched function on a batch of one
    (captured as build_batched_detect_fn says)."""
    batched = build_batched_detect_fn(config, camera, encoding, with_pose=with_pose)

    def detect(image: torch.Tensor) -> tuple[Detections, FrameStats]:
        det, stats = batched(image[None])
        return det.frame(0), stats.frame(0)

    return detect


# detect_checked's invariants, in the order they are checked, with the
# reference's messages (isaac_ros_apriltag_tpu/detector.py:369-384).
INVARIANTS = ("non-finite corners on valid detections",
              "non-finite centers on valid detections",
              "non-finite translations on valid detections",
              "unnormalized quaternions on valid detections",
              "tag id out of family range",
              "num_detections disagrees with the valid mask")


def _invariants(det: Detections, stats: FrameStats, ncodes: int) -> torch.Tensor:
    """(len(INVARIANTS),) bool on the detections' device, True where the
    invariant holds on every valid row of every frame (one frame or a batch)."""
    v = det.valid

    def on_valid(ok: torch.Tensor) -> torch.Tensor:
        return (ok.reshape(*v.shape, -1).all(-1) | ~v).all()

    qn = (det.quaternion * det.quaternion).sum(-1)
    return torch.stack([
        on_valid(torch.isfinite(det.corners)),
        on_valid(torch.isfinite(det.center)),
        on_valid(torch.isfinite(det.translation)),
        on_valid((qn - 1.0).abs() < 1e-3),
        on_valid((det.id >= 0) & (det.id < ncodes)),
        (stats.num_detections == v.sum(-1)).all()])


def device_for(config: DetectorConfig, device: torch.device | str | None) -> torch.device:
    """The device a detector or pipeline runs on (default: 'cuda', for both
    backends; pass device='cpu' to run backend 'torch' on the CPU). Backend
    'cuda' raises unless it is a CUDA device and the kernels build or load.
    On a CUDA device TF32 is turned off for the whole process
    (torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    = False): the decoder's least squares and the pose take f32 matmuls,
    which TF32 would round to 10 mantissa bits."""
    device = torch.device("cuda" if device is None else device)
    if config.backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'cuda' needs CUDA, which is not available")
        from .ops.cuda import _lib
        _lib.library()          # build or load the kernels now; raises on failure
    if device.type == "cuda":
        no_tf32()
    return device


def no_tf32() -> None:
    """Turn TF32 off for the whole process (torch.backends.cuda.matmul and
    cudnn), so f32 matmuls on the card keep their 24 mantissa bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_device(image, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor, as a tensor on `device`."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    return image.to(device)


class Detector:
    """User-facing single-frame detector: validates the config and device at
    construction (see device_for, which also turns TF32 off on a CUDA
    device) and builds one detect function per input encoding."""

    def __init__(self, config: DetectorConfig | None = None,
                 camera: CameraModel | None = None,
                 device: torch.device | str | None = None):
        self.config = config or DetectorConfig()
        if camera is None:
            raise ValueError("camera is required (CameraModel.create / from_camera_info)")
        self.device = device_for(self.config, device)
        self.camera = camera.to(self.device)
        self.family: TagFamily = get_family(self.config.tag_family)
        self._fns: dict[str, object] = {}

    def _fn(self, encoding: str):
        if encoding not in self._fns:
            self._fns[encoding] = build_detect_fn(self.config, self.camera, encoding)
        return self._fns[encoding]

    def detect(self, image, encoding: str = "rgb8") -> Detections:
        return self.detect_with_stats(image, encoding)[0]

    def detect_with_stats(self, image, encoding: str = "rgb8"
                          ) -> tuple[Detections, FrameStats]:
        return self._fn(encoding)(to_device(image, self.device))

    def detect_checked(self, image, encoding: str = "rgb8"
                       ) -> tuple[Detections, FrameStats]:
        """detect_with_stats, then the reference's output invariants
        (INVARIANTS: finite corners, centers and translations, unit
        quaternions, ids in the family, num_detections equal to the valid
        count), taken on the device and read back once; raises RuntimeError
        with the first violated invariant's message. Waits for the device:
        a debugging entry point, not the hot path."""
        det, stats = self.detect_with_stats(image, encoding)
        holds = _invariants(det, stats, self.family.ncodes).tolist()
        for ok, message in zip(holds, INVARIANTS):
            if not ok:
                raise RuntimeError(message)
        return det, stats
