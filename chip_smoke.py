#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA AprilTag detector on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failed check raises and the exit code is
non-zero):
  1. device: the card's name and power limit;
  2. build: nvcc builds the CUDA kernels of isaac_ros_apriltag_tpu_torch/csrc;
  3. kernels: each kernel is bit-exact (torch.equal) against its plain
     PyTorch twin on the card, at the detector's 540x960 segmentation shape
     (threshold on the scene; one CCL round on random input; the full
     8 + 6 round two-phase CCL on a rendered scene), the threshold on
     THRESH_CASES (see thresh_case: every tile size, shapes on and one tile
     over the kernel's block edges, one tile high or wide, flat frames,
     pixels at the threshold, misaligned frame views and W = 2 mod 4
     through its scalar path, batches also against each frame alone), and
     the two scan kernels on SCAN_CASES, lines built to break a chunked scan
     (see scan_case), and on a batch whose frames differ only in their first
     and last rows;
  4. main path: Detector(backend="cuda") on three rendered 1080x1920 frames
     with six tag36h11 tags and noise 2 must find all six ids with corners
     within 1 px of ground truth, backend "torch" on the same card must
     give identical results, and TF32 must be off after the run;
  5. launch counts: the main path ran each kernel the expected number of
     times per frame;
  6. times: ms per frame for both backends (CUDA events after a warmup) and
     device ms per call for each kernel and its twin (CUDA events around
     launches queued behind a spin kernel, so the host's issue rate does
     not pace them);
  7. batched kernels: at batch 8, on the segmentation images of eight
     different 1080p frames (other tag ids, other noise seeds) and on random
     frames that differ, each kernel is bit-exact against its batched twin
     and against itself run on each frame alone (frames are isolated), and
     the two-phase CCL of the batch equals the twins' on both;
  8. batched main path: pipeline.batched_detect_fn (backend "cuda") on the
     eight frames finds 6/6 ids in each with corners within 1 px of ground
     truth, equals Detector.detect_with_stats on each frame (FrameStats,
     valid and ids exact; on valid rows hamming exact, corners within 1e-3
     px, translation and quaternion within 1e-4),
     equals backend "torch" on every field, launches 1 / 14 / 14 kernels for
     the batch, and prints its peak device memory;
  9. graph: GraphPipeline on a batch of 8 distorted 3840x2160 frames (the
     reference's calibration scaled 3x, two different scenes), rectified,
     downscaled 2x and detected at 1080p: 6/6 ids per frame with corners
     within 1 px of the truth projected with the detection camera, "cuda"
     equal to "torch", and the separable rectify and the gather giving the
     same ids with corners within 0.05 px; launches 1 / 14 / 14 for the batch;
 10. times: ms per frame of both backends at batch 1 and batch 8, of the
     graph at batch 8 with the separable rectify and with the gather, and
     device ms per call of each kernel and its twin at batch 8.
It ends with a JSON line describing the kernels (launches of every path;
times beside the least time the card could take, from the bytes each call
must move), the nvidia-smi name and power limit, and a last JSON line
{"ok": true, "device": {...}}. Without a CUDA device it exits with code 1
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H, W = 1080, 1920
TAG_IDS = (1, 8, 15, 22, 29, 36)
TAG_SIZE = 0.3
SEEDS = (0, 1, 2)
CORNER_TOL_PX = 1.0
SCAN_ROUNDS = 8 + 6           # phase-1 + phase-2 CCL rounds per frame
BATCH = 8
# Batched against single-frame detections (phase 8), on valid rows.
BATCH_TOL = {"corners": 1e-3, "translation": 1e-4, "quaternion": 1e-4}
# The reference's shipped usb_cam calibration (1280x720), scaled 3x to the
# 8 MP graph input as bench.py does.
REF_K = dict(fx=942.53242, fy=946.21221, cx=642.81122, cy=346.71313)
REF_D = [0.065725, -0.096954, 0.002318, 0.004110, 0.0]
GRAPH_TOL_PX = 0.05           # separable rectify against the gather
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)

# Scan-kernel inputs that break a chunked scan: widths and heights around
# a warp's 32 lanes and at the 4096-pixel limit, each with fills and labels
# from scan_case.
SCAN_SHAPES = ((1, 1), (31, 32), (32, 33), (33, 31), (1023, 1025), (1025, 1023),
               (33, 4096), (4096, 33))
SCAN_FILLS = (("random", "perm"), ("random", "top"), ("all0", "asc"), ("all127", "perm"),
              ("all255", "desc"), ("all255", "asc"), ("checker", "desc"),
              ("stripes32", "desc"), ("stripes31", "high"), ("stripes33", "perm"),
              ("lone127", "desc"))
SCAN_CASES = tuple((shape, fill, labels) for shape in SCAN_SHAPES
                   for fill, labels in SCAN_FILLS)
K3_CHUNKS = 16                # csrc/ccl.cu's COL_WARPS: K3 cuts a column into this many chunks


def scan_case(shape, fill: str, labels: str, seed: int = 0):
    """(uint8 trinary, int32 labels) numpy arrays of `shape` for one scan case.

    fill: "random"; "all0" / "all127" / "all255"; "checker" (every pixel its
    own run along both axes, joined only by the white diagonal hop, also
    across K3's 32-column bands); "stripesK": blocks K columns wide and K3's
    chunk height + K - 32 rows high, so runs start and end on (K = 32) or
    next to (31, 33) lane groups, K2's 256-pixel load batches, K3's bands
    and its row chunks; "lone127": all white but 127 pixels at those
    boundaries and on the frame's edges.
    labels: "perm" (a permutation of the flat indices), "asc" / "desc" (flat
    index order, so a run's minimum sits at its first or last pixel and the
    carry crosses every chunk), "high" (around 2**30, as rank seeds), "top"
    (up to INT32_MAX, the scans' identity)."""
    H, W = shape
    rng = np.random.default_rng(seed)
    y, x = np.indices(shape)
    chunk = -(-H // K3_CHUNKS)
    if fill == "random":
        tri = rng.choice(np.array([0, 127, 255]), size=shape, p=[0.3, 0.2, 0.5])
    elif fill.startswith("all"):
        tri = np.full(shape, int(fill[3:]))
    elif fill == "checker":
        tri = np.where((x + y) % 2, 255, 0)
    elif fill.startswith("stripes"):
        k = int(fill[7:])
        tri = np.where((x // k + y // max(1, chunk + k - 32)) % 2, 255, 0)
    elif fill == "lone127":
        tri = np.full(shape, 255)
        tri[np.ix_([r for r in (0, chunk - 1, chunk, H - 1) if r < H],
                   [c for c in (0, 31, 32, 255, 256, W - 1) if c < W])] = 127
    else:
        raise ValueError(f"unknown fill {fill!r}")
    n = H * W
    flat = np.arange(n)
    lab = {"perm": lambda: rng.permutation(n), "asc": lambda: flat,
           "desc": lambda: n - 1 - flat, "high": lambda: 2**30 - n // 2 + rng.permutation(n),
           "top": lambda: 2**31 - 1 - rng.permutation(n)}[labels]()
    return tri.astype(np.uint8), lab.astype(np.int32).reshape(shape)


def scan_case_id(case) -> str:
    """'HxW-fill-labels' of one SCAN_CASES entry."""
    (h, w), fill, labels = case
    return f"{h}x{w}-{fill}-{labels}"


def edge_batch(H: int, W: int, n: int = 3, seed: int = 0):
    """n frames that differ only in their first and last rows, as (uint8
    trinary, int32 flat-index labels) of shape (n, H, W): a scan that let
    one frame's last row reach the next frame's first would differ."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.array([0, 127, 255], np.uint8), size=(H, W), p=[0.2, 0.1, 0.7])
    tri = np.stack([base] * n)
    pal = np.array([255, 0, 127], np.uint8)
    for b in range(n):
        tri[b, 0] = pal[b % 3]
        tri[b, -1] = pal[(b + 1) % 3]
    lab = np.broadcast_to(np.arange(H * W, dtype=np.int32).reshape(H, W), (n, H, W))
    return tri, np.ascontiguousarray(lab)


# Threshold-kernel inputs, (tile size, shape, fill, offset); see thresh_case.
# csrc/threshold.cu's blocks write 32 px rows by 128 px columns at every tile
# size, so the shapes sit on one block, one tile over it, one tile high or
# wide, and at the detector's segmentation size. W = 2 mod 4 (ts = 2) and
# frame views that start `offset` floats past a 16-byte boundary take the
# kernel's scalar path.
THRESH_TILES = (2, 4, 8, 16, 32)
THRESH_MIN_DIFF = 5           # min_white_black_diff of every case ("at_thresh" is built on it)
THRESH_CASES = tuple(
    [(ts, shape, "random", 0) for ts in THRESH_TILES
     for shape in ((ts, ts), (ts, 256), (256, ts), (32, 128), (32 + ts, 128 + ts),
                   (544, 960))]
    + [(ts, (64 + ts, 256 + ts), fill, 0) for ts in THRESH_TILES
       for fill in ("flat", "at_thresh")]
    + [(ts, (5, 64 + ts, 128 + 2 * ts), "edges", 0) for ts in THRESH_TILES]
    + [(ts, (3, 64, 256), "random", ts % 3 + 1) for ts in THRESH_TILES]
    + [(4, (540, 960), "random", 0), (2, (540, 960), "random", 0),
       (2, (540, 962), "random", 0), (2, (34, 66), "random", 0),
       (4, (540, 960), "random", 1), (4, (8, 540, 960), "random", 2),
       (2, (3, 34, 130), "edges", 0)])


def thresh_case(case, seed: int = 0):
    """float32 grayscale (numpy) of one THRESH_CASES entry, (H, W) or (B, H, W).

    fill: "random" (uniform 0-255 with a flat 16x16 patch); "flat" (all
    127); "at_thresh": every tile holds its band's min and max at its first
    two pixels, the other pixels are the band's threshold, one float either
    side of it, the min or the max, and the bands (of tile columns) have
    contrast exactly min_diff = 5, one float under it, and two contrasts
    whose threshold rounds; "edges": frames that differ only in their first
    or last row or column of tiles (frame 0 is the base; 1, 2 change the
    first and last tile row, 3, 4 the first and last tile column), so a halo
    that reached past its frame's edge would differ from the frame alone."""
    ts, shape, fill, _ = case
    rng = np.random.default_rng(seed)
    H, W = shape[-2:]
    f32 = np.float32
    if fill == "random":
        g = rng.uniform(0, 255, shape).astype(f32)
        g[..., :16, :16] = 100.0
    elif fill == "flat":
        g = np.full(shape, 127.0, f32)
    elif fill == "at_thresh":
        bands = [(f32(100.0), f32(105.0)), (f32(100.0), np.nextafter(f32(105.0), f32(0))),
                 (f32(0.1), f32(5.1)), (f32(37.7), f32(200.3))]
        band = (np.arange(W) // ts * len(bands)) // (W // ts)
        mn = np.array([b[0] for b in bands], f32)[band]
        mx = np.array([b[1] for b in bands], f32)[band]
        t = mn + (mx - mn) * f32(0.5)
        choices = np.stack([t, np.nextafter(t, f32(-np.inf)), np.nextafter(t, f32(np.inf)),
                            mn, mx])
        g = choices[rng.integers(0, 5, (H, W)), np.arange(W)]
        y, x = np.indices((H, W))
        g = np.where((y % ts == 0) & (x % ts == 0), mn, g)
        g = np.where((y % ts == 0) & (x % ts == 1), mx, g).astype(f32)
        g = np.broadcast_to(g, shape).copy()
    elif fill == "edges":
        g = np.stack([rng.uniform(0, 255, (H, W)).astype(f32)] * shape[0])
        for b, (rows, cols) in enumerate([(slice(0), slice(0)), (slice(0, ts), slice(None)),
                                          (slice(H - ts, H), slice(None)),
                                          (slice(None), slice(0, ts)),
                                          (slice(None), slice(W - ts, W))][:shape[0]]):
            g[b, rows, cols] = 255.0 if b % 2 else 0.0
    else:
        raise ValueError(f"unknown fill {fill!r}")
    return g


def thresh_case_id(case) -> str:
    """'tsN-[Bx]HxW-fill[-offK]' of one THRESH_CASES entry."""
    ts, shape, fill, offset = case
    return f"ts{ts}-{'x'.join(map(str, shape))}-{fill}" + (f"-off{offset}" if offset else "")


def thresh_input(case, device):
    """The case's frames as a contiguous float32 tensor on `device` that
    starts `offset` floats into its allocation (off a 16-byte boundary
    when offset % 4 != 0)."""
    import torch

    offset = case[3]
    g = torch.from_numpy(thresh_case(case))
    view = torch.empty(offset + g.numel(), dtype=torch.float32, device=device)[offset:]
    return view.view(g.shape).copy_(g)


def _gpu_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _scene(seed: int, id_shift: int = 0, cam=None, size=(H, W)):
    """bench.py's noisy 1080p scene: six tags at 2.5 m, in-plane turns, ids
    TAG_IDS + id_shift; `cam` and `size` render it for another camera."""
    from isaac_ros_apriltag_tpu_torch import CameraModel, get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

    if cam is None:
        cam = CameraModel.create(fx=900.0 * W / 1920, fy=900.0 * W / 1920,
                                 cx=W / 2, cy=H / 2, width=W, height=H)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.8, -0.45), (0.0, -0.45), (0.8, -0.45),
                                (-0.8, 0.45), (0.0, 0.45), (0.8, 0.45)]):
        t = np.array([x, y, 2.5])
        tags.append(dict(family=fam, id=TAG_IDS[i] + id_shift, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=TAG_SIZE))
    frame = render_tags(cam.K.numpy(), size, tags, noise=2.0, seed=seed)
    return cam, tags, frame


def batch_scenes(n: int):
    """n different frames of the scene: frame b has ids TAG_IDS + b and
    noise seed b."""
    return [_scene(b, id_shift=b) for b in range(n)]


def _same(a, b) -> bool:
    """Exact equality, NaN equal to NaN (masked float lanes may hold NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _max_abs_err(a, b) -> float:
    return float((a.to(float) - b.to(float)).abs().max())


def _truth_error(det, tags, K) -> float:
    """Worst corner error (px) of one frame's detections against the tags'
    projected corners; raises unless exactly the tags' ids were found, with
    finite corners and pose."""
    import torch

    from isaac_ros_apriltag_tpu_torch.utils.render import project_corners

    rows = {r["id"]: r for r in det.to_list()}
    want = sorted(t["id"] for t in tags)
    if sorted(rows) != want:
        raise AssertionError(f"ids {sorted(rows)} != {want}")
    for name in ("corners", "translation", "quaternion"):
        if not bool(torch.isfinite(getattr(det, name)[det.valid]).all()):
            raise AssertionError(f"non-finite {name} on a valid detection")
    worst = 0.0
    for tag in tags:
        gt = project_corners(K, tag["R"], tag["t"], tag["tag_size"])
        worst = max(worst, float(np.linalg.norm(np.asarray(rows[tag["id"]]["corners"]) - gt,
                                                axis=-1).max()))
    if worst > CORNER_TOL_PX:
        raise AssertionError(f"corner error {worst:.3f} px > {CORNER_TOL_PX} px")
    return worst


def _all_same(a, b, what: str) -> None:
    """Every field of two (Detections, FrameStats) pairs equal (_same)."""
    import dataclasses

    for x, y in zip(a, b):
        for fld in dataclasses.fields(x):
            if not _same(getattr(x, fld.name), getattr(y, fld.name)):
                raise AssertionError(f"{what} differ in {type(x).__name__}.{fld.name}")


def _time_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, by CUDA events after a warmup."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls. The calls are queued
    behind a spin kernel that outlasts their issue on the host, so a small
    kernel is timed back to back on the card, not at the host's pace."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * 2 * issue_s) + 1000)   # cycles at ~2 GHz: twice the issue time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(*tensors) -> float:
    """The least time the card could take to read each input once and write
    each output once, at HBM_BYTES_PER_S. The kernels do a few integer
    operations a pixel, far under the card's rate for them, so bytes bound
    them."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3


def ptxas_usage(log: str) -> dict:
    """{kernel or kernel<template args>: (registers, spill bytes stored and
    loaded, static shared memory bytes)} from the -Xptxas -v lines of a
    build's log."""
    import re

    usage, name, spill = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            name, spill = m.group(1), 0
            if k:
                args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)) and name:
            usage[name] = (int(m.group(1)), spill, int(m.group(2) or 0))
    return usage


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import dataclasses

    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig
    from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_ops
    from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
    from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_roots_rank
    from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold
    from isaac_ros_apriltag_tpu_torch.pipeline import GraphPipeline, batched_detect_fn

    dev = torch.device("cuda")

    # --- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    gpu = _gpu_info()
    print(f"[1 device] {kind} | nvidia-smi: {gpu} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _lib.library()
    built = (f"built by nvcc in {_lib.build_seconds:.1f} s" if _lib.build_seconds is not None
             else "loaded from the build cache")
    usage = ptxas_usage(_lib.build_log or "")
    print(f"[2 build] kernels {built}; load took {time.perf_counter() - t0:.1f} s; ptxas "
          "(registers, spill bytes, shared bytes): "
          + (", ".join(f"{k} {v}" for k, v in usage.items()) or "no report (cached build)"),
          flush=True)

    # --- 3. kernels against their twins, on the card -----------------------
    scenes = [_scene(s) for s in SEEDS]
    cam, tags, frame0 = scenes[0]
    cfg = DetectorConfig(tag_size=TAG_SIZE)
    gray = grayscale(torch.from_numpy(frame0).to(dev), "mono8")
    seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
    sh, sw = seg.shape
    errs = {"threshold": 0.0, "row": 0.0, "col": 0.0}

    def check(name, a, b, what):
        errs[name] = max(errs[name], _max_abs_err(a, b))
        if not _same(a, b):
            raise AssertionError(f"{what}: kernel and twin differ "
                                 f"(max abs err {_max_abs_err(a, b)})")

    tri = thr_ops.adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    check("threshold", tri, adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff),
          f"threshold on the scene {sh}x{sw} ts={cfg.tile_size}")
    rng = np.random.default_rng(7)
    rh, rw = -(-sh // 32) * 32, -(-sw // 32) * 32      # divisible by every tile size
    for case in THRESH_CASES:
        g = thresh_input(case, dev)
        got = thr_ops.adaptive_threshold(g, case[0], THRESH_MIN_DIFF)
        check("threshold", got, adaptive_threshold(g, case[0], THRESH_MIN_DIFF),
              f"threshold {thresh_case_id(case)}")
        for b in range(g.shape[0] if g.ndim == 3 else 0):
            check("threshold", got[b], thr_ops.adaptive_threshold(g[b], case[0], THRESH_MIN_DIFF),
                  f"threshold {thresh_case_id(case)}, frame {b} alone")
    rtri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=(sh, sw),
                                       p=[0.4, 0.2, 0.4])).to(dev)
    rlab = torch.from_numpy(rng.permutation(sh * sw).astype(np.int32).reshape(sh, sw)).to(dev)
    check("row", ccl_ops.row_scan(rtri, rlab), ccl_ops.row_scan_plain(rtri, rlab),
          "row scan, one round, random input")
    check("col", ccl_ops.col_diag_scan(rtri, rlab), ccl_ops.col_diag_scan_plain(rtri, rlab),
          "diagonal hop + column scan, one round, random input")
    for case in SCAN_CASES:
        ct, cl = (torch.from_numpy(a).to(dev) for a in scan_case(*case))
        check("row", ccl_ops.row_scan(ct, cl), ccl_ops.row_scan_plain(ct, cl),
              f"row scan {scan_case_id(case)}")
        check("col", ccl_ops.col_diag_scan(ct, cl), ccl_ops.col_diag_scan_plain(ct, cl),
              f"column scan {scan_case_id(case)}")
    et, el = (torch.from_numpy(a).to(dev) for a in edge_batch(sh, sw))
    for name, kern, twin in (("row", ccl_ops.row_scan, ccl_ops.row_scan_plain),
                             ("col", ccl_ops.col_diag_scan, ccl_ops.col_diag_scan_plain)):
        got = kern(et, el)
        check(name, got, twin(et, el), f"{name} scan, frames that differ in their edge rows")
        for b in range(et.shape[0]):
            check(name, got[b], kern(et[b].contiguous(), el[b].contiguous()),
                  f"{name} scan, edge-row frame {b} alone")

    valid = tri != 127
    _, R_eff = cfg.effective_capacities(sh, sw)
    outs = {}
    for backend in ("cuda", "torch"):
        lab1, conv1 = ccl_ops.ccl_scan(tri, cfg.ccl_scan_rounds, backend=backend)
        rank_img, table, ovf = resolve_roots_rank(lab1, valid, max_components=R_eff,
                                                  chain_steps=cfg.ccl_contraction_steps)
        lab2, conv2 = ccl_ops.ccl_scan(tri, cfg.ccl_phase2_rounds, backend=backend,
                                       label0=rank_img)
        outs[backend] = dict(label1=lab1, converged1=conv1, rank_img=rank_img,
                             rank_table=table, overflow=ovf, label2=lab2, converged2=conv2)
    for k, v in outs["cuda"].items():
        if not _same(v, outs["torch"][k]):
            raise AssertionError(f"two-phase CCL on the scene: {k} differs")
    torch.cuda.synchronize()
    print(f"[3 kernels] bit-exact vs twins: threshold at {sh}x{sw} (scene ts=4) and on "
          f"{len(THRESH_CASES)} adversarial cases (ts={list(THRESH_TILES)}; batches also frame "
          f"by frame alone; "
          f"{sum(c[3] % 4 != 0 or c[1][-1] % 4 != 0 for c in THRESH_CASES)} through the scalar "
          f"path), row and column scans (one round, random; "
          f"{len(SCAN_CASES)} adversarial cases, shapes {list(SCAN_SHAPES)}; a batch of "
          f"{et.shape[0]} {sh}x{sw} frames that differ only in their edge rows, also each alone), "
          f"two-phase CCL {cfg.ccl_scan_rounds}+{cfg.ccl_phase2_rounds} on the scene "
          f"(labels, converged, rank_img, rank_table, overflow); max abs err {errs}",
          flush=True)

    # --- 4. main path -------------------------------------------------------
    det_cuda = Detector(cfg, cam, device=dev)
    det_torch = Detector(dataclasses.replace(cfg, backend="torch"), cam, device=dev)
    frames = [torch.from_numpy(f).to(dev) for _, _, f in scenes]
    torch.cuda.synchronize()
    thr_ops.launches = ccl_ops.row_launches = ccl_ops.col_diag_launches = 0
    results = [det_cuda.detect_with_stats(f, "mono8") for f in frames]
    torch.cuda.synchronize()
    counts = {"threshold": thr_ops.launches, "row": ccl_ops.row_launches,
              "col": ccl_ops.col_diag_launches}
    # The detector turns TF32 off; nothing on the main path turns it back on.
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on after the main path ran")
    K = cam.K.numpy()
    worst = max(_truth_error(det, tg, K) for (det, _), (_, tg, _) in zip(results, scenes))
    for res, f in zip(results, frames):
        _all_same(res, det_torch.detect_with_stats(f, "mono8"), "backends")
    stats0 = {f.name: getattr(results[0][1], f.name).item()
              for f in dataclasses.fields(results[0][1])}
    print(f"[4 main path] {len(frames)} frames {H}x{W}: 6/6 ids each, worst corner error "
          f"{worst:.4f} px (limit {CORNER_TOL_PX}); cuda == torch on every Detections and "
          f"FrameStats field; TF32 off; frame 0 stats {stats0}", flush=True)

    # --- 5. launch counts ---------------------------------------------------
    n = len(frames)
    want = {"threshold": n, "row": SCAN_ROUNDS * n, "col": SCAN_ROUNDS * n}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    print(f"[5 launches] {counts} over {n} frames "
          f"(1 / {SCAN_ROUNDS} / {SCAN_ROUNDS} per frame)", flush=True)

    # --- 6. times -----------------------------------------------------------
    f0 = frames[0]
    frame_ms = {}
    for backend, det in (("cuda", det_cuda), ("torch", det_torch),
                         ("torch", det_torch), ("cuda", det_cuda)):
        frame_ms.setdefault(backend, []).append(
            _time_ms(lambda: det.detect_with_stats(f0, "mono8"), 10))
    lab1 = outs["cuda"]["label1"]
    ts, md = cfg.tile_size, cfg.min_white_black_diff
    pairs = {
        "threshold": (lambda: thr_ops.adaptive_threshold(seg, ts, md),
                      lambda: adaptive_threshold(seg, ts, md)),
        "row": (lambda: ccl_ops.row_scan(tri, lab1), lambda: ccl_ops.row_scan_plain(tri, lab1)),
        "col": (lambda: ccl_ops.col_diag_scan(tri, lab1),
                lambda: ccl_ops.col_diag_scan_plain(tri, lab1)),
    }
    kernel_ms = {k: (_device_ms(a, 50), _device_ms(b, 50)) for k, (a, b) in pairs.items()}
    bound = {"threshold": _bound_ms(seg, tri), "row": _bound_ms(tri, lab1, lab1),
             "col": _bound_ms(tri, lab1, lab1)}
    per_frame = {b: sum(v) / len(v) for b, v in frame_ms.items()}
    print(f"[6 times] on {gpu}: ms/frame at {H}x{W} cuda {per_frame['cuda']:.3f} "
          f"torch {per_frame['torch']:.3f} (runs {frame_ms}); device ms/call at {sh}x{sw} "
          + ", ".join(f"{k} kernel {a:.4f} twin {b:.4f} bound {bound[k]:.4f}"
                      for k, (a, b) in kernel_ms.items()),
          flush=True)

    # --- 7. batched kernels, frames isolated --------------------------------
    bscenes = batch_scenes(BATCH)
    frames8 = torch.from_numpy(np.stack([f for _, _, f in bscenes])).to(dev)
    gray8 = grayscale(frames8, "mono8", batched=True)
    seg8 = _pad_to_tiles(_decimate(gray8, cfg.quad_decimate), ts).contiguous()
    tri8 = thr_ops.adaptive_threshold(seg8, ts, md)
    check("threshold", tri8, adaptive_threshold(seg8, ts, md), f"batch {BATCH} threshold")
    for b in range(BATCH):
        check("threshold", tri8[b], thr_ops.adaptive_threshold(seg8[b].contiguous(), ts, md),
              f"batched threshold against frame {b} alone")
    for tsz in thr_ops.TILE_SIZES:
        g = rng.uniform(0, 255, (BATCH, rh, rw)).astype(np.float32)
        g[1] = 100.0 + 0.01 * g[1]        # a flat frame between two noisy ones
        g = torch.from_numpy(g).to(dev)
        got = thr_ops.adaptive_threshold(g, tsz, 5)
        check("threshold", got, adaptive_threshold(g, tsz, 5), f"batched threshold random ts={tsz}")
        for b in range(BATCH):
            check("threshold", got[b], thr_ops.adaptive_threshold(g[b].contiguous(), tsz, 5),
                  f"batched threshold random ts={tsz} against frame {b} alone")
    rtri8 = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8),
                                        size=(BATCH, sh, sw), p=[0.3, 0.2, 0.5])).to(dev)
    rlab8 = torch.from_numpy(np.stack([rng.permutation(sh * sw).astype(np.int32).reshape(sh, sw)
                                       for _ in range(BATCH)])).to(dev)
    for name, kern, twin in (("row", ccl_ops.row_scan, ccl_ops.row_scan_plain),
                             ("col", ccl_ops.col_diag_scan, ccl_ops.col_diag_scan_plain)):
        got = kern(rtri8, rlab8)
        check(name, got, twin(rtri8, rlab8), f"batched {name} scan, random frames")
        for b in range(BATCH):
            check(name, got[b], kern(rtri8[b].contiguous(), rlab8[b].contiguous()),
                  f"batched {name} scan against frame {b} alone")
    outs8 = {}
    for backend in ("cuda", "torch"):
        lab1, conv1 = ccl_ops.ccl_scan(tri8, cfg.ccl_scan_rounds, backend=backend)
        rank_img, table, ovf = resolve_roots_rank(lab1, tri8 != 127, max_components=R_eff,
                                                  chain_steps=cfg.ccl_contraction_steps)
        lab2, conv2 = ccl_ops.ccl_scan(tri8, cfg.ccl_phase2_rounds, backend=backend,
                                       label0=rank_img)
        outs8[backend] = dict(label1=lab1, converged1=conv1, rank_img=rank_img,
                              rank_table=table, overflow=ovf, label2=lab2, converged2=conv2)
    for k, v in outs8["cuda"].items():
        if not _same(v, outs8["torch"][k]):
            raise AssertionError(f"batched two-phase CCL: {k} differs between kernels and twins")
    for b in range(BATCH):
        lab1, conv1 = ccl_ops.ccl_scan(tri8[b], cfg.ccl_scan_rounds, backend="cuda")
        if not (_same(lab1, outs8["cuda"]["label1"][b])
                and _same(conv1, outs8["cuda"]["converged1"][b])):
            raise AssertionError(f"batched CCL differs from frame {b} alone")
    torch.cuda.synchronize()
    print(f"[7 batched kernels] batch {BATCH} of different frames ({bscenes[0][2].shape[0]}x"
          f"{bscenes[0][2].shape[1]}, segmentation {sh}x{sw}): threshold, row and column "
          f"scans bit-exact vs their batched twins and vs each frame alone (scene, and random "
          f"frames that differ, threshold at ts={list(thr_ops.TILE_SIZES)}); two-phase CCL of "
          f"the batch equal to the twins'; max abs err {errs}", flush=True)

    # --- 8. batched main path -----------------------------------------------
    cam_dev = cam.to(dev)
    bfn = {b: batched_detect_fn(dataclasses.replace(cfg, backend=b), cam_dev, "mono8")
           for b in ("cuda", "torch")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    thr_ops.launches = ccl_ops.row_launches = ccl_ops.col_diag_launches = 0
    det8, st8 = bfn["cuda"](frames8)
    torch.cuda.synchronize()
    counts8 = {"threshold": thr_ops.launches, "row": ccl_ops.row_launches,
               "col": ccl_ops.col_diag_launches}
    peak8 = torch.cuda.max_memory_allocated()
    want1 = {"threshold": 1, "row": SCAN_ROUNDS, "col": SCAN_ROUNDS}
    if counts8 != want1:
        raise AssertionError(f"batched launch counts {counts8} != expected {want1}")
    worst8 = max(_truth_error(det8.frame(b), tg, K) for b, (_, tg, _) in enumerate(bscenes))
    _all_same(bfn["torch"](frames8), (det8, st8), "batched cuda and torch")
    gap = {k: 0.0 for k in BATCH_TOL}
    for b in range(BATCH):
        d1, s1 = det_cuda.detect_with_stats(frames8[b], "mono8")
        db, sb = det8.frame(b), st8.frame(b)
        for fld in dataclasses.fields(s1):
            if not _same(getattr(sb, fld.name), getattr(s1, fld.name)):
                raise AssertionError(f"frame {b}: batched FrameStats.{fld.name} differs")
        # Rows past the valid ones are masked lanes: don't-care.
        for fld in ("valid", "id"):
            if not _same(getattr(db, fld), getattr(d1, fld)):
                raise AssertionError(f"frame {b}: batched Detections.{fld} differs")
        if not _same(db.hamming[d1.valid], d1.hamming[d1.valid]):
            raise AssertionError(f"frame {b}: batched Detections.hamming differs")
        for fld, tol in BATCH_TOL.items():
            err = _max_abs_err(getattr(db, fld)[d1.valid], getattr(d1, fld)[d1.valid])
            gap[fld] = max(gap[fld], err)
            if err > tol:
                raise AssertionError(f"frame {b}: batched {fld} differs by {err} > {tol}")
    print(f"[8 batched main path] batch {BATCH} of different {H}x{W} frames: 6/6 ids each "
          f"(ids shifted by the frame index), worst corner error {worst8:.4f} px (limit "
          f"{CORNER_TOL_PX}); equal to Detector.detect_with_stats per frame (integer fields "
          f"exact, valid rows' float gaps {gap}, limits {BATCH_TOL}); cuda == torch on every "
          f"field; "
          f"launches {counts8} for the batch; peak device memory {peak8 / 2**30:.3f} GiB",
          flush=True)

    # --- 9. graph: 8 MP distorted -> rectify -> 2x downscale -> detect -----
    from isaac_ros_apriltag_tpu_torch import CameraModel
    from isaac_ros_apriltag_tpu_torch.utils.render import distort_image

    cam8 = CameraModel.create(fx=REF_K["fx"] * 3, fy=REF_K["fy"] * 3, cx=REF_K["cx"] * 3,
                              cy=REF_K["cy"] * 3, width=3840, height=2160, dist=REF_D)
    gscenes = [_scene(s, id_shift=s, cam=cam8, size=(2160, 3840)) for s in (0, 1)]
    distorted = [distort_image(f, cam8) for _, _, f in gscenes]
    gbatch = torch.from_numpy(np.stack([distorted[b % 2] for b in range(BATCH)])).to(dev)
    gp = {"cuda": GraphPipeline(cfg, cam8, downscale=2, encoding="mono8", device=dev),
          "torch": GraphPipeline(dataclasses.replace(cfg, backend="torch"), cam8, downscale=2,
                                 encoding="mono8", device=dev),
          "gather": GraphPipeline(cfg, cam8, downscale=2, encoding="mono8", exact_remap=True,
                                  device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    thr_ops.launches = ccl_ops.row_launches = ccl_ops.col_diag_launches = 0
    gdet, gst = gp["cuda"].batched(gbatch)
    torch.cuda.synchronize()
    counts_g = {"threshold": thr_ops.launches, "row": ccl_ops.row_launches,
                "col": ccl_ops.col_diag_launches}
    peak_g = torch.cuda.max_memory_allocated()
    if counts_g != want1:
        raise AssertionError(f"graph launch counts {counts_g} != expected {want1}")
    K_lo = gp["cuda"].detect_camera.K.cpu().numpy()
    worst_g = max(_truth_error(gdet.frame(b), gscenes[b % 2][1], K_lo) for b in range(BATCH))
    _all_same(gp["torch"].batched(gbatch), (gdet, gst), "graph cuda and torch")
    xdet, _ = gp["gather"].batched(gbatch)
    if not (_same(xdet.valid, gdet.valid) and _same(xdet.id, gdet.id)):
        raise AssertionError("graph: separable rectify and gather give other ids")
    rect_gap = _max_abs_err(xdet.corners[gdet.valid], gdet.corners[gdet.valid])
    if rect_gap > GRAPH_TOL_PX:
        raise AssertionError(f"graph: separable and gather corners differ by {rect_gap} px")
    plan = gp["cuda"]._rectify
    print(f"[9 graph] batch {BATCH} (2 different scenes) of 2160x3840 plumb_bob frames -> "
          f"separable rectify (bands {plan.dx_range} x {plan.dy_range}) -> 2x area -> detect at "
          f"1080x1920: 6/6 ids each, worst corner error {worst_g:.4f} px against the truth "
          f"projected with the detection camera (limit {CORNER_TOL_PX}); cuda == torch on every "
          f"field; separable vs gather: same ids, corners within {rect_gap:.4f} px (limit "
          f"{GRAPH_TOL_PX}); launches {counts_g} for the batch; peak device memory "
          f"{peak_g / 2**30:.3f} GiB", flush=True)

    # --- 10. times at batch 8 -------------------------------------------------
    batch_ms = {}
    for backend in ("cuda", "torch", "torch", "cuda"):
        batch_ms.setdefault(backend, []).append(_time_ms(lambda: bfn[backend](frames8), 5) / BATCH)
    graph_ms = {}
    for rectify in ("cuda", "gather", "gather", "cuda"):
        graph_ms.setdefault(rectify, []).append(
            _time_ms(lambda: gp[rectify].batched(gbatch), 3) / BATCH)
    lab8 = outs8["cuda"]["label1"]
    pairs8 = {
        "threshold": (lambda: thr_ops.adaptive_threshold(seg8, ts, md),
                      lambda: adaptive_threshold(seg8, ts, md)),
        "row": (lambda: ccl_ops.row_scan(tri8, lab8), lambda: ccl_ops.row_scan_plain(tri8, lab8)),
        "col": (lambda: ccl_ops.col_diag_scan(tri8, lab8),
                lambda: ccl_ops.col_diag_scan_plain(tri8, lab8)),
    }
    kernel_ms8 = {k: (_device_ms(a, 20), _device_ms(b, 20)) for k, (a, b) in pairs8.items()}
    bound8 = {"threshold": _bound_ms(seg8, tri8), "row": _bound_ms(tri8, lab8, lab8),
              "col": _bound_ms(tri8, lab8, lab8)}
    mean8 = {b: sum(v) / len(v) for b, v in batch_ms.items()}
    graph8 = {b: sum(v) / len(v) for b, v in graph_ms.items()}
    print(f"[10 times] on {gpu}: ms/frame at {H}x{W}, batch 1 cuda {per_frame['cuda']:.3f} "
          f"torch {per_frame['torch']:.3f}; batch {BATCH} cuda {mean8['cuda']:.3f} torch "
          f"{mean8['torch']:.3f} (runs {batch_ms}); graph batch {BATCH} separable "
          f"{graph8['cuda']:.3f} gather {graph8['gather']:.3f} (runs {graph_ms}); device ms/call at "
          f"batch {BATCH} x {sh}x{sw} "
          + ", ".join(f"{k} kernel {a:.4f} twin {b:.4f} bound {bound8[k]:.4f} "
                      f"({bound8[k] / a:.1%} of bound)" for k, (a, b) in kernel_ms8.items()),
          flush=True)

    meta = {
        "threshold": ("isaac_ros_apriltag_tpu_torch/csrc/threshold.cu",
                      "isaac_ros_apriltag_tpu/ops/pallas/threshold.py:70"),
        "row": ("isaac_ros_apriltag_tpu_torch/csrc/ccl.cu",
                "isaac_ros_apriltag_tpu/ops/pallas/ccl.py:87"),
        "col": ("isaac_ros_apriltag_tpu_torch/csrc/ccl.cu",
                "isaac_ros_apriltag_tpu/ops/pallas/ccl.py:94"),
    }
    names = {"threshold": "adaptive_threshold", "row": "ccl_row_scan",
             "col": "ccl_col_diag_scan"}
    paths = {"frame": counts, f"batch{BATCH}": counts8, f"graph{BATCH}": counts_g}
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": errs[k], "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1],
         "bound_ms": bound[k], "bound_by": "bytes", "library_ms": None,
         f"ms_batch{BATCH}": kernel_ms8[k][0], f"plain_ms_batch{BATCH}": kernel_ms8[k][1],
         f"bound_ms_batch{BATCH}": bound8[k], f"share_batch{BATCH}": bound8[k] / kernel_ms8[k][0]}
        for k in names]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
