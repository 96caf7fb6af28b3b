#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA AprilTag detector on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failed check raises and the exit code is
non-zero):
  1. device: the card's name and power limit;
  2. build: nvcc builds the CUDA kernels of isaac_ros_apriltag_tpu_torch/csrc;
  3. kernels: each kernel is bit-exact (torch.equal) against its plain
     PyTorch twin on the card, at the detector's 540x960 segmentation shape
     (threshold for every tile size; one CCL round on random input; the
     full 8 + 6 round two-phase CCL on a rendered scene);
  4. main path: Detector(backend="cuda") on three rendered 1080x1920 frames
     with six tag36h11 tags and noise 2 must find all six ids with corners
     within 1 px of ground truth, backend "torch" on the same card must
     give identical results, and TF32 must be off after the run;
  5. launch counts: the main path ran each kernel the expected number of
     times per frame;
  6. times: ms per frame for both backends and ms per call for each kernel
     and its twin, from CUDA events after a warmup.
It ends with a JSON line describing the kernels, the nvidia-smi name and
power limit, and a last JSON line {"ok": true, "device": {...}}. Without a
CUDA device it exits with code 1 and prints no result.
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


def _gpu_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _scene(seed: int):
    """bench.py's noisy 1080p scene: six tags at 2.5 m, in-plane turns."""
    from isaac_ros_apriltag_tpu_torch import CameraModel, get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

    cam = CameraModel.create(fx=900.0 * W / 1920, fy=900.0 * W / 1920,
                             cx=W / 2, cy=H / 2, width=W, height=H)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.8, -0.45), (0.0, -0.45), (0.8, -0.45),
                                (-0.8, 0.45), (0.0, 0.45), (0.8, 0.45)]):
        t = np.array([x, y, 2.5])
        tags.append(dict(family=fam, id=TAG_IDS[i], R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=TAG_SIZE))
    frame = render_tags(cam.K.numpy(), (H, W), tags, noise=2.0, seed=seed)
    return cam, tags, frame


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
    from isaac_ros_apriltag_tpu_torch.utils.render import project_corners

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
    print(f"[2 build] kernels {built}; load took {time.perf_counter() - t0:.1f} s", flush=True)

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
    for ts in thr_ops.TILE_SIZES:
        g = rng.uniform(0, 255, (rh, rw)).astype(np.float32)
        g[10:40, 20:90] = 100.0          # a flat low-contrast patch
        g = torch.from_numpy(g).to(dev)
        check("threshold", thr_ops.adaptive_threshold(g, ts, 5), adaptive_threshold(g, ts, 5),
              f"threshold random {rh}x{rw} ts={ts}")
    rtri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=(sh, sw),
                                       p=[0.4, 0.2, 0.4])).to(dev)
    rlab = torch.from_numpy(rng.permutation(sh * sw).astype(np.int32).reshape(sh, sw)).to(dev)
    check("row", ccl_ops.row_scan(rtri, rlab), ccl_ops.row_scan_plain(rtri, rlab),
          "row scan, one round, random input")
    check("col", ccl_ops.col_diag_scan(rtri, rlab), ccl_ops.col_diag_scan_plain(rtri, rlab),
          "diagonal hop + column scan, one round, random input")

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
    print(f"[3 kernels] bit-exact vs twins: threshold at {sh}x{sw} (scene ts=4) and "
          f"{rh}x{rw} (random, ts={list(thr_ops.TILE_SIZES)}), row and column scans (one round, random), "
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
    worst = 0.0
    K = cam.K.numpy()
    for (det, stats), (_, tg, _) in zip(results, scenes):
        rows = {r["id"]: r for r in det.to_list()}
        if sorted(rows) != sorted(TAG_IDS):
            raise AssertionError(f"ids {sorted(rows)} != {sorted(TAG_IDS)}")
        for tag in tg:
            gt = project_corners(K, tag["R"], tag["t"], TAG_SIZE)
            err = float(np.linalg.norm(np.asarray(rows[tag["id"]]["corners"]) - gt, axis=-1).max())
            worst = max(worst, err)
        for name, v in [("corners", det.corners), ("translation", det.translation),
                        ("quaternion", det.quaternion)]:
            if not bool(torch.isfinite(v[det.valid]).all()):
                raise AssertionError(f"non-finite {name} on a valid detection")
    if worst > CORNER_TOL_PX:
        raise AssertionError(f"corner error {worst:.3f} px > {CORNER_TOL_PX} px")
    for (dc, sc), f in zip(results, frames):
        dt, st = det_torch.detect_with_stats(f, "mono8")
        for fld in dataclasses.fields(dc):
            if not _same(getattr(dc, fld.name), getattr(dt, fld.name)):
                raise AssertionError(f"backends differ in Detections.{fld.name}")
        for fld in dataclasses.fields(sc):
            if not _same(getattr(sc, fld.name), getattr(st, fld.name)):
                raise AssertionError(f"backends differ in FrameStats.{fld.name}")
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
    kernel_ms = {k: (_time_ms(a, 50), _time_ms(b, 50)) for k, (a, b) in pairs.items()}
    per_frame = {b: sum(v) / len(v) for b, v in frame_ms.items()}
    print(f"[6 times] on {gpu}: ms/frame at {H}x{W} cuda {per_frame['cuda']:.3f} "
          f"torch {per_frame['torch']:.3f} (runs {frame_ms}); ms/call at {sh}x{sw} "
          + ", ".join(f"{k} kernel {a:.4f} twin {b:.4f}" for k, (a, b) in kernel_ms.items()),
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
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": counts[k], "max_abs_err": errs[k], "ms": kernel_ms[k][0],
         "plain_ms": kernel_ms[k][1]} for k in names]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
