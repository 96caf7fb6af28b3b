#!/usr/bin/env python3
"""Where the time of one frame goes, for the PyTorch + CUDA detector on one
NVIDIA GPU, on chip_smoke.py's 1080x1920 six-tag scene (seed 0).

    python3 torch_stage_profile.py [--frames 10] [--out stage_profile.json]

Two measurements, each for backend "cuda" (the hand-written kernels) and
"torch" (their plain twins):
  1. stages: CUDA events between the detector's stages, called one by one in
     the order build_detect_fn calls them, mean ms over --frames frames after
     a warmup (the host synchronises after each frame, not between stages);
  2. device: torch.profiler over 5 frames of Detector.detect_with_stats:
     device busy ms per frame (sum of kernel durations; one stream), wall ms
     per frame with and without the profiler, the idle share against both
     walls, kernels per frame, and the 15 kernels with the most device time.
Prints one JSON object; --out also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

STAGES = ("grayscale + decimate", "threshold", "ccl phase 1", "contraction",
          "ccl phase 2", "resolve_components", "cluster_moments", "quadfit .. pose")


def _stage_ms(cfg, cam, image, frames: int) -> dict:
    import numpy as np
    import torch

    from isaac_ros_apriltag_tpu_torch import detector as D
    from isaac_ros_apriltag_tpu_torch.models.families import get_family
    from isaac_ros_apriltag_tpu_torch.ops.cluster_moments import extract_cluster_moments
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_kernel
    from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
    from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank
    from isaac_ros_apriltag_tpu_torch.ops.threshold import adaptive_threshold

    family = get_family(cfg.tag_family)
    threshold = thr_kernel.adaptive_threshold if cfg.backend == "cuda" else adaptive_threshold

    def frame(ev):
        ev[0].record()
        gray = grayscale(image, "mono8").contiguous()
        seg = D._pad_to_tiles(D._decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
        ev[1].record()
        tri = threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
        valid = tri != 127
        ev[2].record()
        E, R = cfg.effective_capacities(*tri.shape)
        lab, _ = ccl_ops.ccl_scan(tri, cfg.ccl_scan_rounds, backend=cfg.backend)
        ev[3].record()
        rank_img, table, ovf = resolve_roots_rank(lab, valid, max_components=R,
                                                  chain_steps=cfg.ccl_contraction_steps)
        ev[4].record()
        lab, conv = ccl_ops.ccl_scan(tri, cfg.ccl_phase2_rounds, backend=cfg.backend,
                                     label0=rank_img)
        ev[5].record()
        res = resolve_components(lab, valid, min_component_pixels=cfg.min_component_pixels,
                                 max_components=R, chain_steps=cfg.ccl_resolve_steps,
                                 rank_table=table)
        ev[6].record()
        cl = extract_cluster_moments(tri, res.dense, comp_overflow=res.overflow | ovf,
                                     max_edge_points=E, max_clusters=cfg.max_clusters,
                                     min_cluster_pixels=cfg.min_cluster_pixels,
                                     max_cluster_points=cfg.max_cluster_points)
        ev[7].record()
        D._detect_from_clusters(cfg, cam, family, gray, cl, conv & res.converged)
        ev[8].record()

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]

    for _ in range(3):
        frame(events())
    torch.cuda.synchronize()
    acc = np.zeros(len(STAGES))
    for _ in range(frames):
        ev = events()
        frame(ev)
        torch.cuda.synchronize()
        acc += [ev[i].elapsed_time(ev[i + 1]) for i in range(len(STAGES))]
    ms = acc / frames
    return dict(zip(STAGES, ms.tolist()), sum=float(ms.sum()))


def _device_ms(det, image, frames: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        det.detect_with_stats(image, "mono8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        det.detect_with_stats(image, "mono8")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / frames * 1e3
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            det.detect_with_stats(image, "mono8")
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / n * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / n / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        a = by_name.setdefault(e.name[:80], [0.0, 0])
        a[0] += e.time_range.elapsed_us() / n / 1e3
        a[1] += 1
    top = sorted(([k, v[0], v[1] // n] for k, v in by_name.items()), key=lambda r: -r[1])[:15]
    return dict(wall_ms=wall, wall_ms_profiled=wall_prof, device_busy_ms=busy,
                idle_share=1 - busy / wall, idle_share_profiled=1 - busy / wall_prof,
                kernels_per_frame=len(kernels) // n,
                top_kernels_ms_per_frame_and_calls=top)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stage_profile: no CUDA device", file=sys.stderr)
        return 1

    import dataclasses

    from chip_smoke import TAG_SIZE, _gpu_info, _scene
    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig

    cam, _, frame = _scene(0)
    cam = cam.to("cuda")
    image = torch.from_numpy(frame).cuda()
    out = {"gpu": _gpu_info(), "stages_ms": {}, "device": {}}
    for backend in ("cuda", "torch", "torch", "cuda"):
        cfg = dataclasses.replace(DetectorConfig(tag_size=TAG_SIZE), backend=backend)
        det = Detector(cfg, cam, device="cuda")     # also turns TF32 off
        out["stages_ms"].setdefault(backend, []).append(
            _stage_ms(cfg, det.camera, image, args.frames))
        out["device"].setdefault(backend, []).append(_device_ms(det, image, args.frames))
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1))
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
