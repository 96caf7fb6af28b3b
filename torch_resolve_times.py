#!/usr/bin/env python3
"""Device time of one stage's kernels of one checkout, to compare two
trees on one card in one call.

    python3 torch_resolve_times.py [--root DIR]
        [--stage resolve|sort|edge_count|moments|segment_tiles|segment_top|quadfit|refine|
                 decode|pose|finish]

Builds the kernels of the package under DIR (default: this checkout) and
prints one JSON line: the card's nvidia-smi name and power limit, DIR, and
for each of chip_smoke.py's CAPTURE_CASES (torch_bench.py's 720p b1 and
bench b8 inputs) and each call of the stage: READINGS readings of the
call's device ms (chip_smoke.py's _device_ms) and of each device op's ms a
call by name (torch.profiler over ITERS calls: kernels and memsets). The
resolve stage's calls (the default) are those of a detect call: the
contraction on the phase-1 labels and the rank-mode final resolve on the
phase-2 labels, then the scan pass alone (ops/cuda/resolve.py::scan: its
tile sums and scan launches) on the label counts of each of the two, and
the count alone (with its memset) on each's labels. The sort's call is the cluster stage's sort of the kept
pairs (sort_pairs, its memset included), given with the kept pairs; the
edge_count call the stage's pair count (edge_count, with its zeroed
output), given with the pixels; the moments call the moments kernel on
the slots the stage's sort and segment kernels give it (slot_moments),
given with the resident pairs; the segment_top call the top kernel
(segment_top) on the tiles the stage's tiles kernel gives it, given with
the tiles and candidates; the segment_tiles calls the tiles kernel
(segment_tiles, its histogram's zeroing included) and both segment
kernels (top_segments) on the stage's sorted keys, given with the tiles
and the valid keys; the quadfit calls the quad fit's fitting
launch (quad_fit) and its search alone (quad_search) on the prefix tables
of the cluster stage's moments, given with the clusters; the refine call
the top-2T pick and edge refinement in one launch (select_and_refine) on
the quads a detect call gives it, given with the picked quads and the
profile's samples; the decode
call the decode kernel (decode_quads) on the refined candidates a detect
call gives it, given with the quads; the pose call the pose kernel
(estimate_poses) on the top-T tags' corners a detect call gives it,
given with the tags; the finish calls the dedupe and top-T
kernel (finish_detections) on the decoded candidates a detect call gives
it, given with the candidates and the valid ones among them, and, where
the detect path poses in the finish's launch, that launch
(finish_and_pose) on the same candidates. Compare
a parent and a change in turns: parent, change, change, parent. Without a
CUDA device it exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ITERS = 50
READINGS = 3


def op_ms(fn, iters: int) -> dict:
    """{device op name: ms a call} of `iters` calls of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ").strip()[:80]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--stage", default="resolve",
                        choices=("resolve", "sort", "edge_count", "moments", "segment_tiles",
                                 "segment_top", "quadfit", "refine", "decode", "pose", "finish"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_resolve_times: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain_quadfit
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as dk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import refine as fk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk
    from isaac_ros_apriltag_tpu_torch.ops.refine import profile

    # Imported after the package under --root, which chip_smoke's own path
    # entry must not shadow.
    from chip_smoke import (CAPTURE_CASES, _device_ms, _gpu_info, bench_inputs, cluster_inputs,
                            detect_glue_inputs, detect_tail_inputs, front_trinary, labels_of)

    _lib.library()
    dev = torch.device("cuda")
    out = {"gpu": _gpu_info(), "root": root, "stage": args.stage}
    for config, batch in CAPTURE_CASES:
        cfg, cam, inputs = bench_inputs(config, batch, dev, calls=1)
        if args.stage == "quadfit":
            tri, dense, ovf, kw = cluster_inputs(cfg, inputs[0])
            m = cmk.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)
            S = plain_quadfit.prefix_tables(m)
            min_area = 64.0 / cfg.quad_decimate ** 2
            size = {"clusters": S.shape[0]}
            calls = {"quad_fit": lambda: qk.quad_fit(S, m, min_area=min_area),
                     "quad_search": lambda: qk.quad_search(S)}
        elif args.stage == "refine":
            sargs, skw = detect_glue_inputs(cfg, cam, inputs[0])["select_refine"]
            size = {"quads": sargs[0].shape[0] * skw["k"],
                    "samples": profile(skw["search_range"])[1]}
            calls = {"select_refine": lambda: fk.select_and_refine(*sargs, **skw)}
        elif args.stage == "decode":
            gray, corners, family, kw = detect_tail_inputs(cfg, cam, inputs[0])["decode"]
            size = {"quads": corners.numel() // 8}
            calls = {"decode": lambda: dk.decode_quads(gray, corners, family, **kw)}
        elif args.stage == "pose":
            pc, K, tag_size = detect_tail_inputs(cfg, cam, inputs[0])["pose"]
            size = {"tags": pc.numel() // 8}
            calls = {"pose": lambda: pk.estimate_poses(pc, K, tag_size)}
        elif args.stage == "finish":
            glue = detect_glue_inputs(cfg, cam, inputs[0])
            fargs, fkw = glue["tail_finish"]
            dec, pre_valid = fargs[0], fargs[1]
            ok = pre_valid & dec.valid & (dec.margin >= fkw["min_decision_margin"])
            size = {"candidates": pre_valid.numel(), "valid": int(ok.sum())}
            calls = {"finish": lambda: tk.finish_detections(*fargs, **fkw)}
            if "finish_pose" in glue:
                calls["finish_pose"] = lambda: tk.finish_and_pose(*glue["finish_pose"][0],
                                                                  **glue["finish_pose"][1])
        elif args.stage in ("sort", "edge_count", "moments", "segment_tiles", "segment_top"):
            tri, dense, ovf, kw = cluster_inputs(cfg, inputs[0])
            B, H, W = tri.shape
            E = min(kw["max_edge_points"], 4 * H * W)
            ne = cmk.edge_count(tri, dense)
            rows, kept = cmk.sort_pairs(tri, dense, ne, E)
            if args.stage == "sort":
                size = {"kept": int(kept.sum())}
                calls = {"sort": lambda: cmk.sort_pairs(tri, dense, ne, E)}
            elif args.stage == "segment_tiles":
                E2 = min(cfg.max_clusters * cfg.max_cluster_points, E)
                tkw = dict(E=E, min_cluster_pixels=cfg.min_cluster_pixels,
                           max_perimeter=4 * (W + H))
                tiles = cmk.segment_tiles(rows.key, ne, **tkw)
                size = {"tiles": tiles.stats.shape[-1], "valid": int(tiles.nv.sum())}
                calls = {"segment_tiles": lambda: cmk.segment_tiles(rows.key, ne, **tkw),
                         "top_segments": lambda: cmk.top_segments(
                             rows.key, ne, ovf, E2=E2, max_clusters=cfg.max_clusters, **tkw)}
            elif args.stage == "segment_top":
                E2 = min(cfg.max_clusters * cfg.max_cluster_points, E)
                tkw = dict(E=E, min_cluster_pixels=cfg.min_cluster_pixels,
                           max_perimeter=4 * (W + H))
                tiles = cmk.segment_tiles(rows.key, ne, **tkw)
                size = {"tiles": tiles.stats.shape[-1], "candidates": int(tiles.stats[:, 1].sum())}
                calls = {"segment_top": lambda: cmk.segment_top(
                    tiles, ne, ovf, E2=E2, max_clusters=cfg.max_clusters, **tkw)}
            elif args.stage == "edge_count":
                size = {"pixels": B * H * W}
                calls = {"edge_count": lambda: cmk.edge_count(tri, dense)}
            else:
                E2 = min(cfg.max_clusters * cfg.max_cluster_points, E)
                seg = cmk.top_segments(rows.key, ne, ovf, E=E, E2=E2,
                                       max_clusters=cfg.max_clusters,
                                       min_cluster_pixels=cfg.min_cluster_pixels,
                                       max_perimeter=4 * (W + H))
                size = {"resident": int(torch.clamp(seg.count.sum(-1), max=E2).sum())}
                calls = {"moments": lambda: cmk.slot_moments(rows.pay, seg.top_pos, seg.count,
                                                             E2)}
        else:
            valid, lab1, lab2, table, R, _ = labels_of(cfg, front_trinary(cfg, inputs[0]))
            B = valid.shape[0]
            flat = [t.reshape(B, -1).contiguous() for t in (lab1, lab2, valid)]
            N = flat[0].shape[1]
            cnt1, cnt2 = rk.count(flat[0], flat[2], N), rk.count(flat[1], flat[2], R)
            size = {"R": R}
            calls = {"contraction": lambda: rk.resolve_roots_rank(
                         lab1, valid, max_components=R, chain_steps=cfg.ccl_contraction_steps),
                     "final": lambda: rk.resolve_components(
                         lab2, valid, min_component_pixels=cfg.min_component_pixels,
                         max_components=R, chain_steps=cfg.ccl_resolve_steps, rank_table=table),
                     "scan_contraction": lambda: rk.scan(cnt1, R),
                     "scan_final": lambda: rk.scan(cnt2, R),
                     "count_contraction": lambda: rk.count(flat[0], flat[2], N),
                     "count_final": lambda: rk.count(flat[1], flat[2], R)}
        out[f"{config} b{batch}"] = {
            call: {**size, "call_ms": [_device_ms(fn, ITERS) for _ in range(READINGS)],
                   "ops_ms": [op_ms(fn, ITERS) for _ in range(READINGS)]}
            for call, fn in calls.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
