#!/usr/bin/env python3
"""Where the time of the segment-tiles, segment-top, decode, pose,
resolve scan and finish kernels goes, on the inputs a detect call gives
them, by clock stamps.

    python3 torch_stamp_split.py [--out FILE]

Prints one JSON line: the card's nvidia-smi name and power limit, and for
torch_bench.py's 720p b1 and bench b8 inputs (chip_smoke.py's
CAPTURE_CASES), "segment_tiles", "segment_top", "decode", "pose",
"scan_contraction", "scan_final" and "finish": the package's own kernels,
built alone from csrc/ with -DKERNEL_STAMPS (csrc/stamps.cuh: thread 0 of
each block records %globaltimer and clock64 once a step's value is known),
called through their wrappers: device ms unstamped (the package's build)
and stamped, and each step's time in microseconds from clock64 at the
blocks' own clock rate (cycles over globaltimer across a block's life),
mean and largest over blocks (of those that stamped every step; "started"
counts those that stamped the first), and the span from the first block's
start to the last one's end. The segment-tiles steps (a block's first
warp's first tile): the keys' load; the starts and warp scans; the sizes,
the gate and the candidates' scan; the candidates' stores and histogram
atomics; the tile's fields (a tile past the valid prefix stamps its start
only). The pose steps (thread 0's
tag of a block): the corners' and K's loads; the homography; K^-1 and M;
the norms and the scale; the Newton steps; the quaternion; the stores.
The segment-top steps: the histogram's load and
pass 1 to its barrier; the crossing sizes and the reductions; T; pass 2's
layout; its rounds; the winners' rank; the output. The decode steps (a
block's first quad): H; every tap's value; the sums, thresholds,
sharpening, bits and codes; the barrier on the staged codebook; the
codebook's search; the output. The scan steps (the scan pass of the
contraction and of the rank-mode final resolve, its tile sums and scan
launches; the scan kernel's blocks, a tile of a frame each): the tile's
offset and the frame's group count; the tile's ranks and their inv and D
stores; D's fill past the group count. The finish steps (a frame's
block): the candidates' loads; the dedupe; the rank; the top-T stores;
and for the finish with the pose (finish_pose_kernel, where the detect
path runs it), the pose of the top-T tags, to the block's last (the
stamped build adds a barrier before that stamp). Without a CUDA device it
exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERS = 50
STAMP_BLOCKS, STAMP_STEPS = 8192, 8          # csrc/stamps.cuh
STEPS = {"segment_tiles": ("load", "starts_and_warp_scans", "sizes_gate_and_candidate_scan",
                           "candidates_and_atomics", "stats"),
         "pose": ("loads", "homography", "kinv_and_m", "norms_and_scale", "newton",
                  "quaternion", "stores"),
         "segment_top": ("hist_and_pass1", "crossings_and_reductions", "threshold",
                         "pass2_layout", "pass2_rounds", "rank", "output"),
         "decode": ("homography", "tap_values", "sums_bits_codes", "codebook_barrier",
                    "codebook_search", "output"),
         "scan": ("tile_offsets", "ranks", "d_fill"),
         "finish": ("loads", "dedupe", "rank", "stores"),
         "finish_pose": ("loads", "dedupe", "rank", "stores", "pose")}


def build_stamped(source: str, out_dir: str) -> ctypes.CDLL:
    """csrc/<source> alone with -DKERNEL_STAMPS, its entry points typed as
    the package's."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{source}.so")
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-DKERNEL_STAMPS", "-shared",
                    os.path.join(_lib._CSRC, source), "-o", lib], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    for name, n_ptr, n_int in _lib._ENTRY_POINTS:
        if hasattr(so, name):
            fn = getattr(so, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    so.apriltag_read_stamps.argtypes = [ctypes.c_void_p]
    so.apriltag_read_stamps.restype = ctypes.c_int
    so.apriltag_clear_stamps.argtypes = []
    so.apriltag_clear_stamps.restype = ctypes.c_int
    return so


def stamped_steps(so, call, kernel: str) -> dict:
    """Device ms of `call` through the package's library and through the
    stamped one, and its steps' times from the stamps of one stamped call
    after the timed ones, on a cleared table."""
    from unittest import mock

    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    from chip_smoke import _device_ms

    ms = {"unstamped": _device_ms(call, ITERS)}
    with mock.patch.object(_lib, "library", lambda: so):
        ms["stamped"] = _device_ms(call, ITERS)
        torch.cuda.synchronize()
        if so.apriltag_clear_stamps():
            raise RuntimeError("apriltag_clear_stamps failed")
        call()
        torch.cuda.synchronize()
        table = np.zeros((STAMP_BLOCKS, STAMP_STEPS, 2), np.int64)   # that call's stamps
        if so.apriltag_read_stamps(table.ctypes.data):
            raise RuntimeError("apriltag_read_stamps failed")
    n = len(STEPS[kernel]) + 1
    st = table[:, :n]
    live = (st[:, 0, 0] > 0) & (st[:, -1, 0] > 0)
    started = int((st[:, 0, 0] > 0).sum())      # blocks that stamped their start
    g, clk = st[live, :, 0].astype(np.float64), st[live, :, 1].astype(np.float64)
    life_ns, life_clk = g[:, -1] - g[:, 0], clk[:, -1] - clk[:, 0]
    ghz = float(np.median(life_clk / np.maximum(life_ns, 1.0)))
    parts = np.diff(clk, axis=1) / ghz / 1e3
    return dict(ms=ms, blocks=int(live.sum()), started=started, sm_ghz=ghz,
                steps_us={k: dict(mean=float(parts[:, i].mean()), max=float(parts[:, i].max()))
                          for i, k in enumerate(STEPS[kernel])},
                block_us=dict(mean=float(life_ns.mean() / 1e3), max=float(life_ns.max() / 1e3)),
                span_us=float((g[:, -1].max() - g[:, 0].min()) / 1e3))


def top_inputs(cfg, images):
    """The segment kernels' inputs in a detect call on the card: (sorted
    keys, tiles, num_edge, comp_overflow, keyword arguments of
    segment_top; segment_tiles takes E, min_cluster_pixels and
    max_perimeter of them)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    from chip_smoke import cluster_inputs

    tri, dense, ovf, kw = cluster_inputs(cfg, images)
    B, H, W = tri.shape
    E = min(kw["max_edge_points"], 4 * H * W)
    ne = cmk.edge_count(tri, dense)
    rows, _ = cmk.sort_pairs(tri, dense, ne, E)
    tkw = dict(E=E, min_cluster_pixels=cfg.min_cluster_pixels, max_perimeter=4 * (W + H))
    tiles = cmk.segment_tiles(rows.key, ne, **tkw)
    ovf = ovf.to(torch.bool).expand(B).contiguous()
    return rows.key, tiles, ne, ovf, dict(E2=min(cfg.max_clusters * cfg.max_cluster_points, E),
                                max_clusters=cfg.max_clusters, **tkw)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_stamp_split: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import CAPTURE_CASES, _gpu_info, bench_inputs

    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as dk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk

    from chip_smoke import detect_glue_inputs, detect_tail_inputs, front_trinary, labels_of

    dev = torch.device("cuda")
    out_dir = os.path.join(ROOT, "isaac_ros_apriltag_tpu_torch", "_build", "stamp_split")
    stamped = {"segment_top": build_stamped("cluster_moments.cu", out_dir),
               "decode": build_stamped("tail.cu", out_dir),
               "scan": build_stamped("resolve.cu", out_dir)}
    stamped["finish"] = stamped["decode"]
    out = {"gpu": _gpu_info()}
    for config, batch in CAPTURE_CASES:
        cfg, cam, inputs = bench_inputs(config, batch, dev, calls=1)
        keys, tiles, ne, ovf, kw = top_inputs(cfg, inputs[0])
        tkw = {k: kw[k] for k in ("E", "min_cluster_pixels", "max_perimeter")}
        pc, K, tag_size = detect_tail_inputs(cfg, cam, inputs[0])["pose"]
        gray, corners, family, dkw = detect_tail_inputs(cfg, cam, inputs[0])["decode"]
        glue = detect_glue_inputs(cfg, cam, inputs[0])
        fargs, fkw = glue["tail_finish"]
        valid, lab1, lab2, _, R, _ = labels_of(cfg, front_trinary(cfg, inputs[0]))
        B = valid.shape[0]
        lab1, lab2, valid = (t.reshape(B, -1).contiguous() for t in (lab1, lab2, valid))
        counts = {"scan_contraction": rk.count(lab1, valid, lab1.shape[1]),
                  "scan_final": rk.count(lab2, valid, R)}
        scans = {k: dict(S=cnt.shape[1], R=R, **stamped_steps(
                     stamped["scan"], lambda cnt=cnt: rk.scan(cnt, R), "scan"))
                 for k, cnt in counts.items()}
        out[f"{config} b{batch}"] = {**scans,
            "finish": dict(candidates=fargs[1].numel(), **stamped_steps(
                stamped["finish"], lambda: tk.finish_detections(*fargs, **fkw), "finish")),
            **({"finish_pose": dict(candidates=fargs[1].numel(), **stamped_steps(
                stamped["finish"], lambda: tk.finish_and_pose(*glue["finish_pose"][0],
                                                              **glue["finish_pose"][1]),
                "finish_pose"))} if "finish_pose" in glue else {}),
            "segment_tiles": dict(tiles=tiles.stats.shape[-1], **stamped_steps(
                stamped["segment_top"], lambda: cmk.segment_tiles(keys, ne, **tkw),
                "segment_tiles")),
            "pose": dict(tags=pc.numel() // 8, **stamped_steps(
                stamped["decode"], lambda: pk.estimate_poses(pc, K, tag_size), "pose")),
            "segment_top": stamped_steps(stamped["segment_top"],
                                         lambda: cmk.segment_top(tiles, ne, ovf, **kw),
                                         "segment_top"),
            "decode": dict(quads=corners.numel() // 8, **stamped_steps(
                stamped["decode"], lambda: dk.decode_quads(gray, corners, family, **dkw),
                "decode"))}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
