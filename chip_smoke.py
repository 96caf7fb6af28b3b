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
     (see scan_case; rows and columns past 4096 pixels among them), and on a
     batch whose frames differ only in their first and last rows;
  4. main path: Detector(backend="cuda"), warm (its first call eager, its
     second capturing the graph), replayed on three rendered 1080x1920
     frames with six tag36h11 tags and noise 2 must find all six ids with corners
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
     device ms per call of each kernel and its twin at batch 8;
 11. rig: RigDetector over 16 cameras at 1080x1920, each with its own K
     (fx = fy = 900 (1 + 0.02 c), its own cx and cy) and the six-tag scene
     rendered through it (noise 2, seed c): 6/6 ids per camera with corners
     within 1 px and translations within 2 cm of the truth; a shared-K rig
     (camera 0's K) off by more than 5 cm on every camera c >= 5 and equal
     to batched_detect_fn on the same frames; "cuda" equal to "torch";
     launches 1 / 14 / 14 on a replay of the rig call, equal to its eager
     first call; peak memory (of the eager call) and ms per call;
 12. streaming: StreamingRunner over 24 different host 1080p frames at depth
     1, 2 and 3 (batch 1) and as three batches of 8 at depth 1 and 2, equal
     to synchronous detection (valid, ids and FrameStats exact, corners
     within 1e-4 px); a function that sleeps on the card before it reads its
     input, at depth 3, gives every frame its own result; Detector, batched,
     rig and streaming calls under torch.cuda.set_sync_debug_mode("error")
     (no hidden host sync); ms per frame at each depth;
 13. serving: the reference's golden proof-of-life scene on both backends to
     its contract (one detection, id 0, hamming 0, center and corners
     within 2 px, translation within 0.01 m, quaternion within 0.01);
     Detector.detect_checked equal to detect_with_stats on both backends;
     `python -m isaac_ros_apriltag_tpu_torch detect` on the scene saved as
     .npy gives the same row; `... bench --hw 1080,1920 --batch 8 --iters
     20` exits 0 with 6 detections a frame;
 14. spatial: SpatialDetector on one 3840x2160 frame with two tags in 4 row
     bands (segmentation 1080x1920, bands of 272 rows): ids [1, 3], corners
     within 0.6 px of the truth, "cuda" equal to "torch", the single-device
     Detector's ids and corners within 0.1 px; the sharded trinary and labels
     equal to the single-device threshold and the single-device scan run
     the spatial path's 3 x 8 rounds (both converged; the scan's default 8
     rounds do not converge on this frame, and the count of labels short of
     convergence is printed); K1 on the halo-padded band batch and K2/K3 on
     the bands seeded with global flat indices bit-exact vs their twins;
     launches 1 / 24 / 24 a call; peak memory; ms a frame (median of 20
     calls) beside the single-device Detector's;
 15. flat flow: ccl_phase2_rounds=0 on phase 7's batch of 8 frames: 6/6 ids
     each, "cuda" equal to "torch", launches 1 / 8 / 8; ms a frame beside the
     two-phase flow's;
 16. long lines: the scan kernels on rows and columns past 4096 pixels at
     batch 3 of different frames (and each frame alone), ccl_scan on
     (2, 3, 5000) and (1, 5000, 40) equal on both backends, and device ms
     per call at LONG_TIME_SHAPE;
 17. oracle flow: ccl_flow="jumps" (8 rounds, 2 jumps every 4) on phase 7's
     batch of 8: 6/6 ids each, "cuda" equal to "torch", launches 1 / 8 / 8;
     connected_components with jumps bit-exact between backends on the
     segmentation batch and on a random batch of 3, each frame also alone;
     ms a frame beside the two-phase flow's; device ms of the jumps CCL, of
     the same rounds without jumps and of one jump step;
 18. slam: the CLI's default orbit (640x480, 16 frames, 9 tags, noise 1)
     through Detector -> TagMapper -> ba.solve(8) on the card under both
     flows: 9 tags mapped, ATE under 0.05 m, the "cuda" chain's trajectory
     within 1e-3 m of the "torch" chain's; the 12-node pose-graph loop
     closure on the card (and against the CPU); `python -m
     isaac_ros_apriltag_tpu_torch slam --ccl-flow jumps --save-map` exits
     0 and its map loads back;
 19. 10k-tag map: BA on K=16, L=10 000, O=40 000 (map_problem): rms falls
     at least 5x and ends under 0.5 px, cameras within 1e-3 m of the CPU's
     solve and of the 4-shard batched solver's, a Gauss-Newton step under
     torch.cuda.set_sync_debug_mode("error"); ms a step, launches a step
     (torch.profiler), peak memory;
 20. process groups on the card: a world of one NCCL process
     (initialize_multihost on a free loopback port, make_mesh(1, 1)):
     phase 11's rig with group= the mesh's 'cam' group identical to the rig
     without a group on both backends, launches 1 / 14 / 14 a call;
     SpatialDetector(nshards=1, group=) on phase 14's frame identical to
     SpatialDetector(nshards=1); make_distributed_solver(group= the 'map'
     group) within 1e-3 m of nshards=1 on a reduced map_problem; the warm
     mesh rig under torch.cuda.set_sync_debug_mode("error"); ms a
     camera-frame of the mesh rig beside the one-card rig's, in turns (one
     card, mesh, mesh, one card, twice; 10 calls each);
 21. captured call: the detect function replayed from CUDA graphs
     (capture.GraphedCall, the default on the card) at torch_bench.py's
     720p batch 1 and 1080p batch 8 scenes, on both backends: five calls
     on five different inputs (the first eager, with no graph; the second
     captures and replays; the rest replay), all kept, each equal bit for
     bit (NaN == NaN) to the eager call (capture=False) on its input;
     launches 1 / 14 / 14 for a replay; set-up ms (capture + first replay)
     beside a warm eager call's; the device memory the graph keeps (pool
     and static buffers) and the peaks over the replays; ms a frame of the
     eager and the captured call in turns (eager, captured, captured,
     eager, twice; 20 calls each);
 22. profiled replays (run right after phase 2, in a child process): the
     paths whose counts come from graph replays (phase 4's three frames,
     the rig, the stream at depth 2, phase 21's two calls), each warm and
     run once under torch.profiler, whose count of each kernel by name
     must equal the launch counters' and the expected counts;
 23. cluster moments: the four cluster-moment kernels (csrc/
     cluster_moments.cu) on torch_bench.py's 720p b1 and 1080p b8 inputs,
     tests/test_noise.py's max_clusters=16 scene and the 1080p b8 batch with
     a slot budget it overflows, and a 1080p frame segmented at full
     resolution: the kernel path against the plain version
     (counts, valid, dark side, centroid, scale, num_* and overflow
     bit-exact; bin tables within one f32 ulp, the cells that differ
     counted), each kernel against its plain version, two calls and a
     captured replay equal, one launch of each kernel a call; device ms of
     each kernel, its plain version and its bound, and of the stage (kernel
     path, its torch.sort, the plain version's one-hot formulation).
Every path launches K1 once, K2 and K3 once a scan round and each cluster
kernel once a call. A path counted on an eager call reads the wrappers' counters, which each
wrapper adds to where it launches its kernel; a replay adds the counts its
capture recorded (capture.GraphedCall), which phase 22 holds against the
profiler. The kernels line's `captured` path is phase 22's 720p b1 replay.
It ends with a JSON line describing the kernels (launches of every path;
times beside the least time the card could take, from the bytes each call
must move), the nvidia-smi name and power limit, and a last JSON line
{"ok": true, "device": {...}}. Without a CUDA device it exits with code 1
and prints no result.
"""

from __future__ import annotations

import contextlib
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
RIG_CAMERAS = 16
RIG_T_TOL_M = 0.02            # per-camera rig translation against the truth
RIG_SHARED_MIN_ERR_M = 0.05   # shared-K rig error on every camera c >= 5
STREAM_TOL_PX = 1e-4          # streamed corners against synchronous detection
# The reference's proof-of-life contract (test/isaac_ros_apriltag_pol_test.py).
GOLDEN_TOL = {"px": 2.0, "translation": 0.01, "quaternion": 0.01}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# Phase 14: tests/test_spatial.py's 8 MP scene, two tags at 2 m, in 4 bands.
SP_H, SP_W = 2160, 3840
SP_BANDS = 4
SP_CORNER_TOL_PX = 0.6        # the reference's own 8 MP bound
SP_ITERS = 20                 # calls per median
LONG_TIME_SHAPE = (1, 2160, 7680)   # scan kernels timed past 4096 px: an 8K frame's rows
# Phase 18: the CLI's `slam` defaults (16 frames, 9 tags, noise 1, 8 BA
# iterations, ATE bound 0.05 m; the detector flags' tag size 0.22 m).
SLAM_FRAMES, SLAM_TAGS, SLAM_NOISE, SLAM_TAG_SIZE = 16, 9, 1.0, 0.22
SLAM_BA_ITERS = 8
SLAM_ATE_M = 0.05
SLAM_BACKEND_TOL_M = 1e-3     # the card's cuda chain against its torch chain
# Phase 19: BASELINE.json's 10k-tag map on one card.
MAP_KF, MAP_LM, MAP_OBS = 16, 10_000, 40_000
MAP_ITERS = 5
MAP_TOL_M = 1e-3              # card against CPU, shard batch against single
MAP_SHARDS = 4
# Phase 20: the distributed BA on a reduced map (cameras, tags, observations).
MESH_MAP = (8, 1000, 4000)
# Phase 21: (BENCHMARK.json configuration, batch) of torch_bench.py's cells.
CAPTURE_CASES = (("tag36h11-720p-node", 1), ("tag36h11-1080p-batch", 8))
CAPTURE_CALLS = 5             # calls kept, each on its own input
CAPTURE_TURN_CALLS = 20       # calls per timed turn
# Substrings of the kernels' names in a torch.profiler trace (csrc/*.cu).
KERNEL_NAMES = {"threshold": "threshold_kernel", "row": "row_scan_kernel",
                "col": "col_diag_kernel", "edge_count": "cm_edge_count_kernel",
                "edge_pairs": "cm_edge_pairs_kernel", "segments": "cm_segments_kernel",
                "moments": "cm_moments_kernel"}
CLUSTER_KERNELS = ("edge_count", "edge_pairs", "segments", "moments")   # once a detect call
# Phase 23: tests/test_noise.py's max_clusters=16 scene (640x480, fx 420:
# two 0.28 m tags at 1.2 m, noise 3), and the slot budget that overflows a
# 1080p b8 batch's top-C clusters (E2 = 128 x 8 pairs), with a size gate
# (400 px) that leaves fewer eligible segments than slots, so the slot
# budget alone sets its frames' overflow.
NOISE_SCENE = dict(positions=((-0.4, -0.25), (0.3, 0.2)), ids=(100, 200), z=1.2,
                   tag_size=0.28, noise=3.0)
SLOT_OVERFLOW_POINTS, SLOT_OVERFLOW_MIN_PIXELS = 8, 400
CLUSTER_CASE_NAMES = tuple(f"{config} b{batch}" for config, batch in CAPTURE_CASES) + (
    "noise scene, max_clusters 16",
    f"1080p b8, max_cluster_points {SLOT_OVERFLOW_POINTS}, min_cluster_pixels "
    f"{SLOT_OVERFLOW_MIN_PIXELS}",
    "1080p b1, quad_decimate 1")
# The reference's XLA code each cluster kernel replaces (it has no Pallas
# kernel there): the pair count, the pair loop, the reverse cummin + top-C
# sort, and the one-hot per-cluster matmuls (with the cummax and second sort).
CLUSTER_REPLACES = {"edge_count": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:168",
                    "edge_pairs": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:142",
                    "segments": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:202",
                    "moments": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:273"}

# Lines past 4096 pixels: K2 keeps rows up to 4096 in shared memory and
# walks longer ones through the output row (csrc/ccl.cu).
LONG_SHAPES = ((2, 5000), (3, 8193), (5000, 33), (8193, 2))
# Scan-kernel inputs that break a chunked scan: widths and heights around
# a warp's 32 lanes, at 4096 pixels and past it, each with fills and labels
# from scan_case.
SCAN_SHAPES = ((1, 1), (31, 32), (32, 33), (33, 31), (1023, 1025), (1025, 1023),
               (33, 4096), (4096, 33)) + LONG_SHAPES
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


def scan_batch(shape, fill: str, labels: str, n: int = 3):
    """n frames of one scan case, frame b made with seed b, as (uint8
    trinary, int32 labels) of shape (n, H, W)."""
    frames = [scan_case(shape, fill, labels, seed=b) for b in range(n)]
    return tuple(np.stack([f[k] for f in frames]) for k in (0, 1))


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


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def rig_camera(c: int):
    """Camera c of phase 11's rig: fx = fy = 900 (1 + 0.02 c) and a principal
    point of its own, at 1080x1920."""
    from isaac_ros_apriltag_tpu_torch import CameraModel

    f = 900.0 * (1.0 + 0.02 * c)
    return CameraModel.create(fx=f, fy=f, cx=W / 2 + 6.0 * (c - 8), cy=H / 2 - 4.0 * (c - 8),
                              width=W, height=H)


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


def _translation_errors(det, tags) -> list[float]:
    """|t - t_true| (m) of each tag in one frame's detections; raises if a
    tag's id is missing."""
    rows = {r["id"]: r for r in det.to_list()}
    missing = sorted({t["id"] for t in tags} - set(rows))
    if missing:
        raise AssertionError(f"ids {missing} not detected")
    return [float(np.linalg.norm(np.asarray(rows[t["id"]]["translation"]) - t["t"]))
            for t in tags]


def _same_as_sync(got, want, what: str) -> float:
    """A streamed (Detections, FrameStats) against the synchronous call's:
    FrameStats, valid and ids exact, corners on valid rows within
    STREAM_TOL_PX; returns the corner gap."""
    import dataclasses

    (dg, sg), (dw, sw) = got, want
    for fld in dataclasses.fields(sw):
        if not _same(getattr(sg, fld.name), getattr(sw, fld.name)):
            raise AssertionError(f"{what}: FrameStats.{fld.name} differs")
    if not (_same(dg.valid, dw.valid) and _same(dg.id, dw.id)):
        raise AssertionError(f"{what}: valid or ids differ")
    gap = _max_abs_err(dg.corners[dw.valid], dw.corners[dw.valid]) if bool(dw.valid.any()) else 0.0
    if gap > STREAM_TOL_PX:
        raise AssertionError(f"{what}: corners differ by {gap} px > {STREAM_TOL_PX}")
    return gap


def _cli(*args: str):
    """`python -m isaac_ros_apriltag_tpu_torch *args` from the checkout;
    raises unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "isaac_ros_apriltag_tpu_torch", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {out.returncode}:\n{out.stderr[-3000:]}")
    return out


def spatial_scene():
    """Phase 14's 3840x2160 camera, tags and frame: ids 1 and 3, 0.3 m, at 2 m."""
    from isaac_ros_apriltag_tpu_torch import CameraModel, get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

    cam = CameraModel.create(fx=1800.0, fy=1800.0, cx=SP_W / 2, cy=SP_H / 2, width=SP_W,
                             height=SP_H)
    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.35, -0.1), (0.35, 0.12)]):
        t = np.array([x, y, 2.0])
        tags.append(dict(family=fam, id=2 * i + 1, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=TAG_SIZE))
    return cam, tags, render_tags(cam.K.numpy(), (SP_H, SP_W), tags)


def map_problem(n_kf: int = MAP_KF, n_lm: int = MAP_LM, n_obs: int = MAP_OBS, seed: int = 3,
                device="cuda"):
    """tests/test_slam_e2e.py::test_sparse_ba_1000_landmarks's synthetic map
    at any scale: n_kf cameras 0.1 m apart on a line, n_lm upright tags in a
    slab 2-4 m in front, n_obs observations of random (camera, tag) pairs
    with 0.3 px corner noise, states perturbed by 0.05 m. The port's
    BAProblem on `device`."""
    from isaac_ros_apriltag_tpu_torch.convert import ba_problem_from_reference
    from isaac_ros_apriltag_tpu_torch.utils.render import TAG_CORNERS

    rng = np.random.default_rng(seed)
    fx = 420.0
    K = np.array([[fx, 0, 320], [0, fx, 240], [0, 0, 1]], np.float32)
    cam_t_gt = np.stack([np.array([0.1 * k, 0.0, 0.0]) for k in range(n_kf)])
    lm_t_gt = rng.uniform([-3, -2, 2.0], [3 + 1.6, 2, 4.0], (n_lm, 3))
    lm_R_gt = np.broadcast_to(np.diag([-1.0, -1.0, 1.0]), (n_lm, 3, 3))
    obs_kf = rng.integers(0, n_kf, n_obs).astype(np.int32)
    obs_lm = rng.integers(0, n_lm, n_obs).astype(np.int32)
    corners_tag = np.concatenate([TAG_CORNERS * 0.08, np.zeros((4, 1))], -1)
    p_w = corners_tag @ np.swapaxes(lm_R_gt[obs_lm], 1, 2) + lm_t_gt[obs_lm][:, None]
    p_c = p_w - cam_t_gt[obs_kf][:, None]
    uv = np.stack([fx * p_c[..., 0] / p_c[..., 2] + 320,
                   fx * p_c[..., 1] / p_c[..., 2] + 240], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    return ba_problem_from_reference(
        cam_R=np.broadcast_to(np.eye(3), (n_kf, 3, 3)),
        cam_t=cam_t_gt + rng.normal(0, 0.05, (n_kf, 3)), lm_R=lm_R_gt,
        lm_t=lm_t_gt + rng.normal(0, 0.05, (n_lm, 3)), obs_kf=obs_kf, obs_lm=obs_lm,
        obs_uv=uv, obs_valid=np.ones(n_obs, bool), K=K, tag_size=0.16, device=device)


def loop_graph(n: int = 12, seed: int = 0):
    """tests/test_slam.py::test_posegraph_loop_closure's pose graph: n poses
    on the unit circle, each joined to the next (the last closes the loop),
    translations perturbed by 0.05 m but node 0's. Its fields as numpy, and
    the true translations."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt = [], []
    for i in range(n):
        th = 2 * np.pi * i / n
        R_gt.append(np.array([[np.cos(th), -np.sin(th), 0],
                              [np.sin(th), np.cos(th), 0], [0, 0, 1]]))
        t_gt.append(np.array([np.cos(th), np.sin(th), 0.0]))
    ei, ej, eR, et = [], [], [], []
    for i in range(n):
        j = (i + 1) % n
        ei.append(i)
        ej.append(j)
        eR.append(R_gt[i].T @ R_gt[j])
        et.append(R_gt[i].T @ (t_gt[j] - t_gt[i]))
    init_t = np.stack(t_gt) + rng.normal(0, 0.05, (n, 3))
    init_t[0] = t_gt[0]
    fields = dict(R=np.stack(R_gt).astype(np.float32), t=init_t.astype(np.float32),
                  edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
                  edge_R=np.stack(eR).astype(np.float32), edge_t=np.stack(et).astype(np.float32),
                  edge_valid=np.ones(n, bool))
    return fields, np.stack(t_gt)


def _median_ms(fn, iters: int = SP_ITERS) -> float:
    """Median ms of `iters` calls, each between two CUDA events, after a warmup."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def _want(frames: int = 1, rounds: int = SCAN_ROUNDS) -> dict:
    """The launches of `frames` detect calls (or batched calls) of `rounds`
    scan rounds each: K1 once, K2 and K3 once a round, the four cluster
    kernels once."""
    return {"threshold": frames, "row": rounds * frames, "col": rounds * frames,
            **{k: frames for k in CLUSTER_KERNELS}}


def _reset_launches() -> None:
    """Wait for the card, then set every kernel's launch count to 0."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cuda import LAUNCH_COUNTERS, set_launch_counts

    torch.cuda.synchronize()
    set_launch_counts({k: 0 for k in LAUNCH_COUNTERS})


def _launches() -> dict:
    """Wait for the card; the kernels' launch counts since _reset_launches."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cuda import launch_counts

    torch.cuda.synchronize()
    return launch_counts()


def _profiled_kernels(prof) -> dict:
    """How often each kernel ran on the card in a torch.profiler trace, by name."""
    import torch

    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(part in n for n in names) for k, part in KERNEL_NAMES.items()}


@contextlib.contextmanager
def _counted(what: str):
    """Counts the kernels' launches in the block: yields a dict that, after
    the block, holds each kernel's count (every count is set to 0 before the
    block). torch.profiler watches the block, and the count it sees of each
    kernel by name must equal its wrapper's count (a replayed graph's counts
    are added by capture.GraphedCall, not by a wrapper), else it raises.
    Used in a fresh process only (profiled_replays)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    _reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        counts.update(_launches())
    seen = _profiled_kernels(prof)
    if seen != counts:
        raise AssertionError(f"{what}: the launch counters say {counts}, torch.profiler saw "
                             f"{seen}")


def oracle_phase(cfg, cam_dev, frames8, bscenes, tri8, gpu: str, two_phase_fn) -> dict:
    """Phase 17: the single-phase CCL with pointer jumps (ccl_flow='jumps',
    the reference's 'xla' oracle) on phase 7's batch of 8 different 1080p
    frames. Returns the kernels' launches on the batched call."""
    import dataclasses

    import torch

    from isaac_ros_apriltag_tpu_torch import connected_components
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.pipeline import batched_detect_fn

    dev = frames8.device
    jcfg = dataclasses.replace(cfg, ccl_flow="jumps")
    jfn = {b: batched_detect_fn(dataclasses.replace(jcfg, backend=b), cam_dev, "mono8")
           for b in ("cuda", "torch")}
    _reset_launches()
    det, st = jfn["cuda"](frames8)
    counts = _launches()
    want = _want(rounds=cfg.ccl_rounds)
    if counts != want:
        raise AssertionError(f"jumps-flow launch counts {counts} != expected {want}")
    K = cam_dev.K.cpu().numpy()
    worst = max(_truth_error(det.frame(b), tg, K) for b, (_, tg, _) in enumerate(bscenes))
    _all_same(jfn["torch"](frames8), (det, st), "jumps flow cuda and torch")
    # connected_components with jumps: kernels against twins, batch against
    # each frame alone, at the detector's schedule and others.
    rng = np.random.default_rng(17)
    rtri3 = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=(3,) + tri8.shape[1:],
                                        p=[0.4, 0.2, 0.4])).to(dev)
    schedules = ((cfg.ccl_rounds, cfg.ccl_jumps, cfg.ccl_jump_every), (5, 2, 1), (6, 3, 2),
                 (16, 2, 4))
    conv = {}
    for what, tri in (("segmentation batch 8", tri8), ("random batch 3", rtri3)):
        for sched in schedules:
            lab, cv = connected_components(tri, *sched, backend="cuda", with_convergence=True)
            twin = connected_components(tri, *sched, backend="torch", with_convergence=True)
            if not (_same(lab, twin[0]) and _same(cv, twin[1])):
                raise AssertionError(f"connected_components {sched} on the {what}: cuda != torch")
            for b in range(tri.shape[0]):
                one = connected_components(tri[b], *sched, backend="cuda", with_convergence=True)
                if not (_same(one[0], lab[b]) and _same(one[1], cv[b])):
                    raise AssertionError(f"connected_components {sched} on the {what}: frame {b} "
                                         "differs from itself alone")
            conv[f"{what} {sched}"] = int(cv.sum())
    flow_ms = {}
    for name, fn in (("jumps", jfn["cuda"]), ("two_phase", two_phase_fn),
                     ("two_phase", two_phase_fn), ("jumps", jfn["cuda"])):
        flow_ms.setdefault(name, []).append(_time_ms(lambda: fn(frames8), 5) / BATCH)
    sched = schedules[0]
    lab8 = connected_components(tri8, *sched, backend="cuda")
    ccl_ms = {"jumps": _device_ms(lambda: connected_components(tri8, *sched, backend="cuda"), 10),
              "scan": _device_ms(lambda: ccl_ops.ccl_scan(tri8, sched[0], backend="cuda"), 10)}
    jump_ms = _device_ms(lambda: ccl_ops._jump(lab8, sched[1]), 20)
    jump_bound = sched[1] * _bound_ms(lab8, lab8, lab8)
    print(f"[17 oracle flow] ccl_flow='jumps' ({sched[0]} rounds, {sched[1]} jumps every "
          f"{sched[2]}), batch {BATCH} of different {H}x{W} frames: 6/6 ids each, worst corner "
          f"error {worst:.4f} px (limit {CORNER_TOL_PX}); cuda == torch on every field; launches "
          f"{counts} for the batch; connected_components cuda == torch and each frame alone == "
          f"its batch entry at schedules {list(schedules)} on the segmentation batch and a random "
          f"batch of 3 (converged frames {conv}); on {gpu}: ms a frame {flow_ms}; device ms at "
          f"batch {BATCH} x {tri8.shape[1]}x{tri8.shape[2]}: jumps CCL {ccl_ms['jumps']:.4f}, "
          f"the same {sched[0]} scan rounds without jumps {ccl_ms['scan']:.4f}, one torch.gather "
          f"jump step ({sched[1]} gathers) {jump_ms:.4f} (bound {jump_bound:.4f})", flush=True)
    return counts


def slam_phase(gpu: str) -> dict:
    """Phase 18: the CLI's default synthetic orbit through Detector ->
    TagMapper -> BA on the card under both CCL flows, the pose graph's loop
    closure, and `slam` as a subprocess. Returns the kernels' launches over
    the backend-'cuda' chains."""
    import tempfile

    import torch

    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig, TagMapper, ate_rmse
    from isaac_ros_apriltag_tpu_torch.cli import slam_orbit
    from isaac_ros_apriltag_tpu_torch.convert import pose_graph_from_reference
    from isaac_ros_apriltag_tpu_torch.parallel.slam import ba, posegraph

    dev = torch.device("cuda")
    cam, frames, gt = slam_orbit(SLAM_FRAMES, SLAM_TAGS, SLAM_TAG_SIZE, SLAM_NOISE)
    rounds = {"scan": SCAN_ROUNDS, "jumps": DetectorConfig().ccl_rounds}
    counts = {k: 0 for k in _want()}
    chains = {}
    for flow in ("scan", "jumps"):
        for backend in ("cuda", "torch"):
            det = Detector(DetectorConfig(tag_size=SLAM_TAG_SIZE, backend=backend, ccl_flow=flow),
                           cam, device=dev)
            mapper = TagMapper(K=cam.K.numpy(), tag_size=SLAM_TAG_SIZE, device=dev)
            _reset_launches()
            t0 = time.perf_counter()
            for f in frames:
                mapper.process_frame(det.detect(f, "mono8"))
            map_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
            if backend == "cuda":
                got = _launches()
                want = _want(len(frames), rounds[flow])
                if got != want:
                    raise AssertionError(f"slam ({flow}) launch counts {got} != expected {want}")
                counts = {k: counts[k] + got[k] for k in counts}
            p = mapper.build_problem()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solved, rms = ba.solve(p, SLAM_BA_ITERS)
            rms = rms.cpu().numpy()
            ba_ms = (time.perf_counter() - t0) * 1e3
            mapper.update_from_problem(solved)
            kf_t = np.stack(mapper.kf_t)
            ate = ate_rmse(kf_t, gt)
            if len(mapper.lm_ids) != SLAM_TAGS or not np.isfinite(rms).all() or ate >= SLAM_ATE_M:
                raise AssertionError(f"slam ({flow}, {backend}): {len(mapper.lm_ids)} tags mapped, "
                                     f"rms {rms}, ATE {ate} m (limit {SLAM_ATE_M})")
            chains[flow, backend] = dict(kf_t=kf_t, ate=ate, rms=float(rms[-1]), obs=len(mapper.obs),
                                         map_ms=map_ms, ba_ms=ba_ms)
    gaps = {}
    for flow in ("scan", "jumps"):
        gaps[flow] = float(np.abs(chains[flow, "cuda"]["kf_t"] - chains[flow, "torch"]["kf_t"]).max())
        if gaps[flow] > SLAM_BACKEND_TOL_M:
            raise AssertionError(f"slam ({flow}): the cuda chain's trajectory is {gaps[flow]} m from "
                                 f"the torch chain's (limit {SLAM_BACKEND_TOL_M})")
    fields, t_gt = loop_graph()
    g, rms_pg = posegraph.solve(pose_graph_from_reference(**fields, device=dev), iters=10)
    g_cpu, _ = posegraph.solve(pose_graph_from_reference(**fields, device="cpu"), iters=10)
    _, Ji, Jj = posegraph._linearize(g)
    pg_err = float((g.t.cpu() - torch.from_numpy(t_gt).float()).abs().max())
    pg_gap = float((g.t.cpu() - g_cpu.t).abs().max())
    if not (float(rms_pg[-1]) < 1e-3 and pg_err < 1e-2 and pg_gap < 1e-3
            and bool(torch.isfinite(Ji).all()) and bool(torch.isfinite(Jj).all())):
        raise AssertionError(f"pose graph: rms {rms_pg.tolist()}, error {pg_err} m, CPU gap "
                             f"{pg_gap} m, Jacobians finite {bool(torch.isfinite(Ji).all())}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        out = _cli("slam", "--ccl-flow", "jumps", "--save-map", path)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        loaded = TagMapper(K=np.zeros((3, 3)), tag_size=0.0, device=dev)
        loaded.load(path)
    if not (res["tags_mapped"] == SLAM_TAGS and res["ate_rmse_m"] < SLAM_ATE_M
            and len(loaded.lm_ids) == SLAM_TAGS and len(loaded.kf_t) == SLAM_FRAMES
            and loaded.tag_size == SLAM_TAG_SIZE
            and int(loaded.build_problem().obs_valid.sum()) == len(loaded.obs)):
        raise AssertionError(f"cli slam: {res}; loaded map: {len(loaded.lm_ids)} tags, "
                             f"{len(loaded.kf_t)} keyframes")
    summary = {f"{f}/{b}": {k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in c.items() if k != "kf_t"} for (f, b), c in chains.items()}
    print(f"[18 slam] CLI orbit 640x480, {SLAM_FRAMES} frames, {SLAM_TAGS} tags, noise "
          f"{SLAM_NOISE}: Detector -> TagMapper -> ba.solve({SLAM_BA_ITERS}) on the card, both "
          f"flows and backends: {SLAM_TAGS} tags mapped, ATE under {SLAM_ATE_M} m; cuda chain "
          f"within {gaps} m of the torch chain (limit {SLAM_BACKEND_TOL_M}); launches over the "
          f"cuda chains {counts}; pose-graph loop closure (12 nodes) rms {float(rms_pg[-1]):.2e}, "
          f"error {pg_err:.2e} m, {pg_gap:.2e} m from the CPU; `slam --ccl-flow jumps` exited 0: "
          f"{res}, its saved map loaded back; on {gpu}: {summary} (map_ms: ms a frame, detect and "
          f"mapper; ba_ms: the whole solve)", flush=True)
    return counts


def map_phase(gpu: str) -> None:
    """Phase 19: BA on BASELINE.json's 10k-tag map at one card's scale
    (MAP_KF keyframes, MAP_LM landmarks, MAP_OBS observations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from isaac_ros_apriltag_tpu_torch import make_distributed_solver, partition_problem
    from isaac_ros_apriltag_tpu_torch.parallel.slam import ba

    dev = torch.device("cuda")
    p = map_problem(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solved, rms = ba.solve(p, MAP_ITERS)
    rms = rms.cpu().numpy()
    solve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(rms).all() and rms[-1] < 0.5 and rms[-1] <= rms[0] / 5):
        raise AssertionError(f"10k-tag BA did not converge: rms {rms}")
    t0 = time.perf_counter()
    cpu, rms_cpu = ba.solve(map_problem(device="cpu"), MAP_ITERS)
    cpu_s = time.perf_counter() - t0
    gap_cpu = float((solved.cam_t.cpu() - cpu.cam_t).abs().max())
    if gap_cpu > MAP_TOL_M:
        raise AssertionError(f"10k-tag BA: card cameras {gap_cpu} m from the CPU's")
    parts = partition_problem(p, MAP_SHARDS)
    sharded = make_distributed_solver(MAP_ITERS, nshards=MAP_SHARDS)
    sd, rms_d = sharded(parts)
    gap_dba = float((sd.cam_t - solved.cam_t).abs().max())
    if gap_dba > MAP_TOL_M:
        raise AssertionError(f"10k-tag shard-batched BA: cameras {gap_dba} m from the single solver")
    ba.gauss_newton_step(p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba.gauss_newton_step(p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms = _median_ms(lambda: ba.gauss_newton_step(p), 10)
    dba_ms = _median_ms(lambda: sharded(parts), 3) / MAP_ITERS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba.gauss_newton_step(p)
        torch.cuda.synchronize()
    events = prof.events()
    launch_calls = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
                       for e in events)
    device_ops = sum(e.device_type == DeviceType.CUDA for e in events)
    print(f"[19 10k-tag map] K={MAP_KF}, L={MAP_LM}, O={MAP_OBS}: ba.solve({MAP_ITERS}) on the "
          f"card rms {rms.tolist()} (falls {rms[0] / rms[-1]:.1f}x, ends under 0.5 px); cameras "
          f"within {gap_cpu:.2e} m of the CPU's solve and the {MAP_SHARDS}-shard batch within "
          f"{gap_dba:.2e} m of the single solver (limit {MAP_TOL_M}); a Gauss-Newton step ran under "
          f"sync debug mode 'error' (no host sync); on {gpu}: ms a GN step {step_ms:.3f} (median "
          f"of 10), shard-batched {dba_ms:.3f} a step, first solve {solve_s * 1e3:.1f} ms wall, "
          f"the CPU's {cpu_s * 1e3:.1f} ms; a GN step makes {launch_calls} kernel launch calls and "
          f"{device_ops} device operations (torch.profiler); peak device memory of the solve "
          f"{peak / 2**30:.3f} GiB", flush=True)


def mesh_phase(gpu: str, cfg, rigs: dict, rig_cams, rig_frames, sp_cam, sp_frame) -> dict:
    """Phase 20: the port's process-group paths on the card, in a world of
    one NCCL process (NCCL takes one rank a card, and the script needs one
    card). `rigs` are phase 11's one-card rigs by backend. Returns the
    kernels' launches on the mesh rig's first call."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from isaac_ros_apriltag_tpu_torch import (RigDetector, SpatialDetector,
                                              make_distributed_solver, make_mesh,
                                              partition_problem)
    from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = make_mesh(1, 1)
        cam_group, map_group = mesh.get_group("cam"), mesh.get_group("map")
        mrigs = {b: RigDetector(rig.config, rig_cams[0], RIG_CAMERAS, cameras=rig_cams,
                                group=cam_group) for b, rig in rigs.items()}
        _reset_launches()
        got = mrigs["cuda"].detect(rig_frames)
        counts = _launches()
        want = _want()
        if counts != want:
            raise AssertionError(f"mesh rig launch counts {counts} != expected {want}")
        _all_same(got, rigs["cuda"].detect(rig_frames), "mesh rig (cuda) and the one-card rig")
        _all_same(mrigs["torch"].detect(rig_frames), rigs["torch"].detect(rig_frames),
                  "mesh rig (torch) and the one-card rig")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mrigs["cuda"].detect(rig_frames)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sds = [SpatialDetector(cfg, sp_cam, 1, group=g) for g in (cam_group, None)]
        _all_same(*(sd.detect_with_stats(sp_frame) for sd in sds),
                  "SpatialDetector(nshards=1) with and without the group")
        parts = partition_problem(map_problem(*MESH_MAP), 1)
        (pg, rms_g), (p1, rms_1) = (make_distributed_solver(MAP_ITERS, group=map_group)(parts),
                                    make_distributed_solver(MAP_ITERS, nshards=1)(parts))
        gap_ba = max(float((a - b).abs().max())
                     for a, b in ((pg.cam_t, p1.cam_t), (pg.lm_t, p1.lm_t)))
        if gap_ba > MAP_TOL_M or not bool(torch.isfinite(rms_g).all()):
            raise AssertionError(f"distributed BA over the group: {gap_ba} m from nshards=1, "
                                 f"rms {rms_g.tolist()}")
        rig_ms = {}
        for name, rig in (("one_card", rigs["cuda"]), ("mesh", mrigs["cuda"]),
                          ("mesh", mrigs["cuda"]), ("one_card", rigs["cuda"])) * 2:
            rig_ms.setdefault(name, []).append(
                _time_ms(lambda: rig.detect(rig_frames), 10) / RIG_CAMERAS)
    finally:
        dist.destroy_process_group()
    print(f"[20 process groups] a world of one NCCL process, mesh (1, 1): the {RIG_CAMERAS}-camera "
          f"per-camera-K rig over the 'cam' group identical to the one-card rig on both "
          f"backends, launches {counts} a call, no host sync in a warm call; "
          f"SpatialDetector(nshards=1) over the group identical to no group; distributed BA "
          f"(K {MESH_MAP[0]}, L {MESH_MAP[1]}, O {MESH_MAP[2]}, {MAP_ITERS} iterations) over the "
          f"'map' group within {gap_ba:.2e} m of nshards=1 (limit {MAP_TOL_M}), rms "
          f"{float(rms_g[-1]):.4f} / {float(rms_1[-1]):.4f} px; on {gpu}: ms a camera-frame "
          f"{rig_ms}", flush=True)
    return counts


def bench_inputs(config: str, batch: int, dev, calls: int = CAPTURE_CALLS):
    """torch_bench.py's scene for a BENCHMARK.json configuration: its
    DetectorConfig, its camera on `dev` and `calls` different (batch, H, W)
    uint8 inputs on `dev`, input k holding frames k .. k + batch - 1."""
    import torch

    import torch_bench
    from isaac_ros_apriltag_tpu_torch import DetectorConfig

    spec = torch_bench.load_spec()["configs"][config]
    cam = torch_bench.config_camera(spec)
    frames = np.stack([torch_bench.render_frame(cam, b, 0)[1] for b in range(batch + calls - 1)])
    x = torch.from_numpy(frames).to(dev)
    return DetectorConfig(**spec["detector"]), cam.to(dev), [x[k:k + batch] for k in range(calls)]


def cluster_inputs(cfg, images):
    """The cluster-moment stage's inputs for a (B, H, W) uint8 batch on the
    card, through the detector's front on backend 'cuda' (as detect_tail
    feeds the stage): (trinary, dense ids, comp_overflow, the stage's
    keyword arguments)."""
    from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_ops
    from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale
    from isaac_ros_apriltag_tpu_torch.ops.resolve import resolve_components, resolve_roots_rank

    gray = grayscale(images, "mono8", batched=True).contiguous()
    seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
    tri = thr_ops.adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)
    valid = tri != 127
    E, R = cfg.effective_capacities(*tri.shape[-2:])
    lab, _ = ccl_ops.ccl_scan(tri, cfg.ccl_scan_rounds, backend="cuda")
    rank_img, table, ovf = resolve_roots_rank(lab, valid, max_components=R,
                                              chain_steps=cfg.ccl_contraction_steps)
    lab, _ = ccl_ops.ccl_scan(tri, cfg.ccl_phase2_rounds, backend="cuda", label0=rank_img)
    res = resolve_components(lab, valid, min_component_pixels=cfg.min_component_pixels,
                             max_components=R, chain_steps=cfg.ccl_resolve_steps,
                             rank_table=table)
    kw = dict(max_edge_points=E, max_clusters=cfg.max_clusters,
              min_cluster_pixels=cfg.min_cluster_pixels,
              max_cluster_points=cfg.max_cluster_points)
    return tri, res.dense, res.overflow | ovf, kw


CLUSTER_EXACT = ("count", "centroid", "scale", "dark_inside", "valid", "num_clusters",
                 "num_eligible", "num_edge_points", "edge_stride", "overflow")
CLUSTER_TABLES = ("bw", "bx", "by", "bxx", "bxy", "byy")


def _within_one_ulp(a, b) -> bool:
    """Every f32 of `a` equal to `b`'s or its neighbour above or below."""
    import torch

    return a.shape == b.shape and bool(
        ((a == b) | (a == torch.nextafter(b, torch.full_like(b, np.inf)))
         | (a == torch.nextafter(b, torch.full_like(b, -np.inf)))).all())


def cluster_gap(got, want, what: str) -> tuple[int, int]:
    """Two ClusterMoments: every field of CLUSTER_EXACT bit-exact and each
    bin table cell equal or one f32 ulp away (the kernel's f64 sums and the
    plain version's f64 GEMM add in other orders), else raise. Returns
    (cells that differ, cells in all)."""
    for f in CLUSTER_EXACT:
        if not _same(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{what}: {f} differs (max abs err "
                                 f"{_max_abs_err(getattr(got, f), getattr(want, f))})")
    differ = cells = 0
    for f in CLUSTER_TABLES:
        a, b = getattr(got, f), getattr(want, f)
        if not _within_one_ulp(a, b):
            raise AssertionError(f"{what}: {f} differs by more than one f32 ulp "
                                 f"(max abs err {_max_abs_err(a, b)})")
        differ += int((a != b).sum())
        cells += a.numel()
    return differ, cells


def noise_scene():
    """(CameraModel, uint8 640x480 frame): tests/test_noise.py's overflow
    scene, NOISE_SCENE."""
    from isaac_ros_apriltag_tpu_torch import CameraModel, get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)
    fam = get_family("tag36h11")
    tags = []
    for i, ((x, y), tid) in enumerate(zip(NOISE_SCENE["positions"], NOISE_SCENE["ids"])):
        t = np.array([x, y, NOISE_SCENE["z"]])
        tags.append(dict(family=fam, id=tid, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=NOISE_SCENE["tag_size"]))
    return cam, render_tags(cam.K.numpy(), (480, 640), tags, noise=NOISE_SCENE["noise"])


def cluster_cases(dev) -> dict:
    """Phase 23's inputs, name -> (DetectorConfig, (B, H, W) uint8 frames
    on `dev`): torch_bench.py's 720p b1 and 1080p b8 inputs, the
    max_clusters=16 noise scene, the 1080p b8 batch with its slot budget
    cut to SLOT_OVERFLOW_POINTS pairs a cluster and fewer eligible segments
    than slots, and one 1080p frame
    segmented at full resolution (a size histogram past 48 KB of shared
    memory)."""
    import dataclasses

    import torch

    from isaac_ros_apriltag_tpu_torch import DetectorConfig

    bench = [bench_inputs(config, batch, dev, calls=1) for config, batch in CAPTURE_CASES]
    _, img = noise_scene()
    (cfg1, _, in1), (cfg8, _, in8) = bench
    return dict(zip(CLUSTER_CASE_NAMES, (
        (cfg1, in1[0]), (cfg8, in8[0]),
        (DetectorConfig(tag_size=NOISE_SCENE["tag_size"], max_clusters=16, max_tags=16),
         torch.from_numpy(img)[None].to(dev)),
        (dataclasses.replace(cfg8, max_cluster_points=SLOT_OVERFLOW_POINTS,
                             min_cluster_pixels=SLOT_OVERFLOW_MIN_PIXELS), in8[0]),
        (dataclasses.replace(cfg8, quad_decimate=1), in8[0][:1]))))


def check_cluster_case(name: str, cfg, images) -> dict:
    """One of phase 23's cases: the kernel path against the plain version
    (cluster_gap), one launch of each cluster kernel, two calls and a
    captured replay equal, and each kernel against its plain version on the
    same inputs (the moments kernel's tables within one f32 ulp, as
    cluster_gap). Raises on a difference; returns the stage's inputs and
    intermediates, the cells that differ (`differ` of `cells`) and the
    largest difference of each kernel from its plain version (`errs`)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    tri, dense, ovf, kw = cluster_inputs(cfg, images)
    B, H, W = tri.shape
    E = min(kw["max_edge_points"], 4 * H * W)
    E2 = min(cfg.max_clusters * cfg.max_cluster_points, E)
    skw = dict(E=E, E2=E2, max_clusters=cfg.max_clusters,
               min_cluster_pixels=cfg.min_cluster_pixels, max_perimeter=4 * (W + H))

    def stage():
        return cmk.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)

    one = {k: int(k in CLUSTER_KERNELS) for k in _want()}
    _reset_launches()
    got = stage()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"cluster moments, {name}: launches {counts} != {one}")
    differ, cells = cluster_gap(got, plain.extract_cluster_moments(
        tri, dense, comp_overflow=ovf, **kw), f"cluster moments, {name}, against the plain one")
    if not all(_same(a, b) for a, b in zip(stage(), got)):
        raise AssertionError(f"cluster moments, {name}: two calls differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stage()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = stage()
    graph.replay()
    torch.cuda.synchronize()
    if not all(_same(a, b) for a, b in zip(static, got)):
        raise AssertionError(f"cluster moments, {name}: the captured replay differs from eager")
    del graph, static
    ne = cmk.edge_count(tri, dense)
    key, pay = cmk.edge_pairs(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    seg = cmk.top_segments(key_s, ne, ovf, **skw)
    mom = cmk.slot_moments(perm, pay, seg.top_pos, seg.count, E2)
    momp = plain.slot_moments_plain(perm, pay, seg.top_pos, seg.count, E2)
    checks = {"edge_count": [(ne, plain.edge_count_plain(tri, dense))],
              "edge_pairs": list(zip((key, pay), plain.edge_pairs_plain(tri, dense, ne, E))),
              "segments": list(zip(seg, plain.top_segments_plain(key_s, ne, ovf, **skw))),
              "moments": [(getattr(mom, f), getattr(momp, f))
                          for f in ("centroid", "scale", "dark_inside")]}
    errs = {}
    for k, pairs in checks.items():
        errs[k] = max(_max_abs_err(a, b) for a, b in pairs)
        if not all(_same(a, b) for a, b in pairs):
            raise AssertionError(f"{k} kernel, {name}: differs from its plain version")
    if not _within_one_ulp(mom.table, momp.table):
        raise AssertionError(f"moments kernel, {name}: a bin table cell is more than one f32 "
                             "ulp from the plain version's")
    errs["moments"] = max(errs["moments"], _max_abs_err(mom.table, momp.table))
    return dict(tri=tri, dense=dense, ovf=ovf, kw=kw, E=E, E2=E2, skw=skw, ne=ne, key=key,
                pay=pay, key_s=key_s, perm=perm, seg=seg, mom=mom, got=got, differ=differ,
                cells=cells, errs=errs, stage=stage)


def cluster_phase(gpu: str) -> dict:
    """Phase 23: check_cluster_case on each of cluster_cases, and device
    times at torch_bench.py's two shapes. Returns kernel -> {max_abs_err,
    and for 'b1' (720p) and 'batch8' (1080p): shape, ms, plain_ms,
    bound_ms}."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    dev = torch.device("cuda")
    out = {k: {"max_abs_err": 0.0} for k in CLUSTER_KERNELS}
    lines, stage_ms = [], {}
    for name, (cfg, images) in cluster_cases(dev).items():
        c = check_cluster_case(name, cfg, images)
        for k in CLUSTER_KERNELS:
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], c["errs"][k])
        tri, dense, ne, key, pay, key_s, perm, seg, mom = (
            c[k] for k in ("tri", "dense", "ne", "key", "pay", "key_s", "perm", "seg", "mom"))
        ovf, skw, E, E2 = c["ovf"], c["skw"], c["E"], c["E2"]
        B, H, W = tri.shape
        lines.append(f"{name} ({B}x{H}x{W}, E {E}, C {cfg.max_clusters}, E2 {E2}): bin cells "
                     f"one ulp apart {c['differ']} of {c['cells']}; frames with eligible "
                     f"segments past C {int((seg.num_eligible > cfg.max_clusters).sum())} of "
                     f"{B}, with slot pairs past E2 {int((seg.count.sum(-1) > E2).sum())}, "
                     f"overflowed {int(c['got'].overflow.sum())}")
        if name == CLUSTER_CASE_NAMES[3] and not (
                bool((seg.num_eligible <= cfg.max_clusters).all())
                and bool((seg.count.sum(-1) > E2).all()) and bool(c["got"].overflow.all())):
            raise AssertionError(f"{name}: every frame must hold fewer eligible segments than "
                                 "slots and overflow its slot budget")
        if name not in CLUSTER_CASE_NAMES[:len(CAPTURE_CASES)]:
            continue
        # Times at the bench shapes; bounds from the bytes this input needs.
        nv = int((key_s[:, :E] != torch.iinfo(torch.int32).max).sum())
        resident = int(torch.clamp(seg.count.sum(-1), max=E2).sum())
        timed = {
            "edge_count": (lambda: cmk.edge_count(tri, dense),
                           lambda: plain.edge_count_plain(tri, dense),
                           _bound_ms(tri, dense, ne)),
            "edge_pairs": (lambda: cmk.edge_pairs(tri, dense, ne, E),
                           lambda: plain.edge_pairs_plain(tri, dense, ne, E),
                           _bound_ms(tri, dense, ne, key, pay)),
            # the valid prefix of the sorted keys, 4 bytes a key
            "segments": (lambda: cmk.top_segments(key_s, ne, ovf, **skw),
                         lambda: plain.top_segments_plain(key_s, ne, ovf, **skw),
                         4 * nv / HBM_BYTES_PER_S * 1e3 + _bound_ms(ne, ovf, *seg)),
            # each resident pair's permutation entry and pay, 12 bytes
            "moments": (lambda: cmk.slot_moments(perm, pay, seg.top_pos, seg.count, E2),
                        lambda: plain.slot_moments_plain(perm, pay, seg.top_pos, seg.count, E2),
                        12 * resident / HBM_BYTES_PER_S * 1e3
                        + _bound_ms(seg.top_pos, seg.count, *mom)),
        }
        tag = "b1" if B == 1 else f"batch{B}"
        for k, (kern, twin, bound) in timed.items():
            out[k][tag] = dict(shape=[B, H, W], ms=_device_ms(kern, 20),
                               plain_ms=_device_ms(twin, 5), bound_ms=bound)
        kw = c["kw"]
        stage_ms[tag] = {
            "kernels": _device_ms(c["stage"], 10),
            "sort": _device_ms(lambda: torch.sort(key, dim=-1, stable=True), 10),
            "plain": _device_ms(lambda: plain.extract_cluster_moments(
                tri, dense, comp_overflow=ovf, **kw), 5)}
    torch.cuda.synchronize()
    print(f"[23 cluster moments] the kernel path (one launch of each of "
          f"{list(CLUSTER_KERNELS)} a call) against the plain version: counts, valid, dark "
          f"side, centroid, scale, num_* and overflow bit-exact, bin tables within one f32 ulp; "
          f"each kernel against its plain version (the moments' tables within one ulp); two "
          f"calls and a captured replay equal: " + "; ".join(lines) + f"; on {gpu}: device ms "
          f"a call of the stage (kernel path, its torch.sort alone, the plain version's one-hot "
          f"GEMM formulation) {stage_ms}; a kernel (kernel / plain / bound ms) "
          + ", ".join(f"{k} {t} {v[t]['shape']}: {v[t]['ms']:.4f} / {v[t]['plain_ms']:.4f} / "
                      f"{v[t]['bound_ms']:.4f}" for k, v in out.items()
                      for t in ("b1", f"batch{BATCH}")), flush=True)
    return out


def capture_phase(gpu: str) -> dict:
    """Phase 21: the captured detect call against the eager one."""
    import dataclasses
    import itertools

    import torch

    from isaac_ros_apriltag_tpu_torch.capture import GraphedCall
    from isaac_ros_apriltag_tpu_torch.pipeline import batched_detect_fn

    dev = torch.device("cuda")
    want = _want()
    resident0 = torch.cuda.memory_reserved()
    lines = []
    for config, batch in CAPTURE_CASES:
        cfg, cam, inputs = bench_inputs(config, batch, dev)
        H_, W_ = inputs[0].shape[-2:]
        for backend in ("cuda", "torch"):
            bcfg = dataclasses.replace(cfg, backend=backend)
            eager = batched_detect_fn(bcfg, cam, "mono8", capture=False)
            eager(inputs[0])                      # the tables, allocator and cuBLAS warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager(inputs[0])
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
            fn = batched_detect_fn(bcfg, cam, "mono8")
            if not isinstance(fn, GraphedCall):
                raise AssertionError("batched_detect_fn on the card is not captured")
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            outs = [fn(inputs[0])]                # eager: nothing captured
            if fn.graphs:
                raise AssertionError(f"{config} {backend}: a first call captured a graph")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(fn(inputs[1]))            # the capture and its first replay
            torch.cuda.synchronize()
            setup_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.empty_cache()
            kept = torch.cuda.memory_reserved() - reserved0
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            outs.append(fn(inputs[2]))
            counts = _launches()
            if counts != (want if backend == "cuda" else {k: 0 for k in want}):
                raise AssertionError(f"{config} {backend}: replay launch counts {counts}")
            outs += [fn(x) for x in inputs[3:]]
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved()
            if len(fn.graphs) != 1:
                raise AssertionError(f"{len(fn.graphs)} graphs for one input shape")
            for k, (x, out) in enumerate(zip(inputs, outs)):
                _all_same(out, eager(x), f"{config} {backend}: call {k} captured and eager")
            ms = {}
            for mode in ("eager", "captured", "captured", "eager") * 2:
                f, it = (eager if mode == "eager" else fn), itertools.cycle(inputs)
                ms.setdefault(mode, []).append(
                    _median_ms(lambda: f(next(it)), CAPTURE_TURN_CALLS) / batch)
            lines.append(f"{config} ({H_}x{W_}) batch {batch} {backend}: {CAPTURE_CALLS} calls "
                         f"(eager, capture, replays) equal to eager bit for bit; launches in a "
                         f"replay {counts}; set-up "
                         f"{setup_ms:.1f} ms (capture + first replay; warm eager call "
                         f"{eager_ms:.1f} ms); graph keeps {kept / 2**30:.3f} GiB reserved; over "
                         f"the replays peak allocated {peak / 2**30:.3f} GiB, peak reserved "
                         f"{peak_reserved / 2**30:.3f} GiB; ms a frame (median of "
                         f"{CAPTURE_TURN_CALLS}) eager {ms['eager']} captured {ms['captured']}")
            del fn, eager, outs
    print(f"[21 captured call] on {gpu} (device memory reserved at the start "
          f"{resident0 / 2**30:.3f} GiB): " + "; ".join(lines), flush=True)


def profiled_replays() -> dict:
    """`chip_smoke.py --profiled-replays`, phase 22's child process: one run
    of each path whose counts come from graph replays (phase 4's Detector
    on three frames, phase 11's rig, phase 12's stream at depth 2, phase
    21's 720p b1 and 1080p b8 calls), each warm (an eager call, then the
    capture) and counted under torch.profiler (_counted). Returns the
    counts by path."""
    import torch

    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig, RigDetector, run_stream
    from isaac_ros_apriltag_tpu_torch.pipeline import batched_detect_fn

    dev = torch.device("cuda")
    cfg = DetectorConfig(tag_size=TAG_SIZE)
    frames = [torch.from_numpy(_scene(s)[2]).to(dev) for s in SEEDS]
    det = Detector(cfg, _scene(SEEDS[0])[0], device=dev)
    out = {}
    for _ in range(2):
        det.detect_with_stats(frames[0], "mono8")
    with _counted("frame") as out["frame"]:
        for f in frames:
            det.detect_with_stats(f, "mono8")
    rig_scenes = [_scene(c, cam=rig_camera(c)) for c in range(RIG_CAMERAS)]
    rig_host = [sc[2] for sc in rig_scenes]
    rig_frames = torch.from_numpy(np.stack(rig_host)).to(dev)
    rig = RigDetector(cfg, rig_scenes[0][0], RIG_CAMERAS, device=dev,
                      cameras=[sc[0] for sc in rig_scenes])
    for _ in range(2):
        rig.detect(rig_frames)
    with _counted(f"rig{RIG_CAMERAS}") as out[f"rig{RIG_CAMERAS}"]:
        rig.detect(rig_frames)
    del rig
    with _counted("stream") as out["stream"]:
        run_stream(lambda x: det.detect_with_stats(x, "mono8"), rig_host, depth=2, device=dev)
    del det
    for config, batch in CAPTURE_CASES:
        bcfg, bcam, inputs = bench_inputs(config, batch, dev, calls=3)
        fn = batched_detect_fn(bcfg, bcam, "mono8")
        fn(inputs[0]), fn(inputs[1])
        with _counted(f"captured b{batch}") as out[f"captured_b{batch}"]:
            fn(inputs[2])
        del fn
    return out


def profiled_replays_phase(gpu: str) -> dict:
    """Phase 22: profiled_replays in a child process, whose counts must be
    the expected ones. It runs right after the build, while this process
    holds almost no device memory: a profiler session late in a long
    process lost the first kernels of what it watched (a replay's K1 and
    first scan rounds, or an eager call's K1; torch 2.11, CUDA 12.8), and
    one in a fresh process did not. Returns the counts by path."""
    import torch

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--profiled-replays"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"profiled replays exited {out.returncode}: {out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    one = _want()
    want = {"frame": {k: v * len(SEEDS) for k, v in one.items()}, f"rig{RIG_CAMERAS}": one,
            "stream": {k: v * RIG_CAMERAS for k, v in one.items()},
            **{f"captured_b{b}": one for _, b in CAPTURE_CASES}}
    if got != want:
        raise AssertionError(f"profiled replays: counts {got} != expected {want}")
    torch.cuda.synchronize()
    print(f"[22 profiled replays] in a child process ({time.perf_counter() - t0:.1f} s): "
          f"torch.profiler's count of each kernel by name equals the counters' on the "
          f"replayed paths: {got}", flush=True)
    return got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--profiled-replays"]:
        print(json.dumps(profiled_replays()))
        return 0

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
    profiled = profiled_replays_phase(gpu)           # phase 22, run first: see its docstring

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
    for _ in range(2):             # the first call runs eagerly, the second captures
        det_cuda.detect_with_stats(frames[0], "mono8")
    _reset_launches()
    results = [det_cuda.detect_with_stats(f, "mono8") for f in frames]      # replays
    counts = _launches()
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
    want = _want(n)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    print(f"[5 launches] {counts} over {n} frames "
          f"(1 / {SCAN_ROUNDS} / {SCAN_ROUNDS} / 1 / 1 / 1 / 1 per frame)", flush=True)

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
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    det8, st8 = bfn["cuda"](frames8)
    counts8 = _launches()
    peak8 = torch.cuda.max_memory_allocated()
    want1 = _want()
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
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    gdet, gst = gp["cuda"].batched(gbatch)
    counts_g = _launches()
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
    # A detect object keeps its CUDA graphs' memory: drop the ones no later phase calls.
    del gp

    # --- 11. rig: 16 cameras, each with its own intrinsics -------------------
    from isaac_ros_apriltag_tpu_torch import RigDetector

    rig_scenes = [_scene(c, cam=rig_camera(c)) for c in range(RIG_CAMERAS)]
    rig_cams = [sc[0] for sc in rig_scenes]
    rig_host = np.stack([sc[2] for sc in rig_scenes])
    rig_frames = torch.from_numpy(rig_host).to(dev)
    rigs = {b: RigDetector(dataclasses.replace(cfg, backend=b), rig_cams[0], RIG_CAMERAS,
                           device=dev, cameras=rig_cams) for b in ("cuda", "torch")}
    shared_rig = RigDetector(cfg, rig_cams[0], RIG_CAMERAS, device=dev)
    torch.cuda.reset_peak_memory_stats()
    rdet, rst = rigs["cuda"].detect(rig_frames)          # eager: the call's working set
    peak_rig = torch.cuda.max_memory_allocated()
    rigs["cuda"].detect(rig_frames)                      # captures the rig's graph
    _reset_launches()
    rig_replay = rigs["cuda"].detect(rig_frames)
    counts_rig = _launches()
    if counts_rig != want1:
        raise AssertionError(f"rig launch counts {counts_rig} != expected {want1}")
    _all_same(rig_replay, (rdet, rst), "rig replay and eager call")
    worst_rig = max(_truth_error(rdet.frame(c), rig_scenes[c][1], rig_cams[c].K.numpy())
                    for c in range(RIG_CAMERAS))
    worst_t = max(max(_translation_errors(rdet.frame(c), rig_scenes[c][1]))
                  for c in range(RIG_CAMERAS))
    if worst_t > RIG_T_TOL_M:
        raise AssertionError(f"rig translation error {worst_t:.4f} m > {RIG_T_TOL_M} m")
    _all_same(rigs["torch"].detect(rig_frames), (rdet, rst), "rig cuda and torch")
    sdet, sst = shared_rig.detect(rig_frames)
    _all_same(batched_detect_fn(cfg, rig_cams[0].to(dev), "mono8")(rig_frames), (sdet, sst),
              "shared-K rig and batched_detect_fn")
    shared_least = min(min(_translation_errors(sdet.frame(c), rig_scenes[c][1]))
                       for c in range(5, RIG_CAMERAS))
    if shared_least <= RIG_SHARED_MIN_ERR_M:
        raise AssertionError(f"a shared-K rig came within {shared_least:.4f} m of the truth "
                             f"on a camera c >= 5 (must be > {RIG_SHARED_MIN_ERR_M} m)")
    rig_ms = [_time_ms(lambda: rigs["cuda"].detect(rig_frames), 5) for _ in range(2)]
    print(f"[11 rig] {RIG_CAMERAS} cameras at {H}x{W}, fx 900..{900 * (1 + 0.02 * 15):.0f}, "
          f"own principal points: 6/6 ids each, worst corner error {worst_rig:.4f} px (limit "
          f"{CORNER_TOL_PX}), worst translation error {worst_t:.4f} m (limit {RIG_T_TOL_M}); "
          f"shared-K rig equal to batched_detect_fn, its least error on cameras c >= 5 "
          f"{shared_least:.4f} m (must exceed {RIG_SHARED_MIN_ERR_M}); cuda == torch on every "
          f"field; launches {counts_rig} a rig call; peak device memory {peak_rig / 2**30:.3f} "
          f"GiB; on {gpu}: ms a rig call {rig_ms}, ms a camera-frame "
          f"{[m / RIG_CAMERAS for m in rig_ms]}", flush=True)
    del shared_rig

    # --- 12. streaming: host frames through the upload ring -------------------
    from isaac_ros_apriltag_tpu_torch import StreamingRunner, run_stream

    stream_host = [f for _, _, f in bscenes] + list(rig_host)     # 24 different frames

    def detect1(x):
        return det_cuda.detect_with_stats(x, "mono8")

    sync1 = [detect1(torch.from_numpy(f).to(dev)) for f in stream_host]
    stream_gap = 0.0
    _reset_launches()
    outs2 = run_stream(detect1, stream_host, depth=2, device=dev)      # replays
    counts_stream = _launches()
    for depth in (1, 2, 3):
        outs = outs2 if depth == 2 else run_stream(detect1, stream_host, depth=depth, device=dev)
        if len(outs) != len(stream_host):
            raise AssertionError(f"depth {depth}: {len(outs)} results for {len(stream_host)} frames")
        for k, (got, want) in enumerate(zip(outs, sync1)):
            stream_gap = max(stream_gap, _same_as_sync(got, want, f"depth {depth}, frame {k}"))
    n_str = len(stream_host)
    want_stream = _want(n_str)
    if counts_stream != want_stream:
        raise AssertionError(f"stream launch counts {counts_stream} != expected {want_stream}")
    host8 = [np.stack(stream_host[i:i + BATCH]) for i in range(0, n_str, BATCH)]
    sync8 = [bfn["cuda"](torch.from_numpy(b).to(dev)) for b in host8]
    for depth in (1, 2):
        outs = run_stream(bfn["cuda"], host8, depth=depth, device=dev)
        for i, (got, want) in enumerate(zip(outs, sync8)):
            stream_gap = max(stream_gap, _same_as_sync(got, want, f"batch {i} at depth {depth}"))

    def slow_copy(x):
        torch.cuda._sleep(int(2e9 * 0.005))      # ~5 ms at ~2 GHz before the input is read
        return x.clone()

    for k, (got, f) in enumerate(zip(run_stream(slow_copy, stream_host, depth=3, device=dev),
                                     stream_host)):
        if not torch.equal(got.cpu(), torch.from_numpy(f)):
            raise AssertionError(f"depth 3 with a slow reader: result {k} is not frame {k}")
    f_dev = torch.from_numpy(stream_host[0]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect1(f_dev)
        bfn["cuda"](frames8)
        rigs["cuda"].detect(rig_frames)
        for _ in StreamingRunner(detect1, 2, dev).run(stream_host[:3]):
            pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stream_ms = {}
    for depth in (1, 2, 3, 3, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in StreamingRunner(detect1, depth, dev).run(stream_host):
            pass
        stream_ms.setdefault(depth, []).append((time.perf_counter() - t0) * 1e3 / n_str)
    stream8_ms = {}
    for depth in (1, 2, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in StreamingRunner(bfn["cuda"], depth, dev).run(host8):
            pass
        stream8_ms.setdefault(depth, []).append((time.perf_counter() - t0) * 1e3 / n_str)
    print(f"[12 streaming] {n_str} different host {H}x{W} frames at depth 1/2/3 and as "
          f"{len(host8)} batches of {BATCH} at depth 1/2: equal to synchronous detection "
          f"(FrameStats, valid, ids exact; corner gap {stream_gap:.2e} px, limit "
          f"{STREAM_TOL_PX}); a reader that sleeps on the card at depth 3 gets every frame's own "
          f"pixels; Detector, batched, rig and streaming calls ran under sync debug mode "
          f"'error' (no host sync); launches {counts_stream} over {n_str} frames at depth 2; "
          f"on {gpu}: ms a frame, batch 1 {stream_ms}, batch {BATCH} {stream8_ms}", flush=True)

    # --- 13. serving: golden POL scene, detect_checked, the command line -----
    import tempfile

    from isaac_ros_apriltag_tpu_torch.utils.render import GOLDEN, golden_scene

    gk = GOLDEN["K"]
    gcam = CameraModel.create(fx=gk[0, 0], fy=gk[1, 1], cx=gk[0, 2], cy=gk[1, 2],
                              width=GOLDEN["size"][1], height=GOLDEN["size"][0])
    gimg = golden_scene()
    gold, gold_err = {}, {}
    for b in ("cuda", "torch"):
        gd = Detector(DetectorConfig(backend=b, tag_size=GOLDEN["tag_size"]), gcam, device=dev)
        res = gd.detect_with_stats(gimg, "mono8")
        rows = res[0].to_list()
        if len(rows) != 1 or rows[0]["id"] != GOLDEN["id"] or rows[0]["hamming"] != 0:
            raise AssertionError(f"golden ({b}): {rows}")
        r = rows[0]
        err = {"px": max(np.abs(np.asarray(r["center"]) - GOLDEN["center"]).max(),
                         np.abs(np.asarray(r["corners"]) - GOLDEN["corners"]).max()),
               "translation": np.abs(np.asarray(r["translation"]) - GOLDEN["translation"]).max(),
               "quaternion": np.abs(np.asarray(r["quaternion"])
                                    - GOLDEN["quaternion_wxyz"]).max()}
        for k, tol in GOLDEN_TOL.items():
            if not err[k] < tol:
                raise AssertionError(f"golden ({b}): {k} error {err[k]} >= {tol}")
        _all_same(gd.detect_checked(gimg, "mono8"), res, f"detect_checked ({b}, golden)")
        gold[b], gold_err[b] = r, {k: float(v) for k, v in err.items()}
    for b, det in (("cuda", det_cuda), ("torch", det_torch)):
        _all_same(det.detect_checked(frames[0], "mono8"), det.detect_with_stats(frames[0], "mono8"),
                  f"detect_checked ({b}, six tags)")
    if gold["cuda"] != gold["torch"]:
        raise AssertionError(f"golden rows differ between backends: {gold}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "golden.npy")
        np.save(path, gimg)
        out = _cli("detect", "--image", path, "--size", repr(GOLDEN["tag_size"]),
                   "--fx", repr(float(gk[0, 0])), "--fy", repr(float(gk[1, 1])),
                   "--cx", repr(float(gk[0, 2])), "--cy", repr(float(gk[1, 2])))
    cli_rows = [json.loads(line) for line in out.stdout.splitlines() if line.strip()]
    if cli_rows != [gold["cuda"]]:
        raise AssertionError(f"cli detect gave {cli_rows}, in process {gold['cuda']}")
    out = _cli("bench", "--hw", f"{H},{W}", "--batch", str(BATCH), "--iters", "20")
    bench = json.loads(out.stdout.strip().splitlines()[-1])
    if bench["detections_per_frame"] != len(TAG_IDS) or bench["backend"] != "cuda":
        raise AssertionError(f"cli bench: {bench}")
    print(f"[13 serving] golden POL scene {GOLDEN['size'][0]}x{GOLDEN['size'][1]}: one "
          f"detection, id 0, hamming 0 on both backends, errors {gold_err} (limits "
          f"{GOLDEN_TOL}), rows equal; detect_checked == detect_with_stats on both backends "
          f"(golden and six tags); `python -m isaac_ros_apriltag_tpu_torch detect` gave the same "
          f"row; `bench --hw {H},{W} --batch {BATCH} --iters 20` on {gpu}: {bench}", flush=True)
    del det_torch

    # --- 14. spatial: one 8 MP frame in row bands -----------------------------
    from isaac_ros_apriltag_tpu_torch import SpatialDetector, build_spatial_front_fn
    from isaac_ros_apriltag_tpu_torch.parallel.spatial import pad_bands

    cam_sp, sp_tags, sp_img = spatial_scene()
    sp_frame = torch.from_numpy(sp_img).to(dev)
    sds = {b: SpatialDetector(dataclasses.replace(cfg, backend=b), cam_sp, SP_BANDS, device=dev)
           for b in ("cuda", "torch")}
    sp_single = Detector(cfg, cam_sp, device=dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    det_sp, st_sp = sds["cuda"].detect_with_stats(sp_frame)
    counts_sp = _launches()
    peak_sp = torch.cuda.max_memory_allocated()
    sp_rounds = max(3, SP_BANDS - 1) * cfg.ccl_rounds
    want_sp = _want(rounds=sp_rounds)
    if counts_sp != want_sp:
        raise AssertionError(f"spatial launch counts {counts_sp} != expected {want_sp}")
    worst_sp = _truth_error(det_sp, sp_tags, cam_sp.K.numpy())
    if worst_sp >= SP_CORNER_TOL_PX:
        raise AssertionError(f"spatial corner error {worst_sp:.3f} px >= {SP_CORNER_TOL_PX} px")
    _all_same(sds["torch"].detect_with_stats(sp_frame), (det_sp, st_sp), "spatial cuda and torch")
    d1 = sp_single.detect(sp_frame, "mono8")
    if not (_same(d1.valid, det_sp.valid) and _same(d1.id, det_sp.id)):
        raise AssertionError("spatial and single-device detections differ in ids")
    sp_gap = _max_abs_err(d1.corners[d1.valid], det_sp.corners[d1.valid])
    if sp_gap > 0.1:
        raise AssertionError(f"spatial corners {sp_gap} px from the single-device Detector's")
    # The front against the single-device front: the single-device scan, run
    # as many rounds as the spatial path's (its default 8 leave this frame
    # unconverged), converges to each component's global min flat index, and
    # so must the bands with their cut merges.
    tri_sp, lab_sp = build_spatial_front_fn(cfg, cam_sp, SP_BANDS)(sp_frame)
    tri_spt, lab_spt = build_spatial_front_fn(dataclasses.replace(cfg, backend="torch"), cam_sp,
                                              SP_BANDS)(sp_frame)
    seg_sp = _pad_to_tiles(_decimate(grayscale(sp_frame, "mono8"), cfg.quad_decimate),
                           ts).contiguous()
    tri_1 = thr_ops.adaptive_threshold(seg_sp, ts, md)
    lab_1, conv_1 = ccl_ops.ccl_scan(tri_1, sp_rounds, backend="cuda")
    if not bool(conv_1):
        raise AssertionError(f"the single-device scan did not converge in {sp_rounds} rounds")
    lab_8, conv_8 = ccl_ops.ccl_scan(tri_1, cfg.ccl_scan_rounds, backend="cuda")
    unconverged_8 = int((lab_8 != lab_1).sum())
    for what, a, b in (("trinary", tri_sp, tri_1), ("labels", lab_sp, lab_1),
                       ("torch trinary", tri_spt, tri_sp), ("torch labels", lab_spt, lab_sp)):
        if not _same(a, b):
            raise AssertionError(f"spatial front: {what} differ from the single-device front")
    # K1 on the halo-padded band batch, K2 and K3 on the bands seeded with
    # global flat indices and on the final labels, against their twins.
    Hp0, Wsp = seg_sp.shape
    Hp = -(-Hp0 // (SP_BANDS * ts)) * SP_BANDS * ts
    Hb = Hp // SP_BANDS
    seg_bands = torch.cat([seg_sp, seg_sp[-1:].expand(Hp - Hp0, Wsp)]).reshape(SP_BANDS, Hb, Wsp)
    padded = pad_bands(seg_bands, 2 * ts)
    check("threshold", thr_ops.adaptive_threshold(padded, ts, md),
          adaptive_threshold(padded, ts, md), f"threshold on the band batch {tuple(padded.shape)}")
    tri_bands = torch.cat([tri_sp, torch.full((Hp - Hp0, Wsp), 127, dtype=torch.uint8,
                                              device=dev)]).reshape(SP_BANDS, Hb, Wsp)
    lab_global = torch.arange(Hp * Wsp, dtype=torch.int32, device=dev).reshape(SP_BANDS, Hb, Wsp)
    lab_final = lab_global.clone().reshape(Hp, Wsp)
    lab_final[:Hp0] = lab_sp
    lab_final = lab_final.reshape(SP_BANDS, Hb, Wsp)
    for lab_in, what in ((lab_global, "global flat indices"), (lab_final, "final labels")):
        check("row", ccl_ops.row_scan(tri_bands, lab_in), ccl_ops.row_scan_plain(tri_bands, lab_in),
              f"row scan on the bands, {what}")
        check("col", ccl_ops.col_diag_scan(tri_bands, lab_in),
              ccl_ops.col_diag_scan_plain(tri_bands, lab_in), f"column scan on the bands, {what}")
    sp_ms = {}
    for name, fn in (("spatial", lambda: sds["cuda"].detect_with_stats(sp_frame)),
                     ("single", lambda: sp_single.detect_with_stats(sp_frame, "mono8")),
                     ("single", lambda: sp_single.detect_with_stats(sp_frame, "mono8")),
                     ("spatial", lambda: sds["cuda"].detect_with_stats(sp_frame)),
                     ("spatial_torch", lambda: sds["torch"].detect_with_stats(sp_frame))):
        sp_ms.setdefault(name, []).append(_median_ms(fn))
    pairs_sp = {
        "threshold": (padded, lambda: thr_ops.adaptive_threshold(padded, ts, md),
                      lambda: adaptive_threshold(padded, ts, md)),
        "row": (tri_bands, lambda: ccl_ops.row_scan(tri_bands, lab_global),
                lambda: ccl_ops.row_scan_plain(tri_bands, lab_global)),
        "col": (tri_bands, lambda: ccl_ops.col_diag_scan(tri_bands, lab_global),
                lambda: ccl_ops.col_diag_scan_plain(tri_bands, lab_global)),
    }
    kernel_ms_sp = {k: (_device_ms(a, 20), _device_ms(b, 20)) for k, (_, a, b) in pairs_sp.items()}
    bound_sp = {"threshold": _bound_ms(padded, padded.to(torch.uint8)),
                "row": _bound_ms(tri_bands, lab_global, lab_global),
                "col": _bound_ms(tri_bands, lab_global, lab_global)}
    shape_sp = {k: list(v[0].shape) for k, v in pairs_sp.items()}
    print(f"[14 spatial] one {SP_H}x{SP_W} frame (segmentation {Hp0}x{Wsp}) in {SP_BANDS} bands "
          f"of {Hb} rows: ids [1, 3], worst corner error {worst_sp:.4f} px (limit "
          f"{SP_CORNER_TOL_PX}); cuda == torch on every field; single-device Detector: same "
          f"ids, corners within {sp_gap:.2e} px; trinary and labels equal to the single-device "
          f"threshold and {sp_rounds}-round scan (converged; at {cfg.ccl_scan_rounds} rounds "
          f"converged={bool(conv_8)}, {unconverged_8} labels short of it), on both backends; K1 on "
          f"{shape_sp['threshold']} and K2/K3 on {shape_sp['row']} (global flat-index seeds and "
          f"final labels) bit-exact vs twins; launches {counts_sp} a call; peak device memory "
          f"{peak_sp / 2**30:.3f} GiB; on {gpu}: ms a frame (median of {SP_ITERS}) {sp_ms}; device "
          f"ms/call at the band shapes "
          + ", ".join(f"{k} kernel {a:.4f} twin {b:.4f} bound {bound_sp[k]:.4f}"
                      for k, (a, b) in kernel_ms_sp.items()), flush=True)
    del sp_single

    # --- 15. the flat-label flow: ccl_phase2_rounds=0 at batch 8 ---------------
    flat_cfg = dataclasses.replace(cfg, ccl_phase2_rounds=0)
    ffn = {b: batched_detect_fn(dataclasses.replace(flat_cfg, backend=b), cam_dev, "mono8")
           for b in ("cuda", "torch")}
    _reset_launches()
    detf, stf = ffn["cuda"](frames8)
    counts_flat = _launches()
    want_flat = _want(rounds=cfg.ccl_scan_rounds)
    if counts_flat != want_flat:
        raise AssertionError(f"flat-flow launch counts {counts_flat} != expected {want_flat}")
    worst_f = max(_truth_error(detf.frame(b), tg, K) for b, (_, tg, _) in enumerate(bscenes))
    _all_same(ffn["torch"](frames8), (detf, stf), "flat flow cuda and torch")
    flow_ms = {}
    for name, fn in (("flat", ffn["cuda"]), ("two_phase", bfn["cuda"]), ("two_phase", bfn["cuda"]),
                     ("flat", ffn["cuda"])):
        flow_ms.setdefault(name, []).append(_time_ms(lambda: fn(frames8), 5) / BATCH)
    print(f"[15 flat flow] ccl_phase2_rounds=0, batch {BATCH} of different {H}x{W} frames: 6/6 "
          f"ids each, worst corner error {worst_f:.4f} px (limit {CORNER_TOL_PX}); cuda == torch "
          f"on every field; launches {counts_flat} for the batch; on {gpu}: ms a frame {flow_ms}",
          flush=True)
    del ffn

    # --- 16. long lines: rows and columns past 4096 pixels -------------------
    for shape in LONG_SHAPES:
        for fill, labels in SCAN_FILLS:
            lt, ll = (torch.from_numpy(a).to(dev) for a in scan_batch(shape, fill, labels))
            for name, kern, twin in (("row", ccl_ops.row_scan, ccl_ops.row_scan_plain),
                                     ("col", ccl_ops.col_diag_scan, ccl_ops.col_diag_scan_plain)):
                got = kern(lt, ll)
                check(name, got, twin(lt, ll), f"{name} scan {shape} {fill} {labels}, batch 3")
                for b in range(lt.shape[0]):
                    check(name, got[b], kern(lt[b].contiguous(), ll[b].contiguous()),
                          f"{name} scan {shape} {fill} {labels}, frame {b} alone")
    for shape in ((2, 3, 5000), (1, 5000, 40)):
        lt = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                                         p=[0.3, 0.2, 0.5])).to(dev)
        a, b = (ccl_ops.ccl_scan(lt, 8, backend=bk) for bk in ("cuda", "torch"))
        if not (_same(a[0], b[0]) and _same(a[1], b[1])):
            raise AssertionError(f"ccl_scan on {shape}: cuda and torch differ")
    lt = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=LONG_TIME_SHAPE,
                                     p=[0.3, 0.2, 0.5])).to(dev)
    ll = torch.arange(lt.numel(), dtype=torch.int32, device=dev).reshape(LONG_TIME_SHAPE)
    check("row", ccl_ops.row_scan(lt, ll), ccl_ops.row_scan_plain(lt, ll), "row scan, timed shape")
    check("col", ccl_ops.col_diag_scan(lt, ll), ccl_ops.col_diag_scan_plain(lt, ll),
          "column scan, timed shape")
    kernel_ms_long = {"row": (_device_ms(lambda: ccl_ops.row_scan(lt, ll), 20),
                              _device_ms(lambda: ccl_ops.row_scan_plain(lt, ll), 5)),
                      "col": (_device_ms(lambda: ccl_ops.col_diag_scan(lt, ll), 20),
                              _device_ms(lambda: ccl_ops.col_diag_scan_plain(lt, ll), 5))}
    bound_long = _bound_ms(lt, ll, ll)
    torch.cuda.synchronize()
    print(f"[16 long lines] row and column scans bit-exact vs twins on {list(LONG_SHAPES)} at "
          f"batch 1 (phase 3) and batch 3 of different frames, also each alone, "
          f"{len(SCAN_FILLS)} fills each; ccl_scan 8 rounds cuda == torch on (2, 3, 5000) and "
          f"(1, 5000, 40); on {gpu}: device ms/call at {LONG_TIME_SHAPE} "
          + ", ".join(f"{k} kernel {a:.4f} twin {b:.4f} bound {bound_long:.4f} "
                      f"({bound_long / a:.1%} of bound)" for k, (a, b) in kernel_ms_long.items()),
          flush=True)

    # --- 17-20. the oracle flow, SLAM end to end, the 10k-tag map, process groups
    counts_oracle = oracle_phase(cfg, cam_dev, frames8, bscenes, tri8, gpu, bfn["cuda"])
    del bfn
    counts_slam = slam_phase(gpu)
    map_phase(gpu)
    counts_mesh = mesh_phase(gpu, cfg, rigs, rig_cams, rig_frames, cam_sp, sp_frame)

    # --- 21. the captured call against the eager one ------------------------------
    del rigs
    capture_phase(gpu)

    # --- 23. the cluster-moment kernels against their plain versions ---------------
    cluster = cluster_phase(gpu)

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
    paths = {"frame": counts, f"batch{BATCH}": counts8, f"graph{BATCH}": counts_g,
             f"rig{RIG_CAMERAS}": counts_rig, "stream": counts_stream, "spatial": counts_sp,
             "flat": counts_flat, "oracle": counts_oracle, "slam": counts_slam,
             "rig_mesh": counts_mesh, "captured": profiled["captured_b1"]}
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": errs[k], "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1],
         "bound_ms": bound[k], "bound_by": "bytes", "library_ms": None,
         f"ms_batch{BATCH}": kernel_ms8[k][0], f"plain_ms_batch{BATCH}": kernel_ms8[k][1],
         f"bound_ms_batch{BATCH}": bound8[k], f"share_batch{BATCH}": bound8[k] / kernel_ms8[k][0],
         "shape_spatial": shape_sp[k], "ms_spatial": kernel_ms_sp[k][0],
         "plain_ms_spatial": kernel_ms_sp[k][1], "bound_ms_spatial": bound_sp[k],
         "ms_long": kernel_ms_long[k][0] if k in kernel_ms_long else None,
         "plain_ms_long": kernel_ms_long[k][1] if k in kernel_ms_long else None,
         "bound_ms_long": bound_long if k in kernel_ms_long else None}
        for k in names] + [
        {"name": f"cluster_{k}", "route": "cuda",
         "source": "isaac_ros_apriltag_tpu_torch/csrc/cluster_moments.cu",
         "replaces": CLUSTER_REPLACES[k],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": cluster[k]["max_abs_err"], "shape": cluster[k]["b1"]["shape"],
         "ms": cluster[k]["b1"]["ms"], "plain_ms": cluster[k]["b1"]["plain_ms"],
         "bound_ms": cluster[k]["b1"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
         f"shape_batch{BATCH}": cluster[k][f"batch{BATCH}"]["shape"],
         f"ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["ms"],
         f"plain_ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["plain_ms"],
         f"bound_ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["bound_ms"],
         f"share_batch{BATCH}": (cluster[k][f"batch{BATCH}"]["bound_ms"]
                                 / cluster[k][f"batch{BATCH}"]["ms"])}
        for k in CLUSTER_KERNELS]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
