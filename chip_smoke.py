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
     must equal the launch counters' and the expected counts, with no
     cummax kernel among them; and the contraction and the final resolve
     alone at the same two shapes, eager, with no torch sort, scan or
     scatter/gather kernel (RESOLVE_LIBRARY_NAMES) among theirs; the count
     of every kernel in phase 21's two replays, and in the same replays
     with the quad-fit epilogue, the picks, the dedupe and refine in the
     parent's torch form; in each replay only TAIL_BETWEEN's kernels run
     between the quad fit's launch and the finish's, which poses the tags
     (the pick and refine in one launch, then decode), and the pick alone
     does not run;
 23. cluster moments: the cluster-moment kernels (csrc/cluster_moments.cu:
     the pair count, the kept pairs' sort (the histogram pass, then
     SORT_PASSES launches of the scatter kernel, the first of which builds
     the pairs from the pixels), the two
     segment kernels, the moments kernel) on torch_bench.py's 720p b1 and
     1080p b8 inputs, tests/test_noise.py's max_clusters=16 scene and the
     1080p b8 batch with a slot budget it overflows, and a 1080p frame
     segmented at full resolution: the kernel path against the plain version
     (counts, valid, dark side, centroid, scale, num_* and overflow
     bit-exact; bin tables within one f32 ulp, the cells that differ
     counted), each kernel against its plain version (the sorted rows also
     against torch.sort(stable=True) of the padded key row), two calls and a
     captured replay equal, CLUSTER_KERNELS' launches a call; the two
     segment kernels on SEGMENT_ROWS' synthetic sorted keys (segments across
     many tiles, ending on tile edges, ties split across tiles, fewer
     candidates than C, none, a zero size gate, a frame with no valid key, a
     16001-bin histogram) against top_segments_plain and each against its
     plain version, one launch each, two calls and a captured replay equal;
     the later radix passes alone on SORT_ROWS (all keys equal, keys at
     2^30 - 1, K = 0 beside a full row, K on tile boundaries of both tile
     sizes, K past E in tiles of both sizes), from the plain first pass,
     against numpy's stable argsort and each pass against its plain
     version, and the whole sort on SORT_FRAMES (an empty frame beside a
     checkerboard at stride 3, one key, the largest dense ids, K past E,
     rows of 94 pixels, one key over 48 pixel blocks), also with num_edge
     cut to a quarter (more pairs kept than num_edge), two calls and a
     captured replay equal;
     torch.profiler, in a child
     process (`chip_smoke.py --cluster-profile`), sees no library sort or
     select kernel in the stage at both bench shapes; device ms of each
     kernel, its plain version, its bound and (the scatter kernel's row)
     torch.sort of the padded row (the scatter kernel's first and later
     passes also apart), of the sort (the histogram pass and the passes
     with their memset) at both digit widths against torch.sort, its fixed
     yardstick bound and each form's own bound, and of the stage (kernel
     path, the plain version's one-hot formulation);
 24. resolve: the five resolve kernels (csrc/resolve.cu: count, tile sums,
     scan, chain, map) on the phase-1 and phase-2 labels of
     torch_bench.py's 720p b1 and 1080p b8 inputs, the 1080p b8 input at
     R = RESOLVE_SMALL_R, a speckle batch whose phase-1 groups pass R,
     synthetic flat frames for the twin's slot R - 1 and its R = 65536
     clamp, and SLOT_ROWS' frames (see slot_rows: root slots no slot maps
     to, more groups than R, R = 65536, more than _KMAX eligible
     components, long chains, labels and rank-table pixels out of range, an
     empty frame beside a full one, cycles walked past R + 1 hops), random
     labels at capacities that are not multiples of the chain kernel's
     cluster (ODD_R) (and the count and map kernels alone on COUNT_CASES:
     one label a frame, speckle, labels at S - 1 and out of range, rows
     that take their scalar path): the contraction, the rank-mode and the
     flat-mode resolve against the twin bit for bit on every field, one
     launch of each kernel a call, two calls and a captured replay equal,
     each kernel against its plain version bit for bit (the chain kernel:
     slots_plain in the contraction, final_plain, dense_plain after
     slots_plain, in a final resolve), the chain kernel's tables against
     the parent's form (parent_slots_form, parent_dense_form: pointer
     doubling and the roots' sort); device ms of each kernel (its plain
     version, its bound, one library call computing the same function where
     there is one, the parent's form for the chain kernel; the map's share
     of its bound beside its gather) and of the stage against the twin, and
     the chain kernel's clusters the card holds at once
     (cudaOccupancyMaxActiveClusters);
 25. quad fit: the search kernel (csrc/quadfit.cu) on the cluster moments
     of torch_bench.py's 720p b1 and 1080p b8 inputs, of node-720p-b1's
     frame 23 at seed 1 (the capacity edge), of a blank 1080p b8 batch (no
     valid cluster) and on synthetic clusters (tied maxima and 4-subsets,
     one to three candidates, a candidate at bin 63, an empty slot, random
     bins, an inf and a NaN; 39 clusters of exactly 4, 5 and 10 candidates,
     also turned to candidates at bins 0 and 63; one cluster alone): best,
     best_err and the six winner lines
     bit-exact with its plain version; its fitting launch (the search and
     the epilogue: corners, gates, winding, fit error) against the plain
     search and fit_epilogue on every Quads field; each one launch a call,
     two calls and a captured replay equal; device ms of the kernel, its
     plain version, its bound and the library yardstick (the parent's
     selector arc sums, one torch.bmm a table), of the fitting launch
     against its bound, and of the stage (the prefix tables and the fitting
     launch; the plain fit; the parent's form, the search kernel and the
     epilogue's torch ops; the plain fit with the selector arc sums);
 26. tail: the decode and pose kernels (csrc/tail.cu) on what a detect call
     of torch_bench.py's 720p b1 and 1080p b8 inputs gives them (the top-2T
     refined candidates, the top-T tags the finish poses) and on tail_frame's one-tag frames
     of all nine families with a blank quad, one past the frame's corner,
     one outside it, a NaN and a collinear one (also posed), without
     sharpening, at max_hamming 0, with the largest correctable bit flips,
     and a batch of three frames posed with a per-frame K: every output
     bit-exact with the plain version (ops/decode.py, ops/pose.py), one
     launch a call, two calls and a captured replay equal; device ms of
     each kernel, its plain version, its bound and the parent's torch form;
 27. tail glue: the top-2T pick and refine and the dedupe/top-T kernels
     (csrc/tail.cu: refine_kernel, the top-2T pick and refine in one
     launch; tail_finish_kernel, and finish_pose_kernel, the dedupe/top-T with the tags' pose, the
     detect path's launch, with TAIL_K, one a frame for a batch, where a
     case holds no K) on what a detect call of torch_bench.py's 720p b1 and
     1080p b8 inputs gives them and on glue_synthetic's cases (NaN and inf corners, no
     valid quad, tied scores and margins, duplicate ids at equal margins,
     max_tags < C/2, quad_decimate 1 and 3, a batch of 3), the pick and
     refine also on refine_synthetic's (search ranges 0.5 to 5 and 40:
     profiles of 7 to 165 samples, one to seven staged chunks; quads across
     the frame's edges): every output
     bit-exact with the plain version (ops/refine.py, ops/tail.py:
     select_and_refine for the pick and refine, then ops/pose.py for the
     finish with the pose), one
     launch a call, two calls and a captured replay equal, a batch equal to
     each frame alone; device ms of each kernel, its plain version, its
     bound and the parent's torch form.
Every path launches K1 once, K2 and K3 once a scan round, each resolve
kernel once a resolve call (twice in the two-phase flow), each cluster
kernel once a call but the radix scatter, once a pass (CLUSTER_KERNELS),
and the tail's kernels once a call: the quad fit's fitting launch, the
top-2T pick and refine in one launch, decode, and the dedupe and top-T
pick with the pose in one launch (a rig whose cameras have their own K:
the dedupe and top-T pick alone, and pose once a call outside its
graph). A path counted on an eager
call reads the wrappers' counters, which each wrapper adds to where it
launches its kernel; a replay adds the counts its capture recorded
(capture.GraphedCall), which phase 22 holds against the profiler. The kernels line's `captured` path is phase 22's 720p b1 replay.
It ends with a JSON line describing the kernels (launches of every path;
times beside the least time the card could take, from the bytes each call
must move), the nvidia-smi name and power limit, and a last JSON line
{"ok": true, "device": {...}}. Without a CUDA device it exits with code 1
and prints no result.
"""

from __future__ import annotations

import collections
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
# Substrings of the kernels' names in a torch.profiler trace (csrc/*.cu); a
# tuple holds alternatives: the tail kernels' names, demangled or mangled,
# without matching another kernel's (pose_kernel is a tail of transpose_kernel
# and of finish_pose_kernel).
KERNEL_NAMES = {"threshold": "threshold_kernel", "row": "row_scan_kernel",
                "col": "col_diag_kernel", "edge_count": "cm_edge_count_kernel",
                "pair_count": "cm_pair_count_kernel", "radix_scatter": "cm_radix_scatter_kernel",
                "segment_tiles": "cm_seg_tiles_kernel",
                "segment_top": "cm_seg_top_kernel", "moments": "cm_moments_kernel",
                "resolve_count": "resolve_count_kernel",
                "resolve_tiles": "resolve_tile_sums_kernel",
                "resolve_scan": "resolve_scan_kernel", "resolve_chain": "resolve_chain_kernel",
                "resolve_map": "resolve_map_kernel",
                "quadfit_search": "qf_search_kernel",
                "select_refine": ("::refine_kernel(", "13refine_kernelE"),
                "decode": ("::decode_kernel(", "13decode_kernelE"),
                "tail_finish": "tail_finish_kernel",
                "finish_pose": ("::finish_pose_kernel<", "18finish_pose_kernelI"),
                "pose": ("::pose_kernel<", "11pose_kernelI")}
SORT_PASSES = 4               # radix passes of the cluster stage's sort (ops/cluster_moments.py)
# The cluster kernels' launches a detect call: each once, the radix scatter
# once a pass (the first from the pixels, the later ones over the rows).
CLUSTER_KERNELS = {"edge_count": 1, "pair_count": 1, "radix_scatter": SORT_PASSES,
                   "segment_tiles": 1, "segment_top": 1, "moments": 1}
# Substrings of a device kernel's name that mark a library sort or select
# (torch.sort, argsort, nonzero, masked_select; CUB's device-level ones),
# none of which the cluster stage may launch on backend 'cuda'.
LIBRARY_SORT_NAMES = ("sort", "select", "nonzero", "cub::")
CUMMAX_KERNEL = "dim_with_indices"   # torch's cummax/cummin scan kernels' names hold it
# Substrings of a device kernel's name that mark torch's sort (CUB's radix
# sort), cumsum and gather/scatter kernels, none of which a resolve call may
# launch on backend 'cuda'.
RESOLVE_LIBRARY_NAMES = ("DeviceRadixSort", "scan_innermost_dim", "scatter_gather")
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
# kernel there): the pair count, the hash gate, the gated key row's stable
# sort, the reverse cummin, the top-C sort, and the one-hot per-cluster
# matmuls (with the cummax and second sort).
CLUSTER_REPLACES = {"edge_count": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:168",
                    "pair_count": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:176",
                    "radix_scatter": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:180",
                    "segment_tiles": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:202",
                    "segment_top": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:214",
                    "moments": "isaac_ros_apriltag_tpu/ops/cluster_moments.py:273"}
# Phase 23's synthetic sorted-key rows for the two segment kernels, whose
# tiles are 512 keys: name -> (each frame's segment sizes in key order, None
# for a frame with no valid key; row length N, E, E2, max_clusters,
# min_cluster_pixels, max_perimeter; the frames whose num_edge is twice the
# pair budget (stride 2), the frames with comp_overflow). Each case holds a
# segment that runs past a tile's end and is gated or ranked otherwise when
# cut there; the ties at the threshold size fall in more than one tile.
SEGMENT_ROWS = {
    "a segment across many tiles": (
        ([30] * 10 + [3000, 40, 25, 26] + [5] * 100, [20] * 5 + [5000] + [30] * 20),
        8192, 8000, 8000, 4, 24, 4000, (1,), ()),
    "segments ending on tile edges": (
        ([32] * 16 + [100, 412, 700] + [25] * 10,), 2048, 2048, 2048, 8, 24, 600, (), ()),
    "ties at T split across tiles": (
        ([30] * 60 + [50, 45],), 2048, 2048, 500, 20, 24, 600, (), ()),
    "fewer candidates than C": (
        ([10] * 20 + [40, 700] + [5] * 50 + [33],), 4096, 4096, 4096, 128, 24, 2000, (), ()),
    "no candidates": (
        ([10] * 40 + [900] + [3] * 100,), 2048, 2048, 2048, 16, 24, 800, (), ()),
    "min_cluster_pixels 0, nv < E": (
        ([7] * 100 + [600] + [1] * 50,), 4096, 4096, 4096, 16, 0, 5000, (), ()),
    "a frame with no valid key": (
        (None, [26] * 30 + [1000] + [24] * 5), 4096, 4000, 4000, 8, 24, 2000, (), (0,)),
    "a histogram of 16001 bins": (
        ([40] * 20 + [13000] + [30] * 10,), 16384, 16384, 16384, 16, 24, 16000, (), (0,)),
    # The top kernel's own edges: T in the last, partial coarse bin of 32
    # sizes (601 bins); ties straddling T inside a coarse bin, with equal
    # sizes above T at other positions; more entries (candidates of the
    # tiles that reach T) than a round of its 256 threads takes (2048);
    # more tiles than its chunk of 1024, crossing segments on the chunk's
    # edge, min_cluster_pixels below 0; a segment cut at E, E not a
    # multiple of the tile.
    "T in the last coarse bin": (
        ([40] * 30 + [590, 600, 585, 12] + [30] * 20,), 4096, 4096, 4096, 2, 24, 600, (), ()),
    "ties straddling T inside a coarse bin": (
        ([45] * 6 + [50, 50] + [30] * 10 + [45] * 8 + [50] + [20] * 3 + [45] * 4,),
        2048, 2048, 2048, 10, 24, 600, (), ()),
    "entries past one round of the top kernel": (
        ([24] * 1400 + [100] + [24] * 1400 + [100],), 69632, 68001, 68001, 128, 24, 600, (),
        ()),
    "tiles past one chunk of the top kernel": (
        ([500] * 1049 + [510] + [500] * 50 + [520],), 552960, 551000, 551000, 16, -1, 600,
        (), ()),
    "min_cluster_pixels -1, a segment cut at E": (
        ([30] * 50 + [1000],), 4096, 2000, 2000, 8, -1, 800, (), ()),
}
# Phase 23's synthetic rows of kept pairs for the radix passes alone:
# name -> (each frame's (kept count K, key kind), row length N, E; see
# sort_rows). The kernels' sort tiles hold 1024 positions under 2^22 pair
# slots a launch, else 4096; a frame's grid holds ceil(E / tile) blocks, so
# K past E walks its tiles in a loop.
SORT_ROWS = {
    "all keys equal, ties across every tile": (((5000, "equal"), (3000, "zero")), 8192, 8192),
    "keys at 2^30 - 1 and 0": (((6000, "extremes"),), 8192, 6000),
    "K = 0 beside a full row": (((0, "none"), (8192, "few")), 8192, 4096),
    "K on 1024-position tile boundaries": (((1024, "few"), (2048, "runs"), (4096, "few")),
                                           4096, 4096),
    "K on 4096-position tile boundaries": (((4096, "runs"), (8192, "few"), (12288, "runs"),
                                            (0, "none")), 1 << 20, 1 << 16),
    "K past E, tiles walked in a loop": (((60000, "runs"), (30000, "few")), 65536, 1500),
    "K past E, 4096-position tiles walked in a loop": (
        ((40000, "runs"), (20480, "equal"), (9000, "few"), (0, "none")), 1 << 20, 8192),
}
# Phase 23's synthetic frames for the whole sort (see sort_frames): 64x96
# frames (64x94 for rows the pixel kernels cannot load 4 pixels at a time;
# 192x256 for one over many pixel blocks), E at the detector's 3/4 of the
# pixels unless given.
SORT_FRAMES = ("an empty frame beside a checkerboard (stride 3)",
               "one key: a black half and a white half", "the largest dense ids",
               "K past E: a checkerboard at E 240 (stride 57)",
               "rows of 94 pixels (the pixel kernels' scalar path)",
               "one key over 48 pixel blocks: diagonal stripes")
# Once a resolve call (twice a two-phase call).
# Phase 23's synthetic frames for the pair count alone (see count_frames):
# each runs through the vector path (W % 4 == 0, aligned) and, from a view
# one element into a larger buffer, the scalar path.
COUNT_FRAMES = ("speckle, W 4", "speckle, W 158", "one row", "one column", "all ids KMAX",
                "pairs on every frame edge, W 16", "pairs on every frame edge, W 18",
                "speckle, batch 8, W 960")
# Phase 23's synthetic rows for the moments kernel alone (see moment_rows):
# slots past 8 warps of 64 pairs, of one bin, of two alternating bins, of
# one pair and empty; the same out of size order; a cut at E2 in a slot's
# middle; a batch of 8 frames of ring slots.
MOMENT_ROWS = ("past 8 warps, one bin, two bins, one pair, empty",
               "the same slots out of size order", "a slot cut at E2 in its middle",
               "a batch of 8 frames of ring slots")
RESOLVE_KERNELS = ("resolve_count", "resolve_tiles", "resolve_scan", "resolve_chain",
                   "resolve_map")
# The reference's XLA code each resolve kernel replaces (it has no Pallas
# kernel there): the pixel sort whose groups the count finds, the cumsum of
# group starts, the second sort that compacts the first R groups, the
# chain doubling with the sizes and dense ranks (the sort of the roots), and
# the packed-cummax broadcast with the unsort.
RESOLVE_REPLACES = {"resolve_count": "isaac_ros_apriltag_tpu/ops/resolve.py:145",
                    "resolve_tiles": "isaac_ros_apriltag_tpu/ops/resolve.py:150",
                    "resolve_scan": "isaac_ros_apriltag_tpu/ops/resolve.py:156",
                    "resolve_chain": "isaac_ros_apriltag_tpu/ops/resolve.py:194",
                    "resolve_map": "isaac_ros_apriltag_tpu/ops/resolve.py:233"}
# Phase 24: a capacity the 1080p b8 batch overflows, a speckle batch (the
# tests' random trinary) whose phase-1 groups pass R = N / 8, and flat
# synthetic frames (labels = flat index) with one group doubled, at a
# capacity under their group count: the twin's slot R - 1 is never eligible
# ((doubled group, eligible components) pairs), and at R = 65536 the groups
# past 65535 take its dense id.
RESOLVE_SMALL_R = 256
RESOLVE_SPECKLE = dict(shape=(2, 540, 960), p=(0.4, 0.2, 0.4), seed=5)
RESOLVE_SYNTH_SIDE = 300
RESOLVE_SLOT_R = 65000
RESOLVE_SLOT_CASES = ((64999, 0), (64998, 1))
# Phase 24's synthetic slot rows (slot_rows), each also held on the CPU
# (tests/test_torch_resolve_slots.py).
SLOT_ROWS = ("a root slot that no slot maps to, min_component_pixels 0",
             "more groups than R: slot R - 1 takes minus the rest",
             "R = 65536: groups past R take slot 65535's dense id",
             "more than _KMAX eligible components",
             "a chain longer than 2^s, pixel labels out of range",
             "rank mode: rank table pixels and labels out of range",
             "a frame with no valid slot beside a full one",
             "cycles walked past R + 1 hops")
# Phase 24's capacities that are not multiples of the chain kernel's
# cluster of 8 blocks: 7 leaves blocks without a slot, 28801 (the 720p
# capacity plus one) a short last block; random labels of a 200x200 frame.
ODD_R = (7, 28801)
RESOLVE_CASE_NAMES = tuple(f"{config} b{batch}" for config, batch in CAPTURE_CASES) + (
    f"1080p b8, R {RESOLVE_SMALL_R}", "speckle, phase-1 groups past R",
    *(f"slot R - 1, group {g} doubled, R {RESOLVE_SLOT_R}" for g, _ in RESOLVE_SLOT_CASES),
    "R 65536 clamp, one chain", *(f"slot row: {name}" for name in SLOT_ROWS),
    f"random labels, R {' and '.join(map(str, ODD_R))}")
# Phase 24's label count tables of the scan pass alone (scan_rows): name ->
# ((B, S), R, share of present entries; None: frame 0 empty, the last full).
# The scan kernel takes tiles of 4096 entries, 16 a thread, over S + 1 of
# them, and fills D past the group count from every tile of the frame.
SCAN_ROWS = {"S 4097, not a multiple of 4, R 300": ((2, 4097), 300, 0.5),
             "S + 1 = 8192, two whole tiles": ((2, 8191), 5000, 0.6),
             "S + 1 = 8193, one entry into a third tile": ((2, 8192), 5000, 0.6),
             "groups past R, R 1000 (not a multiple of 256)": ((2, 20000), 1000, 0.3),
             "an empty frame beside a full one": ((2, 10000), 12000, None),
             "every entry present, R 65536": ((1, 12289), 1 << 16, 1.0),
             "3 frames of 518400 entries, S + 1 odd": ((3, 518400), 64800, 0.05)}
# Phase 24's inputs of the count kernel alone: name -> ((B, N), S, label
# kind, share of valid pixels); see count_case. N = 518400 is the 1080p
# segmentation frame; rows of 1001 and 12345 pixels take the kernel's
# scalar path. From 2^20 pixels a launch its blocks take 4096 pixels, else
# 1024: the cases hold each of the four instances.
COUNT_CASES = {"one label a frame": ((3, 518400), 518400, "one", 1.0),
               "speckle": ((2, 518400), 518400, "speckle", 0.7),
               "labels at S - 1 and out of range": ((3, 1001), 777, "edges", 0.9),
               "runs, rows of 12345 pixels": ((90, 12345), 4096, "runs", 0.8)}

# Phase 25: the quad fit's cases (see quadfit_cases), the reference's XLA
# code the search kernel replaces (no Pallas kernel there: the selector
# arc sums with the top-k, sort and argmin around them), and the f32
# operations of one arc's sums and line fit for its bound: up to 12 adds
# or subtracts for the six sums; in the fit 5 divisions, 7 multiplies, 7
# adds or subtracts, 2 clamps and a square root.
QUADFIT_CASE_NAMES = tuple(f"{config} b{batch}" for config, batch in CAPTURE_CASES) + (
    "720p frame 23, seed 1 (capacity edge)", "blank 1080p b8 (no valid cluster)",
    "synthetic: ties, few candidates, bin 63, empty, NaN",
    "synthetic: 4, 5 and 10 candidates, at bins 0 and 63, ties, NaN and inf (39 clusters)",
    "one cluster (5 candidates)")
QUADFIT_COUNTS = (4, 5, 10)   # candidates of quadfit_counted's clusters
QUADFIT_REPLACES = "isaac_ros_apriltag_tpu/ops/quadfit.py:56"
QUADFIT_EDGE = ("tag36h11-720p-node", 23, 1)          # config, frame, seed
ARC_FLOPS = 12 + 22
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores (data sheet)
# Phase 26: the tail kernels' cases (see tail_cases) and the reference's XLA
# code each replaces (no Pallas kernel there). TAIL_FAMILY_TAG: the tag id
# and pose of phase 26's one-tag frames (tail_frame); TAIL_QUADS: the quads
# beside the tag there, in the tail frame's 240x320 pixels: a blank patch,
# one past the frame's corner, and (extra) one wholly outside the frame, one
# with NaN and infinite corners and a collinear one, whose homography is
# singular.
TAIL_REPLACES = {"decode": "isaac_ros_apriltag_tpu/ops/decode.py:105",
                 "pose": "isaac_ros_apriltag_tpu/ops/pose.py:38"}
TAIL_K = ((420.0, 0.0, 160.0), (0.0, 420.0, 120.0), (0.0, 0.0, 1.0))
TAIL_SIZE = (240, 320)
TAIL_TAG_SIZE = 0.16
TAIL_QUADS = (((10, 10), (50, 12), (48, 50), (12, 48)),
              ((-20, 200), (30, 205), (28, 260), (-25, 250)))
TAIL_EXTRA_QUADS = (((400, -50), (450, -50), (450, -10), (400, -10)),
                    ((np.nan, 1.0), (np.inf, -np.inf), (1e30, -1e30), (0.0, np.nan)),
                    ((0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)))
# Phase 26's codebooks past the STAGED_CODES = 4096 codes that decode_kernel
# stages in shared memory (csrc/tail.cu; the rest it reads from global
# memory): LARGE_CODES random codes of tag36h11's 36 bits, with tag36h11's
# code of tail_frame's tag (id 3), as read, or with bits flipped, at the
# indices given: kind -> ({index: bits flipped}, the tag's expected (id,
# hamming)). "past the staged codes": the code itself past 4096 (twice: the
# first wins) beats one-bit neighbours among the staged ones; "a tie across
# the staged codes": one-bit neighbours on both sides of 4096, the first
# (staged) one wins.
LARGE_CODES = 5000
LARGE_CODEBOOKS = {"the tag's past the staged codes": ({100: (0,), 4095: (7,), 4500: (),
                                                        4900: ()}, (4500, 0)),
                   "a tie across the staged codes": ({4000: (1, 2), 4095: (5,), 4096: (9,),
                                                      4600: (3,)}, (4095, 1))}
TAIL_FAMILIES = ("tag36h11", "tag36h10", "tag25h9", "tag16h5", "tagCircle21h7",
                 "tagCircle49h12", "tagCustom48h12", "tagStandard41h12", "tagStandard52h13")
TAIL_CASE_NAMES = (tuple(f"{config} b{batch}" for config, batch in CAPTURE_CASES)
                   + TAIL_FAMILIES + ("tag36h11, no sharpening", "tag36h11, max_hamming 0",
                                      "tagCircle49h12, 5 bits flipped, max_hamming 5",
                                      "tag36h11, a batch of 3 frames, per-frame K",
                                      "tag36h11, 3 quads: an idle warp in the last block",
                                      "tag36h11, posed at tag size 0: no fixed pivots")
                   + tuple(f"{LARGE_CODES} codes, {kind}" for kind in LARGE_CODEBOOKS))

# Phase 27: the tail's per-quad refinement and per-frame picks (see
# glue_cases), the reference's XLA code each kernel replaces (no Pallas
# kernel there), and the f32 operations a bound counts: a profile sample
# (its point on the normal, the clamps, floors and fractions, the four taps'
# weights) and a gradient weight (the difference, its square, the two sums
# and the offset); a pair of candidates in a frame's rank (a compare) and
# in the dedupe (the center distance and the tests): a pick ranks the pairs
# of the quads scored above -inf, the finish tests and ranks its valid
# candidates' pairs only.
# The finish with the pose (finish_pose_kernel, the detect path's launch)
# also counts each top-T tag's pose: about POSE_FLOPS f32 operations a tag,
# counted from csrc/tail.cu::pose_one (the 8x8 elimination and back
# substitution 428, the rest of the homography ~90, K^-1 and M ~90, the
# scale and axes ~50, the Newton steps ~250, the quaternion ~50).
# The detect path's pick and refine are one launch (select_refine:
# refine_kernel).
GLUE_KERNELS = ("select_refine", "tail_finish", "finish_pose")
GLUE_NAMES = {"select_refine": "refine_kernel"}
GLUE_REPLACES = {"select_refine": "isaac_ros_apriltag_tpu/detector.py:234",
                 "tail_finish": "isaac_ros_apriltag_tpu/detector.py:254",
                 "finish_pose": "isaac_ros_apriltag_tpu/detector.py:254"}
GLUE_SAMPLE_FLOPS = 21
GLUE_WEIGHT_FLOPS = 8
GLUE_PAIR_FLOPS = {"select_refine": 1, "tail_finish": 12, "finish_pose": 12}
POSE_FLOPS = 950
GLUE_CASE_NAMES = (tuple(f"{config} b{batch}" for config, batch in CAPTURE_CASES)
                   + ("NaN and inf corners", "no valid quad", "tied scores and margins",
                      "duplicate ids, equal margins", "max_tags < C/2", "quad_decimate 1",
                      "quad_decimate 3", "a batch of 3 frames"))
# Phase 27's finish-only cases (finish_synthetic): margins at +-inf and NaN,
# a gate of -inf (valid candidates scored -inf), one id on 128 valid
# candidates in a cluster, N not a multiple of 32 with k < N / 2, and NaN
# edges (two corners at +inf) beside candidates of the same id.
FINISH_CASE_NAMES = ("inf and NaN margins", "min_decision_margin -inf",
                     "one id, 128 valid candidates", "100 candidates, k 7",
                     "NaN edges beside candidates of the same id")
# Phase 27's refine-only cases (refine_synthetic): search ranges whose
# profiles are 7, 9, 13, 17, 24 and 25 samples (refine_kernel stages 24 a
# point at once) and 165 (seven chunks), and quads across the frame's edges.
REFINE_CASE_NAMES = ("search range 0.5", "search range 1", "search range 2", "search range 3",
                     "search range 4.75", "search range 5", "search range 40",
                     "profiles leaving the frame")

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


def segment_rows() -> dict:
    """SEGMENT_ROWS as numpy inputs: name -> ((B, N) int32 sorted keys,
    segment i of a frame holding key 8 i + 5, then int32 max; (B,) int32
    num_edge, the frame's valid keys capped at the pair budget (stride 1)
    or twice the budget (stride 2); (B,) bool comp_overflow; top_segments'
    keyword arguments)."""
    out = {}
    for name, (frames, N, E, E2, C, min_pix, max_per, strided, ovf) in SEGMENT_ROWS.items():
        keys = np.full((len(frames), N), np.iinfo(np.int32).max, np.int32)
        for b, sizes in enumerate(frames):
            row = np.repeat(8 * np.arange(len(sizes or [])) + 5, sizes or [])
            keys[b, :len(row)] = row
        nv = (keys[:, :E] != np.iinfo(np.int32).max).sum(-1)
        budget = (9 * E) // 10
        num_edge = np.where(np.isin(np.arange(len(frames)), strided), 2 * budget,
                            np.minimum(nv, budget)).astype(np.int32)
        out[name] = (keys, num_edge, np.isin(np.arange(len(frames)), ovf),
                     dict(E=E, E2=E2, max_clusters=C, min_cluster_pixels=min_pix,
                          max_perimeter=max_per))
    return out


def sort_rows(seed: int = 0) -> dict:
    """SORT_ROWS as numpy inputs: name -> ((B, N) int32 keys, each frame's
    K keys in [0, K) and int32 max past them; (B, N) int32 pays, 8 p + b at
    position p of frame b; (B,) int32 K; E). Key kinds: 'equal' one key,
    (12345 << 15) | 777; 'zero' 0; 'extremes' 0, 2^30 - 1 or any key below;
    'few' a draw from 12 keys; 'runs' runs of 1 to 40 of random keys;
    'none' no key."""
    rng = np.random.default_rng(seed)
    top = (1 << 30) - 1
    out = {}
    for name, (frames, N, E) in SORT_ROWS.items():
        B = len(frames)
        keys = np.full((B, N), np.iinfo(np.int32).max, np.int32)
        for b, (K, kind) in enumerate(frames):
            if kind == "equal":
                row = np.full(K, (12345 << 15) | 777)
            elif kind == "zero":
                row = np.zeros(K)
            elif kind == "extremes":
                row = np.where(rng.random(K) < 0.4, top,
                               np.where(rng.random(K) < 0.5, 0, rng.integers(0, top, K)))
            elif kind == "few":
                row = rng.choice(rng.integers(0, top, 12), K)
            elif kind == "runs":
                row = np.repeat(rng.integers(0, top, K), rng.integers(1, 41, K))[:K]
            else:
                row = np.zeros(0)
            keys[b, :K] = row
        pays = (8 * np.arange(N)[None] + np.arange(B)[:, None]).astype(np.int32)
        out[name] = (keys, pays, np.array([k for k, _ in frames], np.int32), E)
    return out


def sort_frames(seed: int = 0) -> dict:
    """SORT_FRAMES as numpy inputs: name -> ((B, 64, 96) uint8 trinary,
    int32 dense ids, E). The checkerboard's right and down neighbours pair
    (two pairs a pixel, 2.0 times 3/4 of the pixels: stride 3), its ids
    constant on 6x6 cells; the halves pair only across their border, every
    pair with key (0 << 15) | 1; the largest ids are 32764 to 32766 on a
    random trinary; at E 240 the checkerboard keeps 245 pairs; the 94-pixel
    rows are the speckle's and the cells' first 94 columns; the 192x256
    stripes (48 blocks of the first pass's 1024 pixels) pair right, down and
    down-right across each border, every pair with key (0 << 15) | 1, so
    the ties run through every tile of three offsets' look-back chains."""
    rng = np.random.default_rng(seed)
    H, W = 64, 96
    y, x = np.mgrid[:H, :W]
    checker = (((y + x) % 2) * 255).astype(np.uint8)
    cells = ((x // 6 + (y // 6) * 16) % 700).astype(np.int32)
    E = (3 * H * W) // 4
    halves = np.where(x < W // 2, 0, 255).astype(np.uint8)
    speckle = rng.choice(np.array([0, 255, 127], np.uint8), size=(H, W), p=[0.45, 0.45, 0.1])
    sy, sx = np.mgrid[:192, :256]
    stripes = np.where((sx + sy) // 4 % 2 == 0, 0, 255).astype(np.uint8)
    cases = ((np.stack([np.full((H, W), 127, np.uint8), checker]),
              np.stack([np.zeros((H, W), np.int32), cells]), E),
             (halves[None], (halves // 255).astype(np.int32)[None], E),
             (speckle[None], (32766 - rng.integers(0, 3, (1, H, W))).astype(np.int32), E),
             (checker[None], cells[None], 240),
             (np.ascontiguousarray(speckle[None, :, :94]),
              np.ascontiguousarray(cells[None, :, :94]), (3 * H * 94) // 4),
             (stripes[None], (stripes // 255).astype(np.int32)[None], (3 * 192 * 256) // 4))
    return dict(zip(SORT_FRAMES, cases, strict=True))


def _random_front(shape, seed: int, p_kmax: float = 0.2):
    """A speckle trinary and ids in [0, 40), a share p_kmax of them KMAX."""
    rng = np.random.default_rng(seed)
    tri = rng.choice(np.array([0, 127, 255], np.uint8), size=shape, p=[0.4, 0.2, 0.4])
    dense = rng.integers(0, 40, size=shape).astype(np.int32)
    dense[rng.random(shape) < p_kmax] = (1 << 15) - 1
    return tri, dense


def _edge_checkerboard(H: int, W: int):
    """Black and white 1-pixel checks, each pixel its own id: every pixel
    pairs with its right and down neighbours, the frame's last row and
    column too."""
    yy, xx = np.mgrid[:H, :W]
    tri = np.where((yy + xx) % 2 == 0, 0, 255).astype(np.uint8)[None]
    return tri, (yy * W + xx).astype(np.int32)[None]


def count_frames(seed: int = 0) -> dict:
    """COUNT_FRAMES as numpy inputs: name -> ((B, H, W) uint8 trinary, int32
    dense ids)."""
    tri, dense = _random_front((2, 48, 160), seed)
    return dict(zip(COUNT_FRAMES, (
        _random_front((3, 9, 4), seed + 1), (tri[..., :158].copy(), dense[..., :158].copy()),
        _random_front((2, 1, 64), seed + 2), _random_front((2, 64, 1), seed + 3),
        (tri, np.full_like(dense, (1 << 15) - 1)), _edge_checkerboard(12, 16),
        _edge_checkerboard(12, 18), _random_front((8, 36, 960), seed + 4)), strict=True))


def _ring_pays(n: int, cx: float, cy: float, radius: float, seed: int) -> np.ndarray:
    """n pays on a noisy ring about (cx, cy) (pixels), in raster order."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    X = np.clip(np.round(2 * cx + 2 * radius * np.cos(th)), 0, 4095).astype(np.int64)
    Y = np.clip(np.round(2 * cy + 2 * radius * np.sin(th)), 0, 4095).astype(np.int64)
    order = np.lexsort((X, Y))
    g = rng.integers(0, 16, n)
    return (X[order] | (Y[order] << 12) | (g << 24)).astype(np.int32)


def _slot_row(slots, C: int):
    """Slots' pays laid end to end: ((1, N) pays, (1, C) top_pos, (1, C) count)."""
    row = np.concatenate(slots)
    top, cnt = np.zeros((1, C), np.int32), np.zeros((1, C), np.int32)
    top[0, :len(slots)] = np.cumsum([0] + [len(s) for s in slots[:-1]])
    cnt[0, :len(slots)] = [len(s) for s in slots]
    return row[None], top, cnt


def moment_rows(seed: int = 0) -> dict:
    """MOMENT_ROWS as numpy inputs: name -> ((B, N) int32 pays in sorted
    order, (B, C) int32 top_pos, (B, C) int32 count, E2). One bin: 700 pairs
    at one position (each at the centroid, bin 0); two bins: 600 pairs at
    two positions in turn (bins 0 and 32), as a boundary's two sides come
    in raster order; past 8 warps: a 2600-pair ring (8 warps of 325)."""
    def at(x: int, y: int, g: int) -> int:
        return (2 * x) | ((2 * y) << 12) | (g << 24)

    slots = [_ring_pays(2600, 300.0, 200.0, 90.0, seed + 1),
             np.full(700, at(50, 60, 5), np.int32),
             np.tile(np.array([at(40, 80, 1), at(90, 80, 9)], np.int32), 300),
             np.array([at(7, 9, 6)], np.int32), _ring_pays(40, 20.0, 30.0, 5.0, seed + 2)]
    row, top, cnt = _slot_row(slots, 8)
    perm = np.array([3, 0, 4, 1, 2, 5, 6, 7])
    rng = np.random.default_rng(seed + 3)
    frames = []
    for b in range(8):
        sizes = np.sort(rng.integers(1, 1200, 16))[::-1]
        sizes[0] += 1500 * (b % 2)
        frames.append(_slot_row([_ring_pays(int(n), 100.0 + 10 * b, 80.0 + i, 12.0 + n / 40,
                                            seed + 10 * b + i) for i, n in enumerate(sizes)],
                                16))
    N = max(f[0].shape[1] for f in frames)
    pays = np.stack([np.pad(f[0][0], (0, N - f[0].shape[1])) for f in frames])
    batch = (pays, np.concatenate([f[1] for f in frames]),
             np.concatenate([f[2] for f in frames]), 16 * 1024)
    return dict(zip(MOMENT_ROWS, (
        (row, top, cnt, row.shape[1]), (row, top[:, perm], cnt[:, perm], row.shape[1]),
        (row, top, cnt, int(cnt[0, :2].sum() + cnt[0, 2] // 2)), batch), strict=True))


def _inverted_parents(G: int, a: int, **over) -> np.ndarray:
    """Each of G groups its own parent but an inverted pair: a -> a + 2, so
    root slot a + 1 comes before a + 2, whose component's first slot, a,
    comes before a + 1; `over` sets other groups' parents."""
    p = np.arange(G)
    p[a] = a + 2
    for j, v in over.items():
        p[int(j)] = v
    return p


def _slot_frame(lab: np.ndarray, out: dict | None = None):
    """A (2G,) label row as a (1, 2, G) frame and its validity: out = {j: a
    label for pixel 2j outside the labels' range}, which pixel is then
    invalid (valid pixels hold labels in range; a parent reads any pixel)."""
    valid = np.ones(lab.shape, bool)
    for j, v in (out or {}).items():
        lab[2 * j], valid[2 * j] = v, False
    G = lab.shape[0] // 2
    return lab.reshape(1, 2, G).astype(np.int32), valid.reshape(1, 2, G)


def _flat_slots(parents, out=None):
    """Flat labels of groups 0, 2, .., 2G - 2: pixel 2j + 1 is labelled 2j
    and pixel 2j holds 2 parents[j], the label group 2j's parent reads, so
    slot j's parent is slot parents[j]."""
    G = len(parents)
    lab = np.empty(2 * G, np.int64)
    lab[1::2], lab[0::2] = 2 * np.arange(G), 2 * np.asarray(parents)
    return _slot_frame(lab, out)


def _ranked_slots(parents, R: int, table_out: dict, out: dict):
    """Rank labels 0 .. G - 1: pixel 2v + 1 is labelled v, pixel 2v parents[v]
    and rank_table[v] = 2v (table_out = {v: a pixel outside the frame})."""
    G = len(parents)
    lab = np.empty(2 * G, np.int64)
    lab[1::2], lab[0::2] = np.arange(G), parents
    table = np.zeros(R, np.int64)
    table[:G] = 2 * np.arange(G)
    for v, px in table_out.items():
        table[v] = px
    return (*_slot_frame(lab, out), table[None].astype(np.int32))


def slot_rows() -> dict:
    """SLOT_ROWS -> (labels (B, 2, G) int32, valid (B, 2, G) bool, R, chain
    steps, min_component_pixels, rank table (B, R) int32 or None): frames
    whose slot tables reach the chain kernel's edges, each with an
    inverted pair (see _inverted_parents), so components ranked by their
    first slot, not their root slot, come out in another order."""
    G = (1 << 16) + 50
    tail = _inverted_parents(G, 7)
    tail[10:] = np.arange(10, G) % 7         # slot 65535's root is slot 1
    chain = {str(j): j - 1 for j in range(1, 41)}
    # More groups than R, a second frame whose slots all share root slot 0:
    # its total is exactly 0 (slot R - 1 takes minus the rest, not its own
    # pixels too), under the gate of 1.
    over = [np.concatenate(a) for a in zip(_flat_slots(_inverted_parents(38, 10, **{"31": 3})),
                                          _flat_slots(np.zeros(38, np.int64)))]
    lab, valid = _flat_slots(_inverted_parents(20, 2, **{"15": 5}))
    lab, valid = np.repeat(lab, 2, 0), np.repeat(valid, 2, 0)
    valid[0] = False
    ranks, rvalid, table = _ranked_slots(_inverted_parents(20, 3), 32, {7: -3, 9: 44},
                                         {11: -5, 12: 39})
    rows = [
        (*_flat_slots(_inverted_parents(9, 6, **{str(j): j - 1 for j in range(1, 6)})),
         16, 1, 0, None),
        (*over, 32, 3, 1, None),
        (*_flat_slots(tail), 1 << 16, 2, -(1 << 30), None),
        (*_flat_slots(_inverted_parents(40000, 0)), 40000, 2, 1, None),
        (*_flat_slots(_inverted_parents(48, 41, **chain), out={45: -5, 46: 10 ** 6}),
         64, 3, 2, None),
        (ranks, rvalid, 32, 3, 1, table),
        (lab, valid, 16, 3, 2, None),
        (*_flat_slots(_inverted_parents(12, 8, **{"2": 3, "3": 2, "4": 5, "5": 6, "6": 4})),
         8, 6, 1, None)]
    return dict(zip(SLOT_ROWS, rows, strict=True))


def parent_slots_form(lab, inv, D, n_groups, steps: int, rank_table=None, cnt=None):
    """The torch ops that the chain walk replaced (ops/resolve.py's
    table functions between scan and map before it, up to the roots' sort):
    each slot's parent doubled `steps` times (_pointer_double). Without cnt
    the contraction's (map table, overflow); with cnt the final resolve's
    (root labels, slot sizes with slot R - 1's rule, converged)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain

    B, N = lab.shape
    R, S = D.shape[1], inv.shape[1] - 1
    dev = lab.device
    i64 = dict(dtype=torch.int64, device=dev)
    ng = n_groups.to(torch.int64)
    ks = torch.arange(R, device=dev)
    kvalid = ks < ng[:, None]
    Dl = D.to(torch.int64)
    label_k = Dl if rank_table is None else torch.gather(
        torch.cat([rank_table.to(torch.int64), torch.full((B, 1), N, **i64)], 1), 1, Dl)
    parx = plain._slot_parents(lab, inv, torch.where(kvalid, label_k, N), R)
    parx, prev = plain._pointer_double(parx, steps)
    if cnt is None:
        return (torch.cat([parx[:, :R] & 0xFFFF, torch.full((B, 1), R, **i64)], 1)
                .to(torch.int32), n_groups > R)
    cnt_k = torch.where(kvalid, torch.gather(cnt, 1, Dl.clamp(max=S - 1)).to(torch.int64), 0)
    last = torch.where(ng > R, -cnt_k[:, :R - 1].sum(-1), cnt_k[:, R - 1])
    cnt_k = torch.cat([cnt_k[:, :R - 1], last[:, None]], 1)
    Dx = torch.cat([Dl, torch.full((B, 1), S, **i64)], 1)
    root = torch.where(kvalid, torch.gather(Dx, 1, parx[:, :R]), S)
    return root, cnt_k, torch.all(parx == prev, -1)


def parent_dense_form(root, cnt_k, n_groups, sent: int, min_component_pixels: int):
    """The torch ops that the dense ranks replaced: the sizes, gate and
    dense ranks by the stable sort of the root labels and its cumsums
    (_dense_ranks), the R = 65536 tail and the map table: (table,
    n_eligible, overflow)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain

    B, R = root.shape
    dense_k, n_eligible = plain._dense_ranks(root, cnt_k, sent, min_component_pixels)
    tail = (dense_k[:, (1 << 16) - 1:] if R == 1 << 16 else
            torch.full((B, 1), plain._KMAX, dtype=torch.int64, device=root.device))
    return (torch.cat([dense_k, tail], 1).to(torch.int32), n_eligible,
            (n_groups > R) | (n_eligible > plain._KMAX))


def parent_chain_form(lab, inv, D, n_groups, steps: int, rank_table=None, cnt=None,
                      min_component_pixels: int = 0):
    """The chain kernel's pass in the parent's torch ops: without cnt the
    contraction's (map table, overflow), parent_slots_form; with cnt the
    final resolve's (map table, n_eligible, overflow, converged),
    parent_slots_form then parent_dense_form."""
    out = parent_slots_form(lab, inv, D, n_groups, steps, rank_table, cnt)
    if cnt is None:
        return out
    root, cnt_k, converged = out
    return (*parent_dense_form(root, cnt_k, n_groups, inv.shape[1] - 1, min_component_pixels),
            converged)


def scan_rows(seed: int = 0) -> dict:
    """SCAN_ROWS as numpy inputs of the scan pass: name -> ((B, S) int32
    label counts, R); a present entry's count is 1 to 5."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ((B, S), R, share) in SCAN_ROWS.items():
        if share is None:
            present = np.zeros((B, S), bool)
            present[-1] = True
        else:
            present = rng.random((B, S)) < share
        out[name] = (np.where(present, rng.integers(1, 6, (B, S)), 0).astype(np.int32), R)
    return out


def count_case(name: str, seed: int = 0):
    """COUNT_CASES[name] as numpy inputs: ((B, N) int32 labels, (B, N) bool
    validity, S). 'one': every pixel labelled 7; 'speckle': labels uniform
    in [0, S); 'edges': runs of -5, -1, 0, S - 1, S, S + 3 and int32 max;
    'runs': runs of 1 to 300 pixels of labels in [-2, S + 2)."""
    (B, N), S, kind, share = COUNT_CASES[name]
    rng = np.random.default_rng(seed)
    if kind == "one":
        label = np.full((B, N), 7, np.int64)
    elif kind == "speckle":
        label = rng.integers(0, S, (B, N))
    else:
        values = (np.array([-5, -1, 0, S - 1, S, S + 3, np.iinfo(np.int32).max])
                  if kind == "edges" else np.arange(-2, S + 2))
        runs = rng.integers(1, 300 if kind == "runs" else 20, B * N)
        label = np.repeat(rng.choice(values, B * N), runs)[:B * N].reshape(B, N)
    valid = rng.random((B, N)) < share
    return label.astype(np.int32), valid, S


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


def _replay_equals(fn, got, what: str) -> None:
    """fn() captured in a CUDA graph (after a warm call on a side stream) and
    replayed once must equal `got`, a tensor or a tuple of them, else raise."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = zip(static, got) if isinstance(got, tuple) else [(static, got)]
    if not all(_same(a, b) for a, b in pairs):
        raise AssertionError(f"{what}: the captured replay differs from eager")


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


def _graph_ms(fn, iters: int) -> float:
    """Device ms a call of fn, captured once in a CUDA graph (after a warm
    call on a side stream) and timed by _device_ms of the replay: for a form
    of many small torch ops, whose eager launches overfill the launch queue
    that _device_ms's spin kernel covers, so that eager it is timed at the
    host's pace."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _device_ms(graph.replay, iters)


def _bytes_ms(n: int) -> float:
    """The least ms the card could take to move n bytes, at HBM_BYTES_PER_S."""
    return n / HBM_BYTES_PER_S * 1e3


def _bound_ms(*tensors) -> float:
    """The least time the card could take to read each input once and write
    each output once, at HBM_BYTES_PER_S. The kernels do a few integer
    operations a pixel, far under the card's rate for them, so bytes bound
    them."""
    return _bytes_ms(sum(t.numel() * t.element_size() for t in tensors))


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


def _want(frames: int = 1, rounds: int = SCAN_ROUNDS, resolves: int = 2,
          rig_k: bool = False) -> dict:
    """The launches of `frames` detect calls (or batched calls) of `rounds`
    scan rounds and `resolves` resolve calls each (2 in the two-phase flow,
    the contraction and the final resolve; 1 in the flat and jumps flows):
    K1 once, K2 and K3 once a round, the resolve kernels once a resolve call,
    the cluster kernels
    as CLUSTER_KERNELS counts them, and the tail's kernels once: the quad
    fit's fitting launch, the top-2T pick and refine in one launch
    (select_refine), decode, and the dedupe and top-T pick with the tags'
    pose in one launch (finish_pose); with
    rig_k (a rig whose cameras have their own K), the dedupe and top-T pick
    alone (tail_finish) and pose once a call, outside its graph."""
    return {"threshold": frames, "row": rounds * frames, "col": rounds * frames,
            **{k: n * frames for k, n in CLUSTER_KERNELS.items()},
            **{k: resolves * frames for k in RESOLVE_KERNELS},
            "quadfit_search": frames, "select_refine": frames,
            "decode": frames, "tail_finish": frames * rig_k, "finish_pose": frames * (not rig_k),
            "pose": frames * rig_k}


def _resolve_want() -> dict:
    """The launches of one resolve call alone, the contraction or a final
    resolve: each resolve kernel once."""
    return {k: int(k in RESOLVE_KERNELS) for k in _want()}


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


def _device_kernels(prof) -> list[str]:
    """The names of the kernels that ran on the card in a torch.profiler trace."""
    import torch

    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# The kernels that may run between the quad fit's launch and the finish's
# (with the pose) in a detect call on backend 'cuda' (phase 22 checks that
# nothing else does).
TAIL_BETWEEN = ("select_refine", "decode")


def _kernel_key(name: str):
    """The LAUNCH_COUNTERS name whose KERNEL_NAMES pattern matches a device
    kernel's name, or None."""
    for k, part in KERNEL_NAMES.items():
        if any(p in name for p in ((part,) if isinstance(part, str) else part)):
            return k
    return None


def tail_between(prof) -> list[str]:
    """The device kernels that ran after the last quad-fit launch and
    before the next finish and pose launch in a torch.profiler trace, in
    start order; raises unless both ran."""
    import torch

    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    keys = [_kernel_key(e.name) for e in events]
    if "quadfit_search" not in keys or "finish_pose" not in keys:
        raise AssertionError("the trace holds no quad-fit or no finish and pose launch")
    first = len(keys) - 1 - keys[::-1].index("quadfit_search")
    last = keys.index("finish_pose", first)
    return [e.name for e in events[first + 1:last]]


def _profiled_kernels(prof) -> dict:
    """How often each kernel ran on the card in a torch.profiler trace, by name."""
    names = _device_kernels(prof)
    return {k: sum(any(p in n for p in ((part,) if isinstance(part, str) else part))
                   for n in names) for k, part in KERNEL_NAMES.items()}


@contextlib.contextmanager
def _counted(what: str, banned: tuple = (), totals: dict | None = None):
    """Counts the kernels' launches in the block: yields a dict that, after
    the block, holds each kernel's count (every count is set to 0 before the
    block). torch.profiler watches the block, and the count it sees of each
    kernel by name must equal its wrapper's count (a replayed graph's counts
    are added by capture.GraphedCall, not by a wrapper), and no cummax
    kernel (torch's scans with indices, which the resolve kernels replace)
    nor one whose name holds one of `banned` may run, else it raises. Used
    in a fresh process only (profiled_replays). With `totals`, totals[what]
    is the count of every kernel that ran on the card in the block."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    _reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        counts.update(_launches())
    if totals is not None:
        totals[what] = len(_device_kernels(prof))
    seen = _profiled_kernels(prof)
    if seen != counts:
        raise AssertionError(f"{what}: the launch counters say {counts}, torch.profiler saw "
                             f"{seen}")
    cummax = [n for n in _device_kernels(prof) if CUMMAX_KERNEL in n]
    if cummax:
        raise AssertionError(f"{what}: {len(cummax)} cummax kernels ran ({cummax[0]})")
    ran = sorted({n for n in _device_kernels(prof) if any(b in n for b in banned)})
    if ran:
        raise AssertionError(f"{what}: kernels it may not launch ran: {ran[:3]}")


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
    want = _want(rounds=cfg.ccl_rounds, resolves=1)
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
    resolves = {"scan": 2, "jumps": 1}
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
                want = _want(len(frames), rounds[flow], resolves[flow])
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
        want = _want(rig_k=True)
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


def front_trinary(cfg, images):
    """A (B, H, W) uint8 batch on the card through the detector's front on
    backend 'cuda': grayscale, decimate, pad, threshold (K1)."""
    from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
    from isaac_ros_apriltag_tpu_torch.ops.cuda import threshold as thr_ops
    from isaac_ros_apriltag_tpu_torch.ops.grayscale import grayscale

    gray = grayscale(images, "mono8", batched=True).contiguous()
    seg = _pad_to_tiles(_decimate(gray, cfg.quad_decimate), cfg.tile_size).contiguous()
    return thr_ops.adaptive_threshold(seg, cfg.tile_size, cfg.min_white_black_diff)


def labels_of(cfg, tri):
    """The two-phase CCL of a (B, H, W) trinary batch on the card, backend
    'cuda', as the detector runs it: (validity, phase-1 labels, phase-2
    labels, rank table, R, the contraction's overflow)."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    valid = tri != 127
    R = cfg.effective_capacities(*tri.shape[-2:])[1]
    lab1, _ = ccl_ops.ccl_scan(tri, cfg.ccl_scan_rounds, backend="cuda")
    rank_img, table, ovf = rk.resolve_roots_rank(lab1, valid, max_components=R,
                                                 chain_steps=cfg.ccl_contraction_steps)
    lab2, _ = ccl_ops.ccl_scan(tri, cfg.ccl_phase2_rounds, backend="cuda", label0=rank_img)
    return valid, lab1, lab2, table, R, ovf


def cluster_inputs(cfg, images):
    """The cluster-moment stage's inputs for a (B, H, W) uint8 batch on the
    card, through the detector's front on backend 'cuda' (as detect_tail
    feeds the stage): (trinary, dense ids, comp_overflow, the stage's
    keyword arguments)."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda.resolve import resolve_components

    tri = front_trinary(cfg, images)
    valid, _, lab, table, R, ovf = labels_of(cfg, tri)
    res = resolve_components(lab, valid, min_component_pixels=cfg.min_component_pixels,
                             max_components=R, chain_steps=cfg.ccl_resolve_steps,
                             rank_table=table)
    kw = dict(max_edge_points=cfg.effective_capacities(*tri.shape[-2:])[0],
              max_clusters=cfg.max_clusters, min_cluster_pixels=cfg.min_cluster_pixels,
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


def _misaligned(x):
    """A contiguous copy of x one element into a larger buffer: its rows
    are not 16-byte aligned, so the pixel kernels take their scalar path."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def check_count_frame(name: str, dev) -> int:
    """One of COUNT_FRAMES on the card: the pair count (one launch) against
    edge_count_plain, bit-exact, on the frames as given and on a misaligned
    copy (the scalar path), two calls and a captured replay equal. Raises on
    a difference; returns the pairs counted."""
    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk
    import torch

    tri, dense = (torch.from_numpy(a).to(dev) for a in count_frames()[name])
    want = plain.edge_count_plain(tri, dense)
    for path, (t, d) in (("as given", (tri, dense)),
                         ("misaligned", (_misaligned(tri), _misaligned(dense)))):
        one = {k: int(k == "edge_count") for k in _want()}
        _reset_launches()
        got = cmk.edge_count(t, d)
        counts = _launches()
        if counts != one:
            raise AssertionError(f"count frames, {name}, {path}: launches {counts} != {one}")
        if not _same(got, want):
            raise AssertionError(f"count frames, {name}, {path}: {got.tolist()} != "
                                 f"edge_count_plain's {want.tolist()}")
        if not _same(cmk.edge_count(t, d), got):
            raise AssertionError(f"count frames, {name}, {path}: two calls differ")
        _replay_equals(lambda: cmk.edge_count(t, d), got, f"count frames, {name}, {path}")
    return int(want.sum())


def check_moment_row(name: str, dev) -> tuple[int, int]:
    """One of MOMENT_ROWS on the card: the moments kernel (one launch)
    against slot_moments_plain (centroid, scale, dark side and the weight
    column bit-exact, the other columns within one f32 ulp), two calls and a
    captured replay equal. Raises on a difference; returns (table cells
    apart, cells)."""
    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk
    import torch

    pay, top, cnt, E2 = moment_rows()[name]
    pay, top, cnt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pay, top, cnt))

    def call():
        return tuple(cmk.slot_moments(pay, top, cnt, E2))

    one = {k: int(k == "moments") for k in _want()}
    _reset_launches()
    got = call()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"moment rows, {name}: launches {counts} != {one}")
    want = plain.slot_moments_plain(pay, top, cnt, E2)
    for f, a, b in zip(want._fields, got, want):
        exact = f != "table"
        if not (_same(a, b) if exact else _same(a[..., 0], b[..., 0]) and _within_one_ulp(a, b)):
            raise AssertionError(f"moment rows, {name}: {f} differs from slot_moments_plain "
                                 f"(max abs err {_max_abs_err(a, b)})")
    if not all(_same(a, b) for a, b in zip(call(), got)):
        raise AssertionError(f"moment rows, {name}: two calls differ")
    _replay_equals(call, got, f"moment rows, {name}")
    return int((got[0] != want.table).sum()), got[0].numel()


def _live_look(plane, kept, tile: int):
    """A later pass's (B, T, R) look-back words on each frame's first
    ceil(K / tile) sort tiles (the ones the pass before zeroes), 0 past them
    (the kernels leave those undefined)."""
    import torch

    on = torch.arange(plane.shape[1], device=kept.device) < ((kept + tile - 1) // tile)[:, None]
    return torch.where(on[:, :, None], plane, 0)


def _live_rows(rows, kept) -> tuple:
    """A sort's rows as the kernels define them: keys and pays on [0, K)
    (int32 max and 0 past K)."""
    import torch

    live = torch.arange(rows.key.shape[1], device=kept.device) < kept[:, None]
    return torch.where(live, rows.key, np.iinfo(np.int32).max), torch.where(live, rows.pay, 0)


def radix_steps(rows, tiles, E: int):
    """The later radix passes on the card from `rows` (as the first pass
    leaves them), each against radix_scatter_plain on the rows it was given,
    and the next pass's look-back words zeroed on the live tiles by each
    pass but the last. Returns (sorted rows, [(got, want), ...])."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    B, N = rows.key.shape
    tile = plain.sort_tile(B, N)
    npass = tiles.ctl.shape[1]
    got, pairs, spare = _live_rows(rows, tiles.kept), [], None
    for k in range(1, npass):
        given = plain.SortRows(*got)
        moved = cmk.radix_scatter(rows, tiles, k, E=E, out=spare)
        if k + 1 < npass:
            zeroed = _live_look(tiles.look[k], tiles.kept, tile)
            pairs.append((zeroed, torch.zeros_like(zeroed)))
        spare, rows = (rows.key, rows.pay), moved
        got = _live_rows(rows, tiles.kept)
        pairs += list(zip(got, _live_rows(plain.radix_scatter_plain(given, tiles, k), tiles.kept)))
    return rows, pairs


def sort_steps(tri, dense, ne, E: int):
    """The kept pairs' sort on the card kernel by kernel (the histogram
    pass, the first pass from the pixels, the later passes), each against
    its plain version on the inputs it was given (the histogram pass's
    digit counts, offset digits, tile counts and group sums, and kept
    counts; the first pass's rows on [0, K) and pass 1's look-back words it
    zeroes), and the sorted rows against
    torch.sort(stable=True) of the padded row (edge_pairs_plain): keys on
    [0, max(K, E)), pays on [0, K). Returns (rows, PairTiles, {kernel:
    [(got, want), ...]})."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    B, H, W = tri.shape
    tile = plain.sort_tile(B, 4 * H * W)
    tiles = cmk.pair_count(tri, dense, ne, E)
    want = plain.pair_count_plain(tri, dense, ne, E)
    kept = tiles.kept
    pairs = {"pair_count": [(getattr(tiles, f), getattr(want, f)) for f in (
        "kept", "digits", "offset_digits", "tile_counts", "group_sums")]}
    rows = cmk.radix_first(tri, dense, ne, tiles, E)
    zeroed = _live_look(tiles.look[0], kept, tile)
    pairs["radix_scatter"] = [(zeroed, torch.zeros_like(zeroed))] + list(zip(
        _live_rows(rows, kept), _live_rows(plain.radix_first_plain(tri, dense, ne, want, E), kept)))
    rows, later = radix_steps(rows, tiles, E)
    pairs["radix_scatter"] += later
    key, pay = plain.edge_pairs_plain(tri, dense, ne, E)
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    pos = torch.arange(key.shape[1], device=key.device)
    upto, live = pos < torch.clamp(kept, min=E)[:, None], pos < kept[:, None]
    pairs["radix_scatter"] += [
        (torch.where(upto, rows.key, np.iinfo(np.int32).max), key_s),
        (torch.where(live, rows.pay, 0), torch.where(live, torch.gather(pay, 1, perm), 0))]
    return rows, tiles, pairs


def check_cluster_case(name: str, cfg, images) -> dict:
    """One of phase 23's cases: the kernel path against the plain version
    (cluster_gap), the cluster kernels' launches (CLUSTER_KERNELS), two
    calls and a captured replay equal, and each kernel against its plain
    version on the same inputs (sort_steps for the sort's kernels; the
    moments kernel's tables within one f32 ulp, as cluster_gap). Raises on a
    difference; returns the stage's inputs and intermediates, the cells that
    differ (`differ` of `cells`) and the largest difference of each kernel
    from its plain version (`errs`)."""
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

    one = {k: CLUSTER_KERNELS.get(k, 0) for k in _want()}
    _reset_launches()
    got = stage()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"cluster moments, {name}: launches {counts} != {one}")
    differ, cells = cluster_gap(got, plain.extract_cluster_moments(
        tri, dense, comp_overflow=ovf, **kw), f"cluster moments, {name}, against the plain one")
    if not all(_same(a, b) for a, b in zip(stage(), got)):
        raise AssertionError(f"cluster moments, {name}: two calls differ")
    _replay_equals(stage, got, f"cluster moments, {name}")
    ne = cmk.edge_count(tri, dense)
    rows, sorted_tiles, sort_checks = sort_steps(tri, dense, ne, E)
    tiles, seg, seg_pairs = segment_pairs(rows.key, ne, ovf, skw)
    mom = cmk.slot_moments(rows.pay, seg.top_pos, seg.count, E2)
    momp = plain.slot_moments_plain(rows.pay, seg.top_pos, seg.count, E2)
    checks = {"edge_count": [(ne, plain.edge_count_plain(tri, dense))], **sort_checks,
              **seg_pairs,
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
    return dict(tri=tri, dense=dense, ovf=ovf, kw=kw, E=E, E2=E2, skw=skw, ne=ne, rows=rows,
                kept=sorted_tiles.kept, tiles=tiles, seg=seg, mom=mom,
                got=got, differ=differ, cells=cells, errs=errs, stage=stage)


def _own_candidates(tiles):
    """A SegmentTiles' candidates, each tile's entries past its count (which
    the kernel leaves unwritten) set to 0 as segment_tiles_plain has them."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cluster_moments import SEG_TILE

    B = tiles.stats.shape[0]
    own = torch.arange(SEG_TILE, device=tiles.cand.device) < tiles.stats[:, 1, :, None]
    return torch.where(own.reshape(B, -1), tiles.cand, 0)


def segment_pairs(key_s, ne, ovf, skw: dict):
    """The two segment kernels on (B, N) sorted keys beside their plain
    versions: (tiles, TopSegments, {kernel: [(got, want), ...]}): the tiles
    kernel's fields, histogram, valid keys and candidates against
    segment_tiles_plain; the top kernel on the kernel's tiles against
    segment_top_plain on them and against top_segments_plain on the keys."""
    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    tkw = dict(E=skw["E"], min_cluster_pixels=skw["min_cluster_pixels"],
               max_perimeter=skw["max_perimeter"])
    tiles = cmk.segment_tiles(key_s, ne, **tkw)
    want = plain.segment_tiles_plain(key_s, ne, **tkw)
    seg = cmk.segment_top(tiles, ne, ovf, **skw)
    return tiles, seg, {
        "segment_tiles": [(tiles.stats, want.stats), (tiles.hist, want.hist),
                          (tiles.nv, want.nv), (_own_candidates(tiles), want.cand)],
        "segment_top": list(zip(seg, plain.segment_top_plain(tiles, ne, ovf, **skw)))
        + list(zip(seg, plain.top_segments_plain(key_s, ne, ovf, **skw)))}


def check_segment_row(name: str, dev) -> dict:
    """One of SEGMENT_ROWS on the card: top_segments (the two segment
    kernels, one launch each) against top_segments_plain on every field,
    two calls and a captured replay equal, and each kernel against its
    plain version (segment_pairs). Raises on a difference; returns each
    kernel's largest difference from its plain version."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    keys, num_edge, comp_overflow, skw = segment_rows()[name]
    key_s, ne, ovf = (torch.from_numpy(a).to(dev) for a in (keys, num_edge, comp_overflow))

    def call():
        return cmk.top_segments(key_s, ne, ovf, **skw)

    one = {k: int(k in ("segment_tiles", "segment_top")) for k in _want()}
    _reset_launches()
    got = call()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"segments, {name}: launches {counts} != {one}")
    for f, a, b in zip(got._fields, got, plain.top_segments_plain(key_s, ne, ovf, **skw)):
        if not _same(a, b):
            raise AssertionError(f"segments, {name}: {f} differs from top_segments_plain")
    if not all(_same(a, b) for a, b in zip(call(), got)):
        raise AssertionError(f"segments, {name}: two calls differ")
    _replay_equals(call, got, f"segments, {name}")
    errs = {}
    for k, pairs in segment_pairs(key_s, ne, ovf, skw)[2].items():
        errs[k] = max(_max_abs_err(a, b) for a, b in pairs)
        if not all(_same(a, b) for a, b in pairs):
            raise AssertionError(f"{k} kernel, {name}: differs from its plain version")
    return errs


def sort_row_start(key, pay, kept):
    """(B, N) int32 keys and pays and (B,) kept counts on the card as the
    first pass leaves a sort: (SortRows stably sorted by the first digit
    (radix_scatter_plain), PairTiles with the kept counts, every pass's
    digit counts (none by offset: rows have no pixels) and zeroed look-back
    words and counters)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain

    B, N = key.shape
    i32 = dict(dtype=torch.int32, device=key.device)
    npass, R, R0 = SORT_PASSES, plain.RADIX, plain.FIRST_DIGITS
    T = -(-N // plain.sort_tile(B, N))
    tiles = plain.PairTiles(
        kept=kept, digits=torch.stack([plain.digit_counts_plain(key, kept, k)
                                       for k in range(npass)]),
        offset_digits=torch.zeros((B, 4, R0), **i32), tile_counts=torch.zeros((B, 4, 1, R0), **i32),
        group_sums=torch.zeros((B, 4, 1, R0), **i32),
        look=torch.zeros((npass - 1, B, T, R), **i32), ctl=torch.zeros((B, npass), **i32))
    return plain.radix_scatter_plain(plain.SortRows(key=key, pay=pay), tiles, 0), tiles


def check_sort_row(name: str, dev) -> float:
    """One of SORT_ROWS through the later radix passes alone on the card,
    from the plain first pass: a launch of the scatter
    kernel a pass, the sorted keys and pays equal to numpy's stable argsort
    of each frame's keys, each pass against radix_scatter_plain, two calls
    and a captured replay equal. Raises on a difference; returns the
    largest one."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    keys, pays, kept, E = sort_rows()[name]
    key, pay, K = (torch.from_numpy(a).to(dev) for a in (keys, pays, kept))
    want_key = np.full_like(keys, np.iinfo(np.int32).max)
    want_pay = np.zeros_like(pays)
    for b, n in enumerate(kept):
        order = np.argsort(keys[b, :n], kind="stable")
        want_key[b, :n], want_pay[b, :n] = keys[b, order], pays[b, order]
    want = (torch.from_numpy(want_key).to(dev), torch.from_numpy(want_pay).to(dev))

    def call():
        rows, tiles = sort_row_start(key, pay, K)
        spare = None
        for k in range(1, SORT_PASSES):
            moved = cmk.radix_scatter(rows, tiles, k, E=E, out=spare)
            spare, rows = (rows.key, rows.pay), moved
        return _live_rows(rows, K)

    one = {k: (SORT_PASSES - 1) * (k == "radix_scatter") for k in _want()}
    _reset_launches()
    got = call()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"sort rows, {name}: launches {counts} != {one}")
    _, pairs = radix_steps(*sort_row_start(key, pay, K), E)
    pairs += list(zip(got, want))
    if not all(_same(a, b) for a, b in pairs):
        raise AssertionError(f"sort rows, {name}: the passes differ from the plain passes or "
                             "from numpy's stable argsort")
    if not all(_same(a, b) for a, b in zip(call(), got)):
        raise AssertionError(f"sort rows, {name}: two calls differ")
    _replay_equals(call, got, f"sort rows, {name}")
    return max(_max_abs_err(a, b) for a, b in pairs)


def check_sort_frame(name: str, dev) -> dict:
    """One of SORT_FRAMES through the whole sort on the card: one launch of
    the histogram pass and one of the scatter kernel
    a pass, each kernel against its plain version and the rows against
    torch.sort of the padded row (sort_steps), at the frames' num_edge and
    at a quarter of it, two calls and a captured replay equal. Raises on a
    difference; returns each kernel's largest difference and the frames'
    kept counts, num_edge and E, and the kept counts and num_edge at the
    quarter."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    tri, dense, E = sort_frames()[name]
    tri, dense = torch.from_numpy(tri).to(dev), torch.from_numpy(dense).to(dev)
    ne = cmk.edge_count(tri, dense)
    errs, kept = {}, {}

    def call():
        rows, kept = cmk.sort_pairs(tri, dense, ne, E)
        return _live_rows(rows, kept)

    one = {k: {"pair_count": 1, "radix_scatter": SORT_PASSES}.get(k, 0) for k in _want()}
    _reset_launches()
    got = call()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"sort frames, {name}: launches {counts} != {one}")
    # num_edge cut to a quarter: a smaller stride keeps more pairs than
    # num_edge says the frame holds, and the sort must still take them all.
    for cut in (1, 4):
        _, tiles, checks = sort_steps(tri, dense, ne // cut, E)
        kept[cut] = tiles.kept.tolist()
        for k, pairs in checks.items():
            errs[k] = max([errs.get(k, 0.0)] + [_max_abs_err(a, b) for a, b in pairs])
            if not all(_same(a, b) for a, b in pairs):
                raise AssertionError(f"{k} kernel, sort frames, {name}, num_edge / {cut}: "
                                     "differs from its plain version or torch.sort")
    if not all(_same(a, b) for a, b in zip(call(), got)):
        raise AssertionError(f"sort frames, {name}: two calls differ")
    _replay_equals(call, got, f"sort frames, {name}")
    return dict(errs=errs, kept=kept[1], num_edge=ne.tolist(), E=E, kept_cut=kept[4],
                num_edge_cut=(ne // 4).tolist())


def _chain_ms(steps, iters: int) -> list[float]:
    """Mean device ms of each of `steps`, callables run in order (a chain of
    kernels, each on what the steps before it left), over `iters` runs of
    the chain queued behind a spin kernel (as _device_ms), with CUDA events
    between the steps."""
    import torch

    def chain():
        for f in steps:
            f()

    for _ in range(3):
        chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        chain()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
             for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * 2 * issue_s) + 1000)
    for ev in marks:
        ev[0].record()
        for f, e in zip(steps, ev[1:]):
            f()
            e.record()
    torch.cuda.synchronize()
    return [float(np.mean([ev[j].elapsed_time(ev[j + 1]) for ev in marks]))
            for j in range(len(steps))]


def cluster_profile() -> dict:
    """`chip_smoke.py --cluster-profile`, phase 23's child process: the
    cluster stage on backend 'cuda' at torch_bench.py's two shapes, warm,
    once under torch.profiler: no device kernel of a library sort or select
    (LIBRARY_SORT_NAMES), and each cluster kernel seen as often as its
    counter says. Returns, by shape, the kernels seen and the largest
    library kernels' names (none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    dev = torch.device("cuda")
    out = {}
    for config, batch in CAPTURE_CASES:
        cfg, _, inputs = bench_inputs(config, batch, dev, calls=1)
        tri, dense, ovf, kw = cluster_inputs(cfg, inputs[0])
        cmk.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)
        _reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cmk.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw)
            counts = _launches()
        names = _device_kernels(prof)
        seen = _profiled_kernels(prof)
        library = sorted({n for n in names if any(p in n.lower() for p in LIBRARY_SORT_NAMES)})
        if library:
            raise AssertionError(f"cluster stage b{batch}: library sort or select kernels ran: "
                                 f"{library[:3]}")
        if any(seen[k] != counts[k] for k in CLUSTER_KERNELS):
            raise AssertionError(f"cluster stage b{batch}: the profiler saw {seen}, the "
                                 f"counters say {counts}")
        out[f"b{batch}"] = dict(kernels=len(names), cluster={k: seen[k] for k in CLUSTER_KERNELS},
                                library=library)
    return out


def cluster_phase(gpu: str) -> dict:
    """Phase 23: check_cluster_case on each of cluster_cases, the segment
    kernels on SEGMENT_ROWS, the radix passes on SORT_ROWS and the whole sort
    on SORT_FRAMES, the profiler check of cluster_profile in a child
    process, and device times at torch_bench.py's two shapes. Returns kernel -> {max_abs_err, and for 'b1' (720p)
    and 'batch8' (1080p): shape, ms, plain_ms, bound_ms, library_ms; the
    radix scatter's also `first` and `later`: the first pass's and the
    later passes' ms, plain_ms, bound_ms}."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import cluster_moments as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    if plain.SORT_PASSES != SORT_PASSES:
        raise AssertionError("chip_smoke.SORT_PASSES differs from the package's")
    dev = torch.device("cuda")
    out = {k: {"max_abs_err": 0.0} for k in CLUSTER_KERNELS}
    lines, stage_ms, sort_ms, by_pass = [], {}, {}, {}
    for name, (cfg, images) in cluster_cases(dev).items():
        c = check_cluster_case(name, cfg, images)
        for k in CLUSTER_KERNELS:
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], c["errs"][k])
        tri, dense, ne, rows, kept, seg, mom = (
            c[k] for k in ("tri", "dense", "ne", "rows", "kept", "seg", "mom"))
        ovf, skw, E, E2 = c["ovf"], c["skw"], c["E"], c["E2"]
        B, H, W = tri.shape
        lines.append(f"{name} ({B}x{H}x{W}, E {E}, C {cfg.max_clusters}, E2 {E2}): kept pairs "
                     f"{int(kept.sum())} (frames past E {int((kept > E).sum())}); bin cells "
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
        tiles = c["tiles"]
        tkw = dict(E=E, min_cluster_pixels=skw["min_cluster_pixels"],
                   max_perimeter=skw["max_perimeter"])
        nv = int(tiles.nv.sum())
        cand_bytes = 4 * int(tiles.stats[:, 1].sum()) / HBM_BYTES_PER_S * 1e3
        resident = int(torch.clamp(seg.count.sum(-1), max=E2).sum())
        # The sort's bounds count the bytes the work needs, and not the
        # look-back words (scratch of this design, which stay in L2).
        K, px = int(kept.sum()), B * H * W
        fill = 4 * int(torch.clamp(E - kept, min=0).sum())
        key_pad = plain.edge_pairs_plain(tri, dense, ne, E)[0]
        torch_sort_ms = _device_ms(lambda: torch.sort(key_pad, dim=-1, stable=True), 10)
        tag = "b1" if B == 1 else f"batch{B}"
        state = {}
        steps = [lambda: state.update(t=cmk.pair_count(tri, dense, ne, E)),
                 lambda: state.update(r=cmk.radix_first(tri, dense, ne, state["t"], E))]
        steps += [lambda k=k: state.update(r=cmk.radix_scatter(state["r"], state["t"], k, E=E))
                  for k in range(1, SORT_PASSES)]
        # The digit counts of the frames: the first pass's R0 a frame (and
        # 4 R0 by offset), a later pass's R. The histogram pass reads tri
        # and dense and writes every pass's digit counts, the first pass's by
        # offset and K; the first pass reads the pixels, its digit counts (by
        # offset too) and K and writes 8 bytes a kept pair; a later pass
        # reads its digit counts and K, reads and writes 8 bytes a kept
        # pair; the last also writes the fill to E. The first pass's tile
        # counts and group sums are scratch of this design, in L2, and not
        # counted.
        first_bytes, later_bytes = 4 * plain.FIRST_DIGITS * B, 4 * plain.RADIX * B
        bound = [(5 * px + 5 * first_bytes + (SORT_PASSES - 1) * later_bytes + 4 * B)
                 / HBM_BYTES_PER_S * 1e3,
                 (5 * px + 5 * first_bytes + 4 * B + 8 * K) / HBM_BYTES_PER_S * 1e3]
        bound += [(later_bytes + 4 * B + 16 * K + (fill if k == SORT_PASSES - 1 else 0))
                  / HBM_BYTES_PER_S * 1e3 for k in range(1, SORT_PASSES)]
        main = dict(ms=_chain_ms(steps, 20), bound=bound,
                    sort=_device_ms(lambda: cmk.sort_pairs(tri, dense, ne, E), 20))
        by_pass[tag] = main["ms"]
        want_tiles = plain.pair_count_plain(tri, dense, ne, E)
        given = [plain.radix_first_plain(tri, dense, ne, want_tiles, E)]
        for k in range(1, SORT_PASSES - 1):
            given.append(plain.radix_scatter_plain(given[-1], want_tiles, k))
        first_plain = _device_ms(lambda: plain.radix_first_plain(tri, dense, ne, want_tiles, E), 5)
        later_plain = _device_ms(lambda: [plain.radix_scatter_plain(g, want_tiles, k)
                                          for k, g in enumerate(given, 1)], 5)
        timed = {
            "edge_count": (None, lambda: plain.edge_count_plain(tri, dense),
                           _bound_ms(tri, dense, ne)),
            "pair_count": (main["ms"][0], lambda: plain.pair_count_plain(tri, dense, ne, E),
                           main["bound"][0]),
            "radix_scatter": (sum(main["ms"][1:]), None, sum(main["bound"][1:])),
            # the valid prefix of the sorted keys, 4 bytes a key; the tiles'
            # fields, histogram and valid keys, and 4 bytes a candidate
            "segment_tiles": (None, lambda: plain.segment_tiles_plain(rows.key, ne, **tkw),
                              4 * nv / HBM_BYTES_PER_S * 1e3 + cand_bytes
                              + _bound_ms(ne, tiles.stats, tiles.hist, tiles.nv)),
            "segment_top": (None, lambda: plain.segment_top_plain(tiles, ne, ovf, **skw),
                            cand_bytes + _bound_ms(tiles.stats, tiles.hist, tiles.nv, ne, ovf,
                                                   *seg)),
            # each resident pair's pay, 4 bytes
            "moments": (None, lambda: plain.slot_moments_plain(rows.pay, seg.top_pos, seg.count,
                                                               E2),
                        4 * resident / HBM_BYTES_PER_S * 1e3
                        + _bound_ms(seg.top_pos, seg.count, *mom)),
        }
        alone = {"edge_count": lambda: cmk.edge_count(tri, dense),
                 "segment_tiles": lambda: cmk.segment_tiles(rows.key, ne, **tkw),
                 "segment_top": lambda: cmk.segment_top(tiles, ne, ovf, **skw),
                 "moments": lambda: cmk.slot_moments(rows.pay, seg.top_pos, seg.count, E2)}
        for k, (ms, twin, bound) in timed.items():
            out[k][tag] = dict(shape=[B, H, W], ms=ms if ms is not None else
                               _device_ms(alone[k], 20),
                               plain_ms=first_plain + later_plain if twin is None
                               else _device_ms(twin, 5), bound_ms=bound,
                               library_ms=torch_sort_ms if k == "radix_scatter" else None)
        # segment_top's library call: the one stable sort of the (B, E)
        # gated row that _top_c runs (the selection alone, not the crossing
        # segments' sizes or the gate).
        gated = plain.segment_gated_plain(tiles, ne, **tkw)[0]
        out["segment_top"][tag]["library_ms"] = _device_ms(
            lambda: torch.sort(-gated, dim=-1, stable=True), 10)
        out["radix_scatter"][tag].update(
            first=dict(ms=main["ms"][1], plain_ms=first_plain, bound_ms=main["bound"][1]),
            later=dict(ms=sum(main["ms"][2:]), plain_ms=later_plain,
                       bound_ms=sum(main["bound"][2:])))
        kw = c["kw"]
        # The whole sort's yardstick bound, fixed whatever the design (the
        # compaction's 5 bytes a pixel and 8 a kept pair; a pass's 4 a kept
        # pair for its histogram, then 8 read and 8 written); and the
        # design's own bound, the sum of its kernels'.
        sort_bound = (5 * px + 8 * K + SORT_PASSES * 20 * K) / HBM_BYTES_PER_S * 1e3
        sort_ms[tag] = dict(torch_sort=torch_sort_ms, bound=sort_bound, kept=K, ms=main["sort"],
                            share=sort_bound / main["sort"], own_bound=sum(main["bound"]),
                            own_share=sum(main["bound"]) / main["sort"])
        stage_ms[tag] = {
            "kernels": _device_ms(c["stage"], 10),
            "plain": _device_ms(lambda: plain.extract_cluster_moments(
                tri, dense, comp_overflow=ovf, **kw), 5)}
    for name in SEGMENT_ROWS:
        for k, e in check_segment_row(name, dev).items():
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
    for name in SORT_ROWS:
        out["radix_scatter"]["max_abs_err"] = max(out["radix_scatter"]["max_abs_err"],
                                                  check_sort_row(name, dev))
    frames = {}
    for name in SORT_FRAMES:
        f = check_sort_frame(name, dev)
        for k, e in f["errs"].items():
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
        frames[name] = {k: f[k] for k in ("kept", "num_edge", "E", "kept_cut", "num_edge_cut")}
    if not frames[SORT_FRAMES[3]]["kept"][0] > frames[SORT_FRAMES[3]]["E"]:
        raise AssertionError(f"{SORT_FRAMES[3]}: the frame must keep more pairs than E")
    if not any(k > n for f in frames.values() for k, n in zip(f["kept_cut"], f["num_edge_cut"])):
        raise AssertionError("no synthetic frame keeps more pairs than its cut num_edge")
    counted = {name: check_count_frame(name, dev) for name in COUNT_FRAMES}
    apart = {name: check_moment_row(name, dev) for name in MOMENT_ROWS}
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--cluster-profile"],
                           cwd=ROOT, capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"cluster profile exited {child.returncode}: "
                             f"{child.stderr[-3000:]}")
    profiled = json.loads(child.stdout.strip().splitlines()[-1])
    seg_ms = {t: out["segment_tiles"][t]["ms"] + out["segment_top"][t]["ms"]
              for t in ("b1", f"batch{BATCH}")}
    torch.cuda.synchronize()
    print(f"[23 cluster moments] the kernel path (launches a call {CLUSTER_KERNELS}) against "
          f"the plain version: counts, valid, dark side, centroid, scale, num_* and overflow "
          f"bit-exact, bin tables within one f32 ulp; each kernel against its plain version "
          f"(the sort's rows also against torch.sort of the padded row; the moments' tables "
          f"within one ulp); two calls and a captured replay equal: " + "; ".join(lines)
          + f"; the two segment kernels on the synthetic rows {list(SEGMENT_ROWS)}: equal to "
          f"top_segments_plain and each to its plain version, one launch each, two calls and a "
          f"captured replay equal; the later radix passes on the synthetic rows "
          f"{list(SORT_ROWS)} from the plain first pass: equal to numpy's "
          f"stable argsort and each pass to its plain version, a launch a pass, two calls and a "
          f"captured replay equal; the whole sort on the synthetic frames (kept pairs, "
          f"num_edge, E) {frames}: each kernel equal to its plain version "
          f"and the rows to torch.sort of the padded row; the pair count on the synthetic "
          f"frames (pairs; vector and scalar paths, one launch, bit-exact with "
          f"edge_count_plain, two calls and a captured replay equal) {counted}; the moments "
          f"kernel on the synthetic slot rows (table cells one ulp apart, of; the rest "
          f"bit-exact, one launch, two calls and a captured replay equal) {apart}; "
          f"torch.profiler in a child process "
          f"(kernels seen, cluster kernels, library sorts): {profiled}; on {gpu}: the sort "
          f"(pair_count, then the passes, with the memset; torch.sort of the padded row, the "
          f"yardstick bound by bytes, kept pairs, ms, share of the yardstick, the design's own "
          f"bound and share) {sort_ms}; each kernel's ms (histogram, first pass, later passes) "
          f"{by_pass}; the radix scatter kernel's "
          f"first and later passes (ms / plain / bound) "
          + ", ".join(f"{t} {p}: {out['radix_scatter'][t][p]['ms']:.4f} / "
                      f"{out['radix_scatter'][t][p]['plain_ms']:.4f} / "
                      f"{out['radix_scatter'][t][p]['bound_ms']:.4f}"
                      for t in ("b1", f"batch{BATCH}") for p in ("first", "later"))
          + f"; the two segment kernels summed {seg_ms} ms; "
          f"device ms a call of the stage (kernel path, the plain version's one-hot GEMM "
          f"formulation) {stage_ms}; a kernel a call (kernel / plain / bound / library ms, "
          f"share of the bound) "
          + ", ".join(f"{k} {t} {v[t]['shape']}: {v[t]['ms']:.4f} / {v[t]['plain_ms']:.4f} / "
                      f"{v[t]['bound_ms']:.4f} / {v[t]['library_ms']}, "
                      f"{v[t]['bound_ms'] / v[t]['ms']:.1%}" for k, v in out.items()
                      for t in ("b1", f"batch{BATCH}")), flush=True)
    return out


def resolve_cases(dev) -> dict:
    """Phase 24's inputs, RESOLVE_CASE_NAMES -> list of (call, keyword
    arguments, labels, validity, expected facts): torch_bench.py's 720p b1
    and 1080p b8 inputs, the 1080p b8 input at R = RESOLVE_SMALL_R and a
    speckle batch whose phase-1 groups pass R, each with the contraction
    (phase-1 labels), the final resolve in rank mode (phase-2 labels) and
    the flat-mode resolve (phase-1 labels); the synthetic flat frames of
    RESOLVE_SLOT_CASES and the R = 65536 clamp frame (labels max(p - 1, 0),
    one chain: with min_component_pixels 0 every group's dense id is 0,
    also past group 65535); SLOT_ROWS' frames, the final resolve and (flat
    rows) the contraction; a random frame's flat-mode resolve and
    contraction at each of ODD_R."""
    import dataclasses

    import torch

    from isaac_ros_apriltag_tpu_torch import DetectorConfig

    def front_calls(cfg, tri):
        valid, lab1, lab2, table, R, _ = labels_of(cfg, tri)
        res = dict(min_component_pixels=cfg.min_component_pixels, max_components=R,
                   chain_steps=cfg.ccl_resolve_steps)
        return [("roots_rank", dict(max_components=R, chain_steps=cfg.ccl_contraction_steps),
                 lab1, valid, {}),
                ("components", dict(res, rank_table=table), lab2, valid, {}),
                ("components", res, lab1, valid, {})]

    cases, bench = [], {}
    for config, batch in CAPTURE_CASES:
        cfg, _, inputs = bench_inputs(config, batch, dev, calls=1)
        bench[batch] = cfg, inputs[0]
        cases.append(front_calls(cfg, front_trinary(cfg, inputs[0])))
    cfg8, in8 = bench[BATCH]
    small = dataclasses.replace(cfg8, max_components=RESOLVE_SMALL_R)
    cases.append(front_calls(small, front_trinary(small, in8)))
    rng = np.random.default_rng(RESOLVE_SPECKLE["seed"])
    tri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8),
                                      size=RESOLVE_SPECKLE["shape"],
                                      p=RESOLVE_SPECKLE["p"])).to(dev)
    cfg = DetectorConfig(tag_size=TAG_SIZE)
    cases.append(front_calls(cfg, tri))
    side = RESOLVE_SYNTH_SIDE
    ones = torch.ones((1, side, side), dtype=torch.bool, device=dev)
    for g, eligible in RESOLVE_SLOT_CASES:
        lab = torch.arange(side * side, dtype=torch.int32)
        lab[g + 1] = g
        lab = lab.reshape(ones.shape).to(dev)
        cases.append([
            ("components", dict(min_component_pixels=2, max_components=RESOLVE_SLOT_R,
                                chain_steps=3), lab, ones, dict(n_eligible=eligible)),
            ("roots_rank", dict(max_components=RESOLVE_SLOT_R, chain_steps=3), lab, ones, {})])
    lab = (torch.arange(side * side, dtype=torch.int32) - 1).clamp(min=0)
    lab = lab.reshape(ones.shape).to(dev)
    cases.append([
        ("components", dict(min_component_pixels=0, max_components=1 << 16, chain_steps=17),
         lab, ones, dict(dense=0)),
        ("roots_rank", dict(max_components=1 << 16, chain_steps=17), lab, ones, {})])
    for lab, valid, R, steps, min_px, table in slot_rows().values():
        lab, valid = torch.from_numpy(lab).to(dev), torch.from_numpy(valid).to(dev)
        kw = dict(min_component_pixels=min_px, max_components=R, chain_steps=steps)
        if table is not None:
            kw["rank_table"] = torch.from_numpy(table).to(dev)
        cases.append([("components", kw, lab, valid, {})] + (
            [("roots_rank", dict(max_components=R, chain_steps=steps), lab, valid, {})]
            if table is None else []))
    rng = np.random.default_rng(11)
    lab = torch.from_numpy(rng.integers(0, 40000, (1, 200, 200), dtype=np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((1, 200, 200)) < 0.8).to(dev)
    cases.append([call for R in ODD_R for call in (
        ("components", dict(min_component_pixels=2, max_components=R, chain_steps=3), lab, valid,
         {}),
        ("roots_rank", dict(max_components=R, chain_steps=5), lab, valid, {}))])
    return dict(zip(RESOLVE_CASE_NAMES, cases, strict=True))


def check_resolve_call(what: str, call: str, kw: dict, lab, valid, facts: dict) -> dict:
    """One resolve call of phase 24: the kernel path against the twin bit
    for bit (every field; `facts`' n_eligible or dense id where given), one
    launch of each resolve kernel (_resolve_want), two calls and a captured
    replay equal, each kernel against its plain version on the inputs the
    call gave it, and the chain kernel's tables against the parent's form.
    Raises on a difference; returns the kernels' inputs and
    outputs (`log`), each launched kernel's largest difference from its
    plain version (`errs`), the results and the stage and twin as
    functions."""
    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    rank = call == "roots_rank"
    twin_fn = plain.resolve_roots_rank if rank else plain.resolve_components
    kern_fn = rk.resolve_roots_rank if rank else rk.resolve_components
    tables = plain.resolve_roots_rank_tables if rank else plain.resolve_components_tables
    log = {}

    def recorded(name, fn):
        def run(*args):
            log[name] = (args, fn(*args))
            return log[name][1]
        return run

    def stage():
        return kern_fn(lab, valid, **kw)

    one = _resolve_want()
    _reset_launches()
    got = stage()
    counts = _launches()
    if counts != one:
        raise AssertionError(f"resolve {call}, {what}: launches {counts} != {one}")
    for i, (a, b) in enumerate(zip(got, twin_fn(lab, valid, **kw))):
        if not _same(a, b):
            raise AssertionError(f"resolve {call}, {what}: field {i} differs from the twin "
                                 f"(max abs err {_max_abs_err(a, b)})")
    if "n_eligible" in facts and int(got.n_eligible.sum()) != facts["n_eligible"]:
        raise AssertionError(f"{what}: n_eligible {got.n_eligible.tolist()}, not "
                             f"{facts['n_eligible']}")
    if "dense" in facts and not bool((got.dense == facts["dense"]).all()):
        raise AssertionError(f"{what}: a dense id other than {facts['dense']}")
    if not all(_same(a, b) for a, b in zip(stage(), got)):
        raise AssertionError(f"resolve {call}, {what}: two calls differ")
    _replay_equals(stage, got, f"resolve {call}, {what}")
    passes = plain.TablePasses(*(recorded(n, f) for n, f in (
        ("count", rk.count), ("scan", rk.scan), ("slots", rk.slots), ("final", rk.final),
        ("map", rk.map_pixels))))
    if not all(_same(a, b) for a, b in zip(tables(lab, valid, passes=passes, **kw), got)):
        raise AssertionError(f"resolve {call}, {what}: the recorded passes differ")
    (cl, cv, S), cnt = log["count"]
    (_, R), (inv, D, n_groups) = log["scan"]
    (_, _, _, table, fill), mapped = log["map"]
    tsum = rk.tile_sums(cnt)
    log["tiles"] = ((cnt,), tsum)
    # The chain kernel: the contraction's pass (slots) or the final resolve's (final).
    cargs, chained = log["slots"] if rank else log["final"]
    chain_fn, chain_plain = (rk.slots, plain.slots_plain) if rank else (rk.final,
                                                                         plain.final_plain)
    cplain = chain_plain(*cargs)
    checks = {"resolve_count": [(cnt, plain.count_plain(cl, cv, S))],
              "resolve_tiles": [(tsum, plain.tile_sums_plain(cnt))],
              "resolve_scan": list(zip(rk.scan_ranks(cnt, tsum, R), plain.scan_plain(cnt, R)))
              + list(zip((inv, D, n_groups), plain.scan_plain(cnt, R))),
              "resolve_chain": list(zip(chained, cplain)) + list(zip(chain_fn(*cargs), cplain)),
              "resolve_map": [(mapped, plain.map_plain(cl, cv, inv, table, fill))]}
    if not rank:
        composed = plain.dense_plain(*plain.slots_plain(*cargs[:7]), n_groups, cargs[7])
        checks["resolve_chain"] += list(zip(chained, composed))
    if not all(_same(a, b) for a, b in zip(chained, parent_chain_form(*cargs), strict=True)):
        raise AssertionError(f"resolve {call}, {what}: the chain kernel's tables differ from the "
                             f"parent's form")
    errs = {}
    for k, pairs in checks.items():
        errs[k] = max(_max_abs_err(a, b) for a, b in pairs)
        if not all(_same(a, b) for a, b in pairs):
            raise AssertionError(f"{k} kernel, {call}, {what}: differs from its plain version")
    return dict(log=log, errs=errs, got=got, stage=stage,
                twin=lambda: twin_fn(lab, valid, **kw))


def check_count_case(name: str, dev) -> float:
    """One of COUNT_CASES through the count kernel alone: one launch, equal
    to count_plain, two calls and a captured replay (the table's memset and
    the kernel) equal. Raises on a difference; returns the largest one."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    label, valid, S = count_case(name)
    cl, cv = torch.from_numpy(label).to(dev), torch.from_numpy(valid).to(dev)
    one = {k: int(k == "resolve_count") for k in _want()}
    _reset_launches()
    got = rk.count(cl, cv, S)
    counts = _launches()
    if counts != one:
        raise AssertionError(f"count, {name}: launches {counts} != {one}")
    want = plain.count_plain(cl, cv, S)
    if not (_same(got, want) and _same(rk.count(cl, cv, S), want)):
        raise AssertionError(f"count kernel, {name}: differs from count_plain")
    _replay_equals(lambda: rk.count(cl, cv, S), want, f"count kernel, {name}")
    return _max_abs_err(got, want)


def check_map_case(name: str, dev) -> float:
    """One of COUNT_CASES' label rows through the map kernel alone, with a
    random (B, S + 1) inv into a random (B, 301) table: one launch, equal to
    map_plain, two calls and a captured replay equal. Its 1001- and
    12345-pixel rows take the kernel's scalar instances, at 4 and 16 pixels
    a thread. Raises on a difference; returns the largest one."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    label, valid, S = count_case(name)
    rng = np.random.default_rng(1)
    B, R = label.shape[0], 300
    inv = torch.from_numpy(rng.integers(0, R + 1, (B, S + 1)).astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.integers(-5, 1 << 20, (B, R + 1)).astype(np.int32)).to(dev)
    cl, cv = torch.from_numpy(label).to(dev), torch.from_numpy(valid).to(dev)
    one = {k: int(k == "resolve_map") for k in _want()}
    _reset_launches()
    got = rk.map_pixels(cl, cv, inv, table, -7)
    counts = _launches()
    if counts != one:
        raise AssertionError(f"map, {name}: launches {counts} != {one}")
    want = plain.map_plain(cl, cv, inv, table, -7)
    if not (_same(got, want) and _same(rk.map_pixels(cl, cv, inv, table, -7), want)):
        raise AssertionError(f"map kernel, {name}: differs from map_plain")
    _replay_equals(lambda: rk.map_pixels(cl, cv, inv, table, -7), want, f"map kernel, {name}")
    return _max_abs_err(got, want)


def check_scan_row(name: str, cnt_np, R: int, dev) -> float:
    """One of SCAN_ROWS through the scan pass alone (its tile sums and scan
    launches): one launch of each, every output equal to scan_plain, two
    calls and a captured replay equal. Raises on a difference; returns the
    largest one."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    cnt = torch.from_numpy(cnt_np).to(dev)
    one = {k: int(k in ("resolve_tiles", "resolve_scan")) for k in _want()}
    _reset_launches()
    got = rk.scan(cnt, R)
    counts = _launches()
    if counts != one:
        raise AssertionError(f"scan, {name}: launches {counts} != {one}")
    want = plain.scan_plain(cnt, R)
    if not (all(_same(a, b) for a, b in zip(got, want))
            and all(_same(a, b) for a, b in zip(rk.scan(cnt, R), want))):
        raise AssertionError(f"scan kernels, {name}: differ from scan_plain")
    _replay_equals(lambda: rk.scan(cnt, R), want, f"scan kernels, {name}")
    return max(_max_abs_err(a, b) for a, b in zip(got, want))


def resolve_times(c: dict) -> dict:
    """Device ms of each resolve kernel the call launched (kernel, plain
    version, bound, library call; for the chain kernel the parent's form of
    its step, `parent_ms`) on one call's inputs (check_resolve_call's
    `log`)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import resolve as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk

    log = c["log"]
    (cl, cv, S), cnt = log["count"]
    (_, R), (inv, D, n_groups) = log["scan"]
    (_, _, _, table, fill), mapped = log["map"]
    tsum = log["tiles"][1]
    final = "final" in log
    cargs, chained = log["final" if final else "slots"]
    chain_fn, chain_plain = (rk.final, plain.final_plain) if final else (rk.slots,
                                                                         plain.slots_plain)
    B = cl.shape[0]
    # The chain kernel needs, a valid slot, its label (D), the pixel label
    # its parent reads, that label's slot (inv) and in rank mode the rank
    # table's pixel, in the final resolve its count; the frames' group
    # counts; and writes its outputs. Its rounds, totals and ranks stay in
    # shared memory.
    nv = int(torch.clamp(n_groups, max=R).sum())
    rank_table = cargs[5] if len(cargs) > 5 else None
    per_slot = 4 * (3 + (rank_table is not None) + final)
    chain_ms = _bytes_ms(nv * per_slot + n_groups.numel() * 4
                         + sum(t.numel() * t.element_size() for t in chained))
    # The library yardsticks: one scatter_add_ of the pixels' keys, one
    # cumsum of the presence table, one gather of a per-label table.
    key = torch.where(cv & (cl >= 0) & (cl < S), cl.to(torch.int64), S)
    ones = torch.ones(key.shape, dtype=torch.int32, device=cl.device)
    acc = torch.zeros((B, S + 1), dtype=torch.int32, device=cl.device)
    present = (cnt > 0).to(torch.int32)
    lut = torch.cat([torch.gather(table, 1, inv.to(torch.int64)),
                     torch.full((B, 1), fill, dtype=torch.int32, device=cl.device)], 1)
    pix = torch.where(key < S, key, S + 1)
    timed = {
        "resolve_count": (lambda: rk.count(cl, cv, S), lambda: plain.count_plain(cl, cv, S),
                          _bound_ms(cl, cv, cnt), lambda: acc.scatter_add_(1, key, ones)),
        "resolve_tiles": (lambda: rk.tile_sums(cnt), lambda: plain.tile_sums_plain(cnt),
                          _bound_ms(cnt, tsum), None),
        "resolve_scan": (lambda: rk.scan_ranks(cnt, tsum, R), lambda: plain.scan_plain(cnt, R),
                         _bound_ms(cnt, tsum, inv, D, n_groups),
                         lambda: torch.cumsum(present, -1)),
        "resolve_map": (lambda: rk.map_pixels(cl, cv, inv, table, fill),
                        lambda: plain.map_plain(cl, cv, inv, table, fill),
                        _bound_ms(cl, cv, inv, table, mapped), lambda: torch.gather(lut, 1, pix)),
    }
    timed["resolve_chain"] = (lambda: chain_fn(*cargs), lambda: chain_plain(*cargs), chain_ms,
                              None)
    parent = {"resolve_chain": lambda: parent_chain_form(*cargs)}
    if not _same(torch.gather(lut, 1, pix).to(torch.int32), mapped):
        raise AssertionError("the map's library yardstick computes another function")
    out = {k: dict(ms=_device_ms(kern, 20), plain_ms=_device_ms(twin, 5), bound_ms=bound,
                   library_ms=_device_ms(lib, 20) if lib else None,
                   parent_ms=_device_ms(parent[k], 5) if k in parent else None)
           for k, (kern, twin, bound, lib) in timed.items()}
    # The count's integer atomics follow its runs: maximal spans of one counted label.
    counted = key < S
    starts = counted.clone()
    starts[:, 1:] &= key[:, 1:] != key[:, :-1]
    out["resolve_count"]["runs"] = int(starts.sum())
    out["resolve_chain"]["R"] = R
    return out


def resolve_phase(gpu: str) -> dict:
    """Phase 24: check_resolve_call on each call of resolve_cases, and device
    times at torch_bench.py's two shapes. Returns kernel -> {max_abs_err,
    and for 'b1' (720p) and 'batch8' (1080p): shape, ms, plain_ms,
    bound_ms, library_ms, each summed over a detect call's two resolve
    calls (the contraction and the rank-mode resolve), parent_ms for the
    chain kernel, and by_call}; the chain kernel's also
    max_active_clusters (cudaOccupancyMaxActiveClusters, the frames the
    card runs at once, by pass and R)."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
    import torch

    dev = torch.device("cuda")
    out = {k: {"max_abs_err": 0.0} for k in RESOLVE_KERNELS}
    lines, stage_lines = [], []
    bench_names = {f"{config} b{batch}": batch for config, batch in CAPTURE_CASES}
    for name, calls in resolve_cases(dev).items():
        facts = []
        for call, kw, lab, valid, expect in calls:
            c = check_resolve_call(name, call, dict(kw), lab, valid, expect)
            for k, e in c["errs"].items():
                out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
            mode = ("contraction" if call == "roots_rank" else
                    "rank mode" if "rank_table" in kw else "flat mode")
            (_, _, S), _ = c["log"]["count"]
            (_, R), (_, _, n_groups) = c["log"]["scan"]
            ovf = c["got"][2] if call == "roots_rank" else c["got"].overflow
            facts.append(f"{mode} (S {S}, R {R}): groups {n_groups.tolist()}, overflow "
                         f"{ovf.tolist()}")
            if name not in bench_names:
                continue
            stage_ms, twin_ms = _device_ms(c["stage"], 10), _device_ms(c["twin"], 5)
            stage_lines.append(f"{name} {mode}: kernel path {stage_ms:.4f}, twin {twin_ms:.4f}, "
                               f"bound {_bound_ms(lab, valid, *c['got']):.4f}")
            if mode == "flat mode":
                continue          # the detect call runs the contraction and the rank mode
            batch = bench_names[name]
            tag = "b1" if batch == 1 else f"batch{batch}"
            for k, t in resolve_times(c).items():
                acc = out[k].setdefault(tag, dict(shape=list(lab.shape), ms=0.0, plain_ms=0.0,
                                                  bound_ms=0.0, library_ms=None, parent_ms=None,
                                                  by_call={}))
                for f in ("ms", "plain_ms", "bound_ms"):
                    acc[f] += t[f]
                for f in ("library_ms", "parent_ms"):
                    if t[f] is not None:
                        acc[f] = (acc[f] or 0.0) + t[f]
                acc["by_call"][mode] = t
        lines.append(f"{name}: " + "; ".join(facts))
    scanned = {}
    for name, (cnt, R) in scan_rows().items():
        e = check_scan_row(name, cnt, R, dev)
        for k in ("resolve_tiles", "resolve_scan"):
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
        scanned[name] = int((cnt > 0).sum())
    for name in COUNT_CASES:
        out["resolve_count"]["max_abs_err"] = max(out["resolve_count"]["max_abs_err"],
                                                  check_count_case(name, dev))
        out["resolve_map"]["max_abs_err"] = max(out["resolve_map"]["max_abs_err"],
                                                check_map_case(name, dev))
    R_bench = sorted({out["resolve_chain"][t]["by_call"]["contraction"]["R"]
                      for t in ("b1", f"batch{BATCH}")} | {1 << 16})
    clusters = {f"{what} R {R}": rk.chain_clusters(what == "final", R)
                for what in ("contraction", "final") for R in R_bench}
    out["resolve_chain"]["max_active_clusters"] = clusters
    torch.cuda.synchronize()
    print(f"[24 resolve] the kernel path (one launch of each of {list(RESOLVE_KERNELS)} a "
          f"resolve call) against the twin bit for bit on every field, two calls and a captured "
          f"replay equal, each kernel against its plain version bit for bit (the chain kernel "
          f"in a final resolve also against dense_plain after slots_plain), the chain kernel's "
          f"tables equal to the parent's form: "
          + " | ".join(lines) + f"; the scan pass alone (tile sums and scan) on the synthetic "
          f"tables (present entries) {scanned}: equal to scan_plain, one launch each, two calls "
          f"and a captured replay equal"
          + f"; the count and map kernels alone on {list(COUNT_CASES)}: equal "
          f"to count_plain and map_plain, one launch, two calls and a captured replay equal; on "
          f"{gpu}: device "
          f"ms a call of the stage "
          + "; ".join(stage_lines) + "; a kernel a detect call (the contraction's and the "
          "rank-mode resolve's summed; kernel / plain / bound / library ms) "
          + ", ".join(f"{k} {t} {v[t]['shape']}: {v[t]['ms']:.4f} / {v[t]['plain_ms']:.4f} / "
                      f"{v[t]['bound_ms']:.4f} / {v[t]['library_ms']}"
                      for k, v in out.items() for t in ("b1", f"batch{BATCH}"))
          + "; the chain kernel against the parent's form of its step (kernel / parent ms, "
          "share of bound) " + ", ".join(
              f"{t}: {out['resolve_chain'][t]['ms']:.4f} / "
              f"{out['resolve_chain'][t]['parent_ms']:.4f}, "
              f"{out['resolve_chain'][t]['bound_ms'] / out['resolve_chain'][t]['ms']:.1%}"
              for t in ("b1", f"batch{BATCH}"))
          + f"; the chain kernel's clusters resident at once (8 blocks each) {clusters}"
          + "; resolve_map against its gather (kernel / gather ms, share of bound) "
          + ", ".join(f"{t}: {out['resolve_map'][t]['ms']:.4f} / "
                      f"{out['resolve_map'][t]['library_ms']:.4f}, "
                      f"{out['resolve_map'][t]['bound_ms'] / out['resolve_map'][t]['ms']:.1%}"
                      for t in ("b1", f"batch{BATCH}"))
          + "; by call (the count's runs: its labels' maximal spans in a row of pixels): "
          + json.dumps({k: {t: v[t]["by_call"] for t in ("b1", f"batch{BATCH}")}
                        for k, v in out.items()}), flush=True)
    return out


def synthetic_bins(w, px, py, K: int = 64) -> np.ndarray:
    """(6, K) float64 bin tables w, x, y, xx, xy, yy of w points at (px, py)
    a bin (each broadcast to K bins)."""
    w, px, py = (np.broadcast_to(np.asarray(v, np.float64), (K,)) for v in (w, px, py))
    return np.stack([w, w * px, w * py, w * px * px, w * px * py, w * py * py])


def periodic_bins(seed: int, period: int, K: int = 64) -> np.ndarray:
    """synthetic_bins of small integers that repeat every `period` bins:
    every prefix sum is exact in f32, so windows and arcs `period` bins
    apart tie exactly."""
    rng = np.random.default_rng(seed)
    return synthetic_bins(*(np.tile(rng.integers(lo, hi, period), K // period)
                            for lo, hi in ((1, 5), (-6, 7), (-6, 7))), K=K)


def moved_bins(seed: int, K: int = 64) -> np.ndarray:
    """synthetic_bins of 2 points a bin at the centroid but in three bins,
    moved to random integer points: one to three corner candidates."""
    rng = np.random.default_rng(seed)
    px, py = np.zeros(K), np.zeros(K)
    moved = rng.choice(K, 3, replace=False)
    px[moved], py[moved] = rng.integers(-9, 10, (2, 3))
    return synthetic_bins(2.0, px, py, K)


def prefix_of_bins(bins):
    """(N, 6, K) bins -> (N, 6, K+1) f32 prefix tables on the CPU, as
    ops/quadfit.py::prefix_tables builds them from ClusterMoments."""
    import torch

    b = torch.from_numpy(np.asarray(bins, np.float32))
    return torch.cat([torch.zeros(*b.shape[:-1], 1), torch.cumsum(b, -1)], -1)


def quadfit_synthetic_rows(rng, K: int = 64) -> dict:
    """Phase 25's first synthetic clusters, kind -> (n, 6, K) float64 bin
    tables: integer bins that repeat every 4 or 8 bins (exact f32 sums:
    sixteen or eight tied maxima, tied 4-subsets), every 16 bins turned so a
    candidate sits at bin 63 (the arc after it starts at K), flat bins with
    three bins moved (one to three candidates), empty bins (an invalid
    slot), random bins (drawn from `rng`), and bins holding an inf (one a
    NaN 4-subset error) or a NaN."""
    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain

    rows = {"ties": [periodic_bins(seed, p, K) for p in (4, 8) for seed in range(4)],
            "bin 63": []}
    for seed in range(4):
        b = periodic_bins(seed, 16, K)
        first = int(plain.candidates(prefix_of_bins(b[None]))[0, 0])
        rows["bin 63"].append(np.roll(b, (K - 1 - first) % 16, -1))
    rows["few candidates"] = [moved_bins(seed, K) for seed in range(6)]
    rows["empty"] = [np.zeros((6, K))]
    rows["random"] = [rng.normal(0.0, 3.0, (6, K)) for _ in range(4)]
    rows["random"] += [synthetic_bins(rng.integers(1, 6, K), rng.normal(0, 1, K),
                                      rng.normal(0, 1, K), K) for _ in range(4)]
    rows["NaN and inf"] = []
    for bad, f in ((np.inf, 1), (np.nan, 0), (np.inf, 3)):
        b = periodic_bins(5, 8, K)
        b[f, 21] = bad
        rows["NaN and inf"].append(b)
    return {k: np.stack(v) for k, v in rows.items()}


def counted_bins(n: int, K: int = 64, start: int = 0) -> tuple[np.ndarray, int]:
    """(synthetic_bins of flat bins with 7 to 13 bins moved to random
    integer points, whose clusters have exactly n corner candidates and a
    valid 4-subset; the seed after the one taken), from seed `start` on."""
    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain

    for seed in range(start, start + 10000):
        rng = np.random.default_rng(seed)
        moved = rng.choice(K, 7 + seed % 7, replace=False)
        px, py = np.zeros(K), np.zeros(K)
        px[moved], py[moved] = rng.integers(-9, 10, (2, len(moved)))
        b = synthetic_bins(2.0, px, py, K)
        S = prefix_of_bins(b[None])
        if (int((plain.candidates(S) < K).sum()) == n
                and bool(plain.search_plain(S).best_err.isfinite().all())):
            return b, seed + 1
    raise AssertionError(f"no seed gives {n} candidates")


def quadfit_counted(K: int = 64) -> np.ndarray:
    """Phase 25's second synthetic clusters, (39, 6, K) float64 bin tables:
    for each of QUADFIT_COUNTS, four clusters with that many candidates
    (counted_bins), each also turned so that its first candidate sits at bin
    0 and so that its last sits at bin 63; then tied maxima (bins repeating
    every 16: four tied periods), and an inf and a NaN bin.
    39 clusters: no multiple of the kernel's clusters a block."""
    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain

    rows, seed = [], 0
    for n in QUADFIT_COUNTS:
        for _ in range(4):
            b, seed = counted_bins(n, K, seed)
            cand = plain.candidates(prefix_of_bins(b[None]))[0, :n]
            rows += [b, np.roll(b, -int(cand[0]), -1), np.roll(b, K - 1 - int(cand[-1]), -1)]
    rows.append(periodic_bins(3, 16, K))
    for bad, f in ((np.inf, 2), (np.nan, 4)):
        b = periodic_bins(6, 8, K)
        b[f, 40] = bad
        rows.append(b)
    return np.stack(rows)


def bins_moments(bins, dev, rng):
    """(N, 6, K) bin tables -> ClusterMoments on `dev`: count 128 and valid
    where any bin holds weight, else count 0 and not valid; centroids and
    scales drawn from `rng`."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.cluster_moments import ClusterMoments

    b = torch.from_numpy(np.asarray(bins, np.float32)).to(dev)
    N = b.shape[0]
    valid = (b[:, 0] != 0).any(-1)
    z = torch.zeros(N, dtype=torch.int32, device=dev)
    return ClusterMoments(
        *b.unbind(1), count=torch.where(valid, 128, 0).to(torch.int32),
        centroid=torch.from_numpy(rng.uniform(50, 500, (N, 2)).astype(np.float32)).to(dev),
        scale=torch.from_numpy(rng.uniform(5, 40, N).astype(np.float32)).to(dev),
        dark_inside=valid.clone(), valid=valid, num_clusters=z, num_eligible=z,
        num_edge_points=z, edge_stride=z, overflow=z.bool())


def quadfit_synthetic(dev, K: int = 64):
    """Phase 25's first synthetic clusters (quadfit_synthetic_rows, in its
    order) as ClusterMoments on `dev`."""
    rng = np.random.default_rng(9)
    return bins_moments(np.concatenate(list(quadfit_synthetic_rows(rng, K).values())), dev, rng)


def quadfit_cases(dev) -> dict:
    """Phase 25's inputs, QUADFIT_CASE_NAMES -> (cluster moments on `dev`,
    min_area): the cluster stage's moments (kernel path) of torch_bench.py's
    720p b1 and 1080p b8 inputs, of node-720p-b1's frame 23 at seed 1 (the
    capacity edge, ROADMAP Queue 3) and of 8 blank 1080p frames;
    quadfit_synthetic, quadfit_counted, and one cluster of five candidates
    alone."""
    import torch

    import torch_bench
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    def moments(cfg, images):
        tri, dense, ovf, kw = cluster_inputs(cfg, images)
        return (cmk.extract_cluster_moments(tri, dense, comp_overflow=ovf, **kw),
                64.0 / cfg.quad_decimate ** 2)

    (cfg1, _, in1), (cfg8, _, in8) = (bench_inputs(config, batch, dev, calls=1)
                                      for config, batch in CAPTURE_CASES)
    config, frame, seed = QUADFIT_EDGE
    cam = torch_bench.config_camera(torch_bench.load_spec()["configs"][config])
    edge = torch.from_numpy(torch_bench.render_frame(cam, frame, seed)[1])[None].to(dev)
    return dict(zip(QUADFIT_CASE_NAMES, (
        moments(cfg1, in1[0]), moments(cfg8, in8[0]), moments(cfg1, edge),
        moments(cfg8, torch.zeros_like(in8[0])), (quadfit_synthetic(dev), 16.0),
        (bins_moments(quadfit_counted(), dev, np.random.default_rng(10)), 16.0),
        (bins_moments(counted_bins(5)[0][None], dev, np.random.default_rng(11)), 16.0))))


def _selector_arc_sums(S, a, b):
    """The parent's arc sums, kept as phase 25's library yardstick: one
    {-1, 0, 1} (N, P, K+1) f32 selector and one torch.bmm a table (the
    reference's formulation); ops/quadfit.py::_arc_sums's signature."""
    import torch

    N, T, K1 = S.shape
    K = K1 - 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    shape = (N,) + tuple(shape[1:])
    a = a.expand(shape).reshape(N, -1)
    b = b.expand(shape).reshape(N, -1)
    wrap = (b >= K)[..., None]
    iota = torch.arange(K1, device=a.device)
    ia = a.clamp(0, K)[..., None]
    ib = (b + 1).clamp(0, K)[..., None]
    iw = (b - K + 1).clamp(0, K)[..., None]
    f32 = torch.float32
    sel = torch.where(wrap,
                      (iota == iw).to(f32) - (iota == ia).to(f32) + (iota == K).to(f32),
                      (iota == ib).to(f32) - (iota == ia).to(f32))
    return [torch.bmm(sel, S[:, t, :, None])[..., 0].reshape(shape) for t in range(T)]


def check_quadfit_case(name: str, m, min_area: float) -> dict:
    """One of phase 25's cases: the kernel against its plain version on the
    prefix tables (best, best_err and the six winner lines bit-exact, NaN
    equal to NaN), one launch a call, two calls and a captured replay
    equal; the fitting launch (search and epilogue) against the plain fit
    (search_plain, fit_epilogue) on every Quads field, one launch a call,
    two calls and a captured replay equal. Raises on a difference; returns
    the tables, the kernel's result, the quads and each cluster's count of
    candidates."""
    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk

    S = plain.prefix_tables(m)
    one = {k: int(k == "quadfit_search") for k in _want()}
    _reset_launches()
    got = qk.quad_search(S)
    counts = _launches()
    if counts != one:
        raise AssertionError(f"quad fit, {name}: launches {counts} != {one}")
    want = plain.search_plain(S)
    for f, a, b in zip(want._fields, got, want):
        if not _same(a, b):
            raise AssertionError(f"quad search kernel, {name}: {f} differs from the plain "
                                 f"version (max abs err {_max_abs_err(a, b)})")
    if not all(_same(a, b) for a, b in zip(qk.quad_search(S), got)):
        raise AssertionError(f"quad search kernel, {name}: two calls differ")
    _replay_equals(lambda: qk.quad_search(S), got, f"quad search kernel, {name}")
    _reset_launches()
    qa = qk.fit_quads_from_moments(m, min_area=min_area)
    counts = _launches()
    if counts != one:
        raise AssertionError(f"quad fit, {name}: launches {counts} != {one}")
    qb = plain.fit_quads_from_moments(m, min_area=min_area)
    for f, a, b in zip(qb._fields, qa, qb):
        if not _same(a, b):
            raise AssertionError(f"quad fit, {name}: {f} of the fitting launch differs from "
                                 "the plain search and epilogue")
    if not all(_same(a, b) for a, b in zip(qk.fit_quads_from_moments(m, min_area=min_area), qa)):
        raise AssertionError(f"quad fit, {name}: two calls differ")
    _replay_equals(lambda: qk.fit_quads_from_moments(m, min_area=min_area), qa,
                   f"quad fit, {name}")
    n_cand = (plain.candidates(S) < S.shape[-1] - 1).sum(-1)
    return dict(S=S, got=got, quads=qa, n_cand=n_cand)


def quadfit_phase(gpu: str) -> dict:
    """Phase 25: check_quadfit_case on each of quadfit_cases, and device
    times at torch_bench.py's two shapes of the kernel, its plain version,
    its bound and the library yardstick (_selector_arc_sums on the search's
    arcs), of the fitting launch alone against its bound, and of the stage
    (the prefix tables and the fitting launch; the plain fit; the parent's
    form, parent_fit_form: the search kernel and the epilogue's torch ops,
    these two as captured replays; the plain fit with the selector arc
    sums). Returns {max_abs_err (0: any difference raises), and for 'b1'
    (720p) and 'batch8' (1080p): shape, ms, plain_ms, bound_ms, bound_by,
    library_ms, fit, stage}."""
    import math
    from unittest import mock

    import torch

    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk

    dev = torch.device("cuda")
    out = {"max_abs_err": 0.0}
    lines = []
    bench = {f"{config} b{batch}": batch for config, batch in CAPTURE_CASES}
    for name, (m, min_area) in quadfit_cases(dev).items():
        c = check_quadfit_case(name, m, min_area)
        S, got, n_cand = c["S"], c["got"], c["n_cand"]
        combos = sum(math.comb(int(n), 4) for n in n_cand.tolist())
        lines.append(f"{name} ({S.shape[0]} clusters): candidates a cluster "
                     f"{torch.bincount(n_cand, minlength=11).tolist()} (0..10), valid 4-subsets "
                     f"{combos}, with a combo {int(torch.isfinite(got.best_err).sum())}, valid "
                     f"quads {int(c['quads'].valid.sum())}")
        if name == QUADFIT_CASE_NAMES[3] and bool(m.valid.any()):
            raise AssertionError(f"{name}: a blank batch must hold no valid cluster")
        if name not in bench:
            continue
        # Bound: the tables read once and the results written once, or the
        # f32 operations of 64 window fits and 4 arc fits a valid 4-subset.
        bytes_ms = _bound_ms(S, *got)
        ops_ms = (64 * S.shape[0] + 4 * combos) * ARC_FLOPS / F32_OPS_PER_S * 1e3
        kb = torch.arange(64, device=dev)[None]
        wa = (kb - 2) % 64
        cidx = plain.candidates(S)[:, plain._combos(dev)]
        c1 = torch.roll(cidx, -1, -1) + torch.where(torch.arange(4, device=dev) == 3, 64, 0)
        t = dict(shape=list(S.shape), ms=_device_ms(lambda: qk.quad_search(S), 20),
                 plain_ms=_device_ms(lambda: plain.search_plain(S), 5),
                 bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms
                 else "operations",
                 library_ms=_device_ms(lambda: (_selector_arc_sums(S, wa, wa + 4),
                                                _selector_arc_sums(S, cidx + 1, c1 - 1)), 5))
        with mock.patch.object(plain, "_arc_sums", _selector_arc_sums):
            selector_ms = _device_ms(lambda: plain.fit_quads_from_moments(m, min_area=min_area),
                                     5)
        # The fitting launch: the search's bound and the clusters' fields
        # read, the Quads written.
        fit_bytes = _bound_ms(S, m.centroid, m.scale, m.count, m.valid, *c["quads"][:2],
                              *c["quads"][3:])
        t["fit"] = dict(ms=_device_ms(lambda: qk.quad_fit(S, m, min_area=min_area), 20),
                        bound_ms=max(fit_bytes, ops_ms),
                        bound_by="bytes" if fit_bytes >= ops_ms else "operations")
        t["stage"] = {"kernel": _device_ms(lambda: qk.fit_quads_from_moments(
                          m, min_area=min_area), 20),
                      "plain": _graph_ms(lambda: plain.fit_quads_from_moments(
                          m, min_area=min_area), 20),
                      "parent_form": _graph_ms(lambda: parent_fit_form(m, min_area=min_area),
                                               20),
                      "selector_form": selector_ms}
        out["b1" if bench[name] == 1 else f"batch{bench[name]}"] = t
    torch.cuda.synchronize()
    print(f"[25 quad fit] qf_search_kernel (one launch a call) against its plain version "
          f"(best, best_err, the six winner lines bit-exact), two calls and a captured replay "
          f"equal; its fitting launch (search and epilogue) against the plain search and "
          f"fit_epilogue on every Quads field, one launch, two calls and a replay equal: "
          + "; ".join(lines) + f"; on {gpu}: device ms a call (kernel / plain / bound "
          "(by) / library: the selector arc sums), stage (kernel path / plain search / "
          "parent's form: the search kernel and the epilogue's torch ops / the selector "
          "form; plain and parent's form as captured replays), the fitting launch alone "
          "(kernel / bound (by)) "
          + ", ".join(f"{k} {v['shape']}: {v['ms']:.4f} / {v['plain_ms']:.4f} / "
                      f"{v['bound_ms']:.5f} ({v['bound_by']}) / {v['library_ms']:.4f}, stage "
                      f"{v['stage']['kernel']:.4f} / {v['stage']['plain']:.4f} / "
                      f"{v['stage']['parent_form']:.4f} / {v['stage']['selector_form']:.4f}, "
                      f"fitting launch {v['fit']['ms']:.4f} / {v['fit']['bound_ms']:.5f} "
                      f"({v['fit']['bound_by']})"
                      for k, v in out.items() if k != "max_abs_err"), flush=True)
    return out


def tail_frame(name: str, flip: int = 0, seed: int = 0, tag_id: int = 3,
               extra: bool = False):
    """Phase 26's one-tag frame: a tag of family `name` at 0.5 m seen
    through TAIL_K (noise 2), its code word with the first `flip` bits
    flipped. Returns the gray frame (240, 320) and the quads (C, 4, 2),
    float32: the tag's true corners (0.2 px noise) first, then TAIL_QUADS
    (and TAIL_EXTRA_QUADS with `extra`)."""
    import dataclasses

    from isaac_ros_apriltag_tpu_torch.models.families import get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import (project_corners, render_tags,
                                                           upright_pose)

    K = np.array(TAIL_K, np.float32)
    rng = np.random.default_rng(seed)
    fam = get_family(name)
    if flip:
        codes = fam.codes.copy()
        codes[tag_id] ^= np.uint64(((1 << flip) - 1) << (fam.nbits - flip))
        fam = dataclasses.replace(fam, codes=codes)
    t = np.array([rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03), 0.5])
    R = upright_pose(t, rng.uniform(-0.6, 0.6))
    gray = render_tags(K, TAIL_SIZE, [dict(family=fam, id=tag_id, R=R, t=t,
                                           tag_size=TAIL_TAG_SIZE)], noise=2.0, seed=seed)
    tag = project_corners(K, R, t, TAIL_TAG_SIZE) + rng.normal(0, 0.2, (4, 2))
    quads = np.array(TAIL_QUADS + (TAIL_EXTRA_QUADS if extra else ()), np.float32)
    return gray.astype(np.float32), np.concatenate([tag[None], quads]).astype(np.float32)


def large_codebook_family(kind: str, family=None):
    """tag36h11 with LARGE_CODEBOOKS[kind]'s codebook of LARGE_CODES codes
    (seeded), as a copy of `family` (default: the port's tag36h11; the
    tests pass the reference's)."""
    import dataclasses

    from isaac_ros_apriltag_tpu_torch.models.families import get_family

    fam = get_family("tag36h11") if family is None else family
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 1 << fam.nbits, LARGE_CODES, dtype=np.uint64)
    for at, bits in LARGE_CODEBOOKS[kind][0].items():
        codes[at] = fam.codes[3] ^ np.uint64(sum(1 << b for b in bits))
    return dataclasses.replace(fam, name=f"tag36h11, {LARGE_CODES} codes", codes=codes)


def tail_pose_corners(Ks, n_tags: int, seed: int = 5) -> np.ndarray:
    """(B, n_tags, 4, 2) float32 corners of tags at random poses (0.4 to
    1.5 m, in-plane turns up to 0.8 rad) seen through Ks[b], with 0.2 px
    noise."""
    from isaac_ros_apriltag_tpu_torch.utils.render import project_corners, upright_pose

    rng = np.random.default_rng(seed)
    out = np.empty((len(Ks), n_tags, 4, 2), np.float32)
    for b, K in enumerate(Ks):
        for i in range(n_tags):
            t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                          rng.uniform(0.4, 1.5)])
            R = upright_pose(t, rng.uniform(-0.8, 0.8))
            out[b, i] = project_corners(K, R, t, TAIL_TAG_SIZE) + rng.normal(0, 0.2, (4, 2))
    return out


def detect_tail_inputs(cfg, cam, images) -> dict:
    """The decode and pose kernels' inputs in an eager detect call of a
    (B, H, W) uint8 batch on the card, backend 'cuda': {"decode": (gray,
    the top-2T refined candidates, family, keyword arguments), "pose": (the
    top-T tags' corners, K, tag size), which the detect path poses in the
    finish's launch (finish_and_pose)}."""
    from unittest import mock

    from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as dk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk
    from isaac_ros_apriltag_tpu_torch.pipeline import batched_detect_fn

    seen = {}
    decode, pose, finish_pose = dk.decode_quads, pk.estimate_poses, tk.finish_and_pose

    def seen_decode(gray, corners, family, **kw):
        seen["decode"] = (gray, corners, family, kw)
        return decode(gray, corners, family, **kw)

    def seen_pose(corners, K, tag_size):
        seen["pose"] = (corners, K, tag_size)
        return pose(corners, K, tag_size)

    def seen_finish_pose(*args, **kw):
        sel, poses = finish_pose(*args, **kw)
        seen["pose"] = (sel.corners, args[4], args[5])
        return sel, poses

    with mock.patch.object(dk, "decode_quads", seen_decode), \
            mock.patch.object(pk, "estimate_poses", seen_pose), \
            mock.patch.object(tk, "finish_and_pose", seen_finish_pose):
        batched_detect_fn(cfg, cam, "mono8", capture=False)(images)
    return seen


def tail_cases(dev) -> dict:
    """Phase 26's inputs, TAIL_CASE_NAMES -> {"decode": (gray, corners,
    family, keyword arguments), "pose": (corners, K, tag size)} on `dev`:
    the kernels' inputs in a detect call of torch_bench.py's 720p b1 and
    1080p b8 inputs (detect_tail_inputs); tail_frame's frame of every family
    with TAIL_EXTRA_QUADS (its six quads also posed, with TAIL_K); tag36h11
    without sharpening and at max_hamming 0; tagCircle49h12 with its largest
    correctable count of bits flipped, at that max_hamming; a batch of
    three tag36h11 frames, whose pose takes tail_pose_corners through a
    (3, 3, 3) K, one per frame; a tag36h11 frame of three quads (the last
    block of two quads has one idle warp); and tag36h11's frame decoded
    with each of LARGE_CODEBOOKS, whose tag's (id, hamming) is also given
    as "expect"."""
    import torch

    from isaac_ros_apriltag_tpu_torch.models.families import get_family

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    K = on(np.array(TAIL_K, np.float32))
    cases = {}
    for config, batch in CAPTURE_CASES:
        cfg, cam, inputs = bench_inputs(config, batch, dev, calls=1)
        cases[f"{config} b{batch}"] = detect_tail_inputs(cfg, cam, inputs[0])

    def frame_case(name, frame, **kw):
        gray, quads = frame
        return {"decode": (on(gray), on(quads), get_family(name), kw),
                "pose": (on(quads), K, TAIL_TAG_SIZE)}

    for name in TAIL_FAMILIES:
        cases[name] = frame_case(name, tail_frame(name, extra=True))
    sharp0, ham0, flipped, batch, odd, nopiv = TAIL_CASE_NAMES[
        len(CAPTURE_CASES) + len(TAIL_FAMILIES):-len(LARGE_CODEBOOKS)]
    cases[sharp0] = frame_case("tag36h11", tail_frame("tag36h11", seed=1, extra=True),
                               decode_sharpening=0.0)
    cases[ham0] = frame_case("tag36h11", tail_frame("tag36h11", seed=2, extra=True),
                             max_hamming=0)
    flip = (get_family("tagCircle49h12").min_hamming - 1) // 2
    cases[flipped] = frame_case("tagCircle49h12",
                                tail_frame("tagCircle49h12", flip=flip, seed=2, extra=True),
                                max_hamming=flip)
    frames = [tail_frame("tag36h11", seed=s, tag_id=s + 3, extra=True) for s in range(3)]
    Ks = np.stack([np.array(TAIL_K, np.float32) * np.array([[1 + 0.1 * b], [1 + 0.1 * b], [1]],
                                                           np.float32) for b in range(3)])
    cases[batch] = {"decode": (on(np.stack([g for g, _ in frames])),
                               on(np.stack([q for _, q in frames])), get_family("tag36h11"), {}),
                    "pose": (on(tail_pose_corners(Ks, 4)), on(Ks), TAIL_TAG_SIZE)}
    cases[odd] = frame_case("tag36h11", tail_frame("tag36h11", seed=3))
    # Tag size 0: the elimination's pivots are not the structural ones
    # (ops/cuda/pose.py::standard_pivots), so pose_kernel<false> runs.
    cases[nopiv] = frame_case("tag36h11", tail_frame("tag36h11", seed=4, extra=True))
    cases[nopiv]["pose"] = (*cases[nopiv]["pose"][:2], 0.0)
    gray, quads = tail_frame("tag36h11", extra=True)
    for kind, (_, expect) in LARGE_CODEBOOKS.items():
        cases[f"{LARGE_CODES} codes, {kind}"] = {
            "decode": (on(gray), on(quads), large_codebook_family(kind), {}),
            "pose": (on(quads), K, TAIL_TAG_SIZE), "expect": expect}
    return cases


def _parent_homography(src, dst):
    """The parent's homography_from_correspondences: the 8x8 DLT system by
    torch.linalg.solve_ex (LAPACK's getrf/getrs on the card)."""
    import torch

    c = dst.mean(-2, keepdim=True)
    s = torch.clamp((dst - c).abs().mean((-2, -1)), min=1e-6)
    dstn = (dst - c) / s[..., None, None]
    x, y = src[..., 0], src[..., 1]
    u, v = dstn[..., 0], dstn[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    h = torch.linalg.solve_ex(A, torch.cat([u, v], -1)[..., None]).result[..., 0]
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*h.shape[:-1], 3, 3)
    row01 = Hn[..., :2, :] * s[..., None, None] + torch.stack(
        [c[..., 0, 0], c[..., 0, 1]], -1)[..., None] * Hn[..., 2:3, :]
    return torch.cat([row01, Hn[..., 2:3, :]], -2)


def parent_decode_form(gray, corners, family, *, max_hamming: int = 2,
                       decode_sharpening: float = 0.25):
    """The parent's decode_quads, phase 26's yardstick of the stage before
    its kernel: the same steps as torch ops (einsum homography and gray
    models, a LAPACK solve, float sums over the cells), ~350 of them."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import decode as D
    from isaac_ros_apriltag_tpu_torch.utils.geometry import inverse3x3

    dev = corners.device
    lead = corners.shape[:-2]
    tab = D._tables(family, dev)
    H = _parent_homography(tab.square.expand(*lead, 4, 2), corners)

    def sample(uv):
        ph = torch.cat([uv, torch.ones_like(uv[..., :1])], -1).expand(lead + (uv.shape[0], 3))
        q = torch.einsum("...ij,...nj->...ni", H, ph)
        return D._bilinear(gray, q[..., :2] / q[..., 2:3])

    def fit(uv, vals):
        A = torch.cat([torch.ones_like(uv[..., :1]), uv], -1).expand(lead + (uv.shape[0], 3))
        AtA = torch.einsum("...ni,...nj->...ij", A, A) + 1e-6 * torch.eye(3, device=dev)
        Atb = torch.einsum("...ni,...n->...i", A, vals)
        return torch.einsum("...ij,...j->...i", inverse3x3(AtA), Atb)

    def ev(m, uv):
        return m[..., 0:1] + m[..., 1:2] * uv[..., 0] + m[..., 2:3] * uv[..., 1]

    v_bits = sample(tab.uv_bits)
    thresh = 0.5 * (ev(fit(tab.uv_border, sample(tab.uv_border)), tab.uv_bits)
                    + ev(fit(tab.uv_outer, sample(tab.uv_outer)), tab.uv_bits))
    if decode_sharpening > 0:
        tw = family.total_width
        grid = torch.zeros((*lead, tw * tw), dtype=v_bits.dtype, device=dev)
        grid[..., tab.lin] = v_bits
        grid = grid.reshape(*lead, tw, tw)
        lap = (4.0 * grid - torch.roll(grid, 1, -2) - torch.roll(grid, -1, -2)
               - torch.roll(grid, 1, -1) - torch.roll(grid, -1, -1))
        v_bits = (grid + decode_sharpening * lap).reshape(*lead, tw * tw)[..., tab.lin]
    deviation = v_bits - thresh
    bits = deviation > 0
    wmask = bits.to(torch.float32)
    bmask = 1.0 - wmask
    wcnt, bcnt = wmask.sum(-1), bmask.sum(-1)
    wmean = torch.where(wcnt > 0, (deviation * wmask).sum(-1) / torch.clamp(wcnt, min=1.0),
                        torch.inf)
    bmean = torch.where(bcnt > 0, (-deviation * bmask).sum(-1) / torch.clamp(bcnt, min=1.0),
                        torch.inf)
    code = (bits[..., tab.perms].to(torch.int64) * tab.weights).sum(-1)
    ham = D._popcount64(code[..., None] ^ tab.codes)
    ham_min = ham.amin(-1)
    best_r = torch.argmin(ham_min, -1)
    best_h = torch.gather(ham_min, -1, best_r[..., None])[..., 0].to(torch.int32)
    best_id = torch.gather(torch.argmin(ham, -1), -1, best_r[..., None])[..., 0]
    idx = torch.remainder(torch.arange(4, device=dev) + torch.remainder(2 - best_r, 4)[..., None],
                          4)
    return D.DecodeResult(valid=best_h <= max_hamming, id=best_id.to(torch.int32),
                          hamming=best_h, margin=torch.minimum(wmean, bmean),
                          rotation=best_r.to(torch.int32),
                          corners=torch.gather(corners, -2, idx[..., None].expand(*lead, 4, 2)))


def parent_pose_form(corners, K, tag_size: float):
    """The parent's estimate_poses, phase 26's yardstick of the stage before
    its kernel: torch ops (a LAPACK solve, einsum, vector_norm, linalg.cross,
    the quaternion's argmax and gathers), ~320 of them."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.pose import Poses, _tag_corners
    from isaac_ros_apriltag_tpu_torch.utils.geometry import inverse3x3, orthonormalize_rotation

    obj = _tag_corners(corners.device) * (tag_size * 0.5)
    H = _parent_homography(obj.expand(corners.shape), corners)
    Kinv = inverse3x3(K.to(torch.float32))
    M = (torch.einsum("ij,...jk->...ik", Kinv, H) if K.ndim == 2
         else torch.einsum("bij,b...jk->b...ik", Kinv, H))
    m1, m2, m3 = M[..., 0], M[..., 1], M[..., 2]
    scale = 2.0 / torch.clamp(torch.linalg.vector_norm(m1, dim=-1)
                              + torch.linalg.vector_norm(m2, dim=-1), min=1e-12)
    scale = scale * torch.sign(m3[..., 2])
    r1, r2, t = m1 * scale[..., None], m2 * scale[..., None], m3 * scale[..., None]
    R = orthonormalize_rotation(torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], -1))
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    cands = torch.stack([
        torch.stack([1.0 + tr, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]], -1),
        torch.stack([m[2][1] - m[1][2], 1.0 + m[0][0] - m[1][1] - m[2][2], m[0][1] + m[1][0],
                     m[0][2] + m[2][0]], -1),
        torch.stack([m[0][2] - m[2][0], m[0][1] + m[1][0], 1.0 - m[0][0] + m[1][1] - m[2][2],
                     m[1][2] + m[2][1]], -1),
        torch.stack([m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1],
                     1.0 - m[0][0] - m[1][1] + m[2][2]], -1)], -2)
    pivots = torch.diagonal(cands, dim1=-2, dim2=-1)
    best = torch.argmax(pivots, -1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    lead = torch.gather(q, -1, torch.argmax(q.abs(), -1, keepdim=True))
    return Poses(rotation=R, translation=t, quaternion=q * torch.where(lead < 0, -1.0, 1.0))


def check_tail_case(name: str, case: dict) -> dict:
    """One of phase 26's cases: each tail kernel against its plain version
    bit for bit on every output (NaN equal to NaN), one launch a call, two
    calls and a captured replay equal, and the tag's decoded (id, hamming)
    where the case gives them ("expect"). Raises on a difference; returns
    {"decode": DecodeResult, "pose": Poses} of the kernels."""
    from isaac_ros_apriltag_tpu_torch.ops import decode as plain_decode
    from isaac_ros_apriltag_tpu_torch.ops import pose as plain_pose
    from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as dk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pk

    gray, corners, family, kw = case["decode"]
    out = {}
    for stage, kernel, plain, args, kwargs in (
            ("decode", dk.decode_quads, plain_decode.decode_quads, (gray, corners, family), kw),
            ("pose", pk.estimate_poses, plain_pose.estimate_poses, case["pose"], {})):
        one = {k: int(k == stage) for k in _want()}
        _reset_launches()
        got = kernel(*args, **kwargs)
        counts = _launches()
        if counts != one:
            raise AssertionError(f"{stage}, {name}: launches {counts} != {one}")
        want = plain(*args, **kwargs)
        for f, a, b in zip(want._fields, got, want):
            if not _same(a, b):
                raise AssertionError(f"{stage} kernel, {name}: {f} differs from the plain "
                                     f"version (max abs err {_max_abs_err(a, b)})")
        if not all(_same(a, b) for a, b in zip(kernel(*args, **kwargs), got)):
            raise AssertionError(f"{stage} kernel, {name}: two calls differ")
        _replay_equals(lambda: kernel(*args, **kwargs), got, f"{stage} kernel, {name}")
        if stage == "decode" and "expect" in case:
            seen = (int(got.id.flatten()[0]), int(got.hamming.flatten()[0]))
            if seen != case["expect"]:
                raise AssertionError(f"decode kernel, {name}: the tag decoded as (id, hamming) "
                                     f"{seen}, not {case['expect']}")
        out[stage] = got
    return out


def tail_phase(gpu: str) -> dict:
    """Phase 26: check_tail_case on each of tail_cases, and device times at
    torch_bench.py's two shapes of each tail kernel, its plain version, its
    bound (bytes: decode reads each sample's four taps, the corners, its
    tables and the codebook once and writes its results; pose reads the
    corners and K and writes its results) and the parent's form
    (parent_decode_form, parent_pose_form); the plain version and the
    parent's form, hundreds of small torch ops each, are timed as captured
    replays (_graph_ms). No library call computes either function. Returns {max_abs_err (0: any difference raises), and for 'b1'
    (720p) and 'batch8' (1080p): {decode, pose}: shape, ms, plain_ms,
    bound_ms, bound_by, library_ms, parent_ms}."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import decode as plain_decode
    from isaac_ros_apriltag_tpu_torch.ops import pose as plain_pose
    from isaac_ros_apriltag_tpu_torch.ops.cuda import decode as dk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import pose as pk

    out = {"max_abs_err": 0.0}
    lines = []
    bench = {f"{config} b{batch}": batch for config, batch in CAPTURE_CASES}
    for name, case in tail_cases(torch.device("cuda")).items():
        got = check_tail_case(name, case)
        dec = got["decode"]
        ids = sorted(set(dec.id[dec.valid].tolist()))
        lines.append(f"{name}: {dec.valid.numel()} quads, {int(dec.valid.sum())} valid (ids "
                     f"{ids[:8]}{' ...' if len(ids) > 8 else ''}), "
                     f"{got['pose'].translation.numel() // 3} tags posed")
        if name not in bench:
            continue
        gray, corners, family, kw = case["decode"]
        pc, K, tag_size = case["pose"]
        tab = plain_decode._tables(family, corners.device)
        n_samples = (corners.numel() // 8) * (tab.uv_border.shape[0] + tab.uv_outer.shape[0]
                                              + family.nbits)
        stages = {"decode": (dk.decode_quads, plain_decode.decode_quads, parent_decode_form,
                             (gray, corners, family), kw,
                             n_samples * 4 * 4 + sum(t.numel() * t.element_size() for t in (
                                 corners, tab.floats, tab.ints, tab.codes, *dec))),
                  "pose": (pk.estimate_poses, plain_pose.estimate_poses, parent_pose_form,
                           case["pose"], {},
                           sum(t.numel() * t.element_size() for t in (pc, K, *got["pose"])))}
        t = {}
        for stage, (kernel, plain, parent, args, kwargs, nbytes) in stages.items():
            t[stage] = dict(shape=list(args[1].shape if stage == "decode" else args[0].shape),
                            ms=_device_ms(lambda: kernel(*args, **kwargs), 20),
                            plain_ms=_graph_ms(lambda: plain(*args, **kwargs), 20),
                            bound_ms=_bytes_ms(nbytes), bound_by="bytes", library_ms=None,
                            parent_ms=_graph_ms(lambda: parent(*args, **kwargs), 20))
        out["b1" if bench[name] == 1 else f"batch{bench[name]}"] = t
    torch.cuda.synchronize()
    print(f"[26 tail] decode_kernel and pose_kernel (one launch a call each) against their "
          f"plain versions bit for bit on every output, two calls and a captured replay equal, "
          "the tag's id and hamming as expected past the 4096 staged codes: "
          + "; ".join(lines) + f"; on {gpu}: device ms a call (kernel / plain / bound (bytes) "
          "/ the parent's form, plain and parent's form as captured replays; no library call "
          "computes either) "
          + ", ".join(f"{k} {stage} {v['shape']}: {v['ms']:.4f} / {v['plain_ms']:.4f} / "
                      f"{v['bound_ms']:.5f} ({v['bound_ms'] / v['ms']:.1%} of bound) / "
                      f"{v['parent_ms']:.4f}"
                      for k, per in out.items() if k != "max_abs_err"
                      for stage, v in per.items()), flush=True)
    return out


def parent_refine_form(gray, corners, dark_inside, *, search_range: float = 2.0):
    """The refine_edges of the tree before the refine kernel, half of
    parent_select_refine_form: torch ops on (..., 4, 12, P) profiles (vector_norm, float
    sums over offsets and points), ~160 of them."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.refine import _bilinear
    from isaac_ros_apriltag_tpu_torch.utils.geometry import line_intersection

    dev = corners.device
    p0, p1 = corners, torch.roll(corners, -1, -2)
    centroid = corners.mean(-2, keepdim=True)
    e = p1 - p0
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-6)
    n = torch.stack([e[..., 1], -e[..., 0]], -1)
    mid = 0.5 * (p0 + p1)
    n = torch.where((n * (centroid - mid)).sum(-1, keepdim=True) >= 0, n, -n)
    alphas = (1.0 + torch.arange(12, dtype=torch.float32, device=dev)) / 13
    pts = p0[..., None, :] + alphas[:, None] * (p1 - p0)[..., None, :]
    prof_offs = torch.arange(-search_range - 1.0, search_range + 1.0 + 0.25, 0.5,
                             dtype=torch.float32, device=dev)
    base = pts[..., None, :] + prof_offs[:, None] * n[..., None, None, :]
    prof = _bilinear(gray, base[..., 0], base[..., 1])
    g_in, g_out, offs = prof[..., 4:], prof[..., :prof.shape[-1] - 4], prof_offs[2:-2]
    diff = torch.where(dark_inside[..., None, None, None], g_out - g_in, g_in - g_out)
    w = torch.where(diff > 0, diff * diff, 0.0)
    wsum = w.sum(-1)
    n0 = (w * offs).sum(-1) / torch.clamp(wsum, min=1e-9)
    sample_ok = wsum > 1e-3
    q = pts + n0[..., None] * n[..., None, :]
    sw = torch.where(sample_ok, wsum, 0.0)[..., None]
    mean = (q * sw).sum(-2) / torch.clamp(sw.sum(-2), min=1e-9)
    d = q - mean[..., None, :]
    cxx = (sw[..., 0] * d[..., 0] * d[..., 0]).sum(-1)
    cxy = (sw[..., 0] * d[..., 0] * d[..., 1]).sum(-1)
    cyy = (sw[..., 0] * d[..., 1] * d[..., 1]).sum(-1)
    lam = 0.5 * (cxx + cyy + torch.sqrt(torch.clamp((cxx - cyy) ** 2 + 4 * cxy * cxy, min=0.0)))
    v1, v2 = torch.stack([cxy, lam - cxx], -1), torch.stack([lam - cyy, cxy], -1)
    dirs = torch.where((v1 * v1).sum(-1, keepdim=True) > (v2 * v2).sum(-1, keepdim=True), v1, v2)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-9)
    good = ((sample_ok.sum(-1) >= 6) & (lam > 1e-9))[..., None]
    mean, dirs = torch.where(good, mean, mid), torch.where(good, dirs, e)
    new = line_intersection(torch.roll(mean, 1, -2), torch.roll(dirs, 1, -2), mean, dirs)
    ok = torch.isfinite(new).all(-1) & (
        torch.linalg.vector_norm(new - corners, dim=-1) < search_range + 0.5)
    return torch.where(ok[..., None], new, corners)


def parent_fit_form(m, *, max_line_fit_mse: float = 10.0, critical_cos: float = 0.985,
                    min_area: float = 64.0):
    """The parent's quad fit, phase 25's and 27's yardstick of the stage
    before its epilogue moved into the kernel: the search kernel (its plain
    version on the CPU), then torch ops on the (N, 4) winners (vector_norm,
    float sums over the corners), ~100 of them."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import quadfit as plain
    from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk
    from isaac_ros_apriltag_tpu_torch.utils.geometry import line_intersection

    lead = m.bw.shape[:-1]
    centroid = m.centroid.reshape(-1, 2)
    scale = torch.clamp(m.scale.reshape(-1, 1), min=1e-6)
    q = qk.quad_search(plain.prefix_tables(m))
    pts = torch.stack([q.ex, q.ey], -1)
    dx, dy = plain._line_dir(q.cxx, q.cxy, q.cyy)
    dirs = torch.stack([dx, dy], -1)
    corners = line_intersection(torch.roll(pts, 1, 1), torch.roll(dirs, 1, 1), pts, dirs)
    corners = corners * scale[..., None] + centroid[:, None, :]
    scale2 = scale[..., 0] ** 2
    x0, y0 = corners[..., 0], corners[..., 1]
    area2 = (x0 * torch.roll(y0, -1, -1) - torch.roll(x0, -1, -1) * y0).sum(-1)
    e_in = corners - torch.roll(corners, 1, 1)
    e_out = torch.roll(corners, -1, 1) - corners
    cosang = (e_in * e_out).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(e_in, dim=-1) * torch.linalg.vector_norm(e_out, dim=-1),
        min=1e-9)
    gates = torch.stack([torch.isfinite(q.best_err), q.aerr.amax(-1) * scale2 <= max_line_fit_mse,
                         0.5 * area2.abs() >= min_area,
                         torch.all(cosang.abs() < critical_cos, -1),
                         torch.isfinite(corners).all(-1).all(-1), m.count.reshape(-1) >= 8,
                         m.valid.reshape(-1)], -1)
    flip = torch.roll(torch.flip(corners, (1,)), 1, 1)
    corners = torch.where((area2 < 0)[:, None, None], flip, corners)
    return plain.Quads(corners=corners.reshape(*lead, 4, 2), valid=gates.all(-1).reshape(lead),
                       dark_inside=m.dark_inside, fit_err=(q.best_err * scale2).reshape(lead),
                       gates=gates.reshape(*lead, -1))


def parent_select_form(corners, valid, dark_inside, fit_err, *, want_dark: bool, k: int,
                       decimate: int):
    """The top-2T pick of the tree before its kernel, half of
    parent_select_refine_form: vector_norm and a float sum for the perimeter, torch.sort, gathers and
    the upscale, ~17 torch ops."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.tail import Candidates, take, top, upscale_coords

    qvalid = valid & (dark_inside == want_dark)
    perim = torch.linalg.vector_norm(corners - torch.roll(corners, 1, -2), dim=-1).sum(-1)
    top_s, top_i = top(torch.where(qvalid, perim / (1.0 + fit_err), -torch.inf), k)
    return Candidates(corners=upscale_coords(take(corners, top_i), decimate),
                      dark_inside=take(dark_inside, top_i), pre_valid=torch.isfinite(top_s),
                      num_quads=qvalid.sum(-1).to(torch.int32))


def parent_select_refine_form(gray, corners, valid, dark_inside, fit_err, *, want_dark: bool,
                              k: int, decimate: int, search_range: float):
    """The parent's top-2T pick, then the parent's refine of the picked
    quads: phase 27's yardstick of refine_kernel."""
    from isaac_ros_apriltag_tpu_torch.ops.tail import RefinedCandidates

    cand = parent_select_form(corners, valid, dark_inside, fit_err, want_dark=want_dark, k=k,
                              decimate=decimate)
    return RefinedCandidates(corners=parent_refine_form(gray, cand.corners, cand.dark_inside,
                                                        search_range=search_range),
                             pre_valid=cand.pre_valid, num_quads=cand.num_quads)


def parent_finish_form(dec, pre_valid, num_quads, overflow, *, k: int,
                       min_decision_margin: float):
    """The parent's dedupe, top-T pick, takes, center and counts, phase 27's
    yardstick of tail_finish_kernel: ~68 torch ops (means, vector_norms and
    (B, N, N) tests)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.tail import Selection, take, top
    from isaac_ros_apriltag_tpu_torch.utils.geometry import line_intersection

    N = pre_valid.shape[-1]
    valid = pre_valid & dec.valid & (dec.margin >= min_decision_margin)
    c, ids, margin = dec.corners, dec.id, dec.margin
    center = c.mean(-2)
    edge = torch.linalg.vector_norm(c - torch.roll(c, 1, -2), dim=-1).mean(-1)
    d = torch.linalg.vector_norm(center[:, :, None] - center[:, None, :], dim=-1)
    near = d < 0.75 * torch.maximum(edge[:, :, None], edge[:, None, :])
    idx = torch.arange(N, device=c.device)
    better = (margin[:, :, None] > margin[:, None, :]) | (
        (margin[:, :, None] == margin[:, None, :]) & (idx[:, None] < idx[None, :]))
    valid = valid & ~torch.any(near & (ids[:, :, None] == ids[:, None, :])
                               & valid[:, :, None] & valid[:, None, :] & better, 1)
    top_s, top_f = top(torch.where(valid, margin, -torch.inf), k)
    sel_valid = torch.isfinite(top_s)
    corners = take(c, top_f)
    c0, c1, c2, c3 = corners.unbind(-2)
    return Selection(valid=sel_valid, id=torch.where(sel_valid, take(ids, top_f), -1),
                     hamming=take(dec.hamming, top_f), margin=take(margin, top_f),
                     center=line_intersection(c0, c2 - c0, c1, c3 - c1), corners=corners,
                     num_detections=sel_valid.sum(-1).to(torch.int32),
                     overflow=overflow | (num_quads > N))


def _glue_stages() -> dict:
    """Phase 27's stages: name -> (kernel wrapper, plain version, the
    parent's form)."""
    from isaac_ros_apriltag_tpu_torch.ops import tail as plain_tail
    from isaac_ros_apriltag_tpu_torch.ops.cuda import refine as rk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk

    from isaac_ros_apriltag_tpu_torch.ops import pose as plain_pose
    from isaac_ros_apriltag_tpu_torch.ops.pose import Poses
    from isaac_ros_apriltag_tpu_torch.ops.tail import Selection

    # The fused launch's results as one named tuple: the selection's fields,
    # then the poses'.
    fused = collections.namedtuple("FinishPose", Selection._fields + Poses._fields)

    def plain_finish_pose(dec, pre_valid, num_quads, overflow, K, tag_size, **kw):
        sel = plain_tail.finish_detections(dec, pre_valid, num_quads, overflow, **kw)
        return fused(*sel, *plain_pose.estimate_poses(sel.corners, K, tag_size))

    return {"select_refine": (rk.select_and_refine, plain_tail.select_and_refine,
                              parent_select_refine_form),
            "tail_finish": (tk.finish_detections, plain_tail.finish_detections,
                            parent_finish_form),
            "finish_pose": (lambda *a, **kw: fused(*(t for part in tk.finish_and_pose(*a, **kw)
                                                     for t in part)),
                            plain_finish_pose,
                            lambda *a, **kw: fused(*(t for part in parent_finish_pose_form(
                                *a, **kw) for t in part)))}


def parent_finish_pose_form(dec, pre_valid, num_quads, overflow, K, tag_size: float, *, k: int,
                            min_decision_margin: float):
    """The parent's finish and pose, phase 27's yardstick of
    finish_pose_kernel: parent_finish_form, then parent_pose_form of its
    corners."""
    sel = parent_finish_form(dec, pre_valid, num_quads, overflow, k=k,
                             min_decision_margin=min_decision_margin)
    return sel, parent_pose_form(sel.corners, K, tag_size)


def detect_glue_inputs(cfg, cam, images) -> dict:
    """The inputs of the pick and refine and the finish kernels in an eager
    detect call of a (B, H, W) uint8 batch on the card, backend 'cuda':
    {stage: (args, keyword arguments)}; the fused pick and refine
    (select_and_refine) gives "select_refine", the fused finish and pose
    (finish_and_pose) gives "finish_pose" and, its first four arguments,
    "tail_finish"."""
    from unittest import mock

    from isaac_ros_apriltag_tpu_torch.ops.cuda import refine as rk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk
    from isaac_ros_apriltag_tpu_torch.pipeline import batched_detect_fn

    seen = {}

    def watch(stage, fn):
        def watched(*args, **kw):
            seen[stage] = (args, kw)
            if stage == "finish_pose":      # the finish's own inputs, K and the size left out
                seen["tail_finish"] = (args[:4], kw)
            return fn(*args, **kw)
        return watched

    with mock.patch.object(rk, "select_and_refine",
                           watch("select_refine", rk.select_and_refine)), \
            mock.patch.object(tk, "finish_and_pose", watch("finish_pose", tk.finish_and_pose)):
        batched_detect_fn(cfg, cam, "mono8", capture=False)(images)
    return seen


def glue_synthetic(name: str, dev) -> dict:
    """One of phase 27's synthetic cases (GLUE_CASE_NAMES past the two bench
    shapes), {stage: (args, keyword arguments)} on `dev`, made with seeded
    numpy: C = 128 quads a frame in a 160x120 decimated image (random
    centers, half sizes 4-30 px, turns, half of them wound backwards) to
    select the top k from, the decoded candidates (ids from a few, margins
    about the 10.0 gate, candidates valid before decode or not) to finish,
    and tail_frame's one-tag frames (the tag's quad moved ~0.7 px, the
    other quads, a dark or light inside) to refine at search range d + 1;
    the pick and refine in one launch picks the 128 quads' top k and refines
    them on the one-tag frames. Its two halves' inputs, "tail_select" (the
    128 quads) and "refine" (the one-tag frames' quads), are the tests'
    inputs of their plain versions (ops/tail.py::select_candidates,
    ops/refine.py::refine_edges)."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.decode import DecodeResult

    seed = GLUE_CASE_NAMES.index(name)
    rng = np.random.default_rng(seed)
    B = 3 if name == "a batch of 3 frames" else 2
    C, T, d = 128, 64, 2
    if name == "max_tags < C/2":
        T = 8
    if name.startswith("quad_decimate"):
        d = int(name[-1])
    K = min(2 * T, C)
    ties = name in ("tied scores and margins", "duplicate ids, equal margins")
    nan = name == "NaN and inf corners"

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def quads(n, scale=1.0):
        ctr = rng.uniform((12, 12), (148, 108), (B, n, 1, 2))
        half = rng.uniform(4, 30, (B, n, 1, 1))
        turn = np.where(ties, 0.0, rng.uniform(0, np.pi / 2, (B, n, 1)))
        sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
        c, s_ = np.cos(turn)[..., None], np.sin(turn)[..., None]
        q = ctr + half * np.stack([sq[:, 0] * c[..., 0] - sq[:, 1] * s_[..., 0],
                                   sq[:, 0] * s_[..., 0] + sq[:, 1] * c[..., 0]], -1)
        q = np.where(rng.random((B, n, 1, 1)) < 0.5, q, q[:, :, ::-1])
        if ties:                          # integer corners: equal sizes tie exactly
            q = np.round(q / 4) * 4
        q = q * scale
        if nan:
            q[:, ::7, 1, 0] = np.nan
            q[:, 3::11, 2, 1] = np.inf
            q[:, 5::13, 0, 0] = -np.inf
        return q.astype(np.float32)

    valid = rng.random((B, C)) < (0.0 if name == "no valid quad" else 0.7)
    if nan:
        valid[:, ::7] = valid[:, 3::11] = valid[:, 5::13] = True
    fit_err = (rng.integers(0, 4, (B, C)) * 0.25 if ties else rng.uniform(0, 3, (B, C)))
    select = ((on(quads(C)), on(valid), on(rng.random((B, C)) < 0.8),
               on(fit_err.astype(np.float32))), dict(want_dark=True, k=K, decimate=d))

    corners = quads(K, float(d))
    ids = rng.integers(0, 6, (B, K)).astype(np.int32)
    margin = (rng.integers(5, 40, (B, K)) if ties else rng.uniform(0, 60, (B, K)))
    margin = margin.astype(np.float32)
    if name == "duplicate ids, equal margins":       # j + 1 a copy of j, 1 px over
        corners[:, 1::2] = corners[:, ::2] + 1.0
        ids[:, 1::2], margin[:, 1::2] = ids[:, ::2], margin[:, ::2]
    if nan:
        margin[:, ::9] = np.nan
    dec = DecodeResult(valid=on(rng.random((B, K)) < 0.8), id=on(ids),
                       hamming=on(rng.integers(0, 3, (B, K)).astype(np.int32)),
                       margin=on(margin), rotation=on(np.zeros((B, K), np.int32)),
                       corners=on(corners))
    pre_valid = rng.random((B, K)) < (0.0 if name == "no valid quad" else 0.85)
    finish = ((dec, on(pre_valid), on(rng.integers(0, 2 * K + 1, B).astype(np.int32)),
               on(rng.random(B) < 0.3)), dict(k=T, min_decision_margin=10.0))

    frames = [tail_frame("tag36h11", seed=seed + b, extra=True) for b in range(B)]
    gray = np.stack([g for g, _ in frames])
    rq = np.stack([q for _, q in frames])
    rq[:, 0] += rng.normal(0, 0.7, rq[:, 0].shape).astype(np.float32)
    dark = rng.random(rq.shape[:2]) < 0.5
    dark[:, 0] = True
    refine = ((on(gray), on(rq), on(dark)), dict(search_range=d + 1.0))
    # The pick and refine in one launch: the quads in the frames' decimated
    # pixels, upscaled by d onto the one-tag frames.
    select_refine = ((on(gray), *select[0]), dict(select[1], search_range=d + 1.0))
    return {"select_refine": select_refine, "refine": refine, "tail_select": select,
            "tail_finish": finish}


def finish_synthetic(name: str, dev) -> dict:
    """One of phase 27's finish-only cases (FINISH_CASE_NAMES), {'tail_finish':
    (args, keyword arguments)} on `dev`, made with seeded numpy: B = 2
    frames of N = 128 decoded candidates (100 in '100 candidates, k 7';
    squares of half size 4-20 px about random centers, ids from a few,
    every other candidate a copy of the one before it 1 px over, with its
    id and margin), k = 64 tags (7) at a gate of 10 (-inf in
    'min_decision_margin -inf')."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.decode import DecodeResult

    rng = np.random.default_rng(100 + FINISH_CASE_NAMES.index(name))
    B, N, k, gate = 2, 128, 64, 10.0
    if name == "100 candidates, k 7":
        N, k = 100, 7
    one_id = name == "one id, 128 valid candidates"
    ctr = rng.uniform(60, 100, (B, N, 1, 2)) if one_id else rng.uniform(20, 140, (B, N, 1, 2))
    half = rng.uniform(4, 20, (B, N, 1, 1))
    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    corners = (ctr + half * sq).astype(np.float32)
    ids = rng.integers(0, 4, (B, N))
    margin = rng.uniform(0, 60, (B, N)).astype(np.float32)
    valid = rng.random((B, N)) < 0.8
    pre_valid = rng.random((B, N)) < 0.85
    corners[:, 1::2] = corners[:, ::2] + 1.0
    ids[:, 1::2], margin[:, 1::2] = ids[:, ::2], margin[:, ::2]
    if name == "inf and NaN margins":
        margin[:, ::5] = np.inf
        margin[:, 1::7] = -np.inf
        margin[:, 2::9] = np.nan
    elif name == "min_decision_margin -inf":
        gate = -np.inf
        margin[:, ::4] = -np.inf
        margin[:, 1::6] = np.inf
        margin[:, 2::11] = np.nan
    elif one_id:
        ids[:] = 3
        valid[:] = pre_valid[:] = True
        margin = rng.integers(10, 20, (B, N)).astype(np.float32)      # ties
    elif name == "NaN edges beside candidates of the same id":
        corners[:, ::3, 0, 0] = corners[:, ::3, 1, 0] = np.inf
    dec = DecodeResult(valid=torch.from_numpy(valid).to(dev),
                       id=torch.from_numpy(ids.astype(np.int32)).to(dev),
                       hamming=torch.from_numpy(rng.integers(0, 3, (B, N)).astype(np.int32)).to(dev),
                       margin=torch.from_numpy(margin).to(dev),
                       rotation=torch.zeros((B, N), dtype=torch.int32, device=dev),
                       corners=torch.from_numpy(corners).to(dev))
    args = (dec, torch.from_numpy(pre_valid).to(dev),
            torch.from_numpy(rng.integers(0, 2 * N + 1, B).astype(np.int32)).to(dev),
            torch.from_numpy(rng.random(B) < 0.3).to(dev))
    return {"tail_finish": (args, dict(k=k, min_decision_margin=gate))}


def refine_synthetic(name: str, dev) -> dict:
    """One of phase 27's refine-only cases (REFINE_CASE_NAMES), {stage:
    (args, keyword arguments)} on `dev`, made with seeded numpy: two of
    tail_frame's one-tag frames (the tag's quad moved ~0.7 px, the other
    quads, a dark or light inside) at the named search range, or, for
    'profiles leaving the frame', with 12 more quads of half sizes 6-40 px
    centred within 8 px of the frame's edges, at search range 3.
    "select_refine" picks all C of them, valid and unfit, at decimate 1 (the
    light ones scored -inf and ranked last) and refines them; "refine" holds
    the quads for the plain version alone (ops/refine.py::refine_edges)."""
    import torch

    seed = REFINE_CASE_NAMES.index(name)
    rng = np.random.default_rng(100 + seed)
    frames = [tail_frame("tag36h11", seed=seed + b, extra=True) for b in range(2)]
    gray = np.stack([g for g, _ in frames])
    rq = np.stack([q for _, q in frames])
    rq[:, 0] += rng.normal(0, 0.7, rq[:, 0].shape).astype(np.float32)
    search_range = 3.0
    if name == "profiles leaving the frame":
        H, W = TAIL_SIZE
        n = 12
        edge = rng.integers(0, 4, (2, n))                  # top, bottom, left, right
        along, across = rng.uniform(0, 1, (2, n)), rng.uniform(-8, 8, (2, n))
        ctr = np.stack([np.where(edge < 2, along * (W - 1), np.where(edge == 2, 0, W - 1) + across),
                        np.where(edge < 2, np.where(edge == 0, 0, H - 1) + across,
                                 along * (H - 1))], -1)
        half = rng.uniform(6, 40, (2, n, 1, 1))
        sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
        rq = np.concatenate([rq, (ctr[:, :, None] + half * sq).astype(np.float32)], 1)
    else:
        search_range = float(name.split()[-1])
    dark = rng.random(rq.shape[:2]) < 0.5
    dark[:, 0] = True

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    C = rq.shape[1]
    select_refine = ((on(gray), on(rq), on(np.ones((2, C), bool)), on(dark),
                      on(np.zeros((2, C), np.float32))),
                     dict(want_dark=True, k=C, decimate=1, search_range=search_range))
    return {"select_refine": select_refine,
            "refine": ((on(gray), on(rq), on(dark)), dict(search_range=search_range))}


def glue_cases(dev) -> dict:
    """Phase 27's inputs, GLUE_CASE_NAMES, REFINE_CASE_NAMES and
    FINISH_CASE_NAMES -> {stage: (args, keyword arguments)} on `dev`: the
    kernels' inputs in a detect call of torch_bench.py's 720p b1 and 1080p
    b8 inputs (detect_glue_inputs), then glue_synthetic's,
    refine_synthetic's and finish_synthetic's cases; each case's finish
    also with the pose (finish_pose; "max_tags < C/2" at tag size 0, so
    finish_pose_kernel<false> runs)."""
    cases = {}
    for config, batch in CAPTURE_CASES:
        cfg, cam, inputs = bench_inputs(config, batch, dev, calls=1)
        cases[f"{config} b{batch}"] = detect_glue_inputs(cfg, cam, inputs[0])
    for name in GLUE_CASE_NAMES[len(CAPTURE_CASES):]:
        cases[name] = glue_synthetic(name, dev)
    for name in REFINE_CASE_NAMES:
        cases[name] = refine_synthetic(name, dev)
    for name in FINISH_CASE_NAMES:
        cases[name] = finish_synthetic(name, dev)
    # The finish with the pose where a case holds the finish alone: TAIL_K,
    # one a frame (scaled) for a batch.
    import torch

    K = torch.tensor(TAIL_K, dtype=torch.float32)
    for name, case in cases.items():
        if "tail_finish" in case and "finish_pose" not in case:
            args, kw = case["tail_finish"]
            B = args[1].shape[0]
            Ks = K if B == 1 else torch.stack([K * torch.tensor([[1 + 0.1 * b], [1 + 0.1 * b],
                                                                 [1.0]]) for b in range(B)])
            # One case at tag size 0, whose pivots are not the fixed ones.
            size = 0.0 if name == "max_tags < C/2" else TAIL_TAG_SIZE
            case["finish_pose"] = ((*args, Ks.to(dev), size), kw)
    return cases


def _frame_of(args, b: int):
    """args (tensors and named tuples of tensors, leading dim B) cut to
    frame b, as a batch of one."""
    import torch

    if isinstance(args, torch.Tensor):
        return args[b:b + 1]
    if isinstance(args, tuple):
        cut = [_frame_of(a, b) for a in args]
        return type(args)(*cut) if hasattr(args, "_fields") else tuple(cut)
    return args


def check_glue_case(name: str, case: dict) -> dict:
    """One of phase 27's cases: each of the pick and refine and the finish
    kernels (_glue_stages) that the case holds inputs for against its plain version bit
    for bit on every output (NaN equal to NaN), one launch a call, two
    calls and a captured replay equal, and a batch equal to each frame
    alone. Raises on a difference; returns {stage: the kernel's result}."""
    import torch

    out = {}
    for stage, (kernel, plain, _) in _glue_stages().items():
        if stage not in case:
            continue
        args, kw = case[stage]
        one = {k: int(k == stage) for k in _want()}
        _reset_launches()
        got = kernel(*args, **kw)
        counts = _launches()
        if counts != one:
            raise AssertionError(f"{stage}, {name}: launches {counts} != {one}")
        fields = got._fields if hasattr(got, "_fields") else ("out",)
        gots = tuple(got) if hasattr(got, "_fields") else (got,)
        want = plain(*args, **kw)
        wants = tuple(want) if hasattr(want, "_fields") else (want,)
        for f, a, b in zip(fields, gots, wants):
            if not _same(a, b):
                raise AssertionError(f"{stage} kernel, {name}: {f} differs from the plain "
                                     f"version (max abs err {_max_abs_err(a, b)})")
        again = kernel(*args, **kw)
        if not all(_same(a, b) for a, b in zip(tuple(again) if fields != ("out",) else (again,),
                                               gots)):
            raise AssertionError(f"{stage} kernel, {name}: two calls differ")
        _replay_equals(lambda: kernel(*args, **kw), got, f"{stage} kernel, {name}")
        B = gots[0].shape[0]
        for b in range(B if B > 1 else 0):
            cut = _frame_of(args, b)
            if stage == "finish_pose" and args[4].ndim == 2:    # a shared K stays whole
                cut = (*cut[:4], *args[4:])
            alone = kernel(*cut, **kw)
            alones = tuple(alone) if fields != ("out",) else (alone,)
            if not all(_same(a, g[b:b + 1]) for a, g in zip(alones, gots)):
                raise AssertionError(f"{stage} kernel, {name}: frame {b} alone differs from "
                                     "the batch")
        out[stage] = got
    torch.cuda.synchronize()
    return out


def tap_bytes(gray, corners, search_range: float) -> int:
    """The bytes of gray that refining the (B, K, 4, 2) corners reads: each
    distinct (frame, row, column) that the four taps of its profile samples
    read (neighbouring samples, 0.5 px apart, share most of them), once."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops.refine import sample_points, tap_indices

    B, H, W = gray.shape
    y0, x0, y1, x1, _, _ = tap_indices(H, W, *sample_points(corners, search_range))
    frame = torch.arange(B, device=gray.device).view(B, *[1] * (y0.dim() - 1)) * (H * W)
    taps = torch.stack([frame + y * W + x for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))])
    return torch.unique(taps).numel() * gray.element_size()


def select_refine_bytes(args, kw, got) -> int:
    """The bytes refine_kernel must move: the quads (corners, valid, dark,
    fit_err), tap_bytes of the picked quads' profiles and the outputs."""
    from isaac_ros_apriltag_tpu_torch.ops import tail as plain_tail

    gray, *quads = args
    skw = {k: v for k, v in kw.items() if k != "search_range"}
    cand = plain_tail.select_candidates(*quads, **skw)
    return (tap_bytes(gray, cand.corners, kw["search_range"])
            + sum(t.numel() * t.element_size() for t in (*quads, *got)))


def glue_bound(stage: str, args, kw, got) -> tuple[float, str]:
    """(bound ms, 'bytes' or 'operations') of one of phase 27's kernels on
    its inputs: each input and output once (the pick and refine in one
    launch: select_refine_bytes), or its f32 operations at F32_OPS_PER_S,
    whichever is larger. A pick compares each frame's quads scored above
    -inf pairwise and places the others by counts."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import tail as plain_tail
    from isaac_ros_apriltag_tpu_torch.ops.refine import profile

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def refine_ops(n):
        P = profile(kw["search_range"])[1]
        return n * 4 * 12 * P * GLUE_SAMPLE_FLOPS + n * 4 * 12 * max(P - 4, 0) * GLUE_WEIGHT_FLOPS

    def pick_ops(corners, valid, dark, fit_err):
        N = corners.shape[1]
        qvalid = valid & (dark == kw["want_dark"])
        score = torch.where(qvalid, plain_tail._sum4(plain_tail._edge_lengths(corners))
                            / (1.0 + fit_err), -torch.inf)
        nr = (score > -torch.inf) | torch.isnan(score)
        return (int((nr.sum(-1) ** 2).sum()) + corners.shape[0] * N) * GLUE_PAIR_FLOPS[stage]

    if stage == "select_refine":
        by = select_refine_bytes(args, kw, got)
        ops = refine_ops(args[0].shape[0] * kw["k"]) + pick_ops(*args[1:])
    else:
        flat = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
                if isinstance(t, torch.Tensor)]
        B, N = args[1].shape
        by = nbytes(*flat, *got)
        # The dedupe tests the frame's valid pairs; the rank compares the
        # ones scored above -inf (at most the valid ones); the fused launch
        # poses each top-T tag.
        dec, pre_valid = args[0], args[1]
        nv = (pre_valid & dec.valid & (dec.margin >= kw["min_decision_margin"])).sum(-1)
        ops = int((nv * nv).sum()) * (GLUE_PAIR_FLOPS[stage] + 1)
        if stage == "finish_pose":
            ops += B * min(kw["k"], N) * POSE_FLOPS
    by_ms, ops_ms = _bytes_ms(by), ops / F32_OPS_PER_S * 1e3
    return (by_ms, "bytes") if by_ms >= ops_ms else (ops_ms, "operations")


def glue_phase(gpu: str) -> dict:
    """Phase 27: check_glue_case on each of glue_cases, and device times at
    torch_bench.py's two shapes of each kernel, its plain version, its bound
    (glue_bound) and the parent's form (parent_select_refine_form,
    parent_finish_form, parent_finish_pose_form); the plain version and the
    parent's form, tens to hundreds of small torch ops each, are timed as
    captured replays (_graph_ms). No library call computes any of the three.
    Returns {max_abs_err (0: any difference raises), and for 'b1' (720p)
    and 'batch8' (1080p): {stage: shape, ms, plain_ms, bound_ms, bound_by,
    library_ms, parent_ms}}."""
    import torch

    from isaac_ros_apriltag_tpu_torch.ops import tail as plain_tail
    from isaac_ros_apriltag_tpu_torch.ops.refine import profile

    out = {"max_abs_err": 0.0}
    lines = []
    bench = {f"{config} b{batch}": batch for config, batch in CAPTURE_CASES}
    stages = _glue_stages()
    for name, case in glue_cases(torch.device("cuda")).items():
        got = check_glue_case(name, case)
        if name in FINISH_CASE_NAMES:
            fin = got["tail_finish"]
            (dec, pre_valid, _, _), kw = case["tail_finish"]
            nv = pre_valid & dec.valid & (dec.margin >= kw["min_decision_margin"])
            lines.append(f"{name}: {int(nv.sum())} valid of {nv.numel()} candidates, "
                         f"{int(fin.num_detections.sum())} tags of {fin.valid.numel()}")
            continue
        (_, *quads), kw = case["select_refine"]
        sel = got["select_refine"]
        picked = plain_tail.select_candidates(
            *quads, **{k: v for k, v in kw.items() if k != "search_range"}).corners
        moved = (sel.corners != picked).any(-1).any(-1)
        line = (f"{name}: {' x '.join(map(str, sel.pre_valid.shape))} of "
                f"{' x '.join(map(str, quads[1].shape))} quads picked "
                f"({int(sel.pre_valid.sum())} valid) and refined in one launch "
                f"({int(moved.sum())} moved, {profile(kw['search_range'])[1]} samples a profile)")
        if "tail_finish" in got:
            fin = got["tail_finish"]
            line += f", {int(fin.num_detections.sum())} tags of {fin.valid.numel()}"
        lines.append(line)
        if name not in bench:
            continue
        t = {}
        for stage, (kernel, plain, parent) in stages.items():
            args, kw = case[stage]
            bound, by = glue_bound(stage, args, kw, got[stage])
            t[stage] = dict(shape=list(args[1].shape), ms=_device_ms(lambda: kernel(*args, **kw), 20),
                            plain_ms=_graph_ms(lambda: plain(*args, **kw), 20),
                            bound_ms=bound, bound_by=by, library_ms=None,
                            parent_ms=_graph_ms(lambda: parent(*args, **kw), 20))
        out["b1" if bench[name] == 1 else f"batch{bench[name]}"] = t
    torch.cuda.synchronize()
    print(f"[27 tail glue] refine_kernel (the top-2T pick and refine), tail_finish_kernel "
          f"and finish_pose_kernel (the finish with the pose; one launch a call each) against their "
          f"plain versions bit for bit on every output, two calls "
          f"and a captured replay equal, a batch equal to each frame alone: "
          + "; ".join(lines) + f"; on {gpu}: device ms a call (kernel / plain / bound (by) / "
          "the parent's form, plain and parent's form as captured replays; no library call "
          "computes any) "
          + ", ".join(f"{k} {stage} {v['shape']}: {v['ms']:.4f} / {v['plain_ms']:.4f} / "
                      f"{v['bound_ms']:.5f} ({v['bound_by']}, {v['bound_ms'] / v['ms']:.1%} of "
                      f"bound) / {v['parent_ms']:.4f}"
                      for k, per in out.items() if k != "max_abs_err"
                      for stage, v in per.items()), flush=True)
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
    capture) and counted under torch.profiler (_counted); then the
    contraction and the final resolve alone on those two inputs, eager and
    warm, where no kernel of RESOLVE_LIBRARY_NAMES may run. Returns the
    counts by path, and under "kernels_a_replay" the count of every kernel
    in each bench replay and in the same replay with the quad-fit epilogue,
    the picks, the dedupe and refine in the parent's form (parent_fit_form,
    the pick and refine as parent_select_refine_form, the finish and pose
    as parent_finish_pose_form), and the count of kernels
    between the quad fit's launch and the finish's (with the pose) in a
    bench replay, which must be TAIL_BETWEEN's, in order (tail_between)."""
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig, RigDetector, run_stream
    from isaac_ros_apriltag_tpu_torch.ops.cuda import quadfit as qk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import refine as rk
    from isaac_ros_apriltag_tpu_torch.ops.cuda import tail as tk
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
    totals = {}
    for config, batch in CAPTURE_CASES:
        bcfg, bcam, inputs = bench_inputs(config, batch, dev, calls=3)
        fn = batched_detect_fn(bcfg, bcam, "mono8")
        fn(inputs[0]), fn(inputs[1])
        with _counted(f"captured b{batch}", totals=totals) as out[f"captured_b{batch}"]:
            fn(inputs[2])
        # Between the quad fit and the finish (with the pose) only the
        # tail's hand-written kernels run.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(inputs[2])
            torch.cuda.synchronize()
        between = tail_between(prof)
        if [_kernel_key(n) for n in between] != list(TAIL_BETWEEN):
            raise AssertionError(f"captured b{batch}: between the quad fit and the finish ran "
                                 f"{between}, not only {list(TAIL_BETWEEN)}")
        totals[f"captured b{batch}, between the quad fit and the finish"] = len(between)
        del fn
        # The same replay with the quad-fit epilogue, the picks, the dedupe
        # and refine in the parent's torch ops.
        with mock.patch.object(qk, "fit_quads_from_moments", parent_fit_form), \
                mock.patch.object(rk, "select_and_refine", parent_select_refine_form), \
                mock.patch.object(tk, "finish_detections", parent_finish_form), \
                mock.patch.object(tk, "finish_and_pose", parent_finish_pose_form):
            fn = batched_detect_fn(bcfg, bcam, "mono8")
            fn(inputs[0]), fn(inputs[1])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(inputs[2])
                torch.cuda.synchronize()
            totals[f"captured b{batch}, tail glue in the parent's form"] = len(
                _device_kernels(prof))
            del fn
    out["kernels_a_replay"] = totals
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as rk
    for config, batch in CAPTURE_CASES:
        bcfg, _, inputs = bench_inputs(config, batch, dev, calls=1)
        valid, lab1, lab2, table, R, _ = labels_of(bcfg, front_trinary(bcfg, inputs[0]))
        calls = {"roots_rank": lambda: rk.resolve_roots_rank(
                     lab1, valid, max_components=R, chain_steps=bcfg.ccl_contraction_steps),
                 "components": lambda: rk.resolve_components(
                     lab2, valid, min_component_pixels=bcfg.min_component_pixels,
                     max_components=R, chain_steps=bcfg.ccl_resolve_steps, rank_table=table)}
        for call, fn in calls.items():
            fn()
            with _counted(f"resolve {call} b{batch}", RESOLVE_LIBRARY_NAMES) as out[
                    f"resolve_{call}_b{batch}"]:
                fn()
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
    kernels = got.pop("kernels_a_replay")
    one = _want()
    want = {"frame": {k: v * len(SEEDS) for k, v in one.items()},
            f"rig{RIG_CAMERAS}": _want(rig_k=True),
            "stream": {k: v * RIG_CAMERAS for k, v in one.items()},
            **{f"captured_b{b}": one for _, b in CAPTURE_CASES},
            **{f"resolve_{call}_b{b}": _resolve_want() for _, b in CAPTURE_CASES
               for call in ("roots_rank", "components")}}
    if got != want:
        raise AssertionError(f"profiled replays: counts {got} != expected {want}")
    torch.cuda.synchronize()
    print(f"[22 profiled replays] in a child process ({time.perf_counter() - t0:.1f} s): "
          f"torch.profiler's count of each kernel by name equals the counters' on the "
          f"replayed paths and on the resolve calls alone, which launch no "
          f"{list(RESOLVE_LIBRARY_NAMES)} kernel: {got}; kernels a replay {kernels}",
          flush=True)
    got["kernels_a_replay"] = kernels
    return got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--profiled-replays"]:
        print(json.dumps(profiled_replays()))
        return 0
    if sys.argv[1:] == ["--cluster-profile"]:
        print(json.dumps(cluster_profile()))
        return 0

    import dataclasses

    from isaac_ros_apriltag_tpu_torch import Detector, DetectorConfig
    from isaac_ros_apriltag_tpu_torch.detector import _decimate, _pad_to_tiles
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib
    from isaac_ros_apriltag_tpu_torch.ops.cuda import ccl as ccl_ops
    from isaac_ros_apriltag_tpu_torch.ops.cuda import resolve as resolve_kernels
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
    for backend, contract in (("cuda", resolve_kernels.resolve_roots_rank),
                              ("torch", resolve_roots_rank)):
        lab1, conv1 = ccl_ops.ccl_scan(tri, cfg.ccl_scan_rounds, backend=backend)
        rank_img, table, ovf = contract(lab1, valid, max_components=R_eff,
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
          f"two-phase CCL {cfg.ccl_scan_rounds}+{cfg.ccl_phase2_rounds} on the scene, the "
          f"contraction by the resolve kernels against the twin's "
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
          f"(1 / {SCAN_ROUNDS} / {SCAN_ROUNDS} / 1 / 1 / 1 / 1 / 2 / 2 / 2 / 2 per frame)",
          flush=True)

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
    if counts_rig != _want(rig_k=True):
        raise AssertionError(f"rig launch counts {counts_rig} != expected {_want(rig_k=True)}")
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
    want_sp = _want(rounds=sp_rounds, resolves=1)
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
    want_flat = _want(rounds=cfg.ccl_scan_rounds, resolves=1)
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

    # --- 24. the resolve kernels against the twin and their plain versions ------------
    resolve = resolve_phase(gpu)

    # --- 25. the quad-fit search kernel against its plain version ------------------------
    quadfit = quadfit_phase(gpu)

    # --- 26. the decode and pose kernels against their plain versions --------------------
    tail = tail_phase(gpu)

    # --- 27. the refine, select and finish kernels against their plain versions ----------
    glue = glue_phase(gpu)

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
         "bound_ms": cluster[k]["b1"]["bound_ms"], "bound_by": "bytes",
         "library_ms": cluster[k]["b1"]["library_ms"],
         f"shape_batch{BATCH}": cluster[k][f"batch{BATCH}"]["shape"],
         f"ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["ms"],
         f"plain_ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["plain_ms"],
         f"bound_ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["bound_ms"],
         f"library_ms_batch{BATCH}": cluster[k][f"batch{BATCH}"]["library_ms"],
         f"share_batch{BATCH}": (cluster[k][f"batch{BATCH}"]["bound_ms"]
                                 / cluster[k][f"batch{BATCH}"]["ms"]),
         **({f"{p}_pass{s}": cluster[k][t][p] for p in ("first", "later")
             for t, s in (("b1", ""), (f"batch{BATCH}", f"_batch{BATCH}"))}
            if k == "radix_scatter" else {})}
        for k in CLUSTER_KERNELS] + [
        {"name": k, "route": "cuda", "source": "isaac_ros_apriltag_tpu_torch/csrc/resolve.cu",
         "replaces": RESOLVE_REPLACES[k],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": resolve[k]["max_abs_err"], "shape": resolve[k]["b1"]["shape"],
         "ms": resolve[k]["b1"]["ms"], "plain_ms": resolve[k]["b1"]["plain_ms"],
         "bound_ms": resolve[k]["b1"]["bound_ms"], "bound_by": "bytes",
         "library_ms": resolve[k]["b1"]["library_ms"],
         f"shape_batch{BATCH}": resolve[k][f"batch{BATCH}"]["shape"],
         f"ms_batch{BATCH}": resolve[k][f"batch{BATCH}"]["ms"],
         f"plain_ms_batch{BATCH}": resolve[k][f"batch{BATCH}"]["plain_ms"],
         f"bound_ms_batch{BATCH}": resolve[k][f"batch{BATCH}"]["bound_ms"],
         f"library_ms_batch{BATCH}": resolve[k][f"batch{BATCH}"]["library_ms"],
         "parent_form_ms": resolve[k]["b1"]["parent_ms"],
         f"parent_form_ms_batch{BATCH}": resolve[k][f"batch{BATCH}"]["parent_ms"],
         f"share_batch{BATCH}": (resolve[k][f"batch{BATCH}"]["bound_ms"]
                                 / resolve[k][f"batch{BATCH}"]["ms"]),
         **({"max_active_clusters": resolve[k]["max_active_clusters"]}
            if "max_active_clusters" in resolve[k] else {})}
        for k in RESOLVE_KERNELS] + [
        {"name": "quadfit_search", "route": "cuda",
         "source": "isaac_ros_apriltag_tpu_torch/csrc/quadfit.cu", "replaces": QUADFIT_REPLACES,
         "launches": sum(c["quadfit_search"] for c in paths.values()),
         "launches_by_path": {p: c["quadfit_search"] for p, c in paths.items()},
         "max_abs_err": quadfit["max_abs_err"], "shape": quadfit["b1"]["shape"],
         "ms": quadfit["b1"]["ms"], "plain_ms": quadfit["b1"]["plain_ms"],
         "bound_ms": quadfit["b1"]["bound_ms"], "bound_by": quadfit["b1"]["bound_by"],
         "library_ms": quadfit["b1"]["library_ms"], "stage_ms": quadfit["b1"]["stage"],
         "fit_ms": quadfit["b1"]["fit"]["ms"], "fit_bound_ms": quadfit["b1"]["fit"]["bound_ms"],
         f"fit_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["fit"]["ms"],
         f"fit_bound_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["fit"]["bound_ms"],
         f"shape_batch{BATCH}": quadfit[f"batch{BATCH}"]["shape"],
         f"ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["ms"],
         f"plain_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["plain_ms"],
         f"bound_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["bound_ms"],
         f"bound_by_batch{BATCH}": quadfit[f"batch{BATCH}"]["bound_by"],
         f"library_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["library_ms"],
         f"stage_ms_batch{BATCH}": quadfit[f"batch{BATCH}"]["stage"],
         f"share_batch{BATCH}": (quadfit[f"batch{BATCH}"]["bound_ms"]
                                 / quadfit[f"batch{BATCH}"]["ms"])}] + [
        {"name": f"{k}_kernel", "route": "cuda",
         "source": "isaac_ros_apriltag_tpu_torch/csrc/tail.cu", "replaces": TAIL_REPLACES[k],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": tail["max_abs_err"], "shape": tail["b1"][k]["shape"],
         "ms": tail["b1"][k]["ms"], "plain_ms": tail["b1"][k]["plain_ms"],
         "bound_ms": tail["b1"][k]["bound_ms"], "bound_by": tail["b1"][k]["bound_by"],
         "library_ms": None, "parent_form_ms": tail["b1"][k]["parent_ms"],
         f"shape_batch{BATCH}": tail[f"batch{BATCH}"][k]["shape"],
         f"ms_batch{BATCH}": tail[f"batch{BATCH}"][k]["ms"],
         f"plain_ms_batch{BATCH}": tail[f"batch{BATCH}"][k]["plain_ms"],
         f"bound_ms_batch{BATCH}": tail[f"batch{BATCH}"][k]["bound_ms"],
         f"parent_form_ms_batch{BATCH}": tail[f"batch{BATCH}"][k]["parent_ms"],
         f"share_batch{BATCH}": (tail[f"batch{BATCH}"][k]["bound_ms"]
                                 / tail[f"batch{BATCH}"][k]["ms"])}
        for k in ("decode", "pose")] + [
        {"name": GLUE_NAMES.get(k, f"{k}_kernel"), "route": "cuda",
         "source": "isaac_ros_apriltag_tpu_torch/csrc/tail.cu", "replaces": GLUE_REPLACES[k],
         "launches": sum(c[k] for c in paths.values()),
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         "max_abs_err": glue["max_abs_err"], "shape": glue["b1"][k]["shape"],
         "ms": glue["b1"][k]["ms"], "plain_ms": glue["b1"][k]["plain_ms"],
         "bound_ms": glue["b1"][k]["bound_ms"], "bound_by": glue["b1"][k]["bound_by"],
         "library_ms": None, "parent_form_ms": glue["b1"][k]["parent_ms"],
         f"shape_batch{BATCH}": glue[f"batch{BATCH}"][k]["shape"],
         f"ms_batch{BATCH}": glue[f"batch{BATCH}"][k]["ms"],
         f"plain_ms_batch{BATCH}": glue[f"batch{BATCH}"][k]["plain_ms"],
         f"bound_ms_batch{BATCH}": glue[f"batch{BATCH}"][k]["bound_ms"],
         f"bound_by_batch{BATCH}": glue[f"batch{BATCH}"][k]["bound_by"],
         f"parent_form_ms_batch{BATCH}": glue[f"batch{BATCH}"][k]["parent_ms"],
         f"share_batch{BATCH}": (glue[f"batch{BATCH}"][k]["bound_ms"]
                                 / glue[f"batch{BATCH}"][k]["ms"])}
        for k in GLUE_KERNELS]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
