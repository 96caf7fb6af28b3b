#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA AprilTag detector on one NVIDIA GPU:
the cells of BENCHMARK.json, each a configuration (frame size, camera,
detector settings) under one traffic mix (a runner and its parameters).

    python3 torch_bench.py [--cell NAME ...] [--seed 0] [--out FILE]

With no --cell it runs every cell of BENCHMARK.json's `workloads`; --cell
also takes the cells listed under `held_back` (defined, not yet measured on
every change). Frame b of a cell is bench.py's scene (six tag36h11 tags of
0.3 m at 2.5 m, in-plane turns, noise 2) with ids shifted by b and noise
seed `--seed` + b, rendered from the seed; nothing is read from disk.

Runners (each takes its cell's parameters, so a new cell of a known kind is
a change to BENCHMARK.json only):
  detect  pipeline.batched_detect_fn on frames already on the card, a
          closed loop with `overlap` calls in flight, a CUDA event recorded
          after each call;
  graph   GraphPipeline(downscale).batched on distorted frames (rectify,
          resize, detect), timed as detect;
  rig     RigDetector over per-camera intrinsics, one rig frame a call,
          timed as detect;
  stream  StreamingRunner(depth=1) over host frames that a generator
          releases on a fixed schedule (an open loop); each frame is timed
          from when it was due, and the generator's own lateness is kept.

A closed-loop sample is one call's ms divided by its frames: with one call
in flight the host clock from dispatch to the completion event's sync (the
host is what bounds batch 1), with more the device interval between
consecutive completion events. The p95 is reported only where at least ten
samples lie beyond it. Correctness is taken from the timed calls' own
outputs: every frame must hold its truth's ids and no others with corners
within 1 px, equal the plain-PyTorch backend ("torch") on the same frames
within ROADMAP's float-tail gate, and, in a batch, equal the frame run alone
within 1e-3 px; a frame that fails counts as a failure against the frames
attempted. After the timed run, a separate traced run gives the per-layer
figures: stage ms by CUDA events (torch_stage_profile.py's split), device
busy and idle share, device ops a call, K1/K2/K3 device ms against their
bound, the longest device ops and idle gaps, and peak memory.

The JSON record is printed first with no figures, then again, fuller, after
each section, so a section that dies costs only its own fields; the last
line of stdout is the whole record. Every figure sits beside the card's
nvidia-smi name and power limit. Without a CUDA device it prints nothing on
stdout and exits 1; it exits 1 too if a frame failed or a section died.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from collections import deque

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import HBM_BYTES_PER_S  # noqa: E402  (H100 SXM memory rate, data sheet)

HEADLINE = ("tag36h11_fps_1080p_per_chip", "detect-1080p-b8")   # record name, its cell

# The usb_cam calibration the upstream ships (isaac_ros_apriltag/config/
# camera_info.yaml:19-44), as bench.py:50-51 holds it; the graph scales it.
REF_K = dict(fx=942.53242, fy=946.21221, cx=642.81122, cy=346.71313)
REF_D = [0.065725, -0.096954, 0.002318, 0.004110, 0.0]
TAG_XY = ((-0.8, -0.45), (0.0, -0.45), (0.8, -0.45), (-0.8, 0.45), (0.0, 0.45), (0.8, 0.45))
TAG_DEPTH_M = 2.5
TAG_SIZE = 0.3
NOISE = 2.0

TRUTH_PX = 1.0                  # corners against the rendered truth
BACKEND_TOL = {"corners": 0.1, "translation": 0.01, "quaternion": 0.01}   # cuda vs torch
BATCH_TOL_PX = 1e-3             # a frame in a batch against the frame alone
TAIL_SAMPLES = 10               # samples beyond a reported percentile, at least
KERNELS = {"K1": ("::threshold_kernel<", 4 + 1),      # part of the traced name, bytes a
           "K2": ("::row_scan_kernel<", 1 + 4 + 4),   # pixel: f32 in, u8 out; u8 + i32
           "K3": ("::col_diag_kernel(", 1 + 4 + 4)}   # in, i32 out
STREAM_DEPTH = 1                # deeper windows yield a frame only once the next arrives
FRONT_STAGES = 5                # grayscale .. ccl phase 2 of torch_stage_profile.STAGES
PROFILED_CALLS = 5
STAGE_CALLS = 20
TOP_OPS = 15
TOP_GAPS = 10


# --- scenes ------------------------------------------------------------------

def bench_tags(id_shift: int = 0):
    """bench.py:54-60's six tags (ids 1, 8, .., 36, shifted by id_shift),
    each upright with an in-plane turn of 0.1 i rad."""
    from isaac_ros_apriltag_tpu_torch import get_family
    from isaac_ros_apriltag_tpu_torch.utils.render import upright_pose

    fam = get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate(TAG_XY):
        t = np.array([x, y, TAG_DEPTH_M])
        tags.append(dict(family=fam, id=7 * i + 1 + id_shift, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=TAG_SIZE))
    return tags


def render_frame(cam, b: int, seed: int):
    """Frame b of a cell seen by `cam`: the bench tags with ids shifted by b
    and noise seed seed + b. Returns (tags, uint8 (H, W) frame)."""
    from isaac_ros_apriltag_tpu_torch.utils.render import render_tags

    tags = bench_tags(b)
    return tags, render_tags(cam.K.numpy(), (cam.height, cam.width), tags, noise=NOISE,
                             seed=seed + b)


def config_camera(config: dict, c: int = 0):
    """The configuration's camera (camera c of a rig): explicit intrinsics,
    or `ref_scale`, the usb_cam calibration with its distortion scaled to the
    frame. A rig's camera c has fx = fy = f (1 + f_step c) and its principal
    point moved by (cx_step, cy_step) (c - cameras / 2)."""
    from isaac_ros_apriltag_tpu_torch import CameraModel

    k, H, W = config["camera"], config["height"], config["width"]
    if "ref_scale" in k:
        s = k["ref_scale"]
        return CameraModel.create(fx=REF_K["fx"] * s, fy=REF_K["fy"] * s, cx=REF_K["cx"] * s,
                                  cy=REF_K["cy"] * s, width=W, height=H, dist=REF_D)
    rig = config.get("rig")
    if rig is None:
        return CameraModel.create(fx=k["fx"], fy=k["fy"], cx=k["cx"], cy=k["cy"], width=W,
                                  height=H)
    grow, off = 1.0 + rig["f_step"] * c, c - rig["cameras"] // 2
    return CameraModel.create(fx=k["fx"] * grow, fy=k["fy"] * grow,
                              cx=k["cx"] + rig["cx_step"] * off,
                              cy=k["cy"] + rig["cy_step"] * off, width=W, height=H)


def graph_frame(cam, b: int, seed: int):
    """Frame b of a graph cell: the ideal scene through `cam`'s pinhole,
    then distorted by its plumb_bob model (bench.py:433-437)."""
    from isaac_ros_apriltag_tpu_torch.utils.render import distort_image

    tags, ideal = render_frame(cam, b, seed)
    return tags, distort_image(ideal, cam)


# --- checks -------------------------------------------------------------------

FIELDS = ("valid", "id", "corners", "translation", "quaternion")


def host_frames(outs) -> list[dict]:
    """A list of (Detections, FrameStats) with a leading batch -> one numpy
    dict of FIELDS per frame, in call order; one copy per field."""
    import torch

    stacked = {f: torch.stack([getattr(d, f) for d, _ in outs]).cpu().numpy() for f in FIELDS}
    n, B = stacked["valid"].shape[:2]
    return [{f: stacked[f][i, b] for f in FIELDS} for i in range(n) for b in range(B)]


def _quat_gap(a, b) -> float:
    """Largest |q_a - q_b| over rows, q and -q being one rotation."""
    return float(np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1)).max())


def frame_failures(got: dict, tags, K, ref: dict | None = None, alone: dict | None = None,
                   t_tol: float | None = None) -> tuple[list[str], dict]:
    """Checks of one frame's detections (a numpy dict of FIELDS) against its
    rendered truth (ids exactly the tags', corners within TRUTH_PX of the
    projection through K, translations within t_tol if given), against the
    `torch` backend's result `ref` (BACKEND_TOL on valid rows) and against
    the frame run alone `alone` (BATCH_TOL_PX). Returns (reasons it fails,
    largest gaps)."""
    from isaac_ros_apriltag_tpu_torch.utils.render import project_corners

    why, gaps = [], {}
    v = got["valid"]
    ids = sorted(int(i) for i in got["id"][v])
    want = sorted(t["id"] for t in tags)
    if ids != want:
        why.append(f"ids {ids} != {want}")
    else:
        row = {int(i): k for k, i in enumerate(got["id"]) if v[k]}
        px = t_err = 0.0
        for tag in tags:
            k = row[tag["id"]]
            gt = project_corners(K, tag["R"], tag["t"], tag["tag_size"])
            px = max(px, float(np.linalg.norm(got["corners"][k] - gt, axis=-1).max()))
            t_err = max(t_err, float(np.linalg.norm(got["translation"][k] - tag["t"])))
        gaps["truth_px"] = px
        if not px <= TRUTH_PX:
            why.append(f"corner {px:.3f} px from the truth > {TRUTH_PX}")
        if t_tol is not None:
            gaps["truth_t_m"] = t_err
            if not t_err <= t_tol:
                why.append(f"translation {t_err:.4f} m from the truth > {t_tol}")
    for name, other, tol in (("backend", ref, BACKEND_TOL),
                             ("batch", alone, {"corners": BATCH_TOL_PX})):
        if other is None:
            continue
        if not (np.array_equal(v, other["valid"]) and np.array_equal(got["id"][v],
                                                                    other["id"][v])):
            why.append(f"{name}: valid rows or ids differ")
            continue
        if not v.any():
            continue
        gap = {"corners": float(np.abs(got["corners"][v] - other["corners"][v]).max())}
        if "translation" in tol:
            gap["translation"] = float(np.abs(got["translation"][v]
                                              - other["translation"][v]).max())
            gap["quaternion"] = _quat_gap(got["quaternion"][v], other["quaternion"][v])
        for k, g in gap.items():
            gaps[f"{name}_{k}"] = g
            if not g <= tol[k]:
                why.append(f"{name}: {k} differ by {g:.3g} > {tol[k]}")
    return why, gaps


def tally(frames: list[dict], truths: list, refs: list, alones: list | None, t_tol, index
          ) -> dict:
    """frame_failures over every frame attempted; frame k's truth, reference
    and alone result are those of its distinct frame index(k). Returns the
    count of frames that fail, the largest gaps, the first few reasons, and
    `failed`, the indices of the frames that fail."""
    failed, worst, reasons = [], {}, []
    for k, got in enumerate(frames):
        d = index(k)
        tags, K = truths[d]
        why, gaps = frame_failures(got, tags, K, refs[d], alones[d] if alones else None, t_tol)
        if why:
            failed.append(k)
            if len(reasons) < 5:
                reasons.append(f"frame {k}: " + "; ".join(why))
        for g, x in gaps.items():
            worst[g] = max(worst.get(g, 0.0), x)
    return dict(frames_attempted=len(frames), failures=len(failed), correct=not failed,
                worst=worst, reasons=reasons, failed=failed)


# --- timing ---------------------------------------------------------------------

def tail_percentile(samples) -> float | None:
    """The 95th percentile of samples (linear interpolation), or None unless
    at least TAIL_SAMPLES samples lie beyond it in a sample of this size."""
    n = len(samples)
    if n == 0 or n - 1 - math.floor(0.95 * (n - 1)) < TAIL_SAMPLES:
        return None
    return float(np.percentile(samples, 95))


def summarize(samples_ms, frames: int, wall_s: float) -> dict:
    """The end-to-end metrics of a run: p50 and p95 (tail_percentile) of the
    per-frame samples, quartiles, sample count, frames completed a second."""
    s = np.asarray(samples_ms, np.float64)
    return {"ms_per_frame_p50": float(np.median(s)), "ms_per_frame_p95": tail_percentile(s),
            "frames_per_s": frames / wall_s, "samples": int(s.size),
            "ms_per_frame_q1": float(np.percentile(s, 25)),
            "ms_per_frame_q3": float(np.percentile(s, 75))}


def closed_loop(fn, inputs: list, n: int, overlap: int, keep_from: int = 0):
    """n calls of fn, call i on inputs[i % len(inputs)], with up to `overlap`
    calls in flight (call i + overlap is dispatched before call i is waited
    for). On the card a timing event is recorded after each call: no call
    is synchronised inside. Returns (dispatch times, completion times as the
    host saw them, completion events or None, outputs of calls from
    keep_from on)."""
    import torch

    cuda = inputs[0].device.type == "cuda"
    sent, done, events, outs = [0.0] * n, [0.0] * n, [], []
    window: deque = deque()
    for i in range(n):
        sent[i] = time.perf_counter()
        out = fn(inputs[i % len(inputs)])
        if i >= keep_from:
            outs.append(out)
        if not cuda:
            done[i] = time.perf_counter()
            continue
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        window.append(i)
        if len(window) >= overlap:
            j = window.popleft()
            events[j].synchronize()
            done[j] = time.perf_counter()
    while window:
        j = window.popleft()
        events[j].synchronize()
        done[j] = time.perf_counter()
    return sent, done, events if cuda else None, outs


def timed_run(fn, inputs: list, frames_per_call: int, warm: int, calls: int, overlap: int):
    """`warm` calls, then `calls` timed calls, in one closed loop. Returns
    (summarize's metrics, outputs of the timed calls)."""
    if warm < 1 or calls < 1:
        raise ValueError("a run needs at least one warm and one timed call")
    sent, done, events, outs = closed_loop(fn, inputs, warm + calls, overlap, keep_from=warm)
    timed = range(warm, warm + calls)
    if overlap == 1:
        per_call = [(done[i] - sent[i]) * 1e3 for i in timed]
    elif events is not None:
        per_call = [events[i - 1].elapsed_time(events[i]) for i in timed]
    else:
        per_call = [(done[i] - done[i - 1]) * 1e3 for i in timed]
    wall = done[warm + calls - 1] - done[warm - 1]
    return summarize([t / frames_per_call for t in per_call], calls * frames_per_call,
                     wall), outs


class OpenLoop:
    """Releases frames on a fixed schedule: frame k (frames cycled) is due
    at start + k * period_s. The generator sleeps until a frame is due, and
    releases it late when its consumer kept it busy past that; `due` and
    `released` keep both times of every frame released."""

    def __init__(self, frames: list, n: int, period_s: float, clock=time.perf_counter,
                 sleep=time.sleep):
        self.frames, self.n, self.period = frames, n, period_s
        self.clock, self.sleep = clock, sleep
        self.due: list[float] = []
        self.released: list[float] = []

    def __iter__(self):
        start = self.clock()
        for k in range(self.n):
            due = start + k * self.period
            now = self.clock()
            if now < due:
                self.sleep(due - now)
                now = self.clock()
            self.due.append(due)
            self.released.append(now)
            yield self.frames[k % len(self.frames)]


def open_loop(run, schedule: OpenLoop):
    """Drives run(frames) -> results over the schedule. Returns (outputs,
    ms from each frame's due time to its result, ms each frame was released
    late)."""
    outs, latency = [], []
    for k, out in enumerate(run(schedule)):
        latency.append((schedule.clock() - schedule.due[k]) * 1e3)
        outs.append(out)
    late = [(r - d) * 1e3 for r, d in zip(schedule.released, schedule.due)]
    return outs, latency, late


# --- runners ---------------------------------------------------------------------

def detector_config(config: dict, device: str, **override):
    """DetectorConfig of the configuration; on the CPU its backend is
    'torch' (the kernels' plain versions)."""
    from isaac_ros_apriltag_tpu_torch import DetectorConfig

    cfg = DetectorConfig(**{**config["detector"], **override})
    if device == "cpu":
        cfg = dataclasses.replace(cfg, backend="torch")
    return cfg


def _backends(cfg, device: str):
    """(cfg, its 'torch' twin), after device_for (which builds the kernels
    and turns TF32 off on the card)."""
    from isaac_ros_apriltag_tpu_torch.detector import device_for

    device_for(cfg, device)
    return cfg, dataclasses.replace(cfg, backend="torch")


def _first_call_ms(fn, x) -> float:
    """ms of one call, waited for: the set-up cost of the first call."""
    import torch

    t0 = time.perf_counter()
    fn(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _batches(frame, cam, traffic: dict, seed: int, device: str):
    """The distinct frames of a closed-loop cell, frame(cam, b, seed) for
    each b, as the batches its calls cycle through, on the device. Returns
    (scenes, batches, batch size, distinct frames)."""
    import torch

    B = traffic["batch"]
    distinct = traffic["distinct"]
    if distinct % B and B % distinct:
        raise ValueError(f"distinct {distinct} and batch {B}: one must divide the other")
    n_inputs = max(distinct // B, 1)
    scenes = [frame(cam, b, seed) for b in range(distinct)]
    host = np.stack([scenes[k % distinct][1] for k in range(n_inputs * B)])
    inputs = list(torch.from_numpy(host).to(device).reshape(n_inputs, B, *host.shape[1:]))
    return scenes, inputs, B, distinct


def prepare_detect(config: dict, traffic: dict, seed: int, device: str, override: dict):
    """The detect runner's pieces: batched_detect_fn on batches of the bench
    scene already on the device."""
    from isaac_ros_apriltag_tpu_torch import batched_detect_fn

    cfg, ref_cfg = _backends(detector_config(config, device, **override), device)
    cam = config_camera(config)
    scenes, inputs, B, distinct = _batches(render_frame, cam, traffic, seed, device)
    cam_d = cam.to(device)
    K = cam.K.numpy()
    return dict(cfg=cfg, cam=cam_d, fn=batched_detect_fn(cfg, cam_d, config["encoding"]),
                ref=batched_detect_fn(ref_cfg, cam_d, config["encoding"]), inputs=inputs,
                batch=B, distinct=distinct, truths=[(tags, K) for tags, _ in scenes], t_tol=None)


def prepare_graph(config: dict, traffic: dict, seed: int, device: str, override: dict):
    """The graph runner's pieces: GraphPipeline(downscale).batched on
    distorted frames; the truth is projected through the detection camera."""
    from isaac_ros_apriltag_tpu_torch import GraphPipeline

    cfg, ref_cfg = _backends(detector_config(config, device, **override), device)
    cam = config_camera(config)
    scenes, inputs, B, distinct = _batches(graph_frame, cam, traffic, seed, device)
    gp, ref = (GraphPipeline(c, cam, downscale=config["downscale"], encoding=config["encoding"],
                             device=device) for c in (cfg, ref_cfg))
    K = gp.detect_camera.K.cpu().numpy()
    return dict(cfg=cfg, fn=gp.batched, ref=ref.batched, inputs=inputs, batch=B,
                distinct=distinct, truths=[(tags, K) for tags, _ in scenes], t_tol=None)


def prepare_rig(config: dict, traffic: dict, seed: int, device: str, override: dict):
    """The rig runner's pieces: RigDetector over the rig's cameras, each
    with its own K, one rig frame (camera c is frame c) a call; translations
    are held to the truth too."""
    import torch

    from isaac_ros_apriltag_tpu_torch import RigDetector

    cfg, ref_cfg = _backends(detector_config(config, device, **override), device)
    n = config["rig"]["cameras"]
    cams = [config_camera(config, c) for c in range(n)]
    scenes = [render_frame(cams[c], c, seed) for c in range(n)]
    x = torch.from_numpy(np.stack([f for _, f in scenes])).to(device)
    rig, ref = (RigDetector(c, cams[0], n, device=device, encoding=config["encoding"],
                            cameras=cams) for c in (cfg, ref_cfg))
    return dict(cfg=cfg, fn=rig.detect, ref=ref.detect, inputs=[x], batch=n, distinct=n,
                truths=[(tags, cams[c].K.numpy()) for c, (tags, _) in enumerate(scenes)],
                t_tol=config["rig"]["truth_t_m"], alone=False)


PREPARE = {"detect": prepare_detect, "graph": prepare_graph, "rig": prepare_rig}


def run_closed(runner: str, config: dict, traffic: dict, seed: int = 0, device: str = "cuda",
               override: dict | None = None) -> tuple[dict, dict]:
    """A closed-loop cell (runner detect, graph or rig): set-up call, warm
    and timed calls, then every timed frame checked. Returns (the result,
    the prepared pieces, for the traced run)."""
    p = PREPARE[runner](config, traffic, seed, device, override or {})
    B, inputs, distinct = p["batch"], p["inputs"], p["distinct"]
    setup_ms = _first_call_ms(p["fn"], inputs[0])
    metrics, outs = timed_run(p["fn"], inputs, B, traffic["warm"], traffic["calls"],
                              traffic["overlap"])
    frames = host_frames(outs)
    del outs
    # Distinct frame d is slot d % B of input d // B.
    refs = host_frames([p["ref"](x) for x in inputs])[:distinct]
    alones = None
    if B > 1 and p.get("alone", True):
        alones = host_frames([p["fn"](inputs[d // B][d % B:d % B + 1])
                              for d in range(distinct)])
    warm, n_inputs = traffic["warm"], len(inputs)
    # Timed frame k is slot k % B of call warm + k // B, which ran on input
    # (warm + k // B) % n_inputs.
    checks = tally(frames, p["truths"], refs, alones, p["t_tol"],
                   index=lambda k: ((warm + k // B) % n_inputs * B + k % B) % distinct)
    checks.pop("failed")
    return dict(metrics, **checks, setup_ms=setup_ms, batch=B, distinct=distinct,
                device=device), p


def run_stream(config: dict, traffic: dict, seed: int = 0, device: str = "cuda",
               override: dict | None = None) -> tuple[dict, dict]:
    """The stream runner: StreamingRunner(fn, STREAM_DEPTH) over host frames
    that OpenLoop releases at traffic['hz'] for traffic['seconds']; a frame
    whose result comes more than one period after it was due is a failure,
    as is a wrong one."""
    import torch

    from isaac_ros_apriltag_tpu_torch import StreamingRunner, batched_detect_fn

    cfg, ref_cfg = _backends(detector_config(config, device, **(override or {})), device)
    cam = config_camera(config)
    distinct = traffic["distinct"]
    scenes = [render_frame(cam, b, seed) for b in range(distinct)]
    host = [f for _, f in scenes]
    cam_d = cam.to(device)
    batched = batched_detect_fn(cfg, cam_d, config["encoding"])
    runner = StreamingRunner(lambda x: batched(x[None]), depth=STREAM_DEPTH, device=device)
    setup_ms = _first_call_ms(lambda x: batched(x[None]), torch.from_numpy(host[0]).to(device))
    for _ in runner.run(host[:traffic["warm"]]):
        pass
    period = 1.0 / traffic["hz"]
    n = round(traffic["hz"] * traffic["seconds"])
    schedule = OpenLoop(host, n, period)
    outs, latency, late = open_loop(runner.run, schedule)
    wall = schedule.clock() - schedule.due[0]
    ref_fn = batched_detect_fn(ref_cfg, cam_d, config["encoding"])
    refs = host_frames([ref_fn(torch.from_numpy(f).to(device)[None]) for f in host])
    checks = tally(host_frames(outs), [(tags, cam.K.numpy()) for tags, _ in scenes], refs, None,
                   None, index=lambda k: k % distinct)
    deadline = period * 1e3
    missed = [k for k, t in enumerate(latency) if t > deadline]
    failures = len(set(missed) | set(checks["failed"]))
    s = np.asarray(latency)
    result = {"latency_ms_p50": float(np.median(s)), "latency_ms_p95": tail_percentile(s),
              "frames_per_s": n / wall, "samples": n, "deadline_ms": deadline,
              "deadline_misses": len(missed), "wrong_frames": checks["failures"],
              "generator_late_ms_p50": float(np.median(late)),
              "generator_late_ms_max": float(np.max(late)), "setup_ms": setup_ms,
              "frames_attempted": n, "failures": failures, "correct": checks["correct"],
              "worst": checks["worst"], "reasons": checks["reasons"], "device": device}
    return result, dict(cfg=cfg)


def run_cell(cell: dict, config: dict, seed: int = 0, device: str = "cuda",
             traffic: dict | None = None, override: dict | None = None):
    """Run one cell (or one of its details, with traffic and detector
    overrides) by its runner. Returns (result, prepared pieces)."""
    t = dict(cell["traffic"], **(traffic or {}))
    if cell["runner"] == "stream":
        return run_stream(config, t, seed, device, override)
    return run_closed(cell["runner"], config, t, seed, device, override)


# Each runner's traffic keys.
CLOSED = ("batch", "overlap", "distinct", "warm", "calls")
RUNNERS = {"detect": CLOSED, "graph": CLOSED, "rig": ("overlap", "warm", "calls"),
           "stream": ("hz", "seconds", "distinct", "warm")}


# --- the traced run (per-layer figures) ----------------------------------------------

def trace_layers(fn, inputs: list, overlap: int, seg: tuple | None) -> dict:
    """torch.profiler over PROFILED_CALLS calls dispatched as in the cell
    (after 3 untraced ones); breakdown() of its device and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    closed_loop(fn, inputs, 3, overlap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        closed_loop(fn, inputs, PROFILED_CALLS, overlap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {torch.autograd.DeviceType.CUDA: [], torch.autograd.DeviceType.CPU: []}
    for e in prof.events():
        if e.device_type in spans:
            spans[e.device_type].append((e.name, e.time_range.start, e.time_range.end))
    return breakdown(spans[torch.autograd.DeviceType.CUDA], spans[torch.autograd.DeviceType.CPU],
                     PROFILED_CALLS, wall_ms, seg)


def breakdown(dev: list, host: list, n: int, wall_ms: float, seg: tuple | None) -> dict:
    """Per-call figures of n calls from their device and host ops, each
    (name, start us, end us) on one clock, over `wall_ms` of host time:
    device busy ms (the union of the device ops' spans) and the idle share
    of the wall, device ops and kernels a call, the TOP_OPS device ops with
    the most time (and every device op, in the record only), the TOP_GAPS
    longest gaps between device ops, each with the innermost host op in
    progress at its middle and the device op that ended it, and with seg =
    (B, h, w) K1, K2 and K3's ms a launch against their bound there."""
    dev = sorted(dev, key=lambda e: e[1])
    by_name: dict[str, list] = {}
    gaps, end = [], None
    busy = 0.0
    for name, a, b in dev:
        t = by_name.setdefault(name[:100], [0.0, 0])
        t[0] += (b - a) / 1e3 / n
        t[1] += 1
        if end is not None and a > end:
            gaps.append((a - end, end, name))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    top = sorted(([k, ms, c / n] for k, (ms, c) in by_name.items()), key=lambda r: -r[1])
    gap_rows = []
    for g, start, nxt in sorted(gaps, key=lambda g: -g[0])[:TOP_GAPS]:
        mid = start + g / 2
        inner = min((h for h in host if h[1] <= mid <= h[2]), key=lambda h: h[2] - h[1],
                    default=None)
        gap_rows.append({"gap_ms": g / 1e3, "host_op": inner[0] if inner else None,
                         "next_device_op": nxt[:100]})
    out = {"profiled_calls": n, "wall_ms_per_call": wall_ms / n,
           "device_busy_ms_per_call": busy / 1e3 / n, "idle_share": 1 - busy / 1e3 / wall_ms,
           "device_ops_per_call": len(dev) / n,
           "kernels_per_call": sum(not e[0].startswith(("Memcpy", "Memset")) for e in dev) / n,
           "top_device_ops_ms_and_calls": top[:TOP_OPS], "device_ops_ms_and_calls": top,
           "idle_gaps": gap_rows}
    if seg is not None:
        for k, (part, bytes_px) in KERNELS.items():
            ms = [(b - a) / 1e3 for name, a, b in dev if part in name]
            bound = math.prod(seg) * bytes_px / HBM_BYTES_PER_S * 1e3
            per = float(np.mean(ms)) if ms else None
            out[k] = {"shape": list(seg), "launches_per_call": len(ms) / n,
                      "ms_per_call": sum(ms) / n, "ms_per_launch": per,
                      "bound_ms_per_launch": bound, "share_of_bound": bound / per if per else None}
    return out


def seg_shape(cfg, B: int, H: int, W: int) -> tuple:
    """(B, h, w) of the segmentation image K1, K2 and K3 see: the frame
    decimated and padded to whole tiles."""
    d, ts = cfg.quad_decimate, cfg.tile_size

    def side(n):
        n = -(-n // d)
        return -(-n // ts) * ts
    return (B, side(H), side(W))


def layers(cell: dict, config: dict, prepared: dict, p50: float) -> dict:
    """The per-layer figures of a closed-loop cell, after its timed run:
    stage ms a call (torch_stage_profile's CUDA-event spans; detect runner
    only) with the residual against the cell's median call and the split of
    front against tail, the traced run (trace_layers), and the peak device
    memory of one call with the cell's inputs resident."""
    import torch

    fn, inputs, B, cfg = (prepared[k] for k in ("fn", "inputs", "batch", "cfg"))
    out = {}
    if cell["runner"] == "detect":
        from torch_stage_profile import STAGES, _stage_ms

        st = _stage_ms(cfg, prepared["cam"], inputs[0], STAGE_CALLS)
        stages = {k: st[k] for k in STAGES}
        front = sum(stages[k] for k in STAGES[:FRONT_STAGES])
        out.update(stage_ms_per_call=stages, stage_sum_ms=st["sum"],
                   residual_ms=p50 * B - st["sum"], front_ms=front, tail_ms=st["sum"] - front)
    H, W = config["height"], config["width"]
    if cell["runner"] == "graph":
        H, W = H // config["downscale"], W // config["downscale"]
    out.update(trace_layers(fn, inputs, cell["traffic"]["overlap"], seg_shape(cfg, B, H, W)))
    # The profiler slows the host's dispatch; against the untraced median call
    # the idle share is the one the timed run saw.
    out["idle_share_of_median_call"] = 1 - out["device_busy_ms_per_call"] / (p50 * B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(inputs[0])
    torch.cuda.synchronize()
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


# --- the record ---------------------------------------------------------------------

def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"] + spec.get("held_back", []):
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def check_cell(spec: dict, cell: dict) -> None:
    """Raises ValueError unless the cell names a known runner with exactly
    its traffic keys, a configuration of the spec with a source of at most
    200 characters, and detector settings (its own and each detail's) that
    DetectorConfig accepts."""
    from isaac_ros_apriltag_tpu_torch import DetectorConfig

    name = cell.get("name", "")
    if cell.get("runner") not in RUNNERS or cell.get("config") not in spec["configs"]:
        raise ValueError(f"cell {name!r}: unknown runner or config")
    keys = RUNNERS[cell["runner"]]
    for traffic in [cell["traffic"]] + [dict(cell["traffic"], **d.get("traffic", {}))
                                        for d in cell.get("details", [])]:
        if set(traffic) != set(keys):
            raise ValueError(f"cell {name!r}: traffic keys {sorted(traffic)}; runner "
                             f"{cell['runner']!r} takes {keys}")
    config = spec["configs"][cell["config"]]
    if len(config["source"]) > 200:
        raise ValueError(f"config {cell['config']!r}: source longer than 200 characters")
    for d in [{}] + cell.get("details", []):
        DetectorConfig(**{**config["detector"], **d.get("detector", {})})


def host_us_per_op() -> float:
    """us the host takes to dispatch one small op to the card (an in-place add
    to one float), over 2000 ops: the host's dispatch rate, which bounds a
    host-bound cell and differs from machine to machine."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


class Record:
    """The JSON record: printed whole on one line after each section (and
    written to `out`), so the last line of stdout is always the fullest."""

    def __init__(self, gpu: str, seed: int, out: str | None):
        self.out = out
        self.data = {"metric": HEADLINE[0], "value": None, "unit": "frames/s", "gpu": gpu,
                     "seed": seed, "correct": True, "cells": {}}

    def emit(self) -> None:
        text = json.dumps(self.data)
        say(text)
        if self.out:
            os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
            with open(self.out, "w") as f:
                f.write(text + "\n")

    @contextlib.contextmanager
    def section(self, cell: str, name: str):
        """A section of a cell: an error is recorded as <name>_error on the
        cell, marks the record incorrect, and does not stop the run."""
        entry = self.data["cells"].setdefault(cell, {"gpu": self.data["gpu"]})
        t0 = time.perf_counter()
        try:
            yield entry
            print(f"# {cell} {name} done in {time.perf_counter() - t0:.1f} s on "
                  f"{self.data['gpu']}", file=sys.stderr, flush=True)
        except Exception as e:   # noqa: BLE001 - a dead section costs only its own fields
            import traceback

            entry[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
            self.data["correct"] = False
            traceback.print_exc()
        self.emit()


def say(text: str) -> None:
    print(text, flush=True)


def _line(cell: str, r: dict, gpu: str) -> str:
    """A cell's end-to-end figures as one line."""
    if "latency_ms_p50" in r:
        figures = (f"latency from due p50 {r['latency_ms_p50']:.3f} ms, p95 "
                   f"{r['latency_ms_p95']} ms, {r['deadline_misses']} over "
                   f"{r['deadline_ms']:.1f} ms, generator late p50 "
                   f"{r['generator_late_ms_p50']:.3f} max {r['generator_late_ms_max']:.3f} ms")
    else:
        figures = (f"ms_per_frame p50 {r['ms_per_frame_p50']:.3f}, p95 {r['ms_per_frame_p95']}, "
                   f"q1 {r['ms_per_frame_q1']:.3f}, q3 {r['ms_per_frame_q3']:.3f}")
    return (f"# {cell} on {gpu}: {figures} over {r['samples']} samples; frames_per_s "
            f"{r['frames_per_s']:.2f}; {r['failures']} failures of {r['frames_attempted']} "
            f"frames; set-up {r['setup_ms']:.1f} ms")


def _layer_lines(cell: str, L: dict, gpu: str) -> list[str]:
    """A cell's per-layer figures and breakdown as lines."""
    head = f"# {cell} layers on {gpu}:"
    lines = []
    if "stage_ms_per_call" in L:
        lines.append(f"{head} stage ms a call " + ", ".join(
            f"{k} {v:.3f}" for k, v in L["stage_ms_per_call"].items())
            + f"; sum {L['stage_sum_ms']:.3f}, residual against the median call "
            f"{L['residual_ms']:.3f}; front {L['front_ms']:.3f}, tail {L['tail_ms']:.3f}")
    lines.append(f"{head} traced over {L['profiled_calls']} calls: device busy "
                 f"{L['device_busy_ms_per_call']:.3f} ms of {L['wall_ms_per_call']:.3f} ms a "
                 f"call, idle share {L['idle_share']:.3f} ({L['idle_share_of_median_call']:.3f} "
                 f"of the untraced median call); {L['kernels_per_call']:.0f} kernels "
                 f"({L['device_ops_per_call']:.0f} device ops) a call; peak memory "
                 f"{L['peak_memory_gib']:.3f} GiB")
    for k in KERNELS:
        if k in L and L[k]["ms_per_launch"] is not None:
            q = L[k]
            lines.append(f"{head} {k} at {q['shape']}: {q['launches_per_call']:.0f} launches a "
                         f"call, {q['ms_per_launch']:.4f} ms a launch, bound "
                         f"{q['bound_ms_per_launch']:.4f} ms ({q['share_of_bound']:.1%})")
    lines.append(f"{head} top device ops (ms a call, launches a call): " + "; ".join(
        f"{n} {ms:.3f} {c:.0f}" for n, ms, c in L["top_device_ops_ms_and_calls"]))
    lines.append(f"{head} longest idle gaps (ms, host op in progress, next device op): "
                 + "; ".join(
        f"{g['gap_ms']:.3f} {g['host_op'] or '(no host op)'} -> {g['next_device_op']}"
        for g in L["idle_gaps"]))
    return lines


def bench_cell(record: Record, spec: dict, cell: dict, seed: int) -> None:
    """A cell's sections: timed (with its checks), each detail, layers."""
    name, gpu = cell["name"], record.data["gpu"]
    config = spec["configs"][cell["config"]]
    prepared = None
    with record.section(name, "timed") as entry:
        result, prepared = run_cell(cell, config, seed)
        entry.update(result, runner=cell["runner"], config=cell["config"])
        if not result["correct"]:
            record.data["correct"] = False
        if name == HEADLINE[1]:
            record.data["value"] = result["frames_per_s"]
        say(_line(name, result, gpu))
    for detail in cell.get("details", []):
        with record.section(name, detail["name"]) as entry:
            r, _ = run_cell(cell, config, seed, traffic=detail.get("traffic"),
                            override=detail.get("detector"))
            entry[detail["name"]] = {k: r[k] for k in (
                "frames_per_s", "ms_per_frame_p50", "samples", "failures", "frames_attempted")}
            if not r["correct"]:
                record.data["correct"] = False
            say(_line(f"{name} {detail['name']}", r, gpu))
    if prepared is not None and "inputs" in prepared:
        with record.section(name, "layers") as entry:
            entry["layers"] = layers(cell, config, prepared, entry["ms_per_frame_p50"])
            for line in _layer_lines(name, entry["layers"], gpu):
                say(line)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", help="a cell of BENCHMARK.json (repeatable); "
                    "default: every cell of its workloads")
    ap.add_argument("--seed", type=int, default=0, help="noise seed of frame 0 (frame b: seed + b)")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device", file=sys.stderr)
        return 1
    spec = load_spec()
    cells = [find_cell(spec, n) for n in args.cell] if args.cell else spec["workloads"]
    for cell in cells:
        check_cell(spec, cell)
    from chip_smoke import _gpu_info

    record = Record(_gpu_info(), args.seed, args.out)
    record.data["host_us_per_op"] = host_us_per_op()
    say(f"# host dispatch on {record.data['gpu']}: {record.data['host_us_per_op']:.2f} us an op")
    record.emit()
    for cell in cells:
        bench_cell(record, spec, cell, args.seed)
        if "kernel_build_s" not in record.data:
            from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

            record.data["kernel_build_s"] = _lib.build_seconds
    record.emit()
    return 0 if record.data["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
