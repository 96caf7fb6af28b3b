"""Command-line interface: detect | bench | slam.

Counterpart of ``isaac_ros_apriltag_tpu/cli.py``, with the same detector
flags (the reference's launch arguments ``tag_family``, ``backends``,
``size``, ``max_tags``, ``tile_size``, ``quad_decimate``), backends
``torch|cuda``, a ``--ccl-flow scan|jumps`` (``jumps`` is the flow the
reference runs with ``--backends xla``) and a ``--device`` (default
``cuda``; ``--device cpu`` runs backend ``torch`` on the CPU):

    python -m isaac_ros_apriltag_tpu_torch detect --image frame.npy --fx 600 ...
    python -m isaac_ros_apriltag_tpu_torch bench --hw 1080,1920 --batch 8 --iters 30
    python -m isaac_ros_apriltag_tpu_torch slam --frames 16 --tags 9

`detect` reads an image (.npy, or PNG through cv2 where it is installed),
runs the detector and prints one JSON line per detection. `bench` prints the
fps of the batched detector on a synthetic six-tag scene as one JSON line
and exits non-zero if it found no tag. `slam` renders a synthetic orbit
around a wall of tags, maps it (TagMapper), optimizes it with BA, prints
one JSON line with the ATE and exits non-zero if the ATE is over
--ate-bound; --save-map / --load-map write and read the map checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def _add_detector_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tag-family", default="tag36h11")
    p.add_argument("--backends", default="cuda",
                   help="torch | cuda (reference: CPU|CUDA|PVA)")
    p.add_argument("--size", type=float, default=0.22,
                   help="tag edge length, meters")
    p.add_argument("--max-tags", type=int, default=64)
    p.add_argument("--tile-size", type=int, default=4)
    p.add_argument("--quad-decimate", type=int, default=2)
    p.add_argument("--ccl-flow", default="scan",
                   help="scan | jumps (jumps: the reference's xla flow)")
    p.add_argument("--device", default="cuda",
                   help="cuda | cpu (cpu runs backend torch)")


def _config(args):
    from .config import DetectorConfig

    return DetectorConfig(tag_family=args.tag_family, backend=args.backends,
                          tag_size=args.size, max_tags=args.max_tags,
                          tile_size=args.tile_size,
                          quad_decimate=args.quad_decimate, ccl_flow=args.ccl_flow)


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu --backends torch to run on the CPU")
    return device


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"need cv2 to read {path}; use .npy instead") from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return img


def cmd_detect(args) -> int:
    from .camera.model import CameraModel
    from .detector import Detector

    cfg = _config(args)
    img = _load_image(args.image)
    H, W = img.shape[:2]
    if args.camera_info:
        with open(args.camera_info) as f:
            cam = CameraModel.from_camera_info(json.load(f))
    else:
        fx = args.fx or 0.6 * W
        cam = CameraModel.create(fx=fx, fy=args.fy or fx,
                                 cx=args.cx if args.cx is not None else W / 2,
                                 cy=args.cy if args.cy is not None else H / 2,
                                 width=W, height=H)
    det = Detector(cfg, cam, device=_device(args))
    if not det.family.exact:
        print(f"# WARNING: {det.family.name} uses a self-generated stand-in "
              "codebook (the published table is not regenerable offline) — "
              "ids will NOT match physical tags; vendor the official table "
              "via models.families.register_family for interop",
              file=sys.stderr)
    encoding = "mono8" if img.ndim == 2 else "rgb8"
    t0 = time.perf_counter()
    rows = det.detect(img, encoding=encoding).to_list()
    dt = time.perf_counter() - t0
    for r in rows:
        print(json.dumps(r))
    print(f"# {len(rows)} detections in {dt*1000:.1f} ms (first call)", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from .camera.model import CameraModel
    from .detector import device_for
    from .models.families import get_family
    from .pipeline import batched_detect_fn
    from .utils.render import render_tags, upright_pose
    from .utils.timing import throughput

    H, W = map(int, args.hw.split(","))
    cfg = dataclasses.replace(_config(args), tag_size=0.3)
    device = device_for(cfg, _device(args))
    cam = CameraModel.create(fx=900.0 * W / 1920, fy=900.0 * W / 1920,
                             cx=W / 2, cy=H / 2, width=W, height=H)
    fam = get_family(args.tag_family)
    tags = []
    for i, (x, y) in enumerate([(-0.8, -0.45), (0.0, -0.45), (0.8, -0.45),
                                (-0.8, 0.45), (0.0, 0.45), (0.8, 0.45)]):
        t = np.array([x, y, 2.5])
        tags.append(dict(family=fam, id=7 * i + 1, R=upright_pose(t, 0.1 * i),
                         t=t, tag_size=0.3))
    frame = render_tags(cam.K.numpy(), (H, W), tags, noise=args.noise)
    fn = batched_detect_fn(cfg, cam.to(device), "mono8")
    x = torch.from_numpy(np.stack([frame] * args.batch)).to(device)
    # Every call is waited for (utils/timing.py): the fps is of finished work.
    dt, (det, stats) = throughput(fn, x, args.iters)
    n = int(stats.num_detections.sum()) // args.batch
    fps = args.batch * args.iters / dt
    print(json.dumps({"fps": round(fps, 1), "detections_per_frame": n,
                      "backend": cfg.backend, "hw": [H, W]}))
    return 0 if n > 0 else 1


def slam_orbit(n_frames: int = 16, n_tags: int = 9, tag_size: float = 0.22,
               noise: float = 1.0, tag_family: str = "tag36h11"):
    """The `slam` subcommand's synthetic trajectory: a 640x480 camera
    orbiting a wall of `n_tags` tags (ids 1, 4, 7, ...). Returns the camera,
    the `n_frames` rendered uint8 frames (noise seed k for frame k) and the
    true camera centres, (n_frames, 3)."""
    from .camera.model import CameraModel
    from .models.families import get_family
    from .utils.render import render_tags, rotz

    cam = CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    fam = get_family(tag_family)
    ncols = int(np.ceil(np.sqrt(n_tags)))
    wall = []
    for i in range(n_tags):
        gx = (i % ncols - (ncols - 1) / 2.0) * 0.5
        gy = (i // ncols - (n_tags // ncols) / 2.0) * 0.5
        wall.append((i * 3 + 1, np.array([gx, gy, 0.0])))
    frames, gt_traj = [], []
    for k in range(n_frames):
        ang = 0.25 * np.sin(2 * np.pi * k / n_frames)
        c = np.array([1.2 * np.sin(ang), 0.15 * np.sin(2 * ang), -2.0 - 0.3 * np.cos(ang)])
        R_wc = rotz(0.05 * np.sin(ang))
        gt_traj.append(c)
        tags = []
        for tid, p in wall:
            R_wt = np.diag([1.0, 1.0, 1.0])
            R_ct = R_wc.T @ R_wt @ np.diag([-1.0, -1.0, 1.0])
            t_ct = R_wc.T @ (p - c)
            if t_ct[2] < 0.3:
                continue
            tags.append(dict(family=fam, id=tid, R=R_ct, t=t_ct, tag_size=tag_size))
        frames.append(render_tags(cam.K.numpy(), (480, 640), tags, noise=noise, seed=k))
    return cam, frames, np.stack(gt_traj)


def cmd_slam(args) -> int:
    from .detector import Detector
    from .parallel.slam import ba
    from .parallel.slam.map import TagMapper, ate_rmse

    device = _device(args)
    cam, frames, gt_traj = slam_orbit(args.frames, args.tags, args.size, args.noise,
                                      args.tag_family)
    mapper = TagMapper(K=cam.K.numpy(), tag_size=args.size, device=device)
    if args.load_map:
        mapper.load(args.load_map)
        print(f"# loaded map with {len(mapper.lm_ids)} landmarks", file=sys.stderr)
    det = Detector(_config(args), cam, device=device)
    for img in frames:
        mapper.process_frame(det.detect(img, encoding="mono8"))
    p = mapper.build_problem()
    p, rms = ba.solve(p, iters=args.ba_iters)
    mapper.update_from_problem(p)
    est = np.stack(mapper.kf_t)
    ate = ate_rmse(est, gt_traj)
    if args.save_map:
        mapper.save(args.save_map)
        print(f"# saved map to {args.save_map}", file=sys.stderr)
    print(json.dumps({"frames": args.frames, "tags_mapped": len(mapper.lm_ids),
                      "final_rms_px": float(rms[-1]), "ate_rmse_m": ate}))
    return 0 if ate < args.ate_bound else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="isaac_ros_apriltag_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="detect tags in one image")
    _add_detector_flags(d)
    d.add_argument("--image", required=True)
    d.add_argument("--camera-info", help="CameraInfo-style JSON file")
    d.add_argument("--fx", type=float)
    d.add_argument("--fy", type=float)
    d.add_argument("--cx", type=float)
    d.add_argument("--cy", type=float)
    d.set_defaults(fn=cmd_detect)

    b = sub.add_parser("bench", help="throughput on a synthetic scene")
    _add_detector_flags(b)
    b.add_argument("--hw", default="1080,1920")
    b.add_argument("--batch", type=int, default=8)
    b.add_argument("--iters", type=int, default=30)
    b.add_argument("--noise", type=float, default=2.0)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("slam", help="synthetic-trajectory tag mapping + BA")
    _add_detector_flags(s)
    s.add_argument("--frames", type=int, default=16)
    s.add_argument("--tags", type=int, default=9)
    s.add_argument("--noise", type=float, default=1.0)
    s.add_argument("--ba-iters", type=int, default=8)
    s.add_argument("--ate-bound", type=float, default=0.05)
    s.add_argument("--save-map")
    s.add_argument("--load-map")
    s.set_defaults(fn=cmd_slam)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
