"""Command-line interface: detect | bench.

Counterpart of ``isaac_ros_apriltag_tpu/cli.py``, with the same detector
flags (the reference's launch arguments ``tag_family``, ``backends``,
``size``, ``max_tags``, ``tile_size``, ``quad_decimate``), backends
``torch|cuda`` and a ``--device`` (default ``cuda``; ``--device cpu`` runs
backend ``torch`` on the CPU):

    python -m isaac_ros_apriltag_tpu_torch detect --image frame.npy --fx 600 ...
    python -m isaac_ros_apriltag_tpu_torch bench --hw 1080,1920 --batch 8 --iters 30

`detect` reads an image (.npy, or PNG through cv2 where it is installed),
runs the detector and prints one JSON line per detection. `bench` prints the
fps of the batched detector on a synthetic six-tag scene as one JSON line
and exits non-zero if it found no tag. The reference's `slam` subcommand is
not ported yet.
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
    p.add_argument("--device", default="cuda",
                   help="cuda | cpu (cpu runs backend torch)")


def _config(args):
    from .config import DetectorConfig

    return DetectorConfig(tag_family=args.tag_family, backend=args.backends,
                          tag_size=args.size, max_tags=args.max_tags,
                          tile_size=args.tile_size,
                          quad_decimate=args.quad_decimate)


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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
