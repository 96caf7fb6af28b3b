#!/usr/bin/env python3
"""Device time of the two CCL scan kernels (K2 row scan, K3 diagonal hop +
column scan) of one checkout, to compare two trees on one card in one call.

    python3 torch_kernel_times.py [--root DIR]

Builds the kernels of the package under DIR (default: this checkout) and
prints one JSON line: the card's nvidia-smi name and power limit, DIR, and
for each shape three readings of each kernel's device ms per call (50
launches queued behind a spin kernel, chip_smoke.py's _device_ms) on a
random trinary with labels after 8 scan rounds. The shapes are the batch-8
and batch-1 segmentations of the 1080p main path, the 8 MP spatial path's
four bands, and rows past 4096 pixels (a checkout whose wrapper refuses
them reports the refusal). Compare a parent and a change in turns: parent,
change, change, parent. Without a CUDA device it exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SHAPES = ((8, 540, 960), (1, 540, 960), (4, 272, 1920), (1, 2160, 7680))
READINGS = 3


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib, ccl

    # Imported after the package under --root, which chip_smoke's own path
    # entry must not shadow.
    from chip_smoke import _device_ms, _gpu_info

    _lib.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out = {"gpu": _gpu_info(), "root": root}
    for shape in SHAPES:
        tri = torch.from_numpy(rng.choice(np.array([0, 127, 255], np.uint8), size=shape,
                                          p=[0.3, 0.2, 0.5])).to(dev)
        key = "x".join(map(str, shape))
        try:
            lab, _ = ccl.ccl_scan(tri, 8, backend="cuda")
        except ValueError as e:        # a wrapper that refuses the line length
            out[key] = f"refused: {e}"
            continue
        out[key] = {name: [_device_ms(lambda: kern(tri, lab), 50) for _ in range(READINGS)]
                    for name, kern in (("row", ccl.row_scan), ("col", ccl.col_diag_scan))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
