#!/usr/bin/env python3
"""Where each frame's latency goes in torch_bench.py's open-loop cells.

    python3 torch_bench_latency.py [--cell NAME] [--seed S] [--root DIR] [--out FILE]

Runs one stream cell (default node-720p-30hz) through torch_bench.run_cell
of the checkout under DIR (default: this one) and keeps, for every timed
frame, four times: its latency from its due time (the cell's metric), how
late the generator released it, the time from its release to its result,
and the device time of its detect call (CUDA events on the compute stream
around the call, so from its upload's end to its last kernel; a host stall
while the call is issued falls in it too). The host's share of a frame is
its latency less its late release and its device time. Prints one JSON
line: p50, p95 and max of each; the frames slower than twice the median
latency, each with its times, its index and the second of the run it
falls in; and how many of those have their largest excess over the
run's median in the late release, the device time or the host's share.
With --out, the per-frame lists go to FILE. Compare a parent and a change
in turns, each with its own --root, in one process each. Exits with
torch_bench's verdict (1 if a frame failed); without a CUDA device it
exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cell", default="node-720p-30hz")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bench_latency: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch_bench

    import isaac_ros_apriltag_tpu_torch as port

    kept, calls = {}, []
    open_loop = torch_bench.open_loop

    def recording_open_loop(run, schedule):
        outs, latency, late = open_loop(run, schedule)
        kept.update(latency=latency, late=late)
        return outs, latency, late

    class TimedRunner(port.StreamingRunner):
        """The cell's runner with CUDA events around each detect call."""

        def __init__(self, fn, *a, **kw):
            def timed(x):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = fn(x)
                end.record()
                calls.append((start, end))
                return out

            super().__init__(timed, *a, **kw)

    torch_bench.open_loop = recording_open_loop
    port.StreamingRunner = TimedRunner
    spec = torch_bench.load_spec()
    cell = torch_bench.find_cell(spec, args.cell)
    if cell["runner"] != "stream":
        raise SystemExit(f"{args.cell} is a {cell['runner']!r} cell, not an open-loop stream")
    result, _ = torch_bench.run_cell(cell, spec["configs"][cell["config"]], args.seed)
    torch.cuda.synchronize()
    latency = np.asarray(kept["latency"])
    late = np.asarray(kept["late"])
    n = latency.size
    device = np.asarray([s.elapsed_time(e) for s, e in calls[-n:]])
    service = latency - late
    host = service - device
    period_ms = 1e3 / cell["traffic"]["hz"]
    slow = np.flatnonzero(latency > 2 * np.median(latency))
    parts = {"late": late, "device": device, "host": host}
    excess = np.stack([x[slow] - np.median(x) for x in parts.values()])
    slow_by = dict(zip(parts, np.bincount(excess.argmax(0), minlength=3).tolist()))

    def tail(x):
        return {"p50": float(np.median(x)), "p95": float(np.percentile(x, 95)),
                "max": float(x.max())}

    line = {"cell": args.cell, "seed": args.seed, "root": root, "frames": int(n),
            "failures": result["failures"], "latency_ms_p95": result["latency_ms_p95"],
            "latency": tail(latency), "late": tail(late), "release_to_result": tail(service),
            "device": tail(device), "host": tail(host), "slow_frames": len(slow),
            "slow_by": slow_by,
            "slow": [{"k": int(k), "second": int(k * period_ms // 1e3),
                      "latency": float(latency[k]), "late": float(late[k]),
                      "release_to_result": float(service[k]), "device": float(device[k])}
                     for k in slow]}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(line, per_frame={"latency": latency.tolist(), "late": late.tolist(),
                                            "device": device.tolist()}), f)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
