#!/usr/bin/env python3
"""Device memory of torch_bench.py's cells, over each whole cell.

    python3 torch_bench_memory.py [--cell NAME ...] [--seed S] [--root DIR] [--out DIR]

Runs each cell (default: those of BENCHMARK.json's workloads) through
torch_bench.main of the checkout under DIR (default: this one), one cell
after another in this process, and after each prints one JSON line: the cell, torch_bench's exit code, and the peak device memory
that the caching allocator reserved and allocated over the cell
(torch.cuda.max_memory_reserved / max_memory_allocated, set back to the
current use before the cell). torch_bench.py's own `peak_memory_gib` reads
max_memory_allocated over one traced call, which misses the memory pool of
a CUDA graph (reserved, not allocated); the reserved peak holds it. With
--out, each cell's record goes to DIR/<cell>.json. Compare a parent and a
change in turns, each with its own --root. Exits with torch_bench's worst
exit code; without a CUDA device it exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cell", action="append")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bench_memory: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch_bench

    worst = 0
    for cell in args.cell or [c["name"] for c in torch_bench.load_spec()["workloads"]]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = ["--cell", cell, "--seed", str(args.seed)]
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            argv += ["--out", os.path.join(args.out, f"{cell}.json")]
        rc = torch_bench.main(argv)
        worst = max(worst, rc)
        print(json.dumps({"cell": cell, "root": root, "rc": rc,
                          "max_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                          "max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}),
              flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
