"""Throughput timing of a device function.

Counterpart of ``isaac_ros_apriltag_tpu/utils/timing.py::throughput``. There
a host readback stood in for a sync the TPU's transport did not give; on a
CUDA device an event recorded after each call and synchronised on is a true
sync. On the CPU a call has run to its end when it returns.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import torch


def throughput(fn, x: torch.Tensor, iters: int, *, overlap: int = 1):
    """Time `iters` calls of fn(x), each waited for.

    overlap > 1 keeps that many calls in flight (call i + overlap is queued
    before call i is waited for), so the host's issue of the next call hides
    behind the device's work on this one. Returns (seconds, first_output);
    the first call is a warmup outside the timed loop."""
    if overlap < 1:
        raise ValueError("overlap must be >= 1")
    cuda = x.device.type == "cuda"
    out0 = fn(x)
    window: deque = deque()
    with torch.cuda.device(x.device) if cuda else contextlib.nullcontext():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
            if cuda:
                done = torch.cuda.Event()
                done.record()
                window.append(done)
                if len(window) >= overlap:
                    window.popleft().synchronize()
        for done in window:
            done.synchronize()
        return time.perf_counter() - t0, out0
