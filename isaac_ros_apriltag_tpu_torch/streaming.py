"""Streaming runner: a bounded window of frames in flight, uploads overlapped
with compute.

Counterpart of ``isaac_ros_apriltag_tpu/streaming.py``. Results are yielded
in order; at most `depth` frames are in flight; depth 1 is the synchronous
loop (upload, detect, wait, yield) and depth 2 is double buffering: the host
stages and queues frame k + 1 while the card computes frame k.

On a CUDA device the runner keeps a ring of `depth` pinned host buffers and
`depth` device buffers, made at the first frame's shape and dtype. Frame k
goes through slot k % depth:
  1. the host waits until the slot's previous upload has finished (it must
     not overwrite pinned memory that a copy is still reading), then copies
     the frame into the slot's pinned buffer;
  2. a side copy stream waits until the compute that read the slot's device
     buffer has finished (the slot's done event), then uploads with
     non_blocking=True and records the slot's copy event;
  3. the current stream waits on that copy event and runs fn on the device
     buffer; a done event is recorded after it.
When the window is full the oldest done event is synchronised and its
results are yielded. fn runs on the caller's current stream, so the caller
uses the results on its own stream with no record_stream. A device buffer is
reused `depth` frames later: fn must not return its input or a view of it.

On the CPU there are no streams and no pinned memory: frames are converted
and passed to fn in order, with the same window.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


class StreamingRunner:
    """Pipelines `fn` (a device tensor -> result function) over a stream of
    host frames (numpy arrays or CPU tensors) with up to `depth` frames in
    flight, on `device` (default: the card)."""

    def __init__(self, fn: Callable, depth: int = 2,
                 device: torch.device | str | None = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.fn = fn
        self.depth = depth
        self.device = torch.device("cuda" if device is None else device)

    def run(self, frames: Iterable) -> Iterator:
        """Yield fn(frame) for each frame, in order, pipelined."""
        if self.device.type == "cuda":
            yield from self._run_cuda(frames)
            return
        inflight: deque = deque()
        for frame in frames:
            inflight.append(self.fn(_host(frame).to(self.device)))
            if len(inflight) >= self.depth:
                yield inflight.popleft()
        while inflight:
            yield inflight.popleft()

    def _run_cuda(self, frames: Iterable) -> Iterator:
        compute = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        pinned = staged = None
        uploaded = [None] * self.depth    # per slot: copy event of its last upload
        done = [None] * self.depth        # per slot: event after the compute that read it
        inflight: deque = deque()         # (result, done event), oldest first
        for k, frame in enumerate(frames):
            host = _host(frame)
            if pinned is None:
                pinned = [torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                          for _ in range(self.depth)]
                staged = [torch.empty(host.shape, dtype=host.dtype, device=self.device)
                          for _ in range(self.depth)]
            elif host.shape != pinned[0].shape or host.dtype != pinned[0].dtype:
                raise ValueError(f"frame {k} is {tuple(host.shape)} {host.dtype}; the stream "
                                 f"started at {tuple(pinned[0].shape)} {pinned[0].dtype}")
            s = k % self.depth
            if uploaded[s] is not None:
                uploaded[s].synchronize()
            pinned[s].copy_(host)
            with torch.cuda.stream(copy):
                if done[s] is not None:
                    copy.wait_event(done[s])
                staged[s].copy_(pinned[s], non_blocking=True)
                uploaded[s] = torch.cuda.Event()
                uploaded[s].record(copy)
            compute.wait_event(uploaded[s])
            out = self.fn(staged[s])
            done[s] = torch.cuda.Event()
            done[s].record(compute)
            inflight.append((out, done[s]))
            if len(inflight) >= self.depth:
                out, ev = inflight.popleft()
                ev.synchronize()
                yield out
        while inflight:
            out, ev = inflight.popleft()
            ev.synchronize()
            yield out


def _host(frame) -> torch.Tensor:
    """A numpy array or CPU tensor, as a CPU tensor."""
    if isinstance(frame, torch.Tensor):
        if frame.device.type != "cpu":
            raise ValueError(f"the runner uploads host frames; got one on {frame.device}")
        return frame
    return torch.from_numpy(np.ascontiguousarray(frame))


def run_stream(fn: Callable, frames: Iterable, depth: int = 2,
               device: torch.device | str | None = None) -> list:
    """Collect StreamingRunner results into a list."""
    return list(StreamingRunner(fn, depth, device).run(frames))
