"""Replay a function of one tensor from CUDA graphs, one per input signature.

The reference jits its detect function, so the TPU runs one compiled
program a call. Run eagerly, the port issues each call's ~1900 device ops
one at a time from Python, and at batch 1 that issue, not the card, sets the
pace. ``GraphedCall`` captures the function for each input signature
(shape, dtype, device) that repeats into a ``torch.cuda.CUDAGraph`` and
then issues the whole call with one launch:

- First call with a new signature: run the function eagerly and return that
  result; nothing is captured, so a caller that sends a shape once pays
  nothing for a graph. The eager call also warms what a capture must not
  do (uploads of the constant tables, the caching allocator, cuBLAS).
- Second call with that signature: capture the call on a side stream into
  a graph with its own memory pool, reading a static input buffer (this
  synchronises the device), then replay it as below.
- Every later call, on the caller's current stream, with no host sync: copy
  the input into the static buffer, replay the graph, and clone every
  result tensor out of the graph's static outputs, so that no result is
  ever overwritten by a later call. A call from another stream than the
  graph's last replay first waits on that replay's done event, so the
  static buffers are never overwritten under a replay that still reads
  them.
- The MAX_GRAPHS most recently used signatures keep their graphs; the least
  recently used is dropped (after a device sync) before the next capture.
  The last MAX_GRAPHS signatures called once are remembered.
- The kernels' launch counters (``ops.cuda.LAUNCH_COUNTERS``) count what
  ran on the device: the wrappers' increments during a capture are taken
  back, and each replay adds the launches the capture recorded.

Nothing falls back to eager: an error in a capture or a replay reaches the
caller. The function must not sync the host, and its host-side control flow
must not depend on the input's values (the detect functions hold to both;
tests/test_torch_gpu.py). `runtime` supplies the capture, streams and events;
tests/test_torch_capture.py passes a stand-in that runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Callable

import torch

from .ops.cuda import launch_counts, set_launch_counts

MAX_GRAPHS = 4   # signatures a function keeps graphs for


class CudaGraphs:
    """What GraphedCall needs of the card."""

    @staticmethod
    def capture(fn: Callable, x: torch.Tensor):
        """fn(x) captured into a new CUDAGraph with its own memory pool, on a
        side stream of x's device; returns (graph, fn's static result). The
        capture bars unsafe CUDA calls in this thread only, so other threads
        (a process group's watchdog) go on as before."""
        # torch.profiler does the same for torch.compile's graphs: CUPTI torn
        # down after one profiler session and set up again at the next crashes
        # the process or drops kernels when a graph replays under it.
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device):
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(x.device),
                                  capture_error_mode="thread_local"):
                out = fn(x)
        return graph, out

    current_stream = staticmethod(torch.cuda.current_stream)
    event = staticmethod(torch.cuda.Event)
    synchronize = staticmethod(torch.cuda.synchronize)


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors of a result (a tensor, or tuples, lists and dataclasses of
    them), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _rebuild(obj, tensors):
    """`obj` with its tensors replaced, in _tensors' order, by the next of
    the iterator `tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), tensors)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)([_rebuild(x, tensors) for x in obj])
    return obj


@dataclasses.dataclass
class _Graph:
    graph: object
    static_in: torch.Tensor
    static_out: object              # the captured call's result
    launches: dict[str, int]        # per kernel, launches a replay makes
    stream: object = None           # stream of the last replay
    done: object = None             # event recorded after the last replay's clones


class GraphedCall:
    """fn (a tensor -> tensors function) replayed from one CUDA graph per
    input signature that repeats; see the module's docstring."""

    def __init__(self, fn: Callable, *, runtime=CudaGraphs):
        self.fn = fn
        self.runtime = runtime
        self.graphs: OrderedDict[tuple, _Graph] = OrderedDict()
        self.once: OrderedDict[tuple, None] = OrderedDict()   # called once, no graph

    def __call__(self, x: torch.Tensor):
        key = (tuple(x.shape), x.dtype, x.device)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.once:
                self.once[key] = None
                if len(self.once) > MAX_GRAPHS:
                    self.once.popitem(last=False)
                return self.fn(x)
            del self.once[key]
            while len(self.graphs) >= MAX_GRAPHS:
                old_key, old = self.graphs.popitem(last=False)
                self.runtime.synchronize(old_key[2])    # its last replay may still run
                del old                                 # its pool is free for the capture
            g = self.graphs[key] = self._capture(x)
        self.graphs.move_to_end(key)
        stream = self.runtime.current_stream(x.device)
        if g.done is not None and stream != g.stream:
            stream.wait_event(g.done)
        g.static_in.copy_(x)
        g.graph.replay()
        set_launch_counts({k: n + g.launches[k] for k, n in launch_counts().items()})
        out = _rebuild(g.static_out, iter([t.clone() for t in _tensors(g.static_out)]))
        g.stream, g.done = stream, self.runtime.event()
        g.done.record(stream)
        return out

    def _capture(self, x: torch.Tensor) -> _Graph:
        static_in = x.clone(memory_format=torch.contiguous_format)
        before = launch_counts()
        try:
            graph, out = self.runtime.capture(self.fn, static_in)
            launches = {k: n - before[k] for k, n in launch_counts().items()}
        finally:
            set_launch_counts(before)    # nothing ran on the device while capturing
        return _Graph(graph, static_in, out, launches)
