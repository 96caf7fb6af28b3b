"""Timestamp alignment for multi-camera rigs.

A copy of ``isaac_ros_apriltag_tpu/sync.py`` (numpy only), kept in this
package so that nothing here imports the JAX package. N per-camera frame
streams are aligned by timestamp into lock-step batches for RigDetector:
exact-time matching by default (the reference's message_filters ExactTime
synchronizer, queue depth 3), with an optional tolerance for unsynchronized
hardware (the approximate-time policy).

Host-side, allocation-light: one small deque per camera; device work
starts only when a full aligned set exists.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class TimestampAligner:
    """Aligns N per-camera (stamp, frame) streams into synchronized batches.

    push() returns a (stamps, frames) batch as soon as every camera holds a
    frame within `tolerance` of a common reference stamp; older frames are
    dropped (same policy as a depth-bounded ExactTime queue).
    """

    n_cameras: int
    tolerance: float = 0.0        # seconds; 0 = ExactTime
    queue_size: int = 3           # the reference's sync queue depth
    _queues: list = field(default_factory=list)

    def __post_init__(self):
        if self.n_cameras < 1:
            raise ValueError("n_cameras must be >= 1")
        if self.queue_size < 1:
            raise ValueError("queue_size must be >= 1")
        self._queues = [deque(maxlen=self.queue_size)
                        for _ in range(self.n_cameras)]

    def push(self, camera: int, stamp: float, frame
             ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Add a frame; returns an aligned batch when complete, else None."""
        if not 0 <= camera < self.n_cameras:
            raise ValueError(f"camera {camera} out of range")
        self._queues[camera].append((float(stamp), frame))
        return self._try_match()

    def _try_match(self):
        if any(not q for q in self._queues):
            return None
        # candidate reference: the newest stamp every camera could match
        ref = min(q[-1][0] for q in self._queues)
        picks = []
        for q in self._queues:
            best = min(q, key=lambda sf: abs(sf[0] - ref))
            if abs(best[0] - ref) > self.tolerance:
                return None
            picks.append(best)
        # consume everything at or before the matched stamps
        for q, (s, _) in zip(self._queues, picks):
            while q and q[0][0] <= s:
                q.popleft()
        stamps = np.array([s for s, _ in picks])
        frames = np.stack([f for _, f in picks])
        return stamps, frames
