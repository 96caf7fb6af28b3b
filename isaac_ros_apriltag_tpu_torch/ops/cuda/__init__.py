"""The hand-written kernels' wrappers (csrc/*.cu) and their launch counters.

Each wrapper adds one to its module's counter where it launches its kernel.
LAUNCH_COUNTERS names every counter, so code that counts or replays launches
(capture.py, chip_smoke.py, the tests) reads this one list.
"""

from __future__ import annotations

from . import ccl, cluster_moments, threshold

# kernel -> (wrapper module, name of its launch counter)
LAUNCH_COUNTERS = {"threshold": (threshold, "launches"), "row": (ccl, "row_launches"),
                   "col": (ccl, "col_diag_launches"),
                   "edge_count": (cluster_moments, "count_launches"),
                   "edge_pairs": (cluster_moments, "pairs_launches"),
                   "segments": (cluster_moments, "segments_launches"),
                   "moments": (cluster_moments, "moments_launches")}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, by LAUNCH_COUNTERS' names."""
    return {k: getattr(module, name) for k, (module, name) in LAUNCH_COUNTERS.items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set every kernel's launch count (counts holds each of LAUNCH_COUNTERS' names)."""
    for k, (module, name) in LAUNCH_COUNTERS.items():
        setattr(module, name, counts[k])
