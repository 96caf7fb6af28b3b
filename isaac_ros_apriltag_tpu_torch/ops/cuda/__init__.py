"""The hand-written kernels' wrappers (csrc/*.cu) and their launch counters.

Each wrapper adds one to its module's counter where it launches its kernel.
LAUNCH_COUNTERS names every counter, so code that counts or replays launches
(capture.py, chip_smoke.py, the tests) reads this one list.
"""

from __future__ import annotations

from . import ccl, cluster_moments, decode, pose, quadfit, refine, resolve, tail, threshold

# kernel -> (wrapper module, name of its launch counter)
LAUNCH_COUNTERS = {"threshold": (threshold, "launches"), "row": (ccl, "row_launches"),
                   "col": (ccl, "col_diag_launches"),
                   "edge_count": (cluster_moments, "count_launches"),
                   "pair_count": (cluster_moments, "pair_count_launches"),
                   "radix_scatter": (cluster_moments, "scatter_launches"),
                   "segment_tiles": (cluster_moments, "seg_tiles_launches"),
                   "segment_top": (cluster_moments, "seg_top_launches"),
                   "moments": (cluster_moments, "moments_launches"),
                   "resolve_count": (resolve, "count_launches"),
                   "resolve_tiles": (resolve, "tiles_launches"),
                   "resolve_scan": (resolve, "scan_launches"),
                   "resolve_chain": (resolve, "chain_launches"),
                   "resolve_map": (resolve, "map_launches"),
                   "quadfit_search": (quadfit, "launches"),
                   "select_refine": (refine, "launches"),
                   "decode": (decode, "launches"), "tail_finish": (tail, "finish_launches"),
                   "finish_pose": (tail, "finish_pose_launches"), "pose": (pose, "launches")}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count, by LAUNCH_COUNTERS' names."""
    return {k: getattr(module, name) for k, (module, name) in LAUNCH_COUNTERS.items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set every kernel's launch count (counts holds each of LAUNCH_COUNTERS' names)."""
    for k, (module, name) in LAUNCH_COUNTERS.items():
        setattr(module, name, counts[k])
