"""Wrappers of the resolve kernels (csrc/resolve.cu).

``resolve_roots_rank`` and ``resolve_components`` are the CUDA path of the
resolve stage: the table formulation of ops/resolve.py
(resolve_roots_rank_tables, resolve_components_tables) with its five
passes run by the kernels: ``count`` (one kernel), ``scan`` (the tile-sums
kernel, ``tile_sums``, then the scan kernel, ``scan_ranks``), ``slots``
(the contraction: one launch of the chain kernel, which doubles the slots'
parent map in a thread-block cluster's shared memory and writes the map
table), ``final`` (the final resolve: one launch of the chain kernel, which
also sums the components, gates them and ranks them) and ``map_pixels``
(one kernel). Each wrapper adds one to its kernel's counter where it
launches it; on a CPU tensor it runs that pass's plain version
(ops/resolve.py:: count_plain, tile_sums_plain, scan_plain, slots_plain,
final_plain, map_plain), so on the CPU the stage functions run the plain
composition, bit-exact with the twin. Every launch goes on the current
stream (the count's table zeroed there by a memset), with outputs
allocated here by torch.empty and no host sync, so the stage can be
captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from .. import resolve as plain
from . import _lib

count_launches = 0       # resolve_count_kernel launches made by count
tiles_launches = 0       # resolve_tile_sums_kernel launches made by tile_sums
scan_launches = 0        # resolve_scan_kernel launches made by scan_ranks
map_launches = 0         # resolve_map_kernel launches made by map_pixels
chain_launches = 0       # resolve_chain_kernel launches made by slots and final
# The map kernel's blocks a launch (about four an SM), past which a block
# takes every n-th chunk of its frame's pixels.
MAP_GRID = 528

def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           dev: torch.device) -> None:
    if (t.shape != shape or t.dtype != dtype or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor on {dev}")


def _check_pixels(label: torch.Tensor, valid: torch.Tensor) -> tuple[int, int]:
    """Raise on what the pixel kernels do not take; return (B, N)."""
    if label.device.type != "cuda":
        raise ValueError(f"label must lie on a CUDA device, not {label.device}")
    if label.ndim != 2 or label.numel() == 0:
        raise ValueError("label must be a non-empty (B, N) tensor")
    B, N = label.shape
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    _check("label", label, (B, N), torch.int32, label.device)
    _check("valid", valid, (B, N), torch.bool, label.device)
    return B, N


def _check_table(cnt: torch.Tensor) -> tuple[int, int]:
    """Raise on a label table the scan kernels do not take; return (B, S)."""
    if cnt.device.type != "cuda" or cnt.ndim != 2 or cnt.numel() == 0:
        raise ValueError("cnt must be a non-empty (B, S) tensor on a CUDA device")
    B, S = cnt.shape
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    _check("cnt", cnt, (B, S), torch.int32, cnt.device)
    return B, S


def count(label: torch.Tensor, valid: torch.Tensor, S: int) -> torch.Tensor:
    """(B, N) int32 labels + (B, N) bool validity -> (B, S) int32 counts of
    the valid pixels of each label in [0, S)."""
    global count_launches
    if label.device.type == "cpu":
        return plain.count_plain(label, valid, S)
    B, N = _check_pixels(label, valid)
    if not 1 <= S < 2**31 - 1:
        raise ValueError(f"table size {S} out of range")
    cnt = torch.empty((B, S), dtype=torch.int32, device=label.device)   # zeroed by the launch
    with torch.cuda.device(label.device):
        status = _lib.library().apriltag_resolve_count(label.data_ptr(), valid.data_ptr(),
                                                       cnt.data_ptr(), B, N, S, _stream())
    _lib.check(status, "apriltag_resolve_count")
    count_launches += 1
    return cnt


def tile_sums(cnt: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 counts -> (B, T) int32 present labels a tile of
    SCAN_TILE entries, as tile_sums_plain."""
    global tiles_launches
    if cnt.device.type == "cpu":
        return plain.tile_sums_plain(cnt)
    B, S = _check_table(cnt)
    tiles = -(-(S + 1) // plain.SCAN_TILE)
    tile_sum = torch.empty((B, tiles), dtype=torch.int32, device=cnt.device)
    with torch.cuda.device(cnt.device):
        status = _lib.library().apriltag_resolve_tile_sums(cnt.data_ptr(), tile_sum.data_ptr(),
                                                           B, S, tiles, _stream())
    _lib.check(status, "apriltag_resolve_tile_sums")
    tiles_launches += 1
    return tile_sum


def scan_ranks(cnt: torch.Tensor, tile_sum: torch.Tensor,
               R: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S) int32 counts and their (B, T) tile sums -> (inv (B, S + 1),
    D (B, R), n_groups (B,)), int32, as scan_plain."""
    global scan_launches
    if cnt.device.type == "cpu":
        return plain.scan_plain(cnt, R)
    B, S = _check_table(cnt)
    dev = cnt.device
    tiles = -(-(S + 1) // plain.SCAN_TILE)
    _check("tile_sum", tile_sum, (B, tiles), torch.int32, dev)
    if not 1 <= R <= 1 << 16:
        raise ValueError(f"capacity {R} out of [1, 65536]")
    i32 = dict(dtype=torch.int32, device=dev)
    inv, D = torch.empty((B, S + 1), **i32), torch.empty((B, R), **i32)
    n_groups = torch.empty(B, **i32)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_resolve_scan(
            cnt.data_ptr(), tile_sum.data_ptr(), inv.data_ptr(), D.data_ptr(),
            n_groups.data_ptr(), B, S, R, tiles, _stream())
    _lib.check(status, "apriltag_resolve_scan")
    scan_launches += 1
    return inv, D, n_groups


def scan(cnt: torch.Tensor, R: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S) int32 counts -> (inv, D, n_groups) as scan_plain: tile_sums,
    then scan_ranks."""
    return scan_ranks(cnt, tile_sums(cnt), R)


def map_pixels(label: torch.Tensor, valid: torch.Tensor, inv: torch.Tensor,
               table: torch.Tensor, fill: int) -> torch.Tensor:
    """(B, N) int32 labels + bool validity, (B, S + 1) inv, (B, R + 1) int32
    table -> (B, N) int32 table[inv[label]] on valid pixels labelled in
    [0, S), `fill` elsewhere."""
    global map_launches
    if label.device.type == "cpu":
        return plain.map_plain(label, valid, inv, table, fill)
    B, N = _check_pixels(label, valid)
    dev = label.device
    if inv.ndim != 2 or table.ndim != 2:
        raise ValueError("inv and table must be (B, S + 1) and (B, R + 1) tensors")
    S, R = inv.shape[1] - 1, table.shape[1] - 1
    _check("inv", inv, (B, S + 1), torch.int32, dev)
    _check("table", table, (B, R + 1), torch.int32, dev)
    if S < 1 or R < 1:
        raise ValueError("inv and table must hold at least two entries a frame")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_resolve_map(label.data_ptr(), valid.data_ptr(),
                                                     inv.data_ptr(), table.data_ptr(),
                                                     out.data_ptr(), B, N, S, R, int(fill),
                                                     -(-MAP_GRID // B), _stream())
    _lib.check(status, "apriltag_resolve_map")
    map_launches += 1
    return out


def _check_slot_tables(label: torch.Tensor, inv: torch.Tensor, D: torch.Tensor,
                       n_groups: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on slot tables the chain kernel does not take; return (B, N, S, R)."""
    if label.device.type != "cuda" or label.ndim != 2 or label.numel() == 0:
        raise ValueError("label must be a non-empty (B, N) tensor on a CUDA device")
    if inv.ndim != 2 or D.ndim != 2:
        raise ValueError("inv and D must be (B, S + 1) and (B, R) tensors")
    B, N = label.shape
    S, R = inv.shape[1] - 1, D.shape[1]
    dev = label.device
    if B > _lib.MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernels' {_lib.MAX_BATCH} frames")
    if S < 1 or not 1 <= R <= 1 << 16:
        raise ValueError(f"table size {S} or capacity {R} out of range")
    _check("label", label, (B, N), torch.int32, dev)
    _check("inv", inv, (B, S + 1), torch.int32, dev)
    _check("D", D, (B, R), torch.int32, dev)
    _check("n_groups", n_groups, (B,), torch.int32, dev)
    return B, N, S, R


def _chain(label, inv, D, n_groups, steps, rank_table, cnt, min_component_pixels):
    """Launch the chain kernel: the contraction without cnt, else the final
    resolve. Returns (table, n_eligible, overflow, converged); the
    contraction's n_eligible and converged are None."""
    global chain_launches
    B, N, S, R = _check_slot_tables(label, inv, D, n_groups)
    dev = label.device
    if rank_table is not None:
        _check("rank_table", rank_table, (B, S), torch.int32, dev)
    if cnt is not None:
        _check("cnt", cnt, (B, S), torch.int32, dev)
    if not -2**31 < steps < 2**31:
        raise ValueError(f"chain steps {steps} out of range")
    # Totals lie in [-N, N], N < 2^31: a gate past int32 gates the same.
    gate = max(-2**31, min(int(min_component_pixels), 2**31 - 1))
    final = cnt is not None
    table = torch.empty((B, R + 1), dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    n_eligible = torch.empty(B, dtype=torch.int64, device=dev) if final else None
    converged = torch.empty(B, dtype=torch.bool, device=dev) if final else None
    with torch.cuda.device(dev):
        status = _lib.library().apriltag_resolve_chain(
            label.data_ptr(), inv.data_ptr(), D.data_ptr(), n_groups.data_ptr(),
            _ptr(rank_table), _ptr(cnt), table.data_ptr(), _ptr(n_eligible),
            overflow.data_ptr(), _ptr(converged), B, N, S, R, int(steps), gate, _stream())
    _lib.check(status, "apriltag_resolve_chain")
    chain_launches += 1
    return table, n_eligible, overflow, converged


def slots(label: torch.Tensor, inv: torch.Tensor, D: torch.Tensor, n_groups: torch.Tensor,
          steps: int, rank_table: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The contraction's pass, as slots_plain without cnt: ((B, R + 1) int32
    map table, (B,) bool overflow), by the chain kernel."""
    if label.device.type == "cpu":
        return plain.slots_plain(label, inv, D, n_groups, steps, rank_table)
    table, _, overflow, _ = _chain(label, inv, D, n_groups, steps, rank_table, None, 0)
    return table, overflow


def final(label: torch.Tensor, inv: torch.Tensor, D: torch.Tensor, n_groups: torch.Tensor,
          steps: int, rank_table: torch.Tensor | None, cnt: torch.Tensor,
          min_component_pixels: int):
    """The final resolve's pass, as final_plain: the chains, totals, area
    gate and dense ranks in one launch of the chain kernel, from (B, S)
    int32 label counts cnt; ((B, R + 1) int32 map table, (B,) int64
    n_eligible, (B,) bool overflow, (B,) bool converged)."""
    if label.device.type == "cpu":
        return plain.final_plain(label, inv, D, n_groups, steps, rank_table, cnt,
                                 min_component_pixels)
    if cnt is None:
        raise ValueError("the final resolve needs the (B, S) label counts cnt")
    return _chain(label, inv, D, n_groups, steps, rank_table, cnt, min_component_pixels)


def chain_clusters(final_resolve: bool, R: int, device=None) -> int:
    """cudaOccupancyMaxActiveClusters of the chain kernel at R slots a frame:
    how many frames' clusters the card holds at once."""
    if not 1 <= R <= 1 << 16:
        raise ValueError(f"capacity {R} out of [1, 65536]")
    out = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        status = _lib.library().apriltag_resolve_chain_clusters(
            ctypes.addressof(out), int(final_resolve), R, _stream())
    _lib.check(status, "apriltag_resolve_chain_clusters")
    return out.value


PASSES = plain.TablePasses(count, scan, slots, final, map_pixels)


def resolve_roots_rank(label: torch.Tensor, valid: torch.Tensor, *,
                       max_components: int = 1 << 16, chain_steps: int = 5):
    """ops/resolve.py::resolve_roots_rank's signature and results, bit for
    bit: the contraction by the count, scan, chain and map kernels."""
    return plain.resolve_roots_rank_tables(label, valid, max_components=max_components,
                                           chain_steps=chain_steps, passes=PASSES)


def resolve_components(label: torch.Tensor, valid: torch.Tensor, *,
                       min_component_pixels: int, max_components: int = 1 << 16,
                       chain_steps: int = 4,
                       rank_table: torch.Tensor | None = None) -> plain.ResolvedComponents:
    """ops/resolve.py::resolve_components' signature and results (without
    with_roots), bit for bit: the final resolve by the count, scan, chain
    and map kernels, in rank mode (with rank_table) or flat mode."""
    return plain.resolve_components_tables(
        label, valid, min_component_pixels=min_component_pixels,
        max_components=max_components, chain_steps=chain_steps, rank_table=rank_table,
        passes=PASSES)
