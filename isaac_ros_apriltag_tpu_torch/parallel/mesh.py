"""Process groups, device meshes and the band exchanges of the row-sharded
front.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/mesh.py``. The reference
lays a jax device mesh with the named axes 'cam' (cameras or frame
batches) and 'map' (map blocks of the SLAM layer) over the devices of one
program. In PyTorch each process drives one device, and the processes form
a ``torch.distributed`` process group:

  - ``initialize_multihost`` -> ``torch.distributed.init_process_group``:
    NCCL between CUDA devices, gloo on the CPU. The address, the number of
    processes and this process's rank are given explicitly; nothing here
    discovers a cluster;
  - ``make_mesh`` -> a ('cam', 'map') ``DeviceMesh`` (``init_device_mesh``);
    ``mesh.get_group("cam")`` is a group that a ``RigDetector`` splits its
    cameras over, or a row-sharded ``SpatialDetector`` its bands;
  - the exchanges that ``SpatialDetector(group=...)`` makes when each rank
    holds one band of a frame: ``neighbor_rows`` (halo and cut rows through
    ``batch_isend_irecv``, the counterpart of ``ppermute``) and
    ``all_gather_bands`` (``all_gather_into_tensor``).

The reference's ``cam_sharding``, ``replicated`` and ``map_sharding`` name
jax shardings of arrays over a mesh. A torch tensor lies on one device and
nothing in this package shards one, so they have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         backend: str | None = None) -> None:
    """Join this process to a group of `num_processes` processes that meet at
    `coordinator_address` ('host:port', served by the process of rank 0), as
    rank `process_id`. backend: 'nccl' (default where CUDA is available) or
    'gloo'. Must run before make_mesh or a RigDetector or SpatialDetector
    with a group.

    Under NCCL each process takes its own card, process_id modulo the cards
    of its host (the local rank where the processes of one host are ranks
    0..n-1), makes it the current device and binds the group's communicator
    to it, so the default device of every entry point ('cuda') is that
    card: the counterpart of the local devices that jax.distributed.initialize
    gives each process. Under gloo nothing selects a card."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)


def make_mesh(n_cam: int | None = None, n_map: int = 1):
    """A (n_cam, n_map) DeviceMesh with dims ('cam', 'map') over the processes
    of the initialized group, on CUDA devices under NCCL and on the CPU
    otherwise; n_cam defaults to all of them over n_map, and n_cam * n_map
    must be the number of processes."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    world = dist.get_world_size()
    if n_cam is None:
        n_cam = world // n_map
    if n_cam * n_map != world:
        raise ValueError(f"mesh {n_cam} x {n_map} does not cover the {world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_cam, n_map), mesh_dim_names=("cam", "map"))


def neighbor_rows(band: torch.Tensor, n_rows: int, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows from above, rows from below) of this rank's band (..., Hb, W):
    the last n_rows rows of the band of rank - 1 and the first n_rows rows of
    the band of rank + 1, ranks in `group` (default: the whole world). The
    first rank receives zeros from above and the last zeros from below, as
    ppermute leaves them; the caller fills the frame's edges."""
    group = group or dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    top = band[..., :n_rows, :].contiguous()
    bottom = band[..., -n_rows:, :].contiguous()
    above, below = torch.zeros_like(bottom), torch.zeros_like(top)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, top, peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if rank < size - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, bottom, peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return above, below


def all_gather_bands(band: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (nb, ...) band, in rank order, as one (size * nb, ...)
    tensor on every rank of `group`."""
    size = dist.get_world_size(group)
    out = torch.empty((size * band.shape[0], *band.shape[1:]), dtype=band.dtype,
                      device=band.device)
    dist.all_gather_into_tensor(out, band.contiguous(), group=group)
    return out
