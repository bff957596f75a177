"""The process group and the flat 'data' mesh.

The torch counterpart of zikkurat_algebra_tpu/parallel/mesh.py.  JAX has
one controller driving every device; here each device has a process of
its own and every process runs the same code (SPMD).  A sharded array
exists only as its chunks: rank i holds the contiguous chunk i of the
last (batch) axis, where JAX's NamedSharding puts chunk i on device i.
`shard_batch` cuts a rank's chunk out of a global array, `gather_batch`
joins the chunks on every rank.

A mesh of n ranks is ranks 0 .. n-1 of the process group, so a rank of
the mesh is also its global rank.  `make_mesh` is collective when
n_devices is below the world size (it makes a subgroup): every rank
calls it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..errors import DimensionError, MeshError
from ..ops.field import resolve_device

DATA_AXIS = "data"


@dataclass
class Mesh:
    """The ranks 0 .. size-1 of the process group on one flat axis.
    `rank` is this process's place in it, None outside it."""

    group: object
    size: int
    rank: Optional[int]
    device: torch.device

    def member(self) -> int:
        """This process's rank; a process outside the mesh raises."""
        if self.rank is None:
            raise MeshError(f"this process (global rank {dist.get_rank()}) "
                            f"is not in the mesh of {self.size} ranks")
        return self.rank


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda") -> int:
    """Join the process group: NCCL for device "cuda" (each process then
    uses card rank mod the card count), gloo for "cpu".  Idempotent;
    returns the world size.

    coordinator_address is "host:port" (TCP), or a URL such as
    "tcp://host:port" or "file:///path" (a file store every process can
    reach); num_processes and process_id are the world size and this
    process's rank.  Without an address they come from the environment
    of `torchrun` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if coordinator_address is None:
            url = "env://"
        elif "://" in coordinator_address:
            url = coordinator_address
        else:
            url = f"tcp://{coordinator_address}"
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=url,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
        if dev.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The flat mesh of the first n_devices ranks (default: all) of the
    process group that `init_multihost` joined."""
    if not dist.is_initialized():
        raise MeshError("no process group: call init_multihost first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise MeshError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group, n, rank if rank < n else None, device)


def shard_batch(mesh: Mesh, x: torch.Tensor, batch_axis: int = -1
                ) -> torch.Tensor:
    """This rank's contiguous chunk of a global tensor along batch_axis,
    on the rank's device (a numpy array: `utils.convert.shard_numpy`)."""
    n = x.shape[batch_axis]
    if n % mesh.size:
        raise DimensionError(f"batch of {n} does not split over "
                             f"{mesh.size} ranks")
    c = n // mesh.size
    return x.narrow(batch_axis, mesh.member() * c, c).to(
        mesh.device).contiguous()


def replicated(mesh: Mesh, arr) -> torch.Tensor:
    """The whole array on this rank's device."""
    return torch.as_tensor(arr).to(mesh.device)


def gather_batch(mesh: Mesh, x: torch.Tensor, batch_axis: int = -1
                 ) -> torch.Tensor:
    """The global array, on every rank, from each rank's chunk along
    batch_axis (an all_gather; the inverse of `shard_batch`)."""
    mesh.member()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, batch_axis)
