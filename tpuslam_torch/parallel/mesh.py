"""The rank's view of the world, and cloud sharding (port of
``tpuslam/parallel/mesh.py``, 51 lines).

The JAX package shards the TARGET cloud along a ``"points"`` mesh axis
while the moving cloud and the 3x3 transform stay replicated.  Here the
mesh is one process group: each rank holds its own block of the target
(``shard_cloud``) and a copy of the moving cloud (``replicate_cloud``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.types import LANE, Cloud, pad_cloud

POINTS_AXIS = "points"


@dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D world: its process group (None: the default
    group), its rank and the world size, and the device its shard lives
    on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def mesh_key(mesh: Mesh) -> tuple:
    """What a sharded loop's CUDA graph depends on beside its tensors'
    shapes (part of its key, ``algorithms/device_loop.py``): the backend,
    the world's size, the rank, the device and the process group itself,
    so that a graph captured against one communicator never replays in
    another (the key holds the group: its identity is not reused while a
    graph is kept)."""
    group = mesh.group if mesh.group is not None else dist.group.WORLD
    return (mesh.backend, mesh.size, mesh.rank, str(mesh.device), group)


def capturable(mesh: Mesh) -> bool:
    """Whether a loop over this mesh may be captured as a CUDA graph: under
    NCCL, whose collectives stay on the card; gloo stages each one through
    the host."""
    return mesh.backend == "nccl"


def make_mesh(device=None, group=None) -> Mesh:
    """This rank's ``Mesh`` over ``group`` (None: the default group,
    ``distributed.initialize``).  ``device`` None is the card: under NCCL
    the card of the local rank (``LOCAL_RANK``, else the rank modulo the
    card count), under gloo ``resolve_device(None)``, which raises where
    there is no card.  A caller that wants the CPU passes ``"cpu"``."""
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if device is None and dist.get_backend(group) == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:  # "cuda": the current card
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(group=group, rank=rank, size=size, device=device)


def _host(points) -> np.ndarray:
    if isinstance(points, torch.Tensor):
        return points.detach().to("cpu", torch.float32).numpy()
    return np.asarray(points, dtype=np.float32)


def shard_cloud(points, mesh: Mesh) -> Cloud:
    """This rank's block of a ``[N, 3]`` array padded so that every rank
    gets an equal lane-aligned block (a multiple of ``128 * size`` rows,
    as the JAX package pads): ``f32[Npad / size, 3]`` on ``mesh.device``,
    with the GLOBAL valid count.  The block starts at global row
    ``rank * Npad / size``."""
    full = pad_cloud(_host(points), multiple=LANE * mesh.size, device="cpu")
    shard = full.points.shape[0] // mesh.size
    block = full.points[mesh.rank * shard:(mesh.rank + 1) * shard]
    return Cloud(points=block.contiguous().to(mesh.device),
                 count=full.count.to(mesh.device))


def replicate_cloud(points, mesh: Mesh) -> Cloud:
    """The whole padded cloud on this rank's device (every rank holds the
    same)."""
    return pad_cloud(_host(points), multiple=LANE, device=mesh.device)


def shard_offset(cloud: Cloud, mesh: Mesh) -> int:
    """Global row of this rank's first row of a ``shard_cloud`` block."""
    return mesh.rank * cloud.points.shape[0]


def shard_count(cloud: Cloud, mesh: Mesh) -> torch.Tensor:
    """Valid rows of this rank's block (0-d int32 on its device): the
    global count less the offset, clipped to the block."""
    shard = cloud.points.shape[0]
    return torch.clamp(cloud.count - shard_offset(cloud, mesh), 0, shard).to(torch.int32)


def shard_mask(cloud: Cloud, mesh: Mesh) -> torch.Tensor:
    """f32 validity mask of this rank's block."""
    rows = torch.arange(cloud.points.shape[0], device=cloud.points.device)
    return (rows < shard_count(cloud, mesh)).to(torch.float32)
