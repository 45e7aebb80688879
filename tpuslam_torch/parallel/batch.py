"""Multi-pair registration with the PAIR axis split across the ranks
(port of ``tpuslam/parallel/batch.py``, 111 lines).

The second scaling axis: where ``parallel/icp.py`` splits one large
problem's target cloud, this splits a batch of independent pairs.  Each
rank registers its ``B / size`` pairs with the port's batched dense loop
(``algorithms/batch.py``, one call of K1's batch form an iteration; the
JAX package forces ``use_spatial=False`` there, ``:56``), with no
communication, and the per-pair results are then ``all_gather``ed, so
every rank returns the whole batch, as the JAX package's global array
holds it.  Each pair's result is its solo dense run's, bit for bit.
"""

from __future__ import annotations

import torch

from tpuslam_torch.algorithms.batch import icp_register_batch
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform
from tpuslam_torch.parallel.collectives import all_gather
from tpuslam_torch.parallel.mesh import Mesh


def shard_pairs(batched: Cloud, mesh: Mesh) -> Cloud:
    """This rank's pairs of a stacked Cloud (points f32[B, Npad, 3], count
    i32[B]; ``algorithms/batch.py::stack_clouds``): pairs
    ``rank * B / size`` to ``(rank + 1) * B / size``, on ``mesh.device``.
    B must divide by the world size (pad with duplicate pairs)."""
    b = batched.points.shape[0]
    if b % mesh.size:
        raise ValueError(f"pair count {b} must divide the {mesh.size}-rank world; "
                         "pad the batch")
    per = b // mesh.size
    lo = mesh.rank * per
    return Cloud(points=batched.points[lo:lo + per].contiguous().to(mesh.device),
                 count=batched.count[lo:lo + per].to(mesh.device))


def icp_register_pairs_sharded(
    befores: Cloud,
    afters: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
) -> RegistrationResult:
    """Batched ICP of this rank's pairs (``shard_pairs``), the results of
    every rank gathered: rotations f32[B, 3, 3], translations f32[B, 3],
    iterations i32[B] and errors f32[B] on every rank."""
    local = icp_register_batch(
        befores, afters, eps=eps, max_distance_squared=max_distance_squared,
        max_iterations=max_iterations, divergence_guard=divergence_guard,
        unroll=False, use_spatial=False,
    )
    rotation = all_gather(local.transform.rotation, mesh)
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation,
            translation=all_gather(local.transform.translation, mesh),
            scale=torch.ones(rotation.shape[0], dtype=torch.float32, device=rotation.device),
        ),
        iterations=all_gather(local.iterations.to(torch.int32), mesh),
        error=all_gather(local.error, mesh),
    )
