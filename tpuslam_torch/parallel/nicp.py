"""NICP with the target cloud split across the ranks: candidate
enumeration replicated, exact rescoring sharded (port of
``tpuslam/parallel/nicp.py``, 136 lines).

The moving cloud's moments are computed on every rank from its copy; the
target's count, centroid and scatter are ``psum``'d from per-block
partials (``:44-66``), and its descending eigenbasis taken by ``eigh``.
The 8 sign candidates (``algorithms/nicp.py::_enumerate_candidates``)
are scored by the sharded exact rescore; improper ones get +BIG, and
``argmin`` picks the winner.  As in the JAX package, which vmaps the
rescore over the candidates, all 8·k transformed subcloud rows go
through ONE per-block search (K1 on the card) and one combine.

The subcloud is the host PCG64 draw of the JAX package's sharded path,
``Generator(PCG64(seed)).permutation(n_valid)[:k]`` (``:112-119``), not
the solo path's ``jax.random`` draw (``algorithms/prng.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.algorithms.nicp import (
    MAX_DISTANCE_FOR_COMPARISON,
    _enumerate_candidates,
    masked_centroid,
    principal_axes,
)
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform
from tpuslam_torch.ops.geometry import transform_points
from tpuslam_torch.parallel.collectives import psum
from tpuslam_torch.parallel.mesh import Mesh, shard_mask
from tpuslam_torch.parallel.nn import BIG, sharded_nn_combine


def subcloud_indices(n_valid: int, k: int, seed: int) -> np.ndarray:
    """i32[k] rows of the moving cloud to score (``common.cpp:25-37``, the
    JAX package's sharded draw): a PCG64 permutation of the valid rows cut
    to ``k``, or the first ``k`` padded rows when there are no more than
    ``k`` valid ones (the padded ones weigh 0)."""
    if n_valid > k:
        rng = np.random.Generator(np.random.PCG64(seed))
        return rng.permutation(n_valid)[:k].astype(np.int32)
    return np.arange(k, dtype=np.int32)


def nicp_register_sharded(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    subcloud_size: int = 1000,
    seed: int = 0,
) -> RegistrationResult:
    """``before`` replicated, ``after`` this rank's block; every rank
    returns the same result: the best candidate, the number of
    candidates scored as ``iterations`` and its exact subcloud error."""
    device = before.points.device
    points, mask_b = before.points, before.mask()
    mu_b = masked_centroid(points, mask_b)
    u_b, _ = principal_axes(points, mask_b)

    # the target's moments from per-block partials
    tgt, mask_a = after.points, shard_mask(after, mesh)
    na = torch.clamp_min(psum(torch.sum(mask_a), mesh), 1.0)
    mu_a = psum(torch.sum(tgt * mask_a[:, None], dim=0), mesh) / na
    xa = (tgt - mu_a) * mask_a[:, None]
    cov_a = psum(torch.matmul(xa.T, xa), mesh)
    _, evecs = torch.linalg.eigh(cov_a)
    u_a = evecs.flip(-1)  # descending, as principal_axes

    cands = _enumerate_candidates(u_b, u_a, mu_b, mu_a)
    k = min(subcloud_size, before.padded_size)
    sub_idx = torch.from_numpy(subcloud_indices(int(before.count), k, seed)).to(device).long()
    subcloud, sub_mask = points[sub_idx], mask_b[sub_idx]

    c = cands.rotations.shape[0]
    moved = transform_points(subcloud[None], cands.rotations, cands.translations)  # [C, k, 3]
    _, dist, _ = sharded_nn_combine(moved.reshape(c * k, 3).contiguous(), after, mesh)
    dist = dist.reshape(c, k)
    w = ((dist < MAX_DISTANCE_FOR_COMPARISON) & (sub_mask[None] > 0)).to(torch.float32)
    errors = torch.sum(dist * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
    errors = errors + torch.where(cands.proper, 0.0, BIG)
    best = torch.argmin(errors)
    return RegistrationResult(
        transform=RigidTransform(
            rotation=cands.rotations[best], translation=cands.translations[best],
            scale=torch.ones((), dtype=torch.float32, device=device)),
        iterations=int(torch.sum(cands.proper)),
        error=errors[best],
    )
