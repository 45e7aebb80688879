"""Sharded nearest-neighbour search: per-shard argmin, then the global
combine (port of ``tpuslam/parallel/nn.py``, 82 lines).

The target cloud is split across the ranks; each rank finds, for ALL
source rows, the nearest row of its own block, and the global winner is
resolved by two ``pmin`` collectives, one on the distance and one on the
global index among the blocks at that distance, so the reference's
first-index-wins tie-break (``common.cpp:416``, strict ``<``) holds
across blocks.  A ``psum`` of the winner's row (one non-zero term)
replicates the matched target points for the replicated Procrustes.

On the card the per-block search is kernel K1
(``ops/nn.py::nearest_neighbors``); on the CPU its plain version.  The
JAX package runs its jnp oracle there on every backend
(``parallel/nn.py:70-81``); K1 is bit-identical to that oracle by
contract, so the function is the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuslam_torch.core.types import Cloud
from tpuslam_torch.ops.nn import nearest_neighbors
from tpuslam_torch.parallel.collectives import pmin, psum
from tpuslam_torch.parallel.mesh import Mesh, shard_count, shard_offset

BIG = 3.4e38
IMAX = 2**31 - 1


def lexmin_combine(
    dl: torch.Tensor,
    il: torch.Tensor,
    tgt_shard: torch.Tensor,
    offset: int,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cross-shard combine shared by every sharded NN arm
    (``parallel/nn.py:26-56``).

    ``dl``/``il``: this rank's exact (squared distance, local index) per
    source row, no-match rows as (BIG, 0) so ``il`` stays in range;
    ``offset``: the block's global first row.  Among the blocks at the
    global minimum distance, the LOWEST global index wins; a BIG distance
    wins only where every block reports BIG, and its weight then masks
    the pair downstream.  Returns, the same on every rank, (global index
    i32[N], squared distance f32[N], matched points f32[N, 3])."""
    dl = torch.where(dl >= BIG, torch.full_like(dl, BIG), dl)
    gl = il + offset
    dmin = pmin(dl, mesh)
    cand = torch.where(dl == dmin, gl, torch.full_like(gl, IMAX))
    gmin = pmin(cand, mesh)
    win = gmin == gl
    rows = tgt_shard.index_select(0, il.long())
    matched = psum(torch.where(win[:, None], rows, torch.zeros_like(rows)), mesh)
    return gmin, dmin, matched


def sharded_nn_combine(
    src: torch.Tensor, target: Cloud, mesh: Mesh
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``src``: replicated f32[N, 3]; ``target``: this rank's block of a
    ``shard_cloud`` (``parallel/nn.py:58-82``).  Returns, the same on
    every rank, (global index i32[N], squared distance f32[N], matched
    points f32[N, 3]): the whole cloud's exact nearest neighbours."""
    il, dl = nearest_neighbors(src, target.points, shard_count(target, mesh))
    return lexmin_combine(dl, il, target.points, shard_offset(target, mesh), mesh)
