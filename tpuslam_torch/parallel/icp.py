"""ICP with the target cloud split across the ranks (port of
``tpuslam/parallel/icp.py``, 361 lines).

The loop is the port's solo loop (``algorithms/icp.py::_icp_loop``: the
homogeneous composition, the weight-masked Procrustes, the divergence
guard and every stop condition) with its nearest-neighbour hooks taken
by the sharded search: each iteration runs one per-shard search and the
combine of ``parallel/nn.py`` (two ``pmin``, one ``psum``); the 3x3
algebra runs replicated.  The moving cloud stays replicated, so every
sum over source rows is the solo run's sum, and the dense arm's result
equals solo ``icp_register(use_spatial=False)`` bit for bit at any world
size.

The loop runs in the solo loop's chunks (``algorithms/device_loop.py``),
with one host read a chunk, on every rank.  On CUDA under NCCL a chunk
of ``device_loop.LOOP_CHUNK`` iterations is captured as a CUDA graph, its
collectives with it, and replayed (kept in the open ``graph_scope``,
keyed on the process group too); the hierarchical search then chooses
its arm on the device.  Under gloo, which stages each collective through
the host, a chunk on CUDA is one eager iteration, the search reading its
arm on the host; on the CPU a chunk is ``LOOP_CHUNK`` eager iterations.
An iteration frozen past the stop still runs its search and its
collectives.  Every rank computes the stop from the same reduced
tensors, so every rank freezes alike and the collectives stay matched.
Procrustes is kernel P, which reads nothing back.

Arms (``use_spatial``):

* dense: K1 on this rank's block (``nn.sharded_nn_combine``);
* hierarchical: the port's ``ops/nn_hier.py`` on this rank's block
  (K2 and K3, K1 on overflow), its tile parameters chosen from the
  block's size (``parallel/icp.py:201-220``), the replicated source
  padded to ``gsrc`` rows and Morton-sorted, the block padded to the
  tile with masked rows; then the same combine (``:34-86``).  Each
  block's search is exact for every row it can win, so the combine is
  K1's whole-cloud result; Procrustes sums the sources in Morton order,
  so the run agrees with the solo hierarchical run to float32 rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpuslam_torch.algorithms.device_loop import graph_scope
from tpuslam_torch.algorithms.icp import (
    FLT_MAX,
    Arm,
    ICPResume,
    ICPState,
    _icp_loop,
    full_f32,
)
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform, round_up
from tpuslam_torch.ops.nn_hier import (
    HierState,
    HierTarget,
    _coarse_tile_rows,
    auto_tile_params,
    hier_state_init,
    nearest_neighbors_hier,
    prepare_hier_target,
)
from tpuslam_torch.ops.spatial import morton_permutation
from tpuslam_torch.parallel.mesh import (
    Mesh,
    capturable,
    mesh_key,
    shard_count,
    shard_mask,
    shard_offset,
)
from tpuslam_torch.parallel.nn import lexmin_combine, sharded_nn_combine


class ShardNN(NamedTuple):
    """The loop's NN carry: the matched rows of the last query (from the
    combine; zeros before the first) and the hierarchical arm's per-block
    warm state."""

    matched: torch.Tensor
    hier: Optional[HierState]


class ShardedArm(NamedTuple):
    """What a sharded registration prepares once: the replicated sources
    in the arm's order, their mask, the loop's ``Arm`` (every tensor the
    search reads in its ``inputs``), the search itself and its cold
    carry."""

    src_points: torch.Tensor
    src_mask: torch.Tensor
    arm: Arm
    # (arm inputs, transformed sources, carry) -> (global index, distance,
    # new carry)
    search: Callable
    init: ShardNN

    def query(self, transformed: torch.Tensor, carry: ShardNN):
        """The sharded search at ``transformed`` from ``carry``, outside the
        loop (a final state's correspondences)."""
        return self.search(self.arm.inputs, transformed, carry)


def sharded_arm(before: Cloud, after: Cloud, mesh: Mesh, use_spatial: bool) -> ShardedArm:
    """The dense or hierarchical arm over ``before`` (replicated) and
    ``after`` (this rank's block of a ``shard_cloud``).  The arm's key
    names the search, its static settings, the block's offset and the
    process group (``mesh.mesh_key``); it is capturable under NCCL."""
    offset = shard_offset(after, mesh)
    if not use_spatial:
        def search(inputs, transformed, carry: ShardNN):
            gidx, dist, matched = sharded_nn_combine(transformed, Cloud(*inputs), mesh)
            return gidx, dist, ShardNN(matched, None)

        src_points, src_mask = before.points, before.mask()
        inputs = (after.points, after.count)
        static, hier = ("dense",), None
    else:
        # tile parameters of the rank's block; sources padded to gsrc rows
        # and Morton-sorted, the block padded to the tile with masked rows
        shard = after.points.shape[0]
        g, gsrc, l_budget = auto_tile_params(shard)
        n0 = before.points.shape[0]
        n_pad = round_up(n0, gsrc)
        m_pad = round_up(shard, max(g, _coarse_tile_rows(g, gsrc) or g))
        b_points = torch.nn.functional.pad(before.points, (0, 0, 0, n_pad - n0))
        b_mask = torch.nn.functional.pad(before.mask(), (0, n_pad - n0))
        perm = morton_permutation(b_points, b_mask)
        src_points, src_mask = b_points[perm].contiguous(), b_mask[perm]
        block = torch.nn.functional.pad(after.points, (0, 0, 0, m_pad - shard))
        mask = torch.nn.functional.pad(shard_mask(after, mesh), (0, m_pad - shard))
        target = prepare_hier_target(block, mask, shard_count(after, mesh), g=g)

        def search(inputs, transformed, carry: ShardNN):
            il, dl, hier = nearest_neighbors_hier(
                transformed, inputs[1], HierTarget(*inputs[2:]), carry.hier,
                l_budget=l_budget, g=g, gsrc=gsrc)
            gidx, dist, matched = lexmin_combine(dl, il, inputs[0], offset, mesh)
            return gidx, dist, ShardNN(matched, hier)

        inputs = (block, src_mask, *target)
        static = ("hier", g, gsrc, l_budget)
        hier = hier_state_init(n_pad, before.points.device)

    arm = Arm(inputs, lambda inp, transformed, s: search(inp, transformed, s.nn),
              lambda inp, idx, carry: carry.matched,
              ("sharded", *static, offset, mesh_key(mesh)), capturable(mesh))
    return ShardedArm(src_points, src_mask, arm, search,
                      ShardNN(torch.zeros_like(src_points), hier))


def register_on_arm(
    arm: ShardedArm,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    resume: Optional[ICPResume] = None,
    verbose: bool = False,
) -> RegistrationResult:
    """The solo loop on a prepared arm; its ``nn`` is the final carry.
    The loop runs in chunks as the solo loop does (module docstring)."""
    device = arm.src_points.device

    def f32(x):
        if isinstance(x, (int, float)):
            return full_f32(x, device)  # no blocking host-to-device copy
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if resume is None:
        rotation = torch.eye(3, dtype=torch.float32, device=device)
        translation = torch.zeros(3, dtype=torch.float32, device=device)
        error, prev = f32(1e5), f32(FLT_MAX)  # basicicp.cpp:26
        iter_offset = 0
    else:
        # chunk-boundary warm start: prev_error defaults to the accepted error
        rotation, translation = f32(resume.rotation), f32(resume.translation)
        error = f32(resume.error)
        prev = f32(resume.error if resume.prev_error is None else resume.prev_error)
        iter_offset = int(resume.done_before)
    init = ICPState(rotation=rotation, translation=translation, error=error,
                    prev_error=prev, iterations=0,
                    done=torch.zeros((), dtype=torch.bool, device=device), nn=arm.init)
    return _icp_loop(
        arm.src_points, arm.src_mask, arm.arm,
        f32(eps), f32(max_distance_squared), int(max_iterations),
        divergence_guard=divergence_guard, verbose=verbose,
        iter_offset=iter_offset, init=init, patience=0,
    )


def icp_register_sharded(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    use_spatial: bool = False,
    resume: Optional[ICPResume] = None,
) -> RegistrationResult:
    """``before`` replicated (``mesh.replicate_cloud``), ``after`` this
    rank's block (``mesh.shard_cloud``); every rank returns the same
    result.  ``use_spatial`` runs the hierarchical search per block
    (module docstring).  ``resume`` starts from a chunk boundary
    (``ICPResume``; its ``nn`` is not used: the warm state of the
    hierarchical arm is not carried across chunks, as in the JAX
    package)."""
    res = register_on_arm(
        sharded_arm(before, after, mesh, use_spatial),
        eps=eps, max_distance_squared=max_distance_squared,
        max_iterations=max_iterations, divergence_guard=divergence_guard, resume=resume,
    )
    return res._replace(nn=None)


def icp_register_sharded_prealigned(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    use_spatial: bool = False,
    subcloud_size: int = 1000,
    seed: int = 0,
) -> RegistrationResult:
    """Sharded ICP seeded by sharded NICP (``parallel/icp.py:261-311``).

    The seed is COMPOSED, not resumed: ``before`` is moved by the NICP
    estimate (padded rows kept at zero) and the cold sharded loop runs on
    the moved cloud; the result composes back, ``R = R1 R0``,
    ``t = R1 t0 + t1``."""
    from tpuslam_torch.parallel.nicp import nicp_register_sharded

    pre = nicp_register_sharded(before, after, mesh, subcloud_size=subcloud_size, seed=seed)
    r0, t0 = pre.transform.rotation, pre.transform.translation
    moved = Cloud(points=(torch.matmul(before.points, r0.T) + t0) * before.mask()[:, None],
                  count=before.count)
    res = icp_register_sharded(
        moved, after, mesh, eps=eps, max_distance_squared=max_distance_squared,
        max_iterations=max_iterations, divergence_guard=divergence_guard,
        use_spatial=use_spatial,
    )
    r1, t1 = res.transform.rotation, res.transform.translation
    return RegistrationResult(
        transform=RigidTransform(torch.matmul(r1, r0), torch.matmul(r1, t0) + t1,
                                 res.transform.scale),
        iterations=res.iterations,
        error=res.error,
    )


def icp_register_sharded_chunked(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    chunk: int = 10,
    resume: Optional[ICPResume] = None,
    **kwargs,
) -> RegistrationResult:
    """``icp_register_sharded`` run ``chunk`` iterations at a time
    (``parallel/icp.py:314-361``): each boundary holds the loop's carry,
    so the trajectory is the single run's, bit for bit.  ``resume``
    starts the first chunk from a boundary state (``ICPResume``), whose
    ``done_before`` counts toward ``max_iterations``.  The driver's chunks
    share their shapes: under NCCL the second and later ones replay the
    loop's CUDA graph (the open ``graph_scope``, else one of its own)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    total = 0 if resume is None else int(resume.done_before)
    with graph_scope():
        while True:
            k = chunk if max_iterations == -1 else min(chunk, max_iterations - total)
            result = icp_register_sharded(
                before, after, mesh, eps=eps, max_distance_squared=max_distance_squared,
                max_iterations=k, resume=resume, **kwargs,
            )
            did = int(result.iterations)
            total += did
            resume = ICPResume(rotation=result.transform.rotation,
                               translation=result.transform.translation,
                               error=result.error, done_before=total)
            if did < k or (max_iterations != -1 and total >= max_iterations):
                break
    return RegistrationResult(transform=result.transform, iterations=total,
                              error=result.error)
