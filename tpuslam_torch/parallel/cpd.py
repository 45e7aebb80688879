"""CPD with the target cloud split across the ranks (port of
``tpuslam/parallel/cpd.py``, 408 lines).

Each target row's responsibility denominator is a sum over the
REPLICATED moving cloud, so the E-step runs on each rank's block alone
and only the moments cross ranks (``:83-100``): ``psum`` of p1 f32[M],
px f32[M, 3], the log-likelihood, and the two pt1 reductions the M-step
needs (``A^T pt1`` and ``sum pt1 |a|^2``); pt1 itself stays on its rank.
The sigma^2 initialisation sums the target's partials the same way
(``:66-81``), and the 3x3 M-step runs replicated from the reduced
moments (``:227-256``).

The exact E-step of a block is the port's ``cpd_estep_auto``: on the card
kernel K5, routing to K4 when its admission overflows (the JAX package
routes to ``pallas_cpd_cand`` on the TPU); on the CPU the oracle.  With
the kernels, the moving cloud and each block are Morton-sorted once, as
the solo run sorts its clouds.  K5's route may differ from block to
block; no collective sits inside the E-step, and K5 equals K4 bit for
bit, so that is harmless.  The 3x3 M-step runs replicated, in float32
from the reduced moments (``ShardedEM.mstep``).

The FGT E-step (``:102-170``) is sharded another way than the JAX
package's.  There each block is clustered anew every E-step with an
adaptive centre count, and the blocks' centres and coefficients are
``all_gather``ed into a union model ``size`` times larger; that model is
another approximation than the solo run's (the JAX tests hold the two
runs 2e-2 apart in R), and on the card it moved a 102,400-point Hybrid
run 0.029 in R from the solo run in 30 iterations.  Here both clouds are
clustered once a registration, as the solo run does (``_EM``): the
moving cloud on every rank, the whole target gathered once and sorted as
the solo run sorts it.  Each rank expands its own rows about the whole
target's centres and one ``psum`` of the coefficients gives the solo
run's model, up to float32 summation order.  ``resolve_use_fgt`` reads
the GLOBAL padded sizes.

The EM loop is the solo port's (``algorithms/cpd.py::_em_loop``), with
this module's E-step and M-step as its hooks (``ShardedEM``): its state
on the device, one host read a chunk of ``device_loop.LOOP_CHUNK`` iterations,
an iteration frozen after the stop test fails, after ``max_iterations``
or (Hybrid with the FGT, one phase a chunk) in the other phase.  On CUDA
under NCCL a chunk is captured as a CUDA graph with its collectives and
replayed (K5 then chooses its route on the device); under gloo a chunk
on CUDA is one eager iteration; on the CPU ``LOOP_CHUNK`` eager ones.
The stop test and the phase come from replicated values (sigma^2, the
log-likelihood), so every rank freezes alike, frozen iterations run
their collectives on every rank, and the collectives stay matched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.algorithms.cpd import (
    HYBRID_SWITCH,
    CPDResume,
    CPDState,
    EMConfig,
    EMInputs,
    MStepResult,
    _EMCarry,
    _em_loop,
    cpd_estep_auto,
    mstep_from_moments,
    resolve_use_fgt,
    resolve_use_kernels,
    uniform_constant,
)
from tpuslam_torch.algorithms.device_loop import graph_scope
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform
from tpuslam_torch.kernels.cpd_dense import device_scalar
from tpuslam_torch.ops.fgt import (
    FGTModel,
    compute_fgt_model_multi,
    fgt_predict,
    fgt_predict_multi,
    fgt_tables,
    k_center_ordered,
    segment_order,
)
from tpuslam_torch.ops.geometry import transform_points
from tpuslam_torch.ops.spatial import morton_permutation
from tpuslam_torch.parallel.collectives import all_gather, psum
from tpuslam_torch.parallel.mesh import Mesh, capturable, mesh_key, shard_mask, shard_offset


class Moments(NamedTuple):
    """The reduced E-step statistics, the same on every rank."""

    p1: torch.Tensor  # f32[M]
    px: torch.Tensor  # f32[M, 3]
    error: torch.Tensor  # f32[] negative log-likelihood
    t_pt1_a2: torch.Tensor  # f32[]  sum_n pt1_n |a_n|^2
    s_pt1_a: torch.Tensor  # f32[3] sum_n pt1_n a_n


def _reduce(p1, px, error, pt1, target, mesh: Mesh) -> Moments:
    """``p1`` and ``px`` as given, the rest summed over the ranks."""
    return Moments(
        p1=p1,
        px=px,
        # each block's error holds 3 n_block log(s2) / 2, which sums to the
        # global term
        error=psum(error, mesh),
        t_pt1_a2=psum(torch.sum(pt1 * torch.sum(target * target, -1)), mesh),
        s_pt1_a=psum(torch.matmul(pt1, target), mesh),
    )


def estep_sharded(transformed, mask_b, target, mask_a, sigma2, constant, trunc,
                  mesh: Mesh) -> Moments:
    """The exact (or truncated) E-step of this rank's block, reduced over
    the ranks (``parallel/cpd.py:83-100``): the kernels on the card, the
    oracle on the CPU (``cpd_estep_auto``)."""
    local = cpd_estep_auto(transformed, mask_b, target, mask_a, sigma2, constant, trunc)
    return _reduce(psum(local.p1, mesh), psum(local.px, mesh), local.error, local.pt1, target,
                   mesh)


class FGTClusters(NamedTuple):
    """The clusterings the FGT E-steps of a registration reuse, the solo
    run's (``algorithms/cpd.py::_EM``): the moving cloud's (centres of the
    untransformed cloud, assignment, ``SegmentOrder``), and the whole
    target's centres with this rank's rows' assignment and order."""

    moving: tuple
    target_centers: torch.Tensor  # f32[K, 3]
    block: tuple  # (assignment i32[rows], SegmentOrder) of this rank's rows


def fgt_clusters(moving, mask_b, after: Cloud, mesh: Mesh, k: int, sort: bool,
                 perm_a: Optional[torch.Tensor]) -> FGTClusters:
    """Cluster both clouds once, as the solo run does: the moving cloud on
    every rank, the whole target (gathered once, Morton-sorted when
    ``sort``, as the solo run sorts it) with the solo run's farthest-point
    steps; each rank keeps its own rows' assignment (in its block's order
    ``perm_a``, if the block was sorted)."""
    whole = all_gather(after.points, mesh)
    mask = (torch.arange(whole.shape[0], device=whole.device) < after.count).to(torch.float32)
    perm = (morton_permutation(whole, mask).long() if sort
            else torch.arange(whole.shape[0], device=whole.device))
    centers, indx_sorted, _ = k_center_ordered(whole[perm].contiguous(), mask[perm], k)
    indx = torch.empty_like(indx_sorted).index_copy_(0, perm, indx_sorted)
    offset, rows = shard_offset(after, mesh), after.points.shape[0]
    block = indx[offset:offset + rows]
    if perm_a is not None:
        block = block[perm_a]
    return FGTClusters(k_center_ordered(moving, mask_b, k), centers,
                       (block, segment_order(block, k)))


def estep_fgt_sharded(transformed, mask_b, target, mask_a, sigma_e, weight, m, n,
                      clusters: FGTClusters, state: CPDState, fgt_p: int,
                      ratio_of_far_field: float, mesh: Mesh) -> Moments:
    """The FGT E-step (``cpdutils.cpp:19-73``) with the target's
    expansion summed over the blocks: the moving cloud's model is built
    on every rank, each rank expands its block's rows about the whole
    target's centres, and one ``psum`` of the coefficients gives the solo
    run's target model (module docstring)."""
    centers_y0, indx_y, order_y = clusters.moving
    indx_x, order_x = clusters.block
    k = centers_y0.shape[0]
    hsigma = torch.sqrt(2.0 * sigma_e)
    centers_y = transform_points(centers_y0, state.rotation, state.translation, state.scale)
    model_y = compute_fgt_model_multi(transformed, mask_b[:, None], mask_b, hsigma, k, fgt_p,
                                      clustering=(centers_y, indx_y), order=order_y)
    kt1 = fgt_predict(target, FGTModel(centers=model_y.centers, ak=model_y.ak[..., 0]),
                      hsigma, ratio_of_far_field, fgt_p)
    ndi = uniform_constant(sigma_e, weight, m, n)
    denom = torch.clamp_min(kt1, 0.0) + ndi  # the FGT can dip below 0
    inv_denom = mask_a / denom
    pt1 = (1.0 - ndi / denom) * mask_a
    weights4 = torch.cat([inv_denom[:, None], target * inv_denom[:, None]], dim=1)
    block = compute_fgt_model_multi(target, weights4, mask_a, hsigma, k, fgt_p,
                                    clustering=(clusters.target_centers, indx_x), order=order_x)
    model_x = FGTModel(centers=clusters.target_centers, ak=psum(block.ak, mesh))
    # p1 and px come from the whole target's model: the same on every rank
    out = fgt_predict_multi(transformed, model_x, hsigma, ratio_of_far_field, fgt_p)
    error = (-torch.sum(torch.log(denom) * mask_a)
             + 3.0 * torch.sum(mask_a) * torch.log(sigma_e) / 2.0)
    return _reduce(out[:, 0] * mask_b, out[:, 1:4] * mask_b[:, None], error, pt1, target, mesh)


class ShardedEM(NamedTuple):
    """The sharded hooks of the EM loop (``algorithms/cpd.py::EMConfig``'s
    ``shard``): the E-step of this rank's block reduced over the ranks,
    the replicated M-step, and whether the loop may be captured.  Part of
    a CUDA graph's key through ``key`` (``mesh.mesh_key``)."""

    mesh: Mesh
    key: tuple

    @property
    def capturable(self) -> bool:
        return capturable(self.mesh)

    def estep(self, cfg: EMConfig, t: EMInputs, s: CPDState, transformed, fgt: bool, sigma_e,
              constant, trunc) -> Moments:
        """The iteration's E-step (``algorithms/cpd.py::_plan``'s choice)."""
        if fgt:
            return estep_fgt_sharded(transformed, t.mask_b, t.target, t.mask_a, sigma_e,
                                     t.weight, t.m, t.n, t.fgt, s, cfg.order_of_truncation,
                                     cfg.ratio_of_far_field, self.mesh)
        return estep_sharded(transformed, t.mask_b, t.target, t.mask_a, sigma_e, constant, trunc,
                             self.mesh)

    def mstep(self, t: EMInputs, mo: Moments, const_scale: bool, prev_scale) -> MStepResult:
        """The replicated M-step from the reduced moments
        (``parallel/cpd.py:227-256``)."""
        moving = t.moving
        np_ = torch.sum(mo.p1)
        inv_np = 1.0 / np_
        mu_b = inv_np * torch.matmul(mo.p1, moving)
        mu_a = inv_np * mo.s_pt1_a
        a_mat = torch.matmul(mo.px.T, moving) - np_ * torch.outer(mu_a, mu_b)
        sigma_sub = mo.t_pt1_a2 - np_ * torch.dot(mu_a, mu_a)
        scale_den = (torch.sum(mo.p1 * torch.sum(moving * moving, -1))
                     - np_ * torch.dot(mu_b, mu_b))
        return mstep_from_moments(np_, mu_b, mu_a, a_mat, sigma_sub, scale_den, const_scale,
                                  prev_scale)


def cpd_register_sharded(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    eps: float = 1e-3,
    weight: float = 0.3,
    const_scale: bool = False,
    max_iterations: int = -1,
    tolerance: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    use_fgt: Optional[bool] = None,
    fgt_k: int = 128,
    order_of_truncation: int = 8,
    ratio_of_far_field: float = 10.0,
    resume: Optional[CPDResume] = None,
) -> RegistrationResult:
    """``before`` (moving) replicated, ``after`` (target) this rank's
    block; every rank returns the same result.  The loop, its stop test
    (the solo port's: a finite log-likelihood, ``ntol > tolerance``,
    ``sigma^2 > eps``; ``max_iterations < 0`` runs none) and its
    approximation ladder are ``algorithms/cpd.py``'s, with its default
    E-step (the kernels on the card, the oracle on the CPU) on this
    rank's block (module docstring).  ``resume`` re-enters with a chunk
    boundary's full EM carry (``CPDResume``).  The result's ``error`` is
    sigma^2 and its ``em`` the final ``CPDState``."""
    device = before.points.device

    def f32(x):
        return device_scalar(x, torch.float32, device)

    use_fgt = resolve_use_fgt(use_fgt, approximation_type, before.padded_size,
                              after.points.shape[0] * mesh.size)
    use_kernels = resolve_use_kernels(None, device)
    moving, mask_b = before.points, before.mask()
    target, mask_a = after.points, shard_mask(after, mesh)
    perm_a = None
    if use_kernels:
        # Morton-sorted rows give K5 compact blocks to skip (the solo run's
        # sort; the block is sorted within itself)
        perm_b = morton_permutation(moving, mask_b).long()
        moving, mask_b = moving[perm_b].contiguous(), mask_b[perm_b]
        perm_a = morton_permutation(target, mask_a).long()
        target, mask_a = target[perm_a].contiguous(), mask_a[perm_a]
    fgt_kk = min(fgt_k, before.padded_size, after.points.shape[0] * mesh.size)
    clusters = None
    if use_fgt and approximation_type != ApproximationType.NONE:
        clusters = fgt_clusters(moving, mask_b, after, mesh, fgt_kk, use_kernels, perm_a)
        # the static tables on the device before any capture
        fgt_tables(order_of_truncation, device)

    weight = torch.clamp(f32(weight), 1e-6, 1.0 - 1e-6)
    m = torch.sum(mask_b)
    n = psum(torch.sum(mask_a), mesh)
    # sigma^2_0 in closed form from the target's reduced partials
    sb2 = torch.sum(torch.sum(moving * moving, -1) * mask_b)
    sb = torch.sum(moving * mask_b[:, None], dim=0)
    sa2 = psum(torch.sum(torch.sum(target * target, -1) * mask_a), mesh)
    sa = psum(torch.sum(target * mask_a[:, None], dim=0), mesh)
    sigma2_0 = (n * sb2 + m * sa2 - 2.0 * torch.dot(sb, sa)) / (3.0 * m * n)
    tolerance_t = f32(tolerance)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    inputs = EMInputs(
        moving=moving, target=target, mask_b=mask_b, mask_a=mask_a, m=m, n=n, weight=weight,
        eps=f32(eps), tolerance=tolerance_t, sigma2_0=sigma2_0,
        c_init=uniform_constant(sigma2_0, weight, m, n), switch=HYBRID_SWITCH * sigma2_0,
        cap=zero, offset=zero, fgt=clusters)
    config = EMConfig(approximation_type, use_fgt, use_kernels, fgt_kk, order_of_truncation,
                      ratio_of_far_field, const_scale, shard=ShardedEM(mesh, mesh_key(mesh)))

    if resume is None:
        s = CPDState(rotation=torch.eye(3, dtype=torch.float32, device=device),
                     translation=torch.zeros(3, dtype=torch.float32, device=device),
                     scale=f32(1.0), sigma2=sigma2_0, log_likelihood=f32(0.0),
                     ntol=tolerance_t + 10.0, iterations=zero)
    else:
        s = CPDState(rotation=f32(resume.rotation), translation=f32(resume.translation),
                     scale=f32(resume.scale), sigma2=f32(resume.sigma2),
                     log_likelihood=f32(resume.log_likelihood), ntol=f32(resume.ntol),
                     iterations=zero)
    iter_offset = 0 if resume is None else int(resume.done_before)
    c, counts = _em_loop(config, inputs, _EMCarry(s), int(max_iterations), False, iter_offset)
    s = c.s._replace(iterations=counts[0])
    return RegistrationResult(
        transform=RigidTransform(rotation=s.rotation, translation=s.translation, scale=s.scale),
        iterations=s.iterations,
        error=s.sigma2,  # the reference reports sigma^2 as "error"
        em=s,
    )


def cpd_register_sharded_chunked(
    before: Cloud,
    after: Cloud,
    mesh: Mesh,
    max_iterations: int = -1,
    chunk: int = 5,
    resume: Optional[CPDResume] = None,
    **kwargs,
) -> RegistrationResult:
    """``cpd_register_sharded`` run ``chunk`` EM iterations at a time
    (``parallel/cpd.py:364-408``), the full EM carry crossing each
    boundary, so the trajectory is the single run's, bit for bit.
    ``max_iterations < 0`` runs zero iterations, the reference's quirk
    (``coherentpointdrift.cpp:104``).  ``resume`` starts the first chunk
    from a boundary (``CPDResume``), whose ``done_before`` counts toward
    ``max_iterations``.  The driver's chunks share their shapes: under
    NCCL the second and later ones replay the loop's CUDA graphs (the
    open ``graph_scope``, else one of its own)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if max_iterations < 0:
        return cpd_register_sharded(before, after, mesh, max_iterations=max_iterations,
                                    resume=resume, **kwargs)
    total = 0 if resume is None else int(resume.done_before)
    with graph_scope():
        while True:
            k = min(chunk, max_iterations - total)
            result = cpd_register_sharded(before, after, mesh, max_iterations=k,
                                          resume=resume, **kwargs)
            did = int(result.iterations)
            total += did
            s = result.em
            resume = CPDResume(rotation=s.rotation, translation=s.translation, scale=s.scale,
                               sigma2=s.sigma2, log_likelihood=s.log_likelihood, ntol=s.ntol,
                               done_before=total)
            if did < k or total >= max_iterations:
                break
    return RegistrationResult(transform=result.transform, iterations=total,
                              error=result.error, em=result.em)
