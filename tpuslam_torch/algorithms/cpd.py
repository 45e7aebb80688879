"""Coherent Point Drift — rigid GMM/EM registration (port of
``tpuslam/algorithms/cpd.py``, Myronenko & Song).

Semantics follow the JAX package, which follows the reference
(``coherentpointdrift.cpp``):

* ``sigma^2`` starts at ``sum_ij |b_i - a_j|^2 / (3 N M)`` in closed form;
* the uniform-component constant ``c`` is computed once from the
  initial ``sigma^2`` in exact mode and from the current one in the
  fast (FGT-mode) phase; the weight is clamped to (1e-6, 1 - 1e-6);
* the loop runs while ``iter < max_iterations``, the log-likelihood is
  finite, ``ntol = |(L - L_prev) / L| > tolerance`` and
  ``sigma^2 > eps``; ``max_iterations == -1`` runs zero iterations;
* the M-step is the det-corrected 3x3 SVD of ``A = px^T B - Np mu_a
  mu_b^T``, with the const-scale and free-scale branches; the result's
  rotation is ``scale * R`` at the registry;
* approximation ladder: ``None`` exact; ``Full`` sigma^2 floored at 0.05,
  fast E-step; ``Hybrid`` fast while ``sigma^2 > 0.015 sigma^2_0``, then
  exact with truncation 1e-3.  The fast E-step is the Fast Gauss
  Transform (``ops/fgt.py``) at or above ``CPD_FGT_CROSSOVER`` rows and
  the exact kernels with FGT-mode constants below it
  (``resolve_use_fgt``).

The exact E-step has two implementations (``cpd_estep_auto``): the
blocked oracle ``cpd_estep`` (the JAX package's off-TPU path, with its
matrix-product form of d^2), and the kernel path, kernel K5
(``kernels/cpd_cand.py``) on Morton-sorted clouds, which routes to K4
(``kernels/cpd_dense.py``) when its candidate tables overflow.
``use_kernels=None`` takes the kernel path on CUDA and the oracle on the
CPU, as the JAX package's ``use_pallas=None`` takes Pallas on the TPU
only; ``use_kernels=True`` on the CPU runs the kernel path through the
plain versions.

The EM loop keeps all of its state on the device, as the JAX package's
``lax.while_loop``s do, and freezes a registration once it has stopped
(an iteration after the stop test fails, after ``max_iterations`` or in
the other Hybrid phase changes nothing: ``torch.where`` over the carry).
It runs in chunks of ``device_loop.LOOP_CHUNK`` iterations with one host
read a chunk, its report: the iteration count and the phase the next
chunk needs here, each iteration's E-step (to ``PHASE_TRACE``) and K5
route (to ``kernels/cpd_cand.py``'s ``ROUTE_TRACE``), booked through
``core/choices.py``, and the launches the device counted there.  Hybrid
with the FGT runs one phase's E-step a chunk (the JAX package's
``cond_fast``/``cond_slow`` loops): an iteration of the other phase is
frozen and the next chunk takes that phase.  Every other mode has one
E-step, its phase a device flag (the JAX ``else`` branch): Hybrid below
the FGT crossover picks its constant and truncation flag on the device.
The slow phase calls K5, which chooses between its route and K4's on
the device inside a CUDA graph (a predicated ``choices.recording``); the
JAX package's checked form, which leaves the loop on overflow so the
cond-bodied loop redoes the iteration, gives the same statistics bit for
bit (``tests/test_pallas_cpd.py::test_cand_checked_matches_plain``).

The chunks run on ``algorithms/device_loop.py``, as ICP's do:
on CUDA a chunk is captured once as a CUDA graph (after one eager chunk
of its key, its warm-up) and replayed; the graph is kept, by shape,
mode, phase and history, in the open ``graph_scope`` (else for the
registration), and a later registration of the same key loads its
inputs and replays it.  ``verbose=True`` (the reference's printf),
``device_loop.CUDA_GRAPHS = False`` (the eager baseline of a
measurement) and the CPU run eager chunks, of one iteration on CUDA, of
``LOOP_CHUNK`` on the CPU (``device_loop.chunk_policy``), K5 reading its
route on the host.  Whatever the chunk, the result is the eager
one-iteration loop's, bit for bit.  The pair-axis
loop (``algorithms/batch.py``) runs the same chunks over a leading pair
axis; where its E-step runs pair by pair, a chunk runs only the pairs
that were running in its phase when it began (they are part of its
key), as the other pairs stay frozen through it.  The sharded loop
(``parallel/cpd.py``) runs the same chunks too, its E-step on a rank's
block and its replicated M-step given as hooks (``EMConfig.shard``).

The M-step's sums come from kernel P's moments entry, float64 over fixed
row chunks, and its SVD from P's SVD entry (``kernels/procrustes.py``):
a pair of the pair-axis loop gets its solo run's bits.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, NamedTuple, Optional

import torch

from tpuslam_torch.algorithms.device_loop import (
    chunk_policy,
    graph_scope,
    keep,
    leaves,
    rebuild,
    run_chunks,
    signature,
)
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core import choices
from tpuslam_torch.core.spans import span
from tpuslam_torch.core.types import (
    Cloud,
    RegistrationResult,
    RigidTransform,
    Sufficient,
    pick_block,
)
from tpuslam_torch.kernels.cpd_cand import cpd_estep_cand
from tpuslam_torch.kernels.cpd_dense import cpd_estep_dense_batch, device_scalar
from tpuslam_torch.kernels.procrustes import mstep_moments_batch
from tpuslam_torch.ops.fgt import (
    FGTModel,
    SegmentOrder,
    compute_fgt_model_multi,
    fgt_predict,
    fgt_predict_multi,
    fgt_tables,
    k_center_ordered,
)
from tpuslam_torch.ops.geometry import matvec3, transform_points
from tpuslam_torch.ops.procrustes import svd_rotation_det
from tpuslam_torch.ops.spatial import morton_permutation

__all__ = [
    "CPD_FGT_CROSSOVER", "CPDResume", "CPDState", "MStepResult", "Sufficient",
    "cpd_estep", "cpd_estep_auto", "cpd_estep_fgt", "cpd_mstep",
    "cpd_register", "cpd_register_chunked", "hybrid_fast_threshold", "mstep_from_moments",
    "mstep_from_sums",
    "resolve_use_fgt", "resolve_use_kernels", "sigma_squared_init",
    "uniform_constant",
]

_TWO_PI = 2.0 * math.pi

# padded rows from which the Full/Hybrid fast phase runs the FGT: the JAX
# package's exact-vs-FGT crossover, measured on a TPU v5e; kept until a
# benchmark on the card moves it
CPD_FGT_CROSSOVER = 74_018
# Hybrid runs its fast phase while sigma^2 > HYBRID_SWITCH * sigma^2_0
# (coherentpointdrift.cpp:158)
HYBRID_SWITCH = 0.015
# the E-step of each recent EM iteration, newest last: "fgt", "exact"
# (no truncation) or "trunc" (Hybrid's slow phase)
PHASE_TRACE: deque = deque(maxlen=4096)
PHASES = ("fgt", "exact", "trunc")  # by phase code


def resolve_use_fgt(
    use_fgt: Optional[bool],
    approximation_type: ApproximationType,
    m_pad: int,
    n_pad: int,
) -> bool:
    """``True``/``False`` force the fast phase's E-step; ``None`` takes
    the FGT for Full/Hybrid at or past the crossover size.  Exact mode
    never uses it."""
    if use_fgt is not None:
        return bool(use_fgt)
    if approximation_type == ApproximationType.NONE:
        return False
    return max(int(m_pad), int(n_pad)) >= CPD_FGT_CROSSOVER


def resolve_use_kernels(use_kernels: Optional[bool], device) -> bool:
    """The counterpart of the JAX package's ``use_pallas``: an explicit
    choice stands; None takes the kernels on CUDA and the oracle
    elsewhere."""
    if use_kernels is not None:
        return bool(use_kernels)
    return torch.device(device).type == "cuda"


def sigma_squared_init(
    moving: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
) -> torch.Tensor:
    """Closed form of ``CalculateSigmaSquared``
    (``coherentpointdrift.cpp:126-139``): sum_ij |b_i - a_j|^2 =
    N_a sum|b|^2 + N_b sum|a|^2 - 2 (sum b).(sum a), masked."""
    nb = torch.sum(moving_mask)
    na = torch.sum(target_mask)
    sb2 = torch.sum(torch.sum(moving * moving, -1) * moving_mask)
    sa2 = torch.sum(torch.sum(target * target, -1) * target_mask)
    sb = torch.sum(moving * moving_mask[:, None], dim=0)
    sa = torch.sum(target * target_mask[:, None], dim=0)
    total = na * sb2 + nb * sa2 - 2.0 * torch.dot(sb, sa)
    return total / (3.0 * nb * na)


def uniform_constant(sigma2, weight, m, n) -> torch.Tensor:
    """``(2 pi sigma^2)^{3/2} w M / ((1-w) N)``
    (``coherentpointdrift.cpp:96``, ``cpdutils.cpp:44``)."""
    return torch.pow(_TWO_PI * sigma2, 1.5) * weight * m / ((1.0 - weight) * n)


def cpd_estep(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2,
    constant,
    trunc_active,
    truncate: float = 1e-3,
) -> Sufficient:
    """Blocked exact E-step (``ComputePMatrix``,
    ``coherentpointdrift.cpp:167-221``), streaming target tiles; the
    oracle of the kernels.  d^2 keeps the JAX package's matrix-product
    form ``|y|^2 + |x|^2 - 2 y.x`` (full float32).  ``trunc_active``
    drops responsibilities whose exponent is below ``log(truncate)``."""
    dev = transformed.device
    m, n = transformed.shape[0], target.shape[0]
    sigma2 = device_scalar(sigma2, torch.float32, dev)
    constant = device_scalar(constant, torch.float32, dev)
    trunc_active = device_scalar(trunc_active, torch.bool, dev)
    tile = pick_block(n)
    multiplier = -0.5 / sigma2
    log_trunc = math.log(truncate)
    ty2 = torch.sum(transformed * transformed, dim=-1)
    p1 = torch.zeros(m, dtype=torch.float32, device=dev)
    px = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    err = torch.zeros((), dtype=torch.float32, device=dev)
    pt1 = torch.empty(n, dtype=torch.float32, device=dev)
    for lo in range(0, n, tile):
        xt, mt = target[lo:lo + tile], target_mask[lo:lo + tile]
        d2 = (ty2[:, None] + torch.sum(xt * xt, dim=-1)[None, :]
              - 2.0 * torch.matmul(transformed, xt.T))
        expo = multiplier * d2
        g = torch.exp(expo) * moving_mask[:, None]
        g = torch.where(torch.logical_and(trunc_active, expo < log_trunc),
                        torch.zeros_like(g), g)
        denom = torch.sum(g, dim=0) + constant
        pt1[lo:lo + tile] = (1.0 - constant / denom) * mt
        pn = (g / denom[None, :]) * mt[None, :]
        p1 = p1 + torch.sum(pn, dim=1)
        px = px + torch.matmul(pn, xt)
        err = err - torch.sum(torch.log(denom) * mt)
    err = err + 3.0 * torch.sum(target_mask) * torch.log(sigma2) / 2.0
    return Sufficient(p1=p1, pt1=pt1, px=px, error=err)


def cpd_estep_auto(
    transformed, moving_mask, target, target_mask, sigma2, constant,
    trunc_active, use_kernels: Optional[bool] = None,
) -> Sufficient:
    """The exact E-step: the kernel path (K5, routing to K4) when
    ``resolve_use_kernels`` says so, the oracle ``cpd_estep``
    otherwise."""
    args = (transformed, moving_mask, target, target_mask, sigma2, constant,
            trunc_active)
    if resolve_use_kernels(use_kernels, transformed.device):
        return cpd_estep_cand(*args)
    return cpd_estep(*args)


def cpd_estep_fgt(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2: torch.Tensor,
    weight,
    m: torch.Tensor,
    n: torch.Tensor,
    fgt_k: int,
    fgt_p: int,
    ratio_of_far_field: float,
    sigma2_init: Optional[torch.Tensor] = None,
    clusters=None,
    orders=None,
) -> Sufficient:
    """FGT-approximated E-step (``ComputePMatrixWithFGT``,
    ``cpdutils.cpp:19-73``): five Gauss transforms — Kt1 for the
    denominators, then p1 and the three px columns with 1/denominator
    weights — as one clustering and one 4-weight expansion per cloud.

    ``fgt_k`` caps the centres; with ``sigma2_init`` the live count
    follows the reference's ``K = min(N, M, 50 + sigma0^2/sigma^2)``
    (``cpdutils.cpp:35``).  ``clusters`` = ``(centers_y, indx_y,
    centers_x, indx_x)`` reuses clusterings made once per registration
    (then all ``fgt_k`` centres are used: a tighter approximation than
    the reference's adaptive count); ``orders`` = ``(order_y, order_x)``,
    their ``SegmentOrder``s, made with them, skips the sorts."""
    sigma2 = device_scalar(sigma2, torch.float32, transformed.device)
    if sigma2_init is not None and clusters is None:
        k_rt = torch.minimum(
            torch.minimum(m, n),
            50.0 + sigma2_init / torch.clamp_min(sigma2, 1e-20),
        ).to(torch.int32)
        k_rt = torch.clamp(k_rt, 1, fgt_k)
    else:
        k_rt = None
    cl_y = cl_x = None
    if clusters is not None:
        cl_y = (clusters[0], clusters[1])
        cl_x = (clusters[2], clusters[3])
    order_y, order_x = (None, None) if orders is None else orders
    hsigma = torch.sqrt(2.0 * sigma2)
    model_y = compute_fgt_model_multi(
        transformed, moving_mask[:, None], moving_mask, hsigma, fgt_k, fgt_p,
        k_rt, clustering=cl_y, order=order_y,
    )
    kt1 = fgt_predict(
        target, FGTModel(centers=model_y.centers, ak=model_y.ak[..., 0]),
        hsigma, ratio_of_far_field, fgt_p,
    )
    ndi = uniform_constant(sigma2, weight, m, n)
    denom = torch.clamp_min(kt1, 0.0) + ndi  # the FGT can dip below 0
    inv_denom = target_mask / denom
    pt1 = (1.0 - ndi / denom) * target_mask
    weights4 = torch.cat([inv_denom[:, None], target * inv_denom[:, None]], dim=1)
    model_x = compute_fgt_model_multi(
        target, weights4, target_mask, hsigma, fgt_k, fgt_p, k_rt,
        clustering=cl_x, order=order_x,
    )
    out = fgt_predict_multi(transformed, model_x, hsigma, ratio_of_far_field, fgt_p)
    p1 = out[:, 0] * moving_mask
    px = out[:, 1:4] * moving_mask[:, None]
    err = -torch.sum(torch.log(denom) * target_mask)
    err = err + 3.0 * torch.sum(target_mask) * torch.log(sigma2) / 2.0
    return Sufficient(p1=p1, pt1=pt1, px=px, error=err)


class MStepResult(NamedTuple):
    rotation: torch.Tensor
    translation: torch.Tensor
    scale: torch.Tensor
    sigma2: torch.Tensor


def mstep_from_moments(
    np_: torch.Tensor,
    mu_b: torch.Tensor,
    mu_a: torch.Tensor,
    a_mat: torch.Tensor,
    sigma_sub: torch.Tensor,
    scale_den: torch.Tensor,
    const_scale: bool,
    prev_scale: torch.Tensor,
) -> MStepResult:
    """The moment->transform core of the M-step (``MStep``,
    ``coherentpointdrift.cpp:241-278``): det-corrected 3x3 SVD of ``A``
    (kernel P's SVD entry on CUDA, ``torch.linalg.svd``/``det`` on the CPU:
    ``ops/procrustes.py``), scale ``tr(S D) / denominator`` and the
    sigma^2 update, in float32.  With a leading pair axis on every operand
    each pair gets the bits it gets alone (P's SVD entry is one launch for
    all pairs; the 3-vector products are elementwise, ``matvec3``)."""
    inv_np = 1.0 / np_
    r, sv, det_uv = svd_rotation_det(a_mat)
    # tr(S diag(1, 1, det(U V^T)))  (coherentpointdrift.cpp:258-260)
    scale_num = sv[..., 0] + sv[..., 1] + det_uv * sv[..., 2]
    if const_scale:
        scale = prev_scale
        sigma2 = inv_np * torch.abs(sigma_sub + scale_den - 2.0 * scale_num) / 3.0
    else:
        scale = scale_num / scale_den
        sigma2 = inv_np * torch.abs(sigma_sub - scale * scale_num) / 3.0
    t = mu_a - scale[..., None] * matvec3(r, mu_b)
    return MStepResult(rotation=r, translation=t, scale=scale, sigma2=sigma2)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over the last axis of 3, added left to right: elementwise,
    so a pair of a batch gets the bits it gets alone."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mstep_from_sums(sums: torch.Tensor, const_scale: bool,
                    prev_scale: torch.Tensor) -> MStepResult:
    """The M-step from kernel P's moments ``sums`` f64[..., 18]
    (``kernels/procrustes.py::MSTEP_SUMS``): ``Np``, the means, ``A = px^T
    B - Np mu_a mu_b^T`` (``coherentpointdrift.cpp:240``) and the two
    sigma^2 terms in float64, rounded to float32 for
    ``mstep_from_moments``."""
    np64 = sums[..., 0]
    mu_b = sums[..., 1:4] / np64[..., None]
    mu_a = sums[..., 4:7] / np64[..., None]
    a_mat = (sums[..., 7:16].reshape(sums.shape[:-1] + (3, 3))
             - np64[..., None, None] * (mu_a[..., :, None] * mu_b[..., None, :]))
    sigma_sub = sums[..., 16] - np64 * _dot3(mu_a, mu_a)
    scale_den = sums[..., 17] - np64 * _dot3(mu_b, mu_b)
    f32 = [x.to(torch.float32) for x in (np64, mu_b, mu_a, a_mat, sigma_sub, scale_den)]
    return mstep_from_moments(*f32, const_scale, prev_scale)


def mstep_sums(moving: torch.Tensor, target: torch.Tensor, stats: Sufficient) -> torch.Tensor:
    """Kernel P's moments entry on one pair (``moving`` f32[M, 3]) or a
    batch (f32[B, M, 3]) -> f64[18] or f64[B, 18]."""
    if moving.dim() == 3:
        return mstep_moments_batch(stats.p1, moving, stats.px, stats.pt1, target)
    return mstep_moments_batch(stats.p1[None], moving[None], stats.px[None], stats.pt1[None],
                               target[None])[0]


def cpd_mstep(
    moving: torch.Tensor,
    target: torch.Tensor,
    stats: Sufficient,
    const_scale: bool,
    prev_scale: torch.Tensor,
) -> MStepResult:
    """Closed-form rigid M-step (``MStep``, ``coherentpointdrift.cpp:
    223-278``): the sums of kernel P's moments entry, then
    ``mstep_from_sums``.  Padded rows have ``p1 = 0`` and ``pt1 = 0`` by
    the E-step's construction, so every sum is mask-clean.  With a leading
    pair axis, each pair's bits are its solo call's."""
    return mstep_from_sums(mstep_sums(moving, target, stats), const_scale, prev_scale)


class CPDState(NamedTuple):
    """The EM loop's carry, all on the device; with a leading pair axis in
    the pair-axis loop.  Inside the loop ``iterations`` is an i32 tensor;
    a result's ``em`` holds it as an int (a tensor i32[B] on the pair
    axis)."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    scale: torch.Tensor  # f32[]
    sigma2: torch.Tensor  # f32[]
    log_likelihood: torch.Tensor  # f32[]
    ntol: torch.Tensor  # f32[]
    iterations: Any


class CPDResume(NamedTuple):
    """Warm start at an EM iteration boundary: the loop state as the loop
    would hold it had it continued (``sigma^2_0``, ``t0`` and ``c`` are
    functions of the unchanged inputs and are recomputed), plus the
    iterations already done (numbering of the verbose trace and the
    history ring)."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    scale: torch.Tensor  # f32[]
    sigma2: torch.Tensor  # f32[]
    log_likelihood: torch.Tensor  # f32[]
    ntol: torch.Tensor  # f32[]
    done_before: int = 0


def _centroid_shift(moving, mask_b, target, mask_a, m, n) -> torch.Tensor:
    """The centroid-difference translation of ``centroid_init``."""
    return (torch.sum(target * mask_a[:, None], dim=0) / n
            - torch.sum(moving * mask_b[:, None], dim=0) / m)


class FGTSetup(NamedTuple):
    """What the FGT E-steps of a registration reuse (``_EM``): both
    clouds' clusterings and their segment orders."""

    centers_y: torch.Tensor  # f32[K, 3], centres of the untransformed moving cloud
    indx_y: torch.Tensor  # i32[M]
    order_y: torch.Tensor  # i64[M]
    lengths_y: torch.Tensor  # i64[K]
    centers_x: torch.Tensor  # f32[K, 3]
    indx_x: torch.Tensor  # i32[N]
    order_x: torch.Tensor  # i64[N]
    lengths_x: torch.Tensor  # i64[K]


class EMInputs(NamedTuple):
    """The tensors an EM iteration reads: a CUDA graph's static inputs.
    With a leading pair axis on every field in the pair-axis loop."""

    moving: torch.Tensor  # f32[M, 3], Morton-sorted with the kernels
    target: torch.Tensor  # f32[N, 3]
    mask_b: torch.Tensor  # f32[M]
    mask_a: torch.Tensor  # f32[N]
    m: torch.Tensor  # f32[], valid moving rows
    n: torch.Tensor  # f32[]
    weight: torch.Tensor  # f32[], clamped
    eps: torch.Tensor  # f32[]
    tolerance: torch.Tensor  # f32[]
    sigma2_0: torch.Tensor  # f32[]
    c_init: torch.Tensor  # f32[]
    switch: torch.Tensor  # f32[], the Hybrid switch 0.015 sigma^2_0
    cap: torch.Tensor  # i32[], max_iterations
    offset: torch.Tensor  # i32[], iterations done before (the history ring's slots)
    # the sharded loop's: parallel/cpd.py::FGTClusters
    fgt: Optional[FGTSetup] = None


class EMConfig(NamedTuple):
    """What an EM iteration does, beside its tensors: part of a CUDA
    graph's key."""

    approximation_type: ApproximationType
    use_fgt: bool
    use_kernels: bool
    fgt_k: int
    order_of_truncation: int
    ratio_of_far_field: float
    const_scale: bool
    # the pair-axis loop: truncated E-steps pair by pair through K5 (the
    # solo route) rather than in one call of K4's batch form
    pair_cand: bool = False
    # the sharded loop (parallel/cpd.py::ShardedEM): its E-step on this
    # rank's block with the moments reduced over the ranks, its replicated
    # M-step and whether its collectives may be captured; hashed by its
    # process group
    shard: Optional[Any] = None

    @property
    def split(self) -> bool:
        """One phase's E-step a chunk: Hybrid with the FGT, or with its
        slow phase pair by pair beside the fast phase's batch form."""
        return (self.approximation_type == ApproximationType.Hybrid
                and (self.use_fgt or self.pair_cand))


class _EMCarry(NamedTuple):
    """What a chunk carries: the loop state and, with ``record_history``,
    the ring f32[H, 4]."""

    s: CPDState
    history: Optional[torch.Tensor] = None


class _EM:
    """One registration's EM set-up (module docstring): the clouds
    (Morton-sorted with the kernels unless ``assume_sorted``), sigma^2_0,
    the constants and the FGT clusterings, as ``EMInputs``, and its
    ``EMConfig``.  ``cpd_register`` runs one; the pair-axis loop
    (``algorithms/batch.py``) stacks one per pair, so each pair takes its
    solo run's steps."""

    def __init__(self, before: Cloud, after: Cloud, eps, weight, tolerance,
                 approximation_type: ApproximationType, ratio_of_far_field: float,
                 order_of_truncation: int, use_fgt: Optional[bool], fgt_k: int,
                 use_kernels: Optional[bool], centroid_init: bool, assume_sorted: bool,
                 const_scale: bool = False):
        if before.points.device != after.points.device:
            raise ValueError(
                f"before lies on {before.points.device}, after on "
                f"{after.points.device}: register them on one device")
        self.device = device = before.points.device
        use_fgt = resolve_use_fgt(use_fgt, approximation_type, before.padded_size,
                                  after.padded_size)
        use_kernels = resolve_use_kernels(use_kernels, device)
        moving, target = before.points, after.points
        mask_b, mask_a = before.mask(), after.mask()
        if use_kernels and not assume_sorted:
            # Morton-sorted rows give K5 spatially compact blocks to skip
            perm_b = morton_permutation(moving, mask_b).long()
            moving, mask_b = moving[perm_b], mask_b[perm_b]
            perm_a = morton_permutation(target, mask_a).long()
            target, mask_a = target[perm_a], mask_a[perm_a]
        moving, target = moving.contiguous(), target.contiguous()
        self.rows = min(len(moving), len(target))  # padded rows of the smaller cloud
        m, n = torch.sum(mask_b), torch.sum(mask_a)

        weight = torch.clamp(self.f32(weight), 1e-6, 1.0 - 1e-6)
        if centroid_init:
            self.t0 = _centroid_shift(moving, mask_b, target, mask_a, m, n)
            sigma2_0 = sigma_squared_init(moving + self.t0, mask_b, target, mask_a)
        else:
            self.t0 = torch.zeros(3, dtype=torch.float32, device=device)
            sigma2_0 = sigma_squared_init(moving, mask_b, target, mask_a)

        # the FGT clusterings, made once with the order their segment sums
        # take: the target's never changes, and the moving cloud's
        # assignments are invariant under the similarity transforms EM
        # applies, while its centres (segment means) move with it
        fgt_kk = min(fgt_k, before.padded_size, after.padded_size)
        fgt = None
        if use_fgt and approximation_type != ApproximationType.NONE:
            with span("tpuslam.entry.fgt"):
                cy, iy, oy = k_center_ordered(moving, mask_b, fgt_kk)
                cx, ix, ox = k_center_ordered(target, mask_a, fgt_kk)
                fgt = FGTSetup(cy, iy, oy.order, oy.lengths, cx, ix, ox.order, ox.lengths)
                # the static tables on the device before any capture
                fgt_tables(order_of_truncation, device)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        self.inputs = EMInputs(
            moving=moving, target=target, mask_b=mask_b, mask_a=mask_a, m=m, n=n,
            weight=weight, eps=self.f32(eps), tolerance=self.f32(tolerance), sigma2_0=sigma2_0,
            c_init=uniform_constant(sigma2_0, weight, m, n), switch=HYBRID_SWITCH * sigma2_0,
            cap=zero, offset=zero, fgt=fgt)
        self.config = EMConfig(approximation_type, use_fgt, use_kernels, fgt_kk,
                               order_of_truncation, ratio_of_far_field, const_scale)

    def f32(self, x) -> torch.Tensor:
        return device_scalar(x, torch.float32, self.device)

    def initial(self, resume: Optional[CPDResume]) -> CPDState:
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if resume is None:
            return CPDState(
                rotation=torch.eye(3, dtype=torch.float32, device=self.device),
                translation=self.t0,
                scale=self.f32(1.0),
                sigma2=self.inputs.sigma2_0,
                log_likelihood=self.f32(0.0),
                ntol=self.inputs.tolerance + 10.0,
                iterations=zero,
            )
        return CPDState(
            rotation=self.f32(resume.rotation),
            translation=self.f32(resume.translation),
            scale=self.f32(resume.scale),
            sigma2=self.f32(resume.sigma2),
            log_likelihood=self.f32(resume.log_likelihood),
            ntol=self.f32(resume.ntol),
            iterations=zero,
        )


def _pair_of(tree, p: int):
    """Pair ``p``'s slice of every tensor of a tree with a leading pair axis."""
    return rebuild(tree, (t[p] for t in leaves(tree)))


def _stack_trees(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    stacked = [torch.stack(ls) for ls in zip(*(leaves(t) for t in trees))]
    return rebuild(trees[0], iter(stacked))


def _going(t: EMInputs, s: CPDState) -> torch.Tensor:
    """The reference's loop condition (``coherentpointdrift.cpp:104``): a
    finite log-likelihood, ntol above the tolerance, sigma^2 above eps
    (a non-finite sigma^2 or ntol fails its comparison), and iterations
    left under the cap."""
    return (torch.isfinite(s.log_likelihood) & (s.ntol > t.tolerance) & (s.sigma2 > t.eps)
            & (s.iterations < t.cap))


def _plan(cfg: EMConfig, t: EMInputs, s: CPDState, fast: torch.Tensor, phase: Optional[str]):
    """The iteration's E-step: ``(fgt, sigma_e, constant, trunc, code)``
    (``constant`` None for the FGT, which makes its own; ``trunc`` False,
    or a device flag; ``code`` the PHASES code, an int or a device
    tensor)."""
    if cfg.approximation_type == ApproximationType.NONE:
        return False, s.sigma2, t.c_init, False, 1
    if cfg.approximation_type == ApproximationType.Full:
        # sigma^2 floor (coherentpointdrift.cpp:152-155) and the FGT-mode
        # constant from the current sigma^2 (cpdutils.cpp:44)
        sigma_e = torch.clamp_min(s.sigma2, 0.05)
        if cfg.use_fgt:
            return True, sigma_e, None, False, 0
        return False, sigma_e, uniform_constant(sigma_e, t.weight, t.m, t.n), False, 1
    # Hybrid (coherentpointdrift.cpp:157-164)
    if cfg.split:
        if phase == "slow":
            return False, s.sigma2, t.c_init, torch.ones_like(fast), 2
        if cfg.use_fgt:
            return True, s.sigma2, None, False, 0
        return False, s.sigma2, uniform_constant(s.sigma2, t.weight, t.m, t.n), False, 1
    constant = torch.where(fast, uniform_constant(s.sigma2, t.weight, t.m, t.n), t.c_init)
    return False, s.sigma2, constant, torch.logical_not(fast), torch.where(fast, 1, 2)


def _fgt_estep(cfg: EMConfig, t: EMInputs, s: CPDState, transformed, sigma_e) -> Sufficient:
    f = t.fgt
    centers_y = transform_points(f.centers_y, s.rotation, s.translation, s.scale)
    return cpd_estep_fgt(
        transformed, t.mask_b, t.target, t.mask_a, sigma_e, t.weight, t.m, t.n, cfg.fgt_k,
        cfg.order_of_truncation, cfg.ratio_of_far_field, sigma2_init=t.sigma2_0,
        clusters=(centers_y, f.indx_y, f.centers_x, f.indx_x),
        orders=(SegmentOrder(f.order_y, f.lengths_y), SegmentOrder(f.order_x, f.lengths_x)),
    )


def _pair_by_pair(cfg: EMConfig, phase: Optional[str]) -> bool:
    """Whether the pair-axis E-step of a chunk of ``phase`` runs pair by
    pair: the FGT's, the oracle's, and the truncated one of clouds of
    ``CAND_MIN_ROWS`` rows (``cfg.pair_cand``); the rest is one call of
    K4's batch form."""
    if not cfg.use_kernels:
        return True
    approx = cfg.approximation_type
    fgt = cfg.use_fgt and (approx == ApproximationType.Full
                           or (approx == ApproximationType.Hybrid and phase == "fast"))
    return fgt or (cfg.pair_cand and phase == "slow")


def _estep(cfg: EMConfig, t: EMInputs, s: CPDState, fast, phase, eligible,
           active) -> tuple:
    """The iteration's E-step, solo or over the pair axis, and its phase
    code(s).  Pair by pair, only the ``eligible`` pairs run theirs (None:
    every pair); the others are frozen for the whole chunk and get zero
    statistics, which the freeze discards.  A pair's K5 route is marked
    with whether the pair ran (``active``; solo, ``_em_step`` marks it
    with the phase code)."""
    fgt, sigma_e, constant, trunc, code = _plan(cfg, t, s, fast, phase)
    batched = t.moving.dim() == 3
    scale = s.scale[..., None, None]
    transformed = transform_points(t.moving, s.rotation, s.translation, scale)
    if not batched:
        if cfg.shard is not None:
            stats = cfg.shard.estep(cfg, t, s, transformed, fgt, sigma_e, constant, trunc)
        elif fgt:
            stats = _fgt_estep(cfg, t, s, transformed, sigma_e)
        else:
            stats = cpd_estep_auto(transformed, t.mask_b, t.target, t.mask_a, sigma_e,
                                   constant, trunc, use_kernels=cfg.use_kernels)
        return stats, code
    b = t.moving.shape[0]
    flags = (torch.zeros(b, dtype=torch.bool, device=t.moving.device) if trunc is False
             else trunc)
    if not _pair_by_pair(cfg, phase):
        # one call of K4's batch form: a pair gets the bits of its B = 1 call
        stats = cpd_estep_dense_batch(transformed, t.mask_b, t.target, t.mask_a, sigma_e,
                                      constant, flags)
        return stats, code
    runs = range(b) if eligible is None else eligible
    per = []
    for p in range(b):
        tp, sp = _pair_of(t, p), _pair_of(s, p)
        if p not in runs:
            per.append(Sufficient(
                p1=torch.zeros_like(tp.mask_b), pt1=torch.zeros_like(tp.mask_a),
                px=torch.zeros_like(tp.moving), error=torch.zeros_like(sp.sigma2)))
            continue
        if fgt:
            per.append(_fgt_estep(cfg, tp, sp, transformed[p], sigma_e[p]))
        else:
            per.append(cpd_estep_auto(transformed[p], tp.mask_b, tp.target, tp.mask_a,
                                      sigma_e[p], constant[p],
                                      trunc if trunc is False else flags[p],
                                      use_kernels=cfg.use_kernels))
        choices.ran(active[p])
    return Sufficient(*(torch.stack(f) for f in zip(*per))), code


def _em_step(cfg: EMConfig, t: EMInputs, c: _EMCarry, phase: Optional[str],
             eligible) -> _EMCarry:
    """One EM iteration on the device, frozen where the loop has stopped or
    (Hybrid with the FGT) where the phase is not the chunk's: the new
    carry; its phase code(s) go to the open recording of
    ``core/choices.py``, marked with whether the iteration ran."""
    s = c.s
    go = _going(t, s)
    fast = s.sigma2 > t.switch
    active = go
    if cfg.split:
        active = go & (fast if phase == "fast" else torch.logical_not(fast))
    stats, code = _estep(cfg, t, s, fast, phase, eligible, active)
    ntol = torch.abs((stats.error - s.log_likelihood) / stats.error)
    if cfg.shard is not None:
        mres = cfg.shard.mstep(t, stats, cfg.const_scale, s.scale)
    else:
        mres = mstep_from_sums(mstep_sums(t.moving, t.target, stats), cfg.const_scale, s.scale)
    new = CPDState(rotation=mres.rotation, translation=mres.translation, scale=mres.scale,
                   sigma2=mres.sigma2, log_likelihood=stats.error, ntol=ntol,
                   iterations=s.iterations + 1)
    history = c.history
    if history is not None:
        slot = ((s.iterations + t.offset) % history.shape[0]).to(torch.int64).reshape(1)
        row = torch.stack([new.sigma2, new.ntol, new.log_likelihood, new.scale])[None]
        history = history.index_copy(0, slot, row)
    code = torch.full_like(s.iterations, code) if isinstance(code, int) else code
    choices.book(PHASE_TRACE, PHASES, code)
    choices.ran(active)
    return keep(active, _EMCarry(new, history), c)


def _pair_states(t: EMInputs, s: CPDState) -> torch.Tensor:
    """Each problem's state, i32 (one a pair): 0 stopped, 1 running in the
    fast phase, 2 running in the slow one."""
    return torch.where(_going(t, s), torch.where(s.sigma2 > t.switch, 1, 2), 0).to(
        torch.int32).reshape(-1)


def _em_chunk(cfg: EMConfig, k: int, phase: Optional[str], eligible, t: EMInputs,
              c: _EMCarry) -> tuple:
    """``k`` EM iterations on the device with no host read.  Returns the
    carry, the loop's own status (the iteration count or counts; each
    problem's state, ``_pair_states``) and sigma^2; each iteration's
    phase codes and each K5 call's route go to the open recording of
    ``core/choices.py``."""
    for _ in range(k):
        c = _em_step(cfg, t, c, phase, eligible)
    return c, [c.s.iterations.to(torch.int32).reshape(-1), _pair_states(t, c.s)], c.s.sigma2


def _phase_span(cfg: EMConfig):
    """A chunk's phase span from its key (``core/spans.py``), where the
    loop runs the FGT: ``tpuslam.loop.fgt`` for the FGT's E-steps (Full,
    Hybrid's fast phase), ``tpuslam.loop.trunc`` for Hybrid's slow phase.
    Every other loop's chunks get none: their E-step is one, or its phase
    a device flag."""
    if not cfg.use_fgt or cfg.approximation_type == ApproximationType.NONE:
        return lambda key: None
    return lambda key: "tpuslam.loop." + PHASES[2 if key[-2] == "slow" else 0]


def _em_loop(cfg: EMConfig, t: EMInputs, c: _EMCarry, max_iterations: int, verbose: bool,
             iter_offset: int) -> tuple:
    """The whole EM loop after its set-up (module docstring): the final
    carry and the iteration count(s).  ``t``'s ``cap`` and ``offset`` are
    filled in here.  A chunk's key holds its phase and, where its
    pair-axis E-step runs pair by pair, the pairs that run theirs: those
    that were running in the chunk's phase when it began (any other pair
    stays frozen through the chunk).  The sharded loop (``cfg.shard``) is
    captured only where its collectives may be (NCCL); under gloo a chunk
    on CUDA is one eager iteration (``device_loop.chunk_policy``).  A
    frozen iteration still runs its E-step and its collectives: every
    rank freezes on the same replicated values, so the ranks'
    collectives stay matched."""
    device = t.moving.device
    batched = t.moving.dim() == 3
    nb = t.moving.shape[0] if batched else 1
    use_graph, k = chunk_policy(device, verbose, cfg.shard is None or cfg.shard.capturable)
    # filled on the device: no blocking host-to-device copy
    t = t._replace(
        cap=torch.full(t.cap.shape, max(int(max_iterations), -1), dtype=torch.int32,
                       device=device),
        offset=torch.full(t.offset.shape, int(iter_offset), dtype=torch.int32, device=device))
    counts = [0] * nb
    if max_iterations <= 0:
        return c, counts
    # the set-up's one read: each problem's state, whether the loop runs
    # and its first phase
    states = _pair_states(t, c.s).tolist()
    base = ("cpd", cfg, k, c.history is not None, str(device),
            tuple(signature(x) for x in leaves(t)), signature(c))

    def key_of():
        phase = ("fast" if 1 in states else "slow") if cfg.split else None
        eligible = None
        if batched and _pair_by_pair(cfg, phase):
            want = {"fast": (1,), "slow": (2,), None: (1, 2)}[phase]
            eligible = tuple(p for p, st in enumerate(states) if st in want)
        return base + (phase, eligible)

    def chunk_of(key):
        return lambda inp, carry: _em_chunk(cfg, k, key[-2], key[-1], inp, carry)

    def read(own, sigma2):
        before = counts[0]
        counts[:], states[:] = own[:nb], own[nb:]
        if verbose and counts[0] > before:
            # the reference's per-iteration printf
            # (coherentpointdrift.cpp:121: "loop_nr %d, error: %f")
            print(f"loop_nr {counts[0] + iter_offset}, error: {float(sigma2)}")
        return not any(states)

    if any(states):
        c = run_chunks(key_of, chunk_of, t, c, read, use_graph, _phase_span(cfg))
    return c, counts


def cpd_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    weight: float = 0.3,
    const_scale: bool = False,
    max_iterations: int = -1,
    tolerance: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    ratio_of_far_field: float = 10.0,
    order_of_truncation: int = 8,
    use_fgt: Optional[bool] = None,
    # at least 50 + 1/0.015, so the adaptive live count (cpdutils.cpp:35)
    # is never clipped during the Hybrid fast phase
    fgt_k: int = 128,
    verbose: bool = False,
    record_history: bool = False,
    history_length: int = 256,
    use_kernels: Optional[bool] = None,
    centroid_init: bool = False,
    resume: Optional[CPDResume] = None,
    assume_sorted: bool = False,
) -> RegistrationResult:
    """Register ``before`` (the moving GMM centroids) onto ``after``; both
    clouds on one device, where the loop runs.

    ``use_fgt`` picks the Full/Hybrid fast-phase E-step
    (``resolve_use_fgt``); ``use_kernels`` the exact E-step
    (``resolve_use_kernels``).  With the kernels both clouds are
    Morton-sorted once, unless ``assume_sorted`` says they already are
    (invalid rows last): EM consumes only sufficient statistics, so the
    result does not depend on the row order beyond float32 summation
    order.  ``centroid_init=True`` starts from the centroid-difference
    translation (and takes sigma^2_0 from the shifted clouds).
    ``record_history`` keeps a ring of the last ``history_length``
    iterations' (sigma^2, ntol, log-likelihood, scale), iteration i in
    slot i % history_length.  ``resume`` continues from a ``CPDResume``.
    The result's ``error`` is sigma^2, its ``em`` the final loop state.
    The loop runs ``device_loop.LOOP_CHUNK`` iterations between host
    reads, which changes no bit of the result (module docstring; ``graph_scope``
    keeps its CUDA graphs for later registrations of the same key).  The
    set-up before the loop is the ``tpuslam.entry.prepare`` span
    (``core/spans.py``)."""
    with span("tpuslam.entry.prepare"):
        em = _EM(before, after, eps, weight, tolerance, approximation_type,
                 ratio_of_far_field, order_of_truncation, use_fgt, fgt_k, use_kernels,
                 centroid_init, assume_sorted, const_scale)
        iter_offset = 0 if resume is None else int(resume.done_before)
        history = None
        if record_history:
            history = torch.full((history_length, 4), float("nan"),
                                 dtype=torch.float32, device=em.device)
        carry = _EMCarry(em.initial(resume), history)
    c, counts = _em_loop(em.config, em.inputs, carry, int(max_iterations), verbose,
                         iter_offset)
    s = c.s._replace(iterations=counts[0])
    return RegistrationResult(
        transform=RigidTransform(
            rotation=s.rotation, translation=s.translation, scale=s.scale),
        iterations=s.iterations,
        error=s.sigma2,  # the reference reports sigma^2 as "error"
        history=c.history,
        em=s,
    )

def hybrid_fast_threshold(
    before: Cloud, after: Cloud, centroid_init: bool = False
) -> torch.Tensor:
    """``0.015 * sigma^2_0``, the Hybrid fast->slow switch
    (``coherentpointdrift.cpp:158``), computed as ``cpd_register``'s
    initialisation does on the unsorted clouds."""
    mask_b, mask_a = before.mask(), after.mask()
    moving, target = before.points, after.points
    if centroid_init:
        moving = moving + _centroid_shift(moving, mask_b, target, mask_a,
                                          torch.sum(mask_b), torch.sum(mask_a))
    return HYBRID_SWITCH * sigma_squared_init(moving, mask_b, target, mask_a)


def _morton_sort_cloud(cloud: Cloud) -> Cloud:
    """The cloud's rows in Morton order, invalid rows last, so the sorted
    Cloud's ``mask()`` still holds: the chunked driver sorts once where
    ``cpd_register`` would sort in every chunk."""
    perm = morton_permutation(cloud.points, cloud.mask()).long()
    return Cloud(points=cloud.points[perm].contiguous(), count=cloud.count)


def cpd_register_chunked(
    before: Cloud,
    after: Cloud,
    max_iterations: int = -1,
    chunk: int = 5,
    chunk_fast: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    **kwargs,
) -> RegistrationResult:
    """``cpd_register`` run ``chunk`` EM iterations at a time (port of the
    JAX package's ``cpd_register_chunked``), the whole loop state carried
    across chunks (``CPDResume``): the same trajectory as one whole run,
    bit for bit.  With the kernels, both clouds are Morton-sorted once
    here and every chunk runs with ``assume_sorted``.

    ``chunk_fast`` sizes the chunks of Hybrid's FGT fast phase: the phase
    is read at each boundary from the carried sigma^2 against
    ``hybrid_fast_threshold``; a chunk that crosses the switch finishes in
    the slow phase, and the next one is sized by it.  It changes no
    result.  ``max_iterations < 0`` runs zero iterations, as
    ``cpd_register`` does (``coherentpointdrift.cpp:104``).
    ``record_history`` raises: each chunk would restart the ring.

    ``checkpoint_path`` saves every boundary, the last one included
    (``harness/checkpoint.py``).  A file whose metadata (shapes, cloud
    fingerprints, every EM parameter that determines the trajectory) does
    not match is ignored with a notice and overwritten; a matching one
    whose progress meets ``max_iterations`` is returned as it is."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if kwargs.get("record_history"):
        raise ValueError("record_history is unsupported with chunked dispatch")
    if max_iterations < 0:
        return cpd_register(before, after, max_iterations=max_iterations, **kwargs)
    device = before.points.device
    approx = kwargs.get("approximation_type", ApproximationType.NONE)
    total = 0
    resume = None
    ckpt_meta = None
    if checkpoint_path is not None:
        from tpuslam_torch.harness.checkpoint import cloud_fingerprint, load_resume_or_none

        ckpt_meta = {
            "n_pad": int(before.points.shape[0]),
            "m_pad": int(after.points.shape[0]),
            "n": int(before.count),
            "m": int(after.count),
            "eps": float(kwargs.get("eps", 1e-3)),
            "tolerance": float(kwargs.get("tolerance", 1e-3)),
            "weight": float(kwargs.get("weight", 0.3)),
            "const_scale": bool(kwargs.get("const_scale", False)),
            "approximation_type": str(getattr(approx, "value", approx)),
            "use_fgt": resolve_use_fgt(kwargs.get("use_fgt"), approx, before.padded_size,
                                       after.padded_size),
            "fgt_k": int(kwargs.get("fgt_k", 128)),
            "order_of_truncation": int(kwargs.get("order_of_truncation", 8)),
            "ratio_of_far_field": float(kwargs.get("ratio_of_far_field", 10.0)),
            "centroid_init": bool(kwargs.get("centroid_init", False)),
            "fp_before": cloud_fingerprint(before.points, before.mask()),
            "fp_after": cloud_fingerprint(after.points, after.mask()),
        }
        resume = load_resume_or_none(checkpoint_path, "cpd", ckpt_meta, device=device)
        if resume is not None:
            total = int(resume.done_before)
            if total >= max_iterations:
                if total > max_iterations:
                    print(f"[tpuslam] checkpoint already holds {total} EM iterations "
                          f"(requested {max_iterations}); returning its state")
                return RegistrationResult(
                    transform=RigidTransform(resume.rotation, resume.translation,
                                             resume.scale),
                    iterations=total,
                    error=resume.sigma2,
                )
    # sort once for every chunk: the fingerprints above are of the caller's
    # rows, and the EM state carries nothing per row
    if not kwargs.get("assume_sorted") and resolve_use_kernels(kwargs.get("use_kernels"),
                                                               device):
        before, after = _morton_sort_cloud(before), _morton_sort_cloud(after)
        kwargs = dict(kwargs, assume_sorted=True)
    phase_aware = (
        chunk_fast is not None
        and chunk_fast != chunk
        and approx == ApproximationType.Hybrid
        and resolve_use_fgt(kwargs.get("use_fgt"), approx, before.padded_size,
                            after.padded_size)
    )
    if phase_aware:
        thr = float(hybrid_fast_threshold(
            before, after, centroid_init=bool(kwargs.get("centroid_init", False))))
    # the chunks share their shapes: one CUDA graph a phase serves them
    with graph_scope():
        while True:
            in_fast = phase_aware and (resume is None or float(resume.sigma2) > thr)
            k = min(chunk_fast if in_fast else chunk, max_iterations - total)
            result = cpd_register(before, after, max_iterations=k, resume=resume, **kwargs)
            did = int(result.iterations)
            total += did
            s = result.em
            resume = CPDResume(
                rotation=s.rotation,
                translation=s.translation,
                scale=s.scale,
                sigma2=s.sigma2,
                log_likelihood=s.log_likelihood,
                ntol=s.ntol,
                done_before=total,
            )
            if checkpoint_path is not None:
                from tpuslam_torch.harness.checkpoint import save_cpd_checkpoint

                save_cpd_checkpoint(checkpoint_path, resume, ckpt_meta)
            # the loop stops early (converged, sigma^2 floor, non-finite)
            # only by running fewer than the k iterations it was allowed
            if did < k or total >= max_iterations:
                break
    return RegistrationResult(
        transform=result.transform,
        iterations=total,
        error=result.error,
    )
