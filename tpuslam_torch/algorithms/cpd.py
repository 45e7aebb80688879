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

The EM loop is one eager Python loop.  It reads the stop condition and
the Hybrid phase (``sigma^2 > 0.015 sigma^2_0``) back to the host once
per iteration, and picks the iteration's E-step from them, as the
reference does (``PHASE_TRACE`` records it).  The JAX package instead
runs a flat sequence of specialised ``while_loop``s (fast, slow, fast,
slow, then a loop with a ``lax.cond`` body), and its slow loops call
K5's checked form, leaving the loop on overflow so the cond-bodied loop
redoes the iteration.  All of that exists to keep ``lax.cond`` out of
loops on the TPU.  The eager slow phase calls K5's unchecked form, which
routes to K4 on overflow.  That is the JAX trajectory: the checked form
without overflow returns the unchecked form's statistics bit for bit
(``tests/test_pallas_cpd.py::test_cand_checked_matches_plain``), and an
overflowing iteration is redone by the JAX package exactly as the
unchecked form computes it.
"""

from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple, Optional

import torch

from tpuslam_torch.algorithms.icp import RegistrationResult
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.types import Cloud, RigidTransform, Sufficient, pick_block
from tpuslam_torch.kernels.cpd_cand import cpd_estep_cand
from tpuslam_torch.ops.fgt import (
    FGTModel,
    compute_fgt_model_multi,
    fgt_predict,
    fgt_predict_multi,
    k_center_ordered,
)
from tpuslam_torch.ops.geometry import transform_points
from tpuslam_torch.ops.procrustes import svd_rotation_det
from tpuslam_torch.ops.spatial import morton_permutation

__all__ = [
    "CPD_FGT_CROSSOVER", "CPDResume", "CPDState", "MStepResult", "Sufficient",
    "cpd_estep", "cpd_estep_auto", "cpd_estep_fgt", "cpd_mstep",
    "cpd_register", "cpd_register_chunked", "hybrid_fast_threshold", "mstep_from_moments",
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
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev)
    constant = torch.as_tensor(constant, dtype=torch.float32, device=dev)
    trunc_active = torch.as_tensor(trunc_active, device=dev).to(torch.bool)
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
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=transformed.device)
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
    (``torch.linalg.svd``/``det``, cuSOLVER on CUDA, as
    ``ops/procrustes.py``), scale ``tr(S D) / denominator`` and the
    sigma^2 update."""
    inv_np = 1.0 / np_
    r, sv, det_uv = svd_rotation_det(a_mat)
    # tr(S diag(1, 1, det(U V^T)))  (coherentpointdrift.cpp:258-260)
    scale_num = sv[0] + sv[1] + det_uv * sv[2]
    if const_scale:
        scale = prev_scale
        sigma2 = inv_np * torch.abs(sigma_sub + scale_den - 2.0 * scale_num) / 3.0
    else:
        scale = scale_num / scale_den
        sigma2 = inv_np * torch.abs(sigma_sub - scale * scale_num) / 3.0
    t = mu_a - scale * torch.matmul(r, mu_b)
    return MStepResult(rotation=r, translation=t, scale=scale, sigma2=sigma2)


def cpd_mstep(
    moving: torch.Tensor,
    target: torch.Tensor,
    stats: Sufficient,
    const_scale: bool,
    prev_scale: torch.Tensor,
) -> MStepResult:
    """Closed-form rigid M-step (``MStep``, ``coherentpointdrift.cpp:
    223-278``).  Padded rows have ``p1 = 0`` and ``pt1 = 0`` by the
    E-step's construction, so every sum here is mask-clean."""
    np_ = torch.sum(stats.p1)
    inv_np = 1.0 / np_
    mu_b = inv_np * torch.matmul(stats.p1, moving)
    mu_a = inv_np * torch.matmul(stats.pt1, target)
    # A = px^T B - Np mu_a mu_b^T   (coherentpointdrift.cpp:240)
    a_mat = torch.matmul(stats.px.T, moving) - np_ * torch.outer(mu_a, mu_b)
    sigma_sub = (torch.sum(stats.pt1 * torch.sum(target * target, -1))
                 - np_ * torch.dot(mu_a, mu_a))
    scale_den = (torch.sum(stats.p1 * torch.sum(moving * moving, -1))
                 - np_ * torch.dot(mu_b, mu_b))
    return mstep_from_moments(np_, mu_b, mu_a, a_mat, sigma_sub, scale_den,
                              const_scale, prev_scale)


class CPDState(NamedTuple):
    """The EM loop's carry; every field but ``iterations`` stays on the
    device."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    scale: torch.Tensor  # f32[]
    sigma2: torch.Tensor  # f32[]
    log_likelihood: torch.Tensor  # f32[]
    ntol: torch.Tensor  # f32[]
    iterations: int


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


class _EM:
    """One registration's EM set-up and steps (module docstring): the
    clouds (Morton-sorted with the kernels unless ``assume_sorted``),
    sigma^2_0, the constants, the FGT clusterings, and the loop's phase
    choice, E-step and M-step.  ``cpd_register`` runs one; the batched
    loop (``algorithms/batch.py``) one per pair, so each pair takes its
    solo run's steps."""

    def __init__(self, before: Cloud, after: Cloud, eps, weight, tolerance,
                 approximation_type: ApproximationType, ratio_of_far_field: float,
                 order_of_truncation: int, use_fgt: Optional[bool], fgt_k: int,
                 use_kernels: Optional[bool], centroid_init: bool, assume_sorted: bool):
        if before.points.device != after.points.device:
            raise ValueError(
                f"before lies on {before.points.device}, after on "
                f"{after.points.device}: register them on one device")
        self.device = device = before.points.device
        self.approximation_type = approximation_type
        self.ratio_of_far_field = ratio_of_far_field
        self.order_of_truncation = order_of_truncation
        self.use_fgt = resolve_use_fgt(use_fgt, approximation_type, before.padded_size,
                                       after.padded_size)
        self.use_kernels = resolve_use_kernels(use_kernels, device)
        moving, target = before.points, after.points
        mask_b, mask_a = before.mask(), after.mask()
        if self.use_kernels and not assume_sorted:
            # Morton-sorted rows give K5 spatially compact blocks to skip
            perm_b = morton_permutation(moving, mask_b).long()
            moving, mask_b = moving[perm_b], mask_b[perm_b]
            perm_a = morton_permutation(target, mask_a).long()
            target, mask_a = target[perm_a], mask_a[perm_a]
        self.moving, self.target = moving.contiguous(), target.contiguous()
        self.rows = min(len(moving), len(target))  # padded rows of the smaller cloud
        self.mask_b, self.mask_a = mask_b, mask_a
        self.m, self.n = m, n = torch.sum(mask_b), torch.sum(mask_a)

        self.weight = torch.clamp(self.f32(weight), 1e-6, 1.0 - 1e-6)
        self.eps = self.f32(eps)
        self.tolerance = self.f32(tolerance)
        if centroid_init:
            self.t0 = _centroid_shift(moving, mask_b, target, mask_a, m, n)
            self.sigma2_0 = sigma_squared_init(moving + self.t0, mask_b, target, mask_a)
        else:
            self.t0 = torch.zeros(3, dtype=torch.float32, device=device)
            self.sigma2_0 = sigma_squared_init(moving, mask_b, target, mask_a)
        self.c_init = uniform_constant(self.sigma2_0, self.weight, m, n)
        self.switch = HYBRID_SWITCH * self.sigma2_0

        # the FGT clusterings, made once with the order their segment sums
        # take: the target's never changes, and the moving cloud's
        # assignments are invariant under the similarity transforms EM
        # applies, while its centres (segment means) move with it
        self.fgt_kk = min(fgt_k, before.padded_size, after.padded_size)
        if self.use_fgt and approximation_type != ApproximationType.NONE:
            self.fgt_y = k_center_ordered(moving, mask_b, self.fgt_kk)
            self.fgt_x = k_center_ordered(target, mask_a, self.fgt_kk)

    def f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def initial(self, resume: Optional[CPDResume]) -> CPDState:
        if resume is None:
            return CPDState(
                rotation=torch.eye(3, dtype=torch.float32, device=self.device),
                translation=self.t0,
                scale=self.f32(1.0),
                sigma2=self.sigma2_0,
                log_likelihood=self.f32(0.0),
                ntol=self.tolerance + 10.0,
                iterations=0,
            )
        return CPDState(
            rotation=self.f32(resume.rotation),
            translation=self.f32(resume.translation),
            scale=self.f32(resume.scale),
            sigma2=self.f32(resume.sigma2),
            log_likelihood=self.f32(resume.log_likelihood),
            ntol=self.f32(resume.ntol),
            iterations=0,
        )

    def flags(self, s: CPDState) -> torch.Tensor:
        """bool[2] on the device: whether the loop goes on (a non-finite
        sigma^2 or ntol fails its comparison), and the Hybrid phase."""
        return torch.stack([
            torch.isfinite(s.log_likelihood) & (s.ntol > self.tolerance) & (s.sigma2 > self.eps),
            s.sigma2 > self.switch,
        ])

    def plan(self, s: CPDState, fast: bool):
        """The iteration's E-step: ``(fgt, sigma_e, constant, trunc)``
        (``constant`` None for the FGT, which makes its own)."""
        if self.approximation_type == ApproximationType.NONE:
            return False, s.sigma2, self.c_init, False
        if self.approximation_type == ApproximationType.Full:
            # sigma^2 floor (coherentpointdrift.cpp:152-155) and the
            # FGT-mode constant from the current sigma^2 (cpdutils.cpp:44)
            sigma_e = torch.clamp_min(s.sigma2, 0.05)
            if self.use_fgt:
                return True, sigma_e, None, False
            return False, sigma_e, uniform_constant(sigma_e, self.weight, self.m, self.n), False
        # Hybrid (coherentpointdrift.cpp:157-164)
        if not fast:
            return False, s.sigma2, self.c_init, True
        if self.use_fgt:
            return True, s.sigma2, None, False
        return False, s.sigma2, uniform_constant(s.sigma2, self.weight, self.m, self.n), False

    def transformed(self, s: CPDState) -> torch.Tensor:
        return transform_points(self.moving, s.rotation, s.translation, s.scale)

    def fgt_stats(self, transformed, sigma_e, s: CPDState) -> Sufficient:
        PHASE_TRACE.append("fgt")
        centers_y0, indx_y, order_y = self.fgt_y
        centers_x, indx_x, order_x = self.fgt_x
        centers_y = transform_points(centers_y0, s.rotation, s.translation, s.scale)
        return cpd_estep_fgt(
            transformed, self.mask_b, self.target, self.mask_a, sigma_e, self.weight, self.m,
            self.n, self.fgt_kk, self.order_of_truncation, self.ratio_of_far_field,
            sigma2_init=self.sigma2_0, clusters=(centers_y, indx_y, centers_x, indx_x),
            orders=(order_y, order_x),
        )

    def exact_stats(self, transformed, sigma_e, constant, trunc: bool) -> Sufficient:
        PHASE_TRACE.append("trunc" if trunc else "exact")
        return cpd_estep_auto(transformed, self.mask_b, self.target, self.mask_a, sigma_e,
                              constant, trunc, use_kernels=self.use_kernels)

    def estep(self, s: CPDState, fast: bool) -> Sufficient:
        fgt, sigma_e, constant, trunc = self.plan(s, fast)
        if fgt:
            return self.fgt_stats(self.transformed(s), sigma_e, s)
        return self.exact_stats(self.transformed(s), sigma_e, constant, trunc)

    def advance(self, s: CPDState, stats: Sufficient, const_scale: bool) -> CPDState:
        """The M-step after ``stats``: the next loop state."""
        ntol = torch.abs((stats.error - s.log_likelihood) / stats.error)
        mres = cpd_mstep(self.moving, self.target, stats, const_scale, s.scale)
        return CPDState(
            rotation=mres.rotation,
            translation=mres.translation,
            scale=mres.scale,
            sigma2=mres.sigma2,
            log_likelihood=stats.error,
            ntol=ntol,
            iterations=s.iterations + 1,
        )


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
    The result's ``error`` is sigma^2, its ``em`` the final loop state."""
    em = _EM(before, after, eps, weight, tolerance, approximation_type, ratio_of_far_field,
             order_of_truncation, use_fgt, fgt_k, use_kernels, centroid_init, assume_sorted)
    iter_offset = 0 if resume is None else int(resume.done_before)
    s = em.initial(resume)
    history = None
    if record_history:
        history = torch.full((history_length, 4), float("nan"),
                             dtype=torch.float32, device=em.device)

    while s.iterations < max_iterations:
        # the one read back of the iteration: the stop condition and the phase
        go, fast = em.flags(s).tolist()
        if not go:
            break
        stats = em.estep(s, fast)
        done = s.iterations + iter_offset
        s = em.advance(s, stats, const_scale)
        if record_history:
            history[done % history_length] = torch.stack(
                [s.sigma2, s.ntol, s.log_likelihood, s.scale])
        if verbose:
            # the reference's per-iteration printf
            # (coherentpointdrift.cpp:121: "loop_nr %d, error: %f")
            print(f"loop_nr {done + 1}, error: {float(s.sigma2)}")
    return RegistrationResult(
        transform=RigidTransform(
            rotation=s.rotation, translation=s.translation, scale=s.scale),
        iterations=s.iterations,
        error=s.sigma2,  # the reference reports sigma^2 as "error"
        history=history,
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
        # the loop stops early (converged, sigma^2 floor, non-finite) only
        # by running fewer than the k iterations it was allowed
        if did < k or total >= max_iterations:
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=total,
        error=result.error,
    )
