"""Non-iterative closest point: one-shot principal-axes registration (port
of ``tpuslam/algorithms/nicp.py``).

The reference's NICP (``noniterative.cpp``) jitters which sign of the
two clouds' left singular bases its SVDs return; the JAX package
enumerates that set instead: ``R = U_after diag(s) U_before^T`` for the
8 sign vectors ``s``, the 4 proper ones scored.  ``U`` are the
eigenvectors of the 3x3 masked scatter.

* ``None`` and non-widened ``Hybrid``: every candidate scored exactly,
  the correspondence MSE of a fixed random subcloud of ``before`` against
  its nearest neighbours in ``after``;
* ``Full``: the candidates ranked by the reference's crude index-order
  score, the winner scored exactly;
* widened (``degenerate_angles``, ``degenerate_axes``; see
  ``degenerate_axes_for``): on a (near-)degenerate spectrum the sign set
  is widened with in-plane rotations, every candidate scored exactly,
  two rounds of 17-sample rescored angle grids refine the winner, and a
  3-step nearest-neighbour Procrustes polish snaps it.

Every exact score is ONE nearest-neighbour call of all candidates'
transformed subclouds against the whole target: kernel K1 on CUDA
(``ops/nn.py::nearest_neighbors_batch``), its plain version on the CPU.

The subcloud's scores are JAX's draw bit for bit (``algorithms/prng.py``),
so the port scores the same rows.  Eigenvector signs may differ between
LAPACK and cuSOLVER, which only reorders the candidates.  On a degenerate
spectrum the basis inside the tied subspace is arbitrary, so widened runs
are held to the truth, not to the JAX package.

The work is written over a leading pair axis: ``nicp_register`` is the
batch of one of ``nicp_core``, which ``algorithms/batch.py`` calls with
B pairs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpuslam_torch.algorithms.prng import top_k_order, uniform
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.types import LANE, Cloud, RegistrationResult, RigidTransform, round_up
from tpuslam_torch.ops.geometry import transform_points
from tpuslam_torch.ops.nn import nearest_neighbors_batch

# importing procrustes pins full float32 matmuls (no TF32): the scatter
# is the JAX package's einsum at Precision.HIGHEST (nicp.py:144)
from tpuslam_torch.ops.procrustes import weighted_procrustes

BIG = 3.4e38
# the reference's fixed NN acceptance radius for exact rescoring
# (noniterative.cpp:73)
MAX_DISTANCE_FOR_COMPARISON = 1e6
# all 8 sign vectors, in the JAX package's order
_SIGNS = [[sx, sy, sz] for sx in (1.0, -1.0) for sy in (1.0, -1.0)
          for sz in (1.0, -1.0)]

# --- headed copy of the numpy pre-pass, tpuslam/algorithms/nicp.py:62-109 ---
DEGENERATE_GAP_THRESHOLD = 0.05


def spectrum_gaps(points: np.ndarray, sample: int = 16384):
    """Host-side pre-pass (numpy): relative eigengaps
    ``((l1-l2)/l1, (l2-l3)/l1)`` of the centered scatter of ``points``
    (subsampled for O(1) cost at any cloud size)."""
    pts = np.asarray(points, np.float64)
    if len(pts) > sample:
        pts = pts[:: len(pts) // sample + 1]
    if len(pts) < 4:
        return 1.0, 1.0  # too few points to call anything degenerate
    mu = pts.mean(axis=0)
    xc = pts - mu
    evals = np.linalg.eigvalsh(xc.T @ xc)[::-1]  # descending
    lam1 = max(float(evals[0]), 1e-30)
    return (
        float(evals[0] - evals[1]) / lam1,
        float(evals[1] - evals[2]) / lam1,
    )


def degenerate_axes_for(
    before_points: np.ndarray,
    after_points: np.ndarray,
    threshold: float = DEGENERATE_GAP_THRESHOLD,
):
    """Which principal-basis axes need in-plane candidate widening:
    axis 0 when the (l2, l3) pair ties (rotation within the e2/e3 plane
    is unresolved — cylinders), axis 2 when (l1, l2) ties.  Empty tuple
    = non-degenerate, no widening needed."""
    g12b, g23b = spectrum_gaps(before_points)
    g12a, g23a = spectrum_gaps(after_points)
    axes = []
    if min(g23b, g23a) < threshold:
        axes.append(0)
    if min(g12b, g12a) < threshold:
        axes.append(2)
    return tuple(axes)
# --- end of the headed copy ---


def _rot_about_axis(axis: int, thetas: torch.Tensor) -> torch.Tensor:
    """f32[K, 3, 3] rotations by ``thetas`` about basis axis ``axis``
    (the rotation acts within the other two coordinates' plane)."""
    k = thetas.shape[0]
    c, s = torch.cos(thetas), torch.sin(thetas)
    i, j = [a for a in range(3) if a != axis]
    out = torch.zeros((k, 3, 3), dtype=torch.float32, device=thetas.device)
    out[:, axis, axis] = 1.0
    out[:, i, i] = c
    out[:, j, j] = c
    out[:, i, j] = -s
    out[:, j, i] = s
    return out


def masked_centroid(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32[..., 3] centroid of the rows of ``points`` f32[..., N, 3] where
    ``mask`` f32[..., N] is 1."""
    total = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    return torch.sum(points * mask[..., None], dim=-2) / total[..., None]


def principal_axes(
    points: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left singular basis of the centered 3xN cloud matrix, descending:
    (U f32[..., 3, 3], columns = axes; eigenvalues f32[..., 3]).  The eigh
    of the 3x3 scatter in full float32, on the cloud's device."""
    mu = masked_centroid(points, mask)
    xc = (points - mu[..., None, :]) * mask[..., None]
    c = torch.matmul(xc.mT, xc)
    evals, evecs = torch.linalg.eigh(c)  # ascending
    return evecs.flip(-1), evals.flip(-1)


class _Candidates(NamedTuple):
    rotations: torch.Tensor  # f32[..., C, 3, 3]
    translations: torch.Tensor  # f32[..., C, 3]
    proper: torch.Tensor  # bool[..., C] — det(R) == +1


def _enumerate_candidates(
    u_before: torch.Tensor,
    u_after: torch.Tensor,
    mu_before: torch.Tensor,
    mu_after: torch.Tensor,
    degenerate_angles: int = 0,
    degenerate_axes: Tuple[int, ...] = (),
) -> _Candidates:
    """``R = U_a diag(s) A U_b^T`` for each sign vector ``s`` (outer) and
    in-basis rotation ``A`` (inner): ``A = I``, then, when widened,
    ``degenerate_angles - 1`` rotations about each axis of
    ``degenerate_axes``; ``t = mu_a - R mu_b``."""
    dev = u_before.device
    mats = [torch.eye(3, dtype=torch.float32, device=dev)[None]]
    if degenerate_angles > 1 and degenerate_axes:
        step = float(np.float32(2.0 * math.pi / degenerate_angles))
        thetas = torch.arange(1, degenerate_angles, dtype=torch.float32, device=dev) * step
        for ax in degenerate_axes:
            mats.append(_rot_about_axis(ax, thetas))
    a_stack = torch.cat(mats, dim=0)  # f32[W, 3, 3]
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=dev)  # [8, 3]
    w = a_stack.shape[0]
    ua_s = u_after[..., None, None, :, :] * signs[:, None, None, :]  # [..., 8, 1, 3, 3]
    rots = torch.matmul(torch.matmul(ua_s, a_stack), u_before.mT[..., None, None, :, :])
    rots = rots.reshape(rots.shape[:-4] + (8 * w, 3, 3))
    det_pair = torch.linalg.det(u_after) * torch.linalg.det(u_before)
    dets = (torch.prod(signs, dim=1)[:, None] * det_pair[..., None, None]).expand(
        det_pair.shape + (8, w)).reshape(det_pair.shape + (8 * w,))
    trans = mu_after[..., None, :] - torch.matmul(rots, mu_before[..., None, :, None])[..., 0]
    return _Candidates(rotations=rots, translations=trans, proper=dets > 0)


def _approximated_errors(
    cands: _Candidates,
    centered_before: torch.Tensor,
    centered_after: torch.Tensor,
    pair_mask: torch.Tensor,
) -> torch.Tensor:
    """The reference's crude per-candidate score (``noniterative.cpp:53``):
    MSE of rotated centered-before vs centered-after in index order, over
    the first min(N, M) rows -> f32[..., C].  Only meaningful relative to
    other candidates."""
    n_pairs = torch.clamp_min(torch.sum(pair_mask, dim=-1), 1.0)[..., None]
    zero = torch.zeros(3, dtype=torch.float32, device=pair_mask.device)
    moved = transform_points(centered_before[..., None, :, :], cands.rotations, zero)
    diff = (moved - centered_after[..., None, :, :]) * pair_mask[..., None, :, None]
    return torch.sum(diff * diff, dim=(-2, -1)) / n_pairs


def _exact_errors(
    rotations: torch.Tensor,
    translations: torch.Tensor,
    subcloud: torch.Tensor,
    sub_mask: torch.Tensor,
    after_points: torch.Tensor,
    after_count: torch.Tensor,
) -> torch.Tensor:
    """Exact rescore (``noniterative.cpp:91-96``) of ``C`` candidates of
    each of B pairs -> f32[B, C]: transform the subcloud f32[B, k, 3] by
    each, NN-match against the whole target, correspondence MSE.  All
    candidates go into ONE NN call of B x C·k rows (K1 on CUDA)."""
    b, c = rotations.shape[0], rotations.shape[1]
    k = subcloud.shape[1]
    transformed = (
        torch.matmul(subcloud[:, None], rotations.mT) + translations[:, :, None, :]
    )  # [B, C, k, 3]
    _, dist = nearest_neighbors_batch(
        transformed.reshape(b, c * k, 3), after_points, after_count
    )
    dist = dist.reshape(b, c, k)
    w = ((dist < MAX_DISTANCE_FOR_COMPARISON) & (sub_mask[:, None, :] > 0)).to(torch.float32)
    return torch.sum(dist * w, dim=2) / torch.clamp_min(torch.sum(w, dim=2), 1.0)


def _pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``x[p, best[p]]`` for each pair p of ``x`` [B, C, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), best]


def _rodrigues(axis_vec: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """f32[B, K, 3, 3] rotations by ``thetas`` f32[K] about ``axis_vec``
    f32[B, 3]."""
    a = axis_vec / torch.linalg.vector_norm(axis_vec, dim=-1, keepdim=True)
    zero = torch.zeros_like(a[:, 0])
    kmat = torch.stack([
        torch.stack([zero, -a[:, 2], a[:, 1]], dim=-1),
        torch.stack([a[:, 2], zero, -a[:, 0]], dim=-1),
        torch.stack([-a[:, 1], a[:, 0], zero], dim=-1),
    ], dim=-2)  # [B, 3, 3]
    c = torch.cos(thetas)[None, :, None, None]
    s = torch.sin(thetas)[None, :, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=a.device)
    return eye + s * kmat[:, None] + (1.0 - c) * torch.matmul(kmat, kmat)[:, None]


def nicp_core(
    before: Cloud,
    after: Cloud,
    approximation_type: ApproximationType = ApproximationType.NONE,
    subcloud_size: int = 1000,
    seed: int = 0,
    degenerate_angles: int = 0,
    degenerate_axes: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NICP of B pairs at once: ``before.points`` f32[B, N, 3] and
    ``before.count`` i32[B], ``after`` alike, on one device -> (rotation
    f32[B, 3, 3], translation f32[B, 3], candidates scored i32[B], error
    f32[B]).  One score vector is drawn for the common padded size and
    masked per pair, as the JAX package's vmap of ``nicp_register``
    draws it."""
    device = before.points.device
    bp, ap = before.points, after.points
    b, npad = bp.shape[0], bp.shape[1]
    mask_b, mask_a = before.mask(), after.mask()
    mu_b = masked_centroid(bp, mask_b)
    mu_a = masked_centroid(ap, mask_a)
    u_b, _ = principal_axes(bp, mask_b)
    u_a, _ = principal_axes(ap, mask_a)
    widened = degenerate_angles > 1 and len(degenerate_axes) > 0
    cands = _enumerate_candidates(
        u_b, u_a, mu_b, mu_a,
        degenerate_angles=degenerate_angles, degenerate_axes=degenerate_axes,
    )

    # the subcloud of before for exact scoring (common.cpp:25-37): random
    # valid rows, the whole cloud when it is smaller than subcloud_size;
    # rounded up to 128 rows, those past the requested size weigh 0
    k_req = min(subcloud_size, npad)
    k = min(round_up(k_req, LANE), npad)
    scores = uniform(seed, npad, device)
    order = top_k_order(torch.where(mask_b > 0, scores, -1.0), k)  # [B, k]
    subcloud = torch.take_along_dim(bp, order[..., None], dim=1)
    sub_mask = torch.take_along_dim(mask_b, order, dim=1) * (
        torch.arange(k, device=device) < k_req).to(torch.float32)

    def exact(rots, trs):
        return _exact_errors(rots, trs, subcloud, sub_mask, ap, after.count)

    improper_penalty = torch.where(cands.proper, 0.0, BIG)

    if approximation_type == ApproximationType.Full and not widened:
        # rank by the reference's crude index-order score
        # (noniterative.cpp:53), exactly rescore only the winner
        centered_b = (bp - mu_b[:, None, :]) * mask_b[..., None]
        centered_a = (ap - mu_a[:, None, :]) * mask_a[..., None]
        n_pair = torch.minimum(before.count, after.count)
        pair_mask = (torch.arange(npad, device=device) < n_pair[:, None]).to(torch.float32)
        # truncate/pad the after side to the before size for index pairing
        if centered_a.shape[1] >= npad:
            ca = centered_a[:, :npad]
        else:
            ca = torch.nn.functional.pad(centered_a, (0, 0, 0, npad - centered_a.shape[1]))
        crude = _approximated_errors(cands, centered_b, ca, pair_mask) + improper_penalty
        best = torch.argmin(crude, dim=1)
        rotation = _pick(cands.rotations, best)
        translation = _pick(cands.translations, best)
        error = exact(rotation[:, None], translation[:, None])[:, 0]
    else:
        # None, non-widened Hybrid (its top 5 by the crude score cover the
        # 4 proper candidates) and every widened mode: all scored exactly
        errs = exact(cands.rotations, cands.translations) + improper_penalty
        best = torch.argmin(errs, dim=1)
        rotation = _pick(cands.rotations, best)
        translation = _pick(cands.translations, best)
        error = _pick(errs, best)

    if widened:
        # two rounds of 17-sample rescored grids about the winner, the
        # spacing cut by 8 a round, about before's degenerate eigen-axes:
        # R(d) = R @ Rot(u_b[:, ax], d) (right composition)
        span = 2.0 * math.pi / degenerate_angles
        for _level in range(2):
            for ax in degenerate_axes:
                deltas = torch.linspace(-span / 2, span / 2, 17, dtype=torch.float32,
                                        device=device)
                rots = torch.matmul(rotation[:, None], _rodrigues(u_b[..., ax], deltas))
                trs = mu_a[:, None, :] - torch.matmul(rots, mu_b[:, None, :, None])[..., 0]
                best = torch.argmin(exact(rots, trs), dim=1)
                rotation, translation = _pick(rots, best), _pick(trs, best)
            span = span / 8.0

        # a 3-step NN + Procrustes polish from the sub-degree start
        for _step in range(3):
            moved = transform_points(subcloud, rotation, translation)
            idx, dist = nearest_neighbors_batch(moved, ap, after.count)
            w = ((dist < MAX_DISTANCE_FOR_COMPARISON) & (sub_mask > 0)).to(torch.float32)
            matched = torch.take_along_dim(ap, idx.long()[..., None], dim=1)
            r_s, t_s = weighted_procrustes(moved, matched, w)
            rotation = torch.matmul(r_s, rotation)
            translation = torch.matmul(r_s, translation[..., None])[..., 0] + t_s
        error = exact(rotation[:, None], translation[:, None])[:, 0]

    n_scored = torch.sum(cands.proper, dim=1, dtype=torch.int32)
    return rotation, translation, n_scored, error


def nicp_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    subcloud_size: int = 1000,
    seed: int = 0,
    degenerate_angles: int = 0,
    degenerate_axes: Tuple[int, ...] = (),
) -> RegistrationResult:
    """One-shot registration of ``before`` onto ``after`` (both on one
    device, where it runs).  Returns the best candidate transform, the
    number of candidates scored (the reference's ``repetitions``) as
    ``iterations``, and its exact error (module docstring).  ``eps`` is
    accepted for the signature's sake, as in the JAX package, and unused.

    ``degenerate_angles``/``degenerate_axes`` widen the candidate set with
    in-plane rotations when the inertia spectrum is (near-)degenerate
    (``degenerate_axes_for`` is the host-side pre-pass that picks them)."""
    del eps
    if before.points.device != after.points.device:
        raise ValueError(
            f"before lies on {before.points.device}, after on "
            f"{after.points.device}: register them on one device"
        )
    rotation, translation, n_scored, error = nicp_core(
        Cloud(before.points[None], before.count.reshape(1)),
        Cloud(after.points[None], after.count.reshape(1)),
        approximation_type=approximation_type, subcloud_size=subcloud_size,
        seed=seed, degenerate_angles=degenerate_angles,
        degenerate_axes=tuple(degenerate_axes),
    )
    return RegistrationResult(
        transform=RigidTransform(
            rotation=rotation[0], translation=translation[0],
            scale=torch.ones((), dtype=torch.float32, device=rotation.device),
        ),
        iterations=int(n_scored[0]),
        error=error[0],
    )
