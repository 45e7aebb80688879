"""Iterative Closest Point on the dense nearest-neighbour arm (port of
``tpuslam/algorithms/icp.py``).

Each iteration: transform the source, exact nearest-neighbour
correspondences (kernel K1 on CUDA), weighted 3x3 Procrustes with an SVD,
error, stop conditions.  The math and every stop condition follow the
JAX package's ``_icp_loop``:

* transform composition is homogeneous (``R <- R_step R``,
  ``t <- R_step t + t_step``, ``icpcuda.cu:35``);
* correspondences with squared distance >= ``max_distance_squared`` are
  dropped via {0,1} weights (strict ``<``, ``common.cpp:422``); zero
  correspondences stops the loop (``basicicp.cpp:36-37``);
* the divergence guard (error increased -> revert and stop,
  ``icpcuda.cu:43-49``) is on by default;
* a non-finite error stops the loop and reverts;
* ``max_iterations == -1`` means run until convergence;
* ``patience > 0`` keeps the best-so-far transform and stops after
  ``patience`` non-improving iterations;
* ``iterations`` counts only iterations after which the loop continued.

Unlike the JAX ``lax.while_loop``, this loop runs eagerly and reads the
``done`` flag (and, with ``patience``, the improvement flag) back to the
host once per iteration: one device synchronisation per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.core.types import Cloud, RigidTransform
from tpuslam_torch.ops.geometry import transform_points
from tpuslam_torch.ops.nn import nearest_neighbors
from tpuslam_torch.ops.procrustes import weighted_procrustes

FLT_MAX = 3.4028235e38


class ICPState(NamedTuple):
    """The loop carry; every field but ``iterations`` stays on the device."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    error: torch.Tensor  # f32[]
    prev_error: torch.Tensor  # f32[]
    iterations: int
    done: torch.Tensor  # bool[]


class RegistrationResult(NamedTuple):
    transform: RigidTransform
    iterations: int
    error: torch.Tensor  # f32[]


class ICPResume(NamedTuple):
    """Warm start at an iteration boundary: the accepted transform and its
    error, as the loop would hold them, plus the iterations already done
    (numbering of the verbose trace).  ``prev_error`` seeds the divergence
    guard; None means ``error``."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    error: torch.Tensor  # f32[]
    done_before: int = 0
    prev_error: Optional[torch.Tensor] = None


def _icp_step(
    s: ICPState,
    src_points: torch.Tensor,
    src_mask: torch.Tensor,
    after: Cloud,
    eps: torch.Tensor,
    max_d2: torch.Tensor,
    divergence_guard: bool,
) -> tuple[ICPState, torch.Tensor]:
    """One iteration on the device; returns the new state (with
    ``iterations`` not yet advanced) and the iteration's error."""
    transformed = transform_points(src_points, s.rotation, s.translation)
    idx, dist = nearest_neighbors(transformed, after.points, after.count)
    w = torch.logical_and(dist < max_d2, src_mask > 0).to(torch.float32)
    n_corr = torch.sum(w)
    no_corr = n_corr == 0

    matched = after.points.index_select(0, idx)
    r_step, t_step = weighted_procrustes(transformed, matched, w)
    # 3x3/3-vector composition in full float32 (procrustes pins TF32 off)
    r_new = torch.matmul(r_step, s.rotation)
    t_new = torch.matmul(r_step, s.translation) + t_step

    new_transformed = transform_points(src_points, r_new, t_new)
    diff = matched - new_transformed
    err = torch.sum(torch.sum(diff * diff, dim=-1) * w) / torch.clamp_min(
        n_corr, 1.0
    )

    converged = err < eps
    diverged = (
        err > s.prev_error if divergence_guard
        else torch.zeros_like(converged)
    )
    non_finite = torch.logical_not(torch.isfinite(err))
    # zero correspondences, divergence or a numeric blowup: stop and keep
    # the pre-iteration transform, the last accepted one
    reject = no_corr | diverged | non_finite
    done = reject | converged
    state = ICPState(
        rotation=torch.where(reject, s.rotation, r_new),
        translation=torch.where(reject, s.translation, t_new),
        error=torch.where(reject, s.error, err),
        prev_error=torch.where(done, s.prev_error, err),
        iterations=s.iterations,
        done=done,
    )
    return state, err


def _icp_loop(
    src_points: torch.Tensor,
    src_mask: torch.Tensor,
    after: Cloud,
    eps: torch.Tensor,
    max_d2: torch.Tensor,
    max_iterations: int,
    divergence_guard: bool,
    verbose: bool,
    iter_offset: int,
    init: ICPState,
    patience: int,
) -> RegistrationResult:
    """The whole registration loop after input preparation.

    Reads ``done`` (and the improvement flag when ``patience > 0``) back to
    the host once per iteration; everything else stays on the device."""
    s = init
    device = src_points.device
    best_r, best_t = init.rotation, init.translation
    best_e = torch.tensor(FLT_MAX, dtype=torch.float32, device=device)
    streak = 0
    while max_iterations == -1 or s.iterations < max_iterations:
        if patience > 0 and streak >= patience:
            break
        s, err = _icp_step(
            s, src_points, src_mask, after, eps, max_d2, divergence_guard
        )
        if patience > 0:
            improved = s.error < best_e
            done, improved = torch.stack([s.done, improved]).tolist()
            if improved:
                best_r, best_t, best_e = s.rotation, s.translation, s.error
                streak = 0
            else:
                streak += 1
        else:
            done = bool(s.done)
        if verbose:
            # the reference's per-iteration printf (basicicp.cpp:50)
            print(f"loop_nr {s.iterations + 1 + iter_offset}, error: {float(err)}")
        if done:
            break
        s = s._replace(iterations=s.iterations + 1)

    one = torch.ones((), dtype=torch.float32, device=device)
    if patience > 0:
        # zero evaluated iterations: report the carried-in error
        never_evaluated = best_e >= FLT_MAX
        return RegistrationResult(
            transform=RigidTransform(best_r, best_t, one),
            iterations=s.iterations,
            error=torch.where(never_evaluated, init.error, best_e),
        )
    return RegistrationResult(
        transform=RigidTransform(s.rotation, s.translation, one),
        iterations=s.iterations,
        error=s.error,
    )


def icp_register(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    verbose: bool = False,
    use_spatial: Optional[bool] = None,
    resume: Optional[ICPResume] = None,
    patience: int = 0,
) -> RegistrationResult:
    """Register ``before`` onto ``after``; returns (R, t) with
    ``after ≈ R @ before + t`` plus iteration count and final MSE.

    Both clouds must lie on one device; the loop runs there.  Only the
    dense arm is ported: ``use_spatial=None`` resolves to it (as the JAX
    package resolves it on every backend but the TPU), and
    ``use_spatial=True`` raises.  ``patience > 0`` replaces the
    stop-on-first-error-increase semantics (pair it with
    ``divergence_guard=False``) by a best-so-far loop that stops after
    ``patience`` consecutive non-improving iterations."""
    if use_spatial:
        raise NotImplementedError("hierarchical NN: ROADMAP slice 2")
    if before.points.device != after.points.device:
        raise ValueError(
            f"before lies on {before.points.device}, after on "
            f"{after.points.device}: register them on one device"
        )
    device = before.points.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if resume is None:
        init = ICPState(
            rotation=torch.eye(3, dtype=torch.float32, device=device),
            translation=torch.zeros(3, dtype=torch.float32, device=device),
            error=f32(1e5),  # basicicp.cpp:26
            prev_error=f32(FLT_MAX),
            iterations=0,
            done=torch.zeros((), dtype=torch.bool, device=device),
        )
        iter_offset = 0
    else:
        # warm start at an iteration boundary: the values the loop would
        # hold had it continued, so a resumed run follows the same path
        init = ICPState(
            rotation=f32(resume.rotation),
            translation=f32(resume.translation),
            error=f32(resume.error),
            prev_error=f32(
                resume.error if resume.prev_error is None
                else resume.prev_error
            ),
            iterations=0,
            done=torch.zeros((), dtype=torch.bool, device=device),
        )
        iter_offset = int(resume.done_before)
    return _icp_loop(
        before.points, before.mask(), after,
        f32(eps), f32(max_distance_squared), int(max_iterations),
        divergence_guard=divergence_guard, verbose=verbose,
        iter_offset=iter_offset, init=init, patience=patience,
    )
