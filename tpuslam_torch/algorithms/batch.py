"""Batched multi-pair registration: B cloud pairs in one call (port of
``tpuslam/algorithms/batch.py``).

Pairs are padded to one size and stacked (``stack_clouds``).  ICP has the
JAX package's two lowerings, chosen by its measured crossover (unroll
when B <= 32 and N·M >= 8192²):

* unrolled: solo ``icp_register`` on each pair in turn;
* batched (the JAX package's ``jax.vmap`` of the loop): one eager loop of
  ``icp._icp_step`` over a leading pair axis, its NN one call of K1's
  batch form (dense) or of the batched hierarchical search (K2, K3 and
  K1 batch forms).  A pair that has stopped is frozen exactly as the
  JAX loop freezes it (``icp.py:151-159``): it keeps being queried, so
  it still counts in the hierarchical search's batch-wide arm choice,
  but its rotation, translation, error, ``prev_error``, iterations and
  warm state keep their values.  "All stopped" is read back once per
  iteration.

NICP runs ``nicp.nicp_core`` on the pair axis (its rescore one call of
K1's batch form, ``[B, 8·k, 3]`` against ``[B, M, 3]``); CPD runs the
pairs one after another through solo ``cpd_register``, so each equals
its solo run.

Each ICP and CPD pair equals its solo run bit for bit, on the CPU and on
CUDA, wherever the pairs are padded as the solo run is: the batched
loop's kernels and elementwise work do not depend on the batch, and its
sums over a pair's rows (Procrustes, the error) run pair by pair
(``icp._icp_step``).  Batched NICP agrees with solo NICP to float32
rounding (its 3x3 products and ``eigh`` run batched).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpuslam_torch.algorithms.icp import (
    FLT_MAX,
    ICPResume,
    ICPState,
    RegistrationResult,
    _icp_step,
    icp_register,
    prepare_spatial,
    resolve_use_spatial,
)
from tpuslam_torch.algorithms.nicp import nicp_core
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.types import Cloud, RigidTransform, pad_cloud, round_up
from tpuslam_torch.ops.nn import nearest_neighbors_batch
from tpuslam_torch.ops.nn_hier import (
    HierState,
    HierTarget,
    hier_state_init,
    nearest_neighbors_hier_batch,
)

# the JAX package's lowering crossover for icp_register_batch, measured
# on a TPU v5e (tools/batch_diag.py); kept until a sweep on the card
# replaces it
_UNROLL_MAX_B = 32
_UNROLL_MIN_PAIRWORK = 8192 * 8192  # N*M per pair


def stack_clouds(
    clouds: Sequence[np.ndarray],
    multiple: int = 128,
    device: Optional[torch.device | str] = None,
) -> Cloud:
    """Pad host ``f32[N_i, 3]`` arrays to one ``multiple``-aligned size and
    stack them: ``points`` f32[B, Npad, 3], ``count`` i32[B], on
    ``device`` (``resolve_device``: the card when there is one)."""
    if not len(clouds):
        raise ValueError("empty cloud batch")
    device = resolve_device(device)
    npad = max(round_up(max(len(c), 1), multiple) for c in clouds)
    padded = [pad_cloud(c, multiple=npad, device=device) for c in clouds]
    return Cloud(
        points=torch.stack([p.points for p in padded]),
        count=torch.stack([p.count for p in padded]),
    )


def _pair(clouds: Cloud, p: int) -> Cloud:
    return Cloud(clouds.points[p], clouds.count[p])


def _stack_results(results) -> RegistrationResult:
    """Per-pair results as one: every field with a leading pair axis,
    ``iterations`` an i32[B] tensor."""
    device = results[0].error.device
    return RegistrationResult(
        transform=RigidTransform(*(torch.stack(f) for f in zip(*(r.transform for r in results)))),
        iterations=torch.tensor([int(r.iterations) for r in results], dtype=torch.int32,
                                device=device),
        error=torch.stack([r.error for r in results]),
    )


def _resolve_unroll(unroll: Optional[bool], befores: Cloud, afters: Cloud) -> bool:
    if unroll is not None:
        return bool(unroll)
    b, n = befores.points.shape[0], befores.points.shape[1]
    m = afters.points.shape[1]
    return b <= _UNROLL_MAX_B and n * m >= _UNROLL_MIN_PAIRWORK


def _check_pairs(befores: Cloud, afters: Cloud) -> None:
    if befores.points.device != afters.points.device:
        raise ValueError(
            f"befores lie on {befores.points.device}, afters on "
            f"{afters.points.device}: register them on one device"
        )
    if befores.points.shape[0] != afters.points.shape[0]:
        raise ValueError(
            f"pair count mismatch: {befores.points.shape[0]} befores vs "
            f"{afters.points.shape[0]} afters"
        )


def _icp_batched_loop(
    befores: Cloud,
    afters: Cloud,
    eps: float,
    max_distance_squared: float,
    max_iterations: int,
    divergence_guard: bool,
    use_spatial: Optional[bool],
    resume: Optional[ICPResume] = None,
) -> RegistrationResult:
    """The batched lowering (module docstring): ``icp._icp_step`` over the
    pair axis with the JAX loop's freeze, until every pair has stopped."""
    device = befores.points.device
    b = befores.points.shape[0]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if resolve_use_spatial(use_spatial, afters.points.shape[1], device):
        setups = [prepare_spatial(_pair(befores, p), _pair(afters, p)) for p in range(b)]
        src_points = torch.stack([s.src_points for s in setups])
        src_mask = torch.stack([s.src_mask for s in setups])
        target = HierTarget(*(torch.stack(f) for f in zip(*(s.target for s in setups))))
        g, gsrc, l_budget = setups[0].g, setups[0].gsrc, setups[0].l_budget

        def run_nn(transformed, s: ICPState):
            return nearest_neighbors_hier_batch(
                transformed, src_mask, target, s.nn, l_budget=l_budget, g=g, gsrc=gsrc)

        def gather_matched(idx, nn_state):
            # the hier state already holds original_points[idx]
            return nn_state.prev_target

        if resume is not None and resume.nn is not None:
            nn_init = HierState(*(t.to(device) for t in resume.nn))
        else:
            nn_init = hier_state_init(src_points.shape[1], device, batch=(b,))
    else:
        src_points, src_mask = befores.points, befores.mask()

        def run_nn(transformed, s: ICPState):
            idx, dist = nearest_neighbors_batch(transformed, afters.points, afters.count)
            return idx, dist, s.nn

        def gather_matched(idx, nn_state):
            return torch.take_along_dim(afters.points, idx.long()[..., None], dim=1)

        nn_init = None

    if resume is None:
        rotation = torch.eye(3, dtype=torch.float32, device=device).expand(b, 3, 3)
        translation = torch.zeros((b, 3), dtype=torch.float32, device=device)
        error = f32(1e5).expand(b)  # basicicp.cpp:26
        prev_error = f32(FLT_MAX).expand(b)
    else:
        rotation, translation = f32(resume.rotation), f32(resume.translation)
        error = f32(resume.error)
        prev_error = f32(resume.error if resume.prev_error is None else resume.prev_error)
    s = ICPState(
        rotation=rotation, translation=translation, error=error, prev_error=prev_error,
        iterations=torch.zeros((b,), dtype=torch.int32, device=device),
        done=torch.zeros((b,), dtype=torch.bool, device=device),
        nn=nn_init,
    )
    eps_t, max_d2 = f32(eps), f32(max_distance_squared)
    max_it = int(max_iterations)
    while True:
        # the JAX loop's cond per pair; the loop runs while any pair's holds
        active = ~s.done
        if max_it != -1:
            active = active & (s.iterations < max_it)
        if not bool(active.any()):  # the one read back of the iteration
            break
        new, _ = _icp_step(s, src_points, src_mask, run_nn, gather_matched,
                           eps_t, max_d2, divergence_guard)
        # the reference increments only when the loop continues
        new = new._replace(iterations=torch.where(new.done, s.iterations, s.iterations + 1))

        def keep(old, nw):  # a stopped pair keeps its state, as in the JAX loop
            return torch.where(active.reshape((b,) + (1,) * (nw.dim() - 1)), nw, old)

        s = ICPState(
            *(keep(o, n) for o, n in zip(s[:-1], new[:-1])),
            nn=None if s.nn is None else HierState(*map(keep, s.nn, new.nn)),
        )
    one = torch.ones((b,), dtype=torch.float32, device=device)
    return RegistrationResult(
        transform=RigidTransform(s.rotation, s.translation, one),
        iterations=s.iterations,
        error=s.error,
        nn=s.nn,
    )


def icp_register_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    divergence_guard: bool = True,
    unroll: Optional[bool] = None,
    use_spatial: Optional[bool] = None,
) -> RegistrationResult:
    """``icp_register`` over the leading pair axis.  ``unroll`` (None: the
    crossover in the module docstring) picks the lowering; ``use_spatial``
    (None: as solo, the hierarchical arm on CUDA from 8,192 target rows)
    is honoured by both.  ``iterations`` is an i32[B] tensor."""
    _check_pairs(befores, afters)
    common = dict(eps=eps, max_distance_squared=max_distance_squared,
                  max_iterations=max_iterations, divergence_guard=divergence_guard)
    if _resolve_unroll(unroll, befores, afters):
        return _stack_results([
            icp_register(_pair(befores, p), _pair(afters, p), use_spatial=use_spatial, **common)
            for p in range(befores.points.shape[0])
        ])
    return _icp_batched_loop(befores, afters, use_spatial=use_spatial, **common)


def nicp_register_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    approximation_type: ApproximationType = ApproximationType.NONE,
    subcloud_size: int = 1000,
    seed: int = 0,
) -> RegistrationResult:
    """``nicp_register`` over the leading pair axis, without widening (as
    in the JAX package).  ``eps`` is unused, as in the solo call."""
    del eps
    _check_pairs(befores, afters)
    rotation, translation, n_scored, error = nicp_core(
        befores, afters, approximation_type=approximation_type,
        subcloud_size=subcloud_size, seed=seed,
    )
    return RegistrationResult(
        transform=RigidTransform(rotation, translation, torch.ones_like(error)),
        iterations=n_scored,
        error=error,
    )


def cpd_register_batch(
    befores: Cloud,
    afters: Cloud,
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
    centroid_init: bool = False,
) -> RegistrationResult:
    """``cpd_register`` of each pair, one after another, with every
    trajectory-determining knob of the solo call, so each pair's result
    is its solo run's.  (The pair-axis EM loop on K4's batch form is
    ROADMAP Queue 1's next item.)"""
    from tpuslam_torch.algorithms.cpd import cpd_register

    _check_pairs(befores, afters)
    return _stack_results([
        cpd_register(
            _pair(befores, p), _pair(afters, p), eps=eps, weight=weight,
            const_scale=const_scale, max_iterations=max_iterations, tolerance=tolerance,
            approximation_type=approximation_type, use_fgt=use_fgt, fgt_k=fgt_k,
            order_of_truncation=order_of_truncation, ratio_of_far_field=ratio_of_far_field,
            centroid_init=centroid_init,
        )
        for p in range(befores.points.shape[0])
    ])


def icp_register_prealigned_batch(
    befores: Cloud,
    afters: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    subcloud_size: int = 1000,
    seed: int = 0,
    divergence_guard: bool = True,
    unroll: Optional[bool] = None,
) -> RegistrationResult:
    """Batched ``icp_register_prealigned``: one batched NICP shot seeds
    each pair's ICP loop through a batched ``ICPResume`` (error sentinel
    1e5, guard seed FLT_MAX, as in the solo path); the loop takes the
    lowering ``icp_register_batch`` would, its NN arm the solo default."""
    _check_pairs(befores, afters)
    pre = nicp_register_batch(befores, afters, eps=eps, subcloud_size=subcloud_size, seed=seed)
    b = befores.points.shape[0]
    device = befores.points.device
    resume = ICPResume(
        rotation=pre.transform.rotation,
        translation=pre.transform.translation,
        error=torch.full((b,), 1e5, dtype=torch.float32, device=device),
        prev_error=torch.tensor(FLT_MAX, dtype=torch.float32, device=device).repeat(b),
    )
    common = dict(eps=eps, max_distance_squared=max_distance_squared,
                  max_iterations=max_iterations, divergence_guard=divergence_guard)
    if _resolve_unroll(unroll, befores, afters):
        return _stack_results([
            icp_register(
                _pair(befores, p), _pair(afters, p),
                resume=ICPResume(resume.rotation[p], resume.translation[p], resume.error[p],
                                 prev_error=resume.prev_error[p]),
                **common,
            )
            for p in range(b)
        ])
    return _icp_batched_loop(befores, afters, use_spatial=None, resume=resume, **common)
