"""Batched multi-pair registration: B cloud pairs in one call (port of
``tpuslam/algorithms/batch.py``).

Pairs are padded to one size and stacked (``stack_clouds``).  ICP has the
JAX package's two lowerings.  On the CPU the JAX package's measured
crossover picks one (unroll when B <= 32 and N·M >= 8192²); on CUDA the
batched lowering is the default, as no size measured on the card has
the unrolled one ahead:

* unrolled: solo ``icp_register`` on each pair in turn, the pairs
  sharing one CUDA graph of the loop (``icp.graph_scope``);
* batched (the JAX package's ``jax.vmap`` of the loop): the solo
  device-resident loop ``icp._icp_loop`` over a leading pair axis, its
  NN one call of K1's batch form (dense) or of the batched hierarchical
  search (K2, K3 and K1 batch forms), its Procrustes and error one
  launch of kernel P for all pairs.  A pair that has stopped is frozen
  exactly as the JAX loop freezes it (``icp.py:151-159``): it keeps
  being queried, so it still counts in the hierarchical search's
  batch-wide arm choice, but its rotation, translation, error,
  ``prev_error``, iterations and warm state keep their values.  "All
  stopped" is read back once a chunk of iterations (on CUDA a replayed
  CUDA graph).

NICP runs ``nicp.nicp_core`` on the pair axis (its rescore one call of
K1's batch form, ``[B, 8·k, 3]`` against ``[B, M, 3]``).

CPD runs the solo device-resident EM loop (``cpd._em_loop``) over the
pair axis (the JAX package's ``jax.vmap`` of ``cpd_register``, whose
E-step its custom-vmap rule lowers to the batched Pallas kernels).  Each
pair keeps its solo run's set-up (``cpd._EM``: Morton order, sigma^2_0,
constants, FGT clusterings), stacked, and is frozen on its own stop
test and, in Hybrid with the FGT, its own phase, so every pair's
``iterations`` is its own; the loop reads the host once a chunk of
iterations (on CUDA a replayed CUDA graph).  A chunk of Hybrid with the
FGT runs the fast phase while any running pair needs it, then the slow
phase.  With the kernels, each iteration's exact and truncated E-steps
of all pairs are one call of K4's batch form
(``kernels/cpd_dense.py::cpd_estep_dense_batch``: K4 gives a pair the
bits of its B = 1 call), except truncated E-steps of clouds of
``CAND_MIN_ROWS`` rows or more, which take K5 pair by pair as the solo
run does; FGT E-steps run pair by pair.  Pair by pair, a chunk runs
only the pairs that were running in its phase when it began (the set
is part of its graph's key): any other pair stays frozen through it.
The M-step is one launch of kernel P's moments entry and one of its
SVD entry for all pairs, each pair's sums in a fixed order of its own
rows.

Each ICP and CPD pair equals its solo run bit for bit, on the CPU and on
CUDA, wherever the pairs are padded as the solo run is: the kernels and
the elementwise work do not depend on the batch, and every sum over a
pair's rows runs pair by pair (CUDA's reductions pick their split from
the shape).  Batched NICP agrees with solo NICP to float32 rounding (its
3x3 products and ``eigh`` run batched).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpuslam_torch.algorithms.icp import (
    FLT_MAX,
    ICPResume,
    ICPState,
    _icp_loop,
    dense_arm,
    full_f32,
    graph_scope,
    hier_arm,
    icp_register,
    prepare_spatial,
    resolve_use_spatial,
)
from tpuslam_torch.algorithms.cpd import _EM, _em_loop, _EMCarry, _stack_trees
from tpuslam_torch.algorithms.nicp import nicp_core
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform, pad_cloud, round_up
from tpuslam_torch.ops.nn_hier import HierState, HierTarget, hier_state_init

# the lowering crossover of icp_register_batch on the CPU: unroll when
# B <= 32 and N*M per pair reaches the pair work below, the JAX package's,
# measured on a TPU v5e (tools/batch_diag.py).  On CUDA the batched
# lowering took 0.08-0.65 of the 16 solo runs' time at every size the
# card measured, 2,048 to 102,400 rows a pair (harness/batch_diag.py,
# PERF.md), so it never unrolls unless asked
_UNROLL_MAX_B = 32
_UNROLL_MIN_PAIRWORK = 8192 * 8192  # N*M per pair

# The batched CPD loop sends a truncated (Hybrid slow-phase) E-step of a
# pair whose clouds both pad to this many rows or more to K5 on its own
# (``cpd_estep_cand``, the solo run's route) rather than into K4's batch
# form: K5 skips the block pairs that add +0.0 and equals K4 bit for bit,
# so the route changes no bits.  Measured on an H100 by
# ``harness/cpd_routes.py`` (Hybrid box pairs, slow phase): K5 pair by
# pair cost 1.9-6.5 ms more a truncated E-step than the batch form from
# 16,384 to 102,400 rows (its admission overflows from 32,768, and the
# solo route then runs K4 after it), and saved 44 and 112 ms at 262,144
# and 376,401 rows.
CAND_MIN_ROWS = 262_144


def stack_clouds(
    clouds: Sequence[np.ndarray],
    multiple: int = 128,
    device: Optional[torch.device | str] = None,
) -> Cloud:
    """Pad host ``f32[N_i, 3]`` arrays to one ``multiple``-aligned size and
    stack them: ``points`` f32[B, Npad, 3], ``count`` i32[B], on
    ``device`` (``resolve_device``: None is the card, and raises where
    there is none)."""
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
    if befores.points.device.type == "cuda":
        return False
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
    """The batched lowering (module docstring): ``icp._icp_loop`` over the
    pair axis with the JAX loop's freeze, until every pair has stopped."""
    device = befores.points.device
    b = befores.points.shape[0]

    def f32(x):
        if isinstance(x, (int, float)):
            return full_f32(x, device)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if resolve_use_spatial(use_spatial, afters.points.shape[1], device):
        setups = [prepare_spatial(_pair(befores, p), _pair(afters, p)) for p in range(b)]
        src_points = torch.stack([s.src_points for s in setups])
        src_mask = torch.stack([s.src_mask for s in setups])
        target = HierTarget(*(torch.stack(f) for f in zip(*(s.target for s in setups))))
        arm = hier_arm(src_mask, target, setups[0].l_budget, setups[0].g, setups[0].gsrc)
        if resume is not None and resume.nn is not None:
            nn_init = HierState(*(t.to(device) for t in resume.nn))
        else:
            nn_init = hier_state_init(src_points.shape[1], device, batch=(b,))
    else:
        src_points, src_mask = befores.points, befores.mask()
        arm = dense_arm(afters.points, afters.count)
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
    init = ICPState(
        rotation=rotation, translation=translation, error=error, prev_error=prev_error,
        iterations=torch.zeros((b,), dtype=torch.int32, device=device),
        done=torch.zeros((b,), dtype=torch.bool, device=device),
        nn=nn_init,
    )
    return _icp_loop(src_points, src_mask, arm, f32(eps), f32(max_distance_squared),
                     int(max_iterations), divergence_guard=divergence_guard, verbose=False,
                     iter_offset=0, init=init, patience=0)


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
        with graph_scope():
            return _stack_results([
                icp_register(_pair(befores, p), _pair(afters, p), use_spatial=use_spatial,
                             **common)
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
    use_kernels: Optional[bool] = None,
) -> RegistrationResult:
    """``cpd_register`` over the leading pair axis: one EM loop whose
    iteration steps every pair that has not stopped (module docstring),
    with every trajectory-determining knob of the solo call, so each
    pair's result is its solo run's, bit for bit.  ``use_kernels`` as in
    the solo call: with the kernels the exact and truncated E-steps of
    all pairs are one call of K4's batch form (truncated ones of
    ``CAND_MIN_ROWS`` rows or more take K5 pair by pair), else each pair
    runs the oracle.  ``iterations`` is an i32[B] tensor."""
    _check_pairs(befores, afters)
    ems = [
        _EM(_pair(befores, p), _pair(afters, p), eps, weight, tolerance, approximation_type,
            ratio_of_far_field, order_of_truncation, use_fgt, fgt_k, use_kernels,
            centroid_init, assume_sorted=False, const_scale=const_scale)
        for p in range(befores.points.shape[0])
    ]
    # every pair is padded alike, so every pair has the first pair's config
    cfg = ems[0].config._replace(pair_cand=ems[0].rows >= CAND_MIN_ROWS)
    c, _ = _em_loop(cfg, _stack_trees([em.inputs for em in ems]),
                    _EMCarry(_stack_trees([em.initial(None) for em in ems])),
                    int(max_iterations), verbose=False, iter_offset=0)
    s = c.s
    return RegistrationResult(
        transform=RigidTransform(s.rotation, s.translation, s.scale),
        iterations=s.iterations,
        error=s.sigma2,
    )


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
        with graph_scope():
            return _stack_results([
                icp_register(
                    _pair(befores, p), _pair(afters, p),
                    resume=ICPResume(resume.rotation[p], resume.translation[p],
                                     resume.error[p], prev_error=resume.prev_error[p]),
                    **common,
                )
                for p in range(b)
            ])
    return _icp_batched_loop(befores, afters, use_spatial=None, resume=resume, **common)
