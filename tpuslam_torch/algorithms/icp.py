"""Iterative Closest Point (port of ``tpuslam/algorithms/icp.py``).

Each iteration: transform the source, exact nearest-neighbour
correspondences, weighted 3x3 Procrustes with an SVD, error, stop
conditions.  The correspondences come from one of two arms, both exact:

* dense: kernel K1 (``ops/nn.py``) over the whole target;
* hierarchical (``use_spatial``): ``ops/nn_hier.py`` on Morton-sorted
  sources and targets, kernels K2 and K3 with K1 as the overflow arm.
  ``use_spatial=None`` takes it on CUDA from 8,192 target rows
  (``resolve_use_spatial``), as the JAX package does on the TPU.

The math and every stop condition follow the JAX package's
``_icp_loop``:

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
host once per iteration; the hierarchical arm adds one read of its two
overflow flags.

``icp_register_chunked`` runs the loop a chunk of iterations at a time
along the same trajectory, and checkpoints each boundary to disk when
asked (``harness/checkpoint.py``); ``icp_register_prealigned`` seeds it
with one NICP shot.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpuslam_torch.core.types import Cloud, RigidTransform, round_up
from tpuslam_torch.ops.geometry import matmul3, matvec3, per_pair, transform_points
from tpuslam_torch.ops.nn import nearest_neighbors
from tpuslam_torch.ops.nn_hier import (
    MAX_ROWS,
    HierState,
    HierTarget,
    _coarse_tile_rows,
    auto_tile_params,
    hier_state_init,
    nearest_neighbors_hier,
    prepare_hier_target,
)
from tpuslam_torch.ops.procrustes import weighted_procrustes
from tpuslam_torch.ops.spatial import morton_permutation

FLT_MAX = 3.4028235e38
# target rows from which use_spatial=None takes the hierarchical arm on
# CUDA: the JAX package's crossover, measured on a TPU v5e
SPATIAL_MIN_ROWS = 8192


class ICPState(NamedTuple):
    """The loop carry; every field but ``iterations`` stays on the device
    (in the batched loop of ``algorithms/batch.py``, where every field has
    a leading pair axis, ``iterations`` is an i32[B] tensor too)."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    error: torch.Tensor  # f32[]
    prev_error: torch.Tensor  # f32[]
    iterations: int
    done: torch.Tensor  # bool[]
    # hierarchical-NN carry (spatial arm only; None on the dense arm)
    nn: Optional[HierState] = None


class RegistrationResult(NamedTuple):
    transform: RigidTransform
    iterations: int
    error: torch.Tensor  # f32[]
    # final hierarchical-NN warm state (spatial arm only)
    nn: Optional[HierState] = None
    # CPD only: the per-iteration ring f32[H, 4] of (sigma^2, ntol,
    # log-likelihood, scale) when asked for, and the final EM loop state
    # (algorithms.cpd.CPDState; typed loosely to avoid an import cycle)
    history: Optional[torch.Tensor] = None
    em: Optional[tuple] = None


class ICPResume(NamedTuple):
    """Warm start at an iteration boundary: the accepted transform and its
    error, as the loop would hold them, plus the iterations already done
    (numbering of the verbose trace).  ``prev_error`` seeds the divergence
    guard; None means ``error``.  ``nn`` is the hierarchical arm's warm
    state (positions of the padded, Morton-sorted sources, which are a
    function of the input cloud alone); None starts it cold."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    error: torch.Tensor  # f32[]
    done_before: int = 0
    prev_error: Optional[torch.Tensor] = None
    nn: Optional[HierState] = None


# (transformed sources, state) -> (idx, dist, nn state)
RunNN = Callable[
    [torch.Tensor, ICPState],
    Tuple[torch.Tensor, torch.Tensor, Optional[HierState]],
]
# (idx, nn state) -> matched target points f32[N, 3]
GatherMatched = Callable[[torch.Tensor, Optional[HierState]], torch.Tensor]


def resolve_use_spatial(
    use_spatial: Optional[bool], target_rows: int, device: torch.device
) -> bool:
    """The default of the hierarchical arm: an explicit choice stands;
    None takes it on CUDA from ``SPATIAL_MIN_ROWS`` target rows while the
    rows, with 256 rows of tile padding, stay exactly representable as
    float32 indices.  This is the JAX package's gate with its TPU
    backend replaced by CUDA; on the CPU, as on every JAX backend but the
    TPU, None is the dense arm."""
    if use_spatial is not None:
        return bool(use_spatial)
    return (
        torch.device(device).type == "cuda"
        and target_rows >= SPATIAL_MIN_ROWS
        and target_rows + 256 <= MAX_ROWS
    )


class SpatialSetup(NamedTuple):
    """What the hierarchical arm prepares once per registration."""

    src_points: torch.Tensor  # f32[Npad, 3] — padded, Morton-sorted
    src_mask: torch.Tensor  # f32[Npad]
    target: HierTarget
    g: int
    gsrc: int
    l_budget: int


def prepare_spatial(before: Cloud, after: Cloud) -> SpatialSetup:
    """Pad the sources to ``gsrc`` rows and the target to the coarse tile
    (masked rows), Morton-sort the sources once and prepare the target:
    the JAX package's set-up of its spatial branch (``icp.py:360-384``)."""
    g, gsrc, l_budget = auto_tile_params(after.points.shape[0])
    n0, m0 = before.points.shape[0], after.points.shape[0]
    n_pad = round_up(n0, gsrc)
    m_pad = round_up(m0, max(g, _coarse_tile_rows(g, gsrc) or g))
    b_points = torch.nn.functional.pad(before.points, (0, 0, 0, n_pad - n0))
    src_mask = torch.nn.functional.pad(before.mask(), (0, n_pad - n0))
    a_points = torch.nn.functional.pad(after.points, (0, 0, 0, m_pad - m0))
    a_mask = torch.nn.functional.pad(after.mask(), (0, m_pad - m0))
    perm = morton_permutation(b_points, src_mask)
    return SpatialSetup(
        src_points=b_points[perm].contiguous(),
        src_mask=src_mask[perm],
        target=prepare_hier_target(a_points, a_mask, after.count, g=g),
        g=g,
        gsrc=gsrc,
        l_budget=l_budget,
    )


def _mean_sq_error(diff: torch.Tensor, w: torch.Tensor, n_corr: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.sum(diff * diff, dim=-1) * w) / torch.clamp_min(n_corr, 1.0)


def _icp_step(
    s: ICPState,
    src_points: torch.Tensor,
    src_mask: torch.Tensor,
    run_nn: RunNN,
    gather_matched: GatherMatched,
    eps: torch.Tensor,
    max_d2: torch.Tensor,
    divergence_guard: bool,
) -> tuple[ICPState, torch.Tensor]:
    """One iteration on the device; returns the new state (with
    ``iterations`` not yet advanced) and the iteration's error.  With a
    leading pair axis on every tensor (``algorithms/batch.py``) it steps
    each pair as its solo step would, bit for bit: the NN kernels and the
    elementwise work do not depend on the batch, and the sums over a
    pair's rows (Procrustes, the error) run pair by pair."""
    transformed = transform_points(src_points, s.rotation, s.translation)
    idx, dist, nn_state = run_nn(transformed, s)
    w = torch.logical_and(dist < max_d2, src_mask > 0).to(torch.float32)
    n_corr = torch.sum(w, dim=-1)
    no_corr = n_corr == 0

    matched = gather_matched(idx, nn_state)
    r_step, t_step = weighted_procrustes(transformed, matched, w)
    # 3x3/3-vector composition in full float32, rounded alike batched
    r_new = matmul3(r_step, s.rotation)
    t_new = matvec3(r_step, s.translation) + t_step

    new_transformed = transform_points(src_points, r_new, t_new)
    diff = matched - new_transformed
    err = (per_pair(_mean_sq_error, diff, w, n_corr) if diff.dim() == 3
           else _mean_sq_error(diff, w, n_corr))

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
        rotation=torch.where(reject[..., None, None], s.rotation, r_new),
        translation=torch.where(reject[..., None], s.translation, t_new),
        error=torch.where(reject, s.error, err),
        prev_error=torch.where(done, s.prev_error, err),
        iterations=s.iterations,
        done=done,
        nn=nn_state,
    )
    return state, err


def _icp_loop(
    src_points: torch.Tensor,
    src_mask: torch.Tensor,
    run_nn: RunNN,
    gather_matched: GatherMatched,
    eps: torch.Tensor,
    max_d2: torch.Tensor,
    max_iterations: int,
    divergence_guard: bool,
    verbose: bool,
    iter_offset: int,
    init: ICPState,
    patience: int,
) -> RegistrationResult:
    """The whole registration loop after input preparation;
    ``run_nn`` and ``gather_matched`` are the correspondence arm.

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
            s, src_points, src_mask, run_nn, gather_matched,
            eps, max_d2, divergence_guard,
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
            nn=s.nn,
        )
    return RegistrationResult(
        transform=RigidTransform(s.rotation, s.translation, one),
        iterations=s.iterations,
        error=s.error,
        nn=s.nn,
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

    Both clouds must lie on one device; the loop runs there.
    ``use_spatial`` picks the correspondence arm (``resolve_use_spatial``:
    None is the hierarchical arm on CUDA from 8,192 target rows and the
    dense arm otherwise); both arms give the same correspondences, but the
    hierarchical arm visits the sources in Morton order, so Procrustes
    sums them in another order.  ``use_spatial=True`` raises for a target
    of 2**24 rows or more.  ``patience > 0`` replaces the
    stop-on-first-error-increase semantics (pair it with
    ``divergence_guard=False``) by a best-so-far loop that stops after
    ``patience`` consecutive non-improving iterations."""
    if before.points.device != after.points.device:
        raise ValueError(
            f"before lies on {before.points.device}, after on "
            f"{after.points.device}: register them on one device"
        )
    device = before.points.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if resolve_use_spatial(use_spatial, after.points.shape[0], device):
        setup = prepare_spatial(before, after)
        src_points, src_mask = setup.src_points, setup.src_mask

        def run_nn(transformed, s: ICPState):
            return nearest_neighbors_hier(
                transformed, src_mask, setup.target, s.nn,
                l_budget=setup.l_budget, g=setup.g, gsrc=setup.gsrc,
            )

        def gather_matched(idx, nn_state):
            # the hier state already holds original_points[idx]
            return nn_state.prev_target

        if resume is not None and resume.nn is not None:
            nn_init = HierState(*(t.to(device) for t in resume.nn))
        else:
            nn_init = hier_state_init(src_points.shape[0], device)
    else:
        src_points, src_mask = before.points, before.mask()

        def run_nn(transformed, s: ICPState):
            idx, dist = nearest_neighbors(transformed, after.points, after.count)
            return idx, dist, s.nn

        def gather_matched(idx, nn_state):
            return after.points.index_select(0, idx)

        nn_init = None

    if resume is None:
        init = ICPState(
            rotation=torch.eye(3, dtype=torch.float32, device=device),
            translation=torch.zeros(3, dtype=torch.float32, device=device),
            error=f32(1e5),  # basicicp.cpp:26
            prev_error=f32(FLT_MAX),
            iterations=0,
            done=torch.zeros((), dtype=torch.bool, device=device),
            nn=nn_init,
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
            nn=nn_init,
        )
        iter_offset = int(resume.done_before)
    return _icp_loop(
        src_points, src_mask, run_nn, gather_matched,
        f32(eps), f32(max_distance_squared), int(max_iterations),
        divergence_guard=divergence_guard, verbose=verbose,
        iter_offset=iter_offset, init=init, patience=patience,
    )


def _icp_ckpt_meta(
    before: Cloud,
    after: Cloud,
    eps: float,
    max_distance_squared: float,
    divergence_guard: bool,
    extra: Optional[dict] = None,
) -> dict:
    """Checkpoint metadata of a chunked ICP run, the JAX package's keys:
    shapes, cloud fingerprints and every loop parameter that determines
    the trajectory, ``prealign`` among them (False here, set by
    ``icp_register_prealigned``), so a cold-start file never resumes a
    prealigned run or the reverse.  The NN arm is not among them: every
    arm is exact."""
    from tpuslam_torch.harness.checkpoint import cloud_fingerprint

    meta = {
        "n_pad": int(before.points.shape[0]),
        "m_pad": int(after.points.shape[0]),
        "n": int(before.count),
        "m": int(after.count),
        "eps": float(eps),
        "max_distance_squared": float(max_distance_squared),
        "divergence_guard": bool(divergence_guard),
        "prealign": False,
        "fp_before": cloud_fingerprint(before.points, before.mask()),
        "fp_after": cloud_fingerprint(after.points, after.mask()),
    }
    meta.update(extra or {})
    return meta


def icp_register_chunked(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    chunk: int = 10,
    resume: Optional[ICPResume] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_extra_meta: Optional[dict] = None,
    **kwargs,
) -> RegistrationResult:
    """``icp_register`` run ``chunk`` iterations at a time (port of the JAX
    package's ``icp_register_chunked``), the transform, its error and the
    hierarchical arm's warm state carried across chunks on the device
    (``ICPResume``).  The trajectory is the whole run's, bit for bit: each
    boundary holds what the loop would hold had it continued (the guard
    is seeded from the carried error, as the loop's ``prev_error`` equals
    it after an accepted step).

    ``checkpoint_path`` saves every boundary, the last one included
    (``harness/checkpoint.py``), so a killed run continues from its last
    boundary in a new process.  A file that does not match this run
    (cloud fingerprints, shapes, loop parameters) is ignored with a notice
    and overwritten; a matching one whose progress already meets
    ``max_iterations`` is returned as it is (an idempotent re-run), with a
    notice when it holds more.  ``kwargs`` go to ``icp_register``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    device = before.points.device
    total = 0
    ckpt_meta = None
    if checkpoint_path is not None:
        from tpuslam_torch.harness.checkpoint import load_resume_or_none

        ckpt_meta = _icp_ckpt_meta(
            before, after, eps, max_distance_squared,
            divergence_guard=bool(kwargs.get("divergence_guard", True)),
            extra=checkpoint_extra_meta,
        )
        loaded = load_resume_or_none(checkpoint_path, "icp", ckpt_meta, device=device)
        if loaded is not None:
            resume = loaded
            total = int(loaded.done_before)
        if resume is not None and max_iterations != -1 and total >= max_iterations:
            if total > max_iterations:
                print(f"[tpuslam] checkpoint already holds {total} iterations "
                      f"(requested {max_iterations}); returning its state")
            return RegistrationResult(
                transform=RigidTransform(
                    torch.as_tensor(resume.rotation, dtype=torch.float32, device=device),
                    torch.as_tensor(resume.translation, dtype=torch.float32, device=device),
                    torch.ones((), dtype=torch.float32, device=device),
                ),
                iterations=total,
                error=torch.as_tensor(resume.error, dtype=torch.float32, device=device),
            )
    while True:
        k = chunk if max_iterations == -1 else min(chunk, max_iterations - total)
        result = icp_register(
            before, after, eps=eps, max_distance_squared=max_distance_squared,
            max_iterations=k, resume=resume, **kwargs,
        )
        did = int(result.iterations)
        total += did
        resume = ICPResume(
            rotation=result.transform.rotation,
            translation=result.transform.translation,
            error=result.error,
            done_before=total,
            nn=result.nn,
        )
        if checkpoint_path is not None:
            from tpuslam_torch.harness.checkpoint import save_icp_checkpoint

            save_icp_checkpoint(checkpoint_path, resume, ckpt_meta)
        # the loop does not count the iteration it stops at, so fewer than
        # k iterations means it stopped (converged, diverged, no match)
        if did < k or (max_iterations != -1 and total >= max_iterations):
            break
    return RegistrationResult(
        transform=result.transform,
        iterations=total,
        error=result.error,
    )


def icp_register_prealigned(
    before: Cloud,
    after: Cloud,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    subcloud_size: int = 1000,
    seed: int = 0,
    chunk: int = 0,
    checkpoint_path: Optional[str] = None,
    **kwargs,
) -> RegistrationResult:
    """ICP seeded by a one-shot NICP estimate (opt-in: ``icp-prealign``;
    port of the JAX package's ``icp_register_prealigned``).

    The NICP shot lands inside ICP's basin whenever the clouds' principal
    axes are resolvable; the unchanged ICP loop (``icp_register``, with
    its default NN arm) then refines from it through ``ICPResume``.  The
    carried error is the cold-start reporting sentinel 1e5
    (``basicicp.cpp:26``) and the divergence guard is seeded with FLT_MAX,
    as a cold start seeds it: the NICP subcloud error is over another
    point set, and an absolute threshold would abort the first iteration
    on large-unit clouds.

    ``chunk`` or ``checkpoint_path`` runs the loop through
    ``icp_register_chunked`` (``chunk`` 0 means 10 there), with the
    ``prealign``, ``prealign_subcloud`` and ``prealign_seed`` metadata.  A
    matching checkpoint holds progress past the seed, so it is loaded
    first and the NICP shot is skipped."""
    from tpuslam_torch.algorithms import nicp

    extra_meta = {
        "prealign": True,
        "prealign_subcloud": int(subcloud_size),
        "prealign_seed": int(seed),
    }
    device = before.points.device
    resume = None
    if checkpoint_path is not None:
        from tpuslam_torch.harness.checkpoint import load_resume_or_none

        # quiet: the chunked driver checks the same file again and prints
        # any mismatch notice
        resume = load_resume_or_none(
            checkpoint_path, "icp",
            _icp_ckpt_meta(before, after, eps, max_distance_squared,
                           divergence_guard=bool(kwargs.get("divergence_guard", True)),
                           extra=extra_meta),
            quiet=True, device=device,
        )
    if resume is None:
        pre = nicp.nicp_register(before, after, eps=eps, subcloud_size=subcloud_size, seed=seed)
        resume = ICPResume(
            rotation=pre.transform.rotation,
            translation=pre.transform.translation,
            error=torch.tensor(1e5, dtype=torch.float32, device=device),
            prev_error=torch.tensor(FLT_MAX, dtype=torch.float32, device=device),
        )
    common = dict(eps=eps, max_distance_squared=max_distance_squared,
                  max_iterations=max_iterations, resume=resume, **kwargs)
    if chunk or checkpoint_path:
        return icp_register_chunked(
            before, after, chunk=chunk or 10, checkpoint_path=checkpoint_path,
            checkpoint_extra_meta=extra_meta, **common,
        )
    return icp_register(before, after, **common)
