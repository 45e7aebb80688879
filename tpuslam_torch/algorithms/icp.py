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

Like the JAX ``lax.while_loop``, the loop keeps all of its state on the
device and freezes a problem once it has stopped (an iteration after
``done``, after ``max_iterations`` or after ``patience`` non-improving
iterations changes nothing).  ``algorithms/device_loop.py`` drives the
loop in chunks of ``device_loop.LOOP_CHUNK`` iterations with one host
read a chunk, its report: whether the loop has stopped and the iteration
count here, the hierarchical arm of each query and the launches the
device counted there.  On CUDA a chunk is captured once as a CUDA graph
over static input buffers and replayed, the hierarchical search then
choosing its arm on the device.  The graph is kept for the
registration, or, inside ``graph_scope``, for the scope's owner (a
sequence, a stream, a chunked run, a server, a measurement), one per
shape it meets: a later registration of the same shapes copies its
inputs in and replays it.
The sharded arm (``parallel/icp.py``) runs the same chunks with its
collectives inside: captured under NCCL, whose collectives a CUDA graph
records.  ``verbose=True`` (the reference prints each iteration's
error), ``device_loop.CUDA_GRAPHS = False`` (the eager baseline of a
measurement) and an arm that cannot be captured (``Arm.capturable``
False: the sharded arm under gloo, which stages each collective through
the host) run eager chunks of one iteration, the search reading its arm
on the host; so does the CPU, at ``LOOP_CHUNK``
(``device_loop.chunk_policy``).  Whatever the chunk, the result is the
one-iteration loop's, bit for bit.

``icp_register_chunked`` runs the loop a chunk of iterations at a time
along the same trajectory, and checkpoints each boundary to disk when
asked (``harness/checkpoint.py``); ``icp_register_prealigned`` seeds it
with one NICP shot.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from tpuslam_torch.algorithms.device_loop import (
    chunk_policy,
    graph_scope,
    keep,
    run_chunks,
    signature,
)
from tpuslam_torch.core import choices
from tpuslam_torch.core.spans import span
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform, round_up
from tpuslam_torch.ops.geometry import matmul3, matvec3, transform_points
from tpuslam_torch.ops.nn import nearest_neighbors, nearest_neighbors_batch
from tpuslam_torch.ops.nn_hier import (
    MAX_ROWS,
    HierState,
    HierTarget,
    _coarse_tile_rows,
    auto_tile_params,
    hier_state_init,
    nearest_neighbors_hier,
    nearest_neighbors_hier_batch,
    prepare_hier_target,
)
from tpuslam_torch.ops.procrustes import mean_sq_error, weighted_procrustes
from tpuslam_torch.ops.spatial import morton_permutation

FLT_MAX = 3.4028235e38
# target rows from which use_spatial=None takes the hierarchical arm on
# CUDA: the JAX package's crossover, measured on a TPU v5e
SPATIAL_MIN_ROWS = 8192
INT32_MAX = 2**31 - 1


def full_f32(x: float, device, shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """``x`` rounded to float32 on the host (as ``torch.tensor`` rounds it:
    ``FLT_MAX`` as a double lies just above float32's largest value) and
    filled on the device: no blocking host-to-device copy."""
    return torch.full(shape, float(torch.tensor(x, dtype=torch.float32)),
                      dtype=torch.float32, device=device)


class ICPState(NamedTuple):
    """The loop carry, all on the device (in the batched loop of
    ``algorithms/batch.py`` every field has a leading pair axis).  A
    caller may give ``iterations`` as an int; the loop holds it as an
    i32 tensor."""

    rotation: torch.Tensor  # f32[3,3]
    translation: torch.Tensor  # f32[3]
    error: torch.Tensor  # f32[]
    prev_error: torch.Tensor  # f32[]
    iterations: Any  # i32[] (or an int before the loop)
    done: torch.Tensor  # bool[]
    # hierarchical-NN carry (spatial arm only; None on the dense arm)
    nn: Optional[HierState] = None


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


class Arm(NamedTuple):
    """A correspondence arm of the loop: the tensors it reads and two
    functions of them alone, ``run_nn(inputs, transformed, state)`` ->
    (idx, dist, nn state) and ``gather(inputs, idx, nn state)`` -> matched
    target points.  ``key`` names the functions and their static settings
    for the CUDA-graph cache (for the sharded arm, its process group too).
    An arm that is not ``capturable`` (the sharded arm under gloo) runs
    eager chunks of one iteration on CUDA."""

    inputs: Tuple[torch.Tensor, ...]
    run_nn: Callable
    gather: Callable
    key: tuple
    capturable: bool = True


def hier_arm(src_mask: torch.Tensor, target: HierTarget, l_budget: int, g: int,
             gsrc: int) -> Arm:
    """The hierarchical arm on Morton-sorted sources; with a leading pair
    axis on ``src_mask`` and every leaf of ``target``, its batch form."""
    batched = src_mask.dim() == 2
    query = nearest_neighbors_hier_batch if batched else nearest_neighbors_hier

    def run_nn(inputs, transformed, s: ICPState):
        return query(transformed, inputs[0], HierTarget(*inputs[1:]), s.nn,
                     l_budget=l_budget, g=g, gsrc=gsrc)

    def gather(inputs, idx, nn_state):
        # the hier state already holds original_points[idx]
        return nn_state.prev_target

    return Arm((src_mask, *target), run_nn, gather, ("hier", batched, l_budget, g, gsrc))


def dense_arm(points: torch.Tensor, count: torch.Tensor) -> Arm:
    """The dense arm (K1) on the target ``points`` f32[M, 3] and its
    ``count``; with a leading pair axis, its batch form."""
    if points.dim() == 3:
        def run_nn(inputs, transformed, s: ICPState):
            idx, dist = nearest_neighbors_batch(transformed, inputs[0], inputs[1])
            return idx, dist, s.nn

        def gather(inputs, idx, nn_state):
            return torch.take_along_dim(inputs[0], idx.long()[..., None], dim=1)

        return Arm((points, count), run_nn, gather, ("dense", True))

    def run_nn(inputs, transformed, s: ICPState):
        idx, dist = nearest_neighbors(transformed, inputs[0], inputs[1])
        return idx, dist, s.nn

    def gather(inputs, idx, nn_state):
        return inputs[0].index_select(0, idx)

    return Arm((points, count), run_nn, gather, ("dense", False))


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
    pair's rows (Procrustes, the error) run in an order that does not
    depend on it (kernel P on CUDA, pair by pair on the CPU)."""
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
    err = mean_sq_error(diff, w, n_corr)

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


class _Carry(NamedTuple):
    """What a chunk carries: the loop state and, with ``patience``, the
    best-so-far transform, its error and the non-improving streak."""

    s: ICPState
    best_r: Optional[torch.Tensor] = None
    best_t: Optional[torch.Tensor] = None
    best_e: Optional[torch.Tensor] = None
    streak: Optional[torch.Tensor] = None


def _running(c: _Carry, cap: torch.Tensor, patience: torch.Tensor, has_patience: bool):
    """The JAX loop's ``cond``: not done, under the cap, within patience."""
    go = torch.logical_not(c.s.done) & (c.s.iterations < cap)
    if has_patience:
        go = go & (c.streak < patience)
    return go


def _chunk(step: Callable, k: int, has_patience: bool, inputs: tuple, c: _Carry):
    """``k`` iterations of the loop on the device, each frozen where the
    loop has stopped, with no host read.  Returns the carry, the loop's
    own status (stopped; the iteration count or counts) and each
    iteration's error; each query's arm goes to the open recording of
    ``core/choices.py``, marked with whether its iteration ran."""
    cap, patience = inputs[4], inputs[5]
    errs = []
    for _ in range(k):
        go = _running(c, cap, patience, has_patience)
        new, err = step(inputs, c.s)
        # the reference increments only when the loop continues
        new = new._replace(iterations=torch.where(new.done, c.s.iterations,
                                                  c.s.iterations + 1))
        best = c[1:]
        if has_patience:
            improved = new.error < c.best_e
            better = go & improved
            best = (keep(better, new.rotation, c.best_r),
                    keep(better, new.translation, c.best_t),
                    keep(better, new.error, c.best_e),
                    torch.where(go, torch.where(improved, 0, c.streak + 1), c.streak))
        c = _Carry(keep(go, new, c.s), *best)
        choices.ran(go if go.dim() == 0 else go.any())
        errs.append(err)
    stopped = torch.logical_not(_running(c, cap, patience, has_patience).any())
    own = [stopped.to(torch.int32).reshape(1), c.s.iterations.to(torch.int32).reshape(-1)]
    return c, own, errs


def _icp_loop(
    src_points: torch.Tensor,
    src_mask: torch.Tensor,
    arm: Arm,
    eps: torch.Tensor,
    max_d2: torch.Tensor,
    max_iterations: int,
    divergence_guard: bool,
    verbose: bool,
    iter_offset: int,
    init: ICPState,
    patience: int,
) -> RegistrationResult:
    """The whole registration loop after input preparation; ``arm`` is
    the correspondence arm.  With a leading pair axis on every tensor
    (``algorithms/batch.py``) each pair runs its own loop and ``iterations``
    comes back as an i32[B] tensor.

    On CUDA a chunk of ``LOOP_CHUNK`` iterations is captured as a CUDA
    graph (after one eager chunk, its warm-up) and replayed, from the open
    ``graph_scope`` where it holds the shape; a failed capture raises.
    Eager chunks otherwise (``device_loop.chunk_policy``; an arm that
    cannot be captured runs them on CUDA too).  An iteration frozen past
    the stop still runs its query, collectives included: every rank of a
    sharded loop freezes on the same replicated values, so the ranks'
    collectives stay matched."""
    device = src_points.device
    batch = tuple(init.done.shape)
    use_graph, k = chunk_policy(device, verbose, arm.capturable)
    has_patience = patience > 0

    def full(value, dtype, shape=()):
        # filled on the device: no blocking host-to-device copy
        return torch.full(shape, value, dtype=dtype, device=device)

    iterations = init.iterations
    if not isinstance(iterations, torch.Tensor):
        iterations = full(int(iterations), torch.int32, batch)
    c = _Carry(init._replace(iterations=iterations.to(torch.int32)))
    if has_patience:
        c = c._replace(best_r=init.rotation, best_t=init.translation,
                       best_e=full_f32(FLT_MAX, device), streak=full(0, torch.int32))
    cap = full(INT32_MAX if max_iterations == -1 else int(max_iterations), torch.int32)
    inputs = (src_points, src_mask, eps, max_d2, cap, full(int(patience), torch.int32),
              *arm.inputs)
    arm_inputs = len(inputs) - len(arm.inputs)

    def step(inp, s: ICPState):
        own = inp[arm_inputs:]
        return _icp_step(
            s, inp[0], inp[1],
            lambda transformed, st: arm.run_nn(own, transformed, st),
            lambda idx, nn_state: arm.gather(own, idx, nn_state),
            inp[2], inp[3], divergence_guard,
        )

    def fn(inp, carry):
        return _chunk(step, k, has_patience, inp, carry)

    counts = [0]
    if max_iterations != 0:
        key = (arm.key, divergence_guard, has_patience, k, str(device),
               tuple(signature(t) for t in inputs), signature(c))
        it_before = [0]

        def read(own, errs):
            counts[:] = own[1:]
            if verbose:
                # the reference's per-iteration printf (basicicp.cpp:50)
                print(f"loop_nr {it_before[0] + 1 + iter_offset}, error: {float(errs[0])}")
                it_before[0] = counts[0]
            return bool(own[0])

        c = run_chunks(lambda: key, lambda _: fn, inputs, c, read, use_graph)
    s = c.s
    iters = s.iterations if batch else counts[0]
    one = torch.ones(batch, dtype=torch.float32, device=device)
    if has_patience:
        # zero evaluated iterations: report the carried-in error
        never_evaluated = c.best_e >= FLT_MAX
        return RegistrationResult(
            transform=RigidTransform(c.best_r, c.best_t, one),
            iterations=iters,
            error=torch.where(never_evaluated, init.error, c.best_e),
            nn=s.nn,
        )
    return RegistrationResult(
        transform=RigidTransform(s.rotation, s.translation, one),
        iterations=iters,
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
    ``patience`` consecutive non-improving iterations.  The loop runs
    ``device_loop.LOOP_CHUNK`` iterations between host reads, which changes no bit of
    the result (module docstring; ``graph_scope`` keeps its CUDA graph
    for later registrations of the same shapes).  The set-up before the
    loop is the ``tpuslam.entry.prepare`` span (``core/spans.py``)."""
    with span("tpuslam.entry.prepare"):
        if before.points.device != after.points.device:
            raise ValueError(
                f"before lies on {before.points.device}, after on "
                f"{after.points.device}: register them on one device"
            )
        device = before.points.device

        def f32(x):
            if isinstance(x, (int, float)):
                return full_f32(x, device)
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        if resolve_use_spatial(use_spatial, after.points.shape[0], device):
            setup = prepare_spatial(before, after)
            src_points, src_mask = setup.src_points, setup.src_mask
            arm = hier_arm(src_mask, setup.target, setup.l_budget, setup.g, setup.gsrc)
            if resume is not None and resume.nn is not None:
                nn_init = HierState(*(t.to(device) for t in resume.nn))
            else:
                nn_init = hier_state_init(src_points.shape[0], device)
        else:
            src_points, src_mask = before.points, before.mask()
            arm = dense_arm(after.points, after.count)
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
        eps_t, max_d2_t = f32(eps), f32(max_distance_squared)
    return _icp_loop(
        src_points, src_mask, arm, eps_t, max_d2_t, int(max_iterations),
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
    # the chunks share their shapes: one CUDA graph of the loop serves them
    with graph_scope():
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
            error=full_f32(1e5, device),
            prev_error=full_f32(FLT_MAX, device),
        )
    common = dict(eps=eps, max_distance_squared=max_distance_squared,
                  max_iterations=max_iterations, resume=resume, **kwargs)
    if chunk or checkpoint_path:
        return icp_register_chunked(
            before, after, chunk=chunk or 10, checkpoint_path=checkpoint_path,
            checkpoint_extra_meta=extra_meta, **common,
        )
    return icp_register(before, after, **common)
