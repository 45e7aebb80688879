"""Sequential scan registration (odometry): align a stream of clouds pair
by pair and compose absolute poses (port of
``tpuslam/algorithms/sequence.py``).

Pair k registers scan k onto scan k+1; ``relative[k]`` maps scan k into
scan k+1's frame (the reference's ``before -> after`` direction).  The
absolute poses compose on the host in float32 numpy, as in the JAX
package: ``T_{k+1} = T_k ∘ rel_k^-1``, so ``absolute[k]`` maps scan k
into scan 0's frame.

Three lowerings of ``register_sequence``, each held to its JAX twin:

* **scan** (the default): every cloud is padded to one size (on the
  hierarchical arm rounded to ``max(gsrc, g, coarse tile)``, since each
  cloud is the source of one pair and the target of another),
  Morton-sorted once on the host (``ops/spatial.py::host_morton_order``,
  invalid rows last), moved to the device once, and on the hierarchical
  arm prepared once as a target (``prepare_hier_target(presorted=True)``);
  the same sorted rows serve as source of pair k and target of pair k-1.
  Each pair runs ``icp._icp_loop`` from the previous pair's relative
  transform (a constant-velocity prior) kept on the device; the pairs
  share one shape, so on CUDA they replay one captured graph of the
  loop's chunk (``icp.graph_scope``, held by the call or the stream),
  each pair's scans copied into its buffers.  With
  ``seed_with_previous`` every pair, pair 0 included, runs the
  best-so-far loop with ``patience = SEED_PATIENCE`` and the divergence
  guard off; without it every pair starts from the identity with
  patience 0 and the guard on.  The JAX package runs these pairs as one
  ``lax.scan`` program per ``pairs_per_dispatch`` pairs; the port has no
  program to bound, so it takes ``pairs_per_dispatch`` and ignores it,
  which changes no result, as it changes none in JAX.
* **per pair** (``scan=False``): ``icp_register`` pair by pair.  Pair 0
  starts cold with the guard on and patience 0; seeded pairs resume from
  the previous relative transform (``ICPResume`` with error 1e5 and the
  guard seed FLT_MAX, on the device) with the guard off and patience 8.
  It is not bit-equal to the scan lowering, in either package: pair 0's
  semantics differ, and ``icp_register`` sorts on the device.
* **batch** (``batch=True``): ``icp_register_batch`` over (clouds[:-1],
  clouds[1:]), without seeding.

``SequenceStream`` is the scan lowering one scan at a time: each pushed
scan is staged once (sorted, moved, prepared), registered as the target
of one pair and kept as the source of the next.  Its patience is fixed
when it is made (``SEED_PATIENCE`` by default, the guard off), so the
first push, unseeded, still runs the best-so-far loop: that is the JAX
stream's first push too (its ``seeded`` flag starts that push from the
identity, which the carried seed already is).  The seed stays on the
device; each push reads its relative transform back to compose the pose.

Host reads: each ICP iteration reads its stop flags back once, and the
hierarchical search its overflow flags once per query (``icp.py``,
``ops/nn_hier.py``); the drivers here add one read per push, and one per
sequence of the stacked relative transforms.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuslam_torch.algorithms.icp import (
    FLT_MAX,
    ICPResume,
    ICPState,
    _icp_loop,
    dense_arm,
    graph_scope,
    hier_arm,
    icp_register,
    resolve_use_spatial,
)
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.types import Cloud, RegistrationResult, RigidTransform, pad_cloud, round_up
from tpuslam_torch.ops.nn_hier import (
    HierTarget,
    _coarse_tile_rows,
    auto_tile_params,
    hier_state_init,
    prepare_hier_target,
)
from tpuslam_torch.ops.spatial import host_morton_order

# patience of seeded pairs (scan and per-pair lowerings, and the stream):
# a warm start begins near the optimum, where the error fluctuates, and
# the reference's stop-on-first-increase guard would stop it on noise;
# the JAX package's value, swept on a TPU
SEED_PATIENCE = 8


class SequenceResult(NamedTuple):
    """Per-pair relative transforms and composed absolute poses, as host
    numpy arrays in ``RigidTransform``s (scale 1).

    ``relative``: K transforms, scan k -> scan k+1's frame.
    ``absolute``: K+1 poses, scan k -> scan 0's frame (pose 0 the identity).
    ``iterations`` i32[K] and ``errors`` f32[K]: each pair's diagnostics."""

    relative: List[RigidTransform]
    absolute: List[RigidTransform]
    iterations: np.ndarray
    errors: np.ndarray


def _host_transform(rotation, translation) -> RigidTransform:
    return RigidTransform(rotation=np.asarray(rotation, np.float32),
                          translation=np.asarray(translation, np.float32),
                          scale=np.float32(1.0))


def _identity() -> RigidTransform:
    return _host_transform(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


def _compose(a: RigidTransform, b: RigidTransform) -> RigidTransform:
    """a ∘ b (apply b, then a), float32 numpy, unit scale."""
    return _host_transform(a.rotation @ b.rotation, a.rotation @ b.translation + a.translation)


def _invert(t: RigidTransform) -> RigidTransform:
    rt = t.rotation.T
    return _host_transform(rt, -(rt @ t.translation))


def _host_points(cloud) -> np.ndarray:
    """A scan as host ``f32[N, 3]``: a numpy array, a tensor, or a port
    ``Cloud`` (its valid rows)."""
    if isinstance(cloud, Cloud):
        cloud = cloud.points[: int(cloud.count)]
    if isinstance(cloud, torch.Tensor):
        cloud = cloud.detach().cpu().numpy()
    return np.asarray(cloud, np.float32)


class _Staging(NamedTuple):
    """How the scans of one sequence are padded and searched."""

    npad: int
    use_spatial: bool
    tiles: Tuple[int, int, int]  # (g, gsrc, l_budget) of the hierarchical arm
    device: torch.device


def _staging(npad: int, use_spatial: Optional[bool], device: torch.device) -> _Staging:
    """Resolve the arm for ``npad`` target rows; on the hierarchical arm
    round ``npad`` so that a scan fits both roles (the sources' ``gsrc``
    groups and the target's fine and coarse tiles), with the tile
    parameters of the unrounded size, as the JAX package does."""
    if not resolve_use_spatial(use_spatial, npad, device):
        return _Staging(npad, False, (0, 0, 0), device)
    g, gsrc, l_budget = auto_tile_params(npad)
    npad = round_up(npad, max(gsrc, g, _coarse_tile_rows(g, gsrc) or g))
    return _Staging(npad, True, (g, gsrc, l_budget), device)


def _pad_sorted(a: np.ndarray, st: _Staging) -> np.ndarray:
    """Pad one scan to ``st.npad`` rows; on the hierarchical arm sort it
    into Morton order, invalid rows last, so that a count-prefix mask
    holds on the sorted rows."""
    if len(a) > st.npad:
        raise ValueError(f"scan has {len(a)} points > max_points={st.npad}")
    padded = np.zeros((st.npad, 3), np.float32)
    padded[: len(a)] = a
    if st.use_spatial:
        padded = padded[host_morton_order(padded, len(a))]
    return padded


class _Scan(NamedTuple):
    """One scan on the device, staged once for both of its roles."""

    points: torch.Tensor  # f32[npad, 3], Morton-sorted on the hierarchical arm
    count: torch.Tensor  # i32[]
    mask: torch.Tensor  # f32[npad]
    target: Optional[HierTarget]  # its hierarchical target state (None: dense arm)


def _to_device(padded: np.ndarray, count: int, st: _Staging, prepare: bool) -> _Scan:
    points = torch.from_numpy(padded).to(st.device)
    # torch.full fills on the device: no blocking host-to-device copy
    count_t = torch.full((), count, dtype=torch.int32, device=st.device)
    mask = (torch.arange(st.npad, device=st.device) < count_t).to(torch.float32)
    target = None
    if st.use_spatial and prepare:
        target = prepare_hier_target(points, mask, count_t, g=st.tiles[0], presorted=True)
    return _Scan(points, count_t, mask, target)


def _register_pair(src: _Scan, tgt: _Scan, seed_r: torch.Tensor, seed_t: torch.Tensor,
                   eps: float, max_distance_squared: float, max_iterations: int,
                   patience: int, st: _Staging) -> RegistrationResult:
    """One pair of the scan lowering: ``_icp_loop`` from the seed, the
    guard on exactly when ``patience`` is 0."""
    device = st.device

    def f32(x):
        # rounded to float32 on the host (as torch.tensor rounds it), then
        # filled on the device: no blocking host-to-device copy
        return torch.full((), float(np.float32(x)), dtype=torch.float32, device=device)

    if st.use_spatial:
        g, gsrc, l_budget = st.tiles
        # the hier state holds the matched (sorted) target rows
        arm = hier_arm(src.mask, tgt.target, l_budget, g, gsrc)
        nn_init = hier_state_init(src.points.shape[0], device)
    else:
        arm = dense_arm(tgt.points, tgt.count)
        nn_init = None
    init = ICPState(
        rotation=seed_r,
        translation=seed_t,
        error=f32(1e5),  # reporting init, basicicp.cpp:26
        prev_error=f32(FLT_MAX),
        iterations=0,
        done=torch.zeros((), dtype=torch.bool, device=device),
        nn=nn_init,
    )
    return _icp_loop(src.points, src.mask, arm, f32(eps),
                     f32(max_distance_squared), int(max_iterations),
                     divergence_guard=patience == 0, verbose=False, iter_offset=0,
                     init=init, patience=patience)


def _register_sequence_scanned(
    arrs: List[np.ndarray],
    st: _Staging,
    eps: float,
    max_distance_squared: float,
    max_iterations: int,
    seed_with_previous: bool,
    patience: Optional[int],
):
    """The scan lowering (module docstring): stage every scan once, then
    register the pairs in order with the seed carried on the device."""
    if patience is None:
        patience = SEED_PATIENCE if seed_with_previous else 0
    # the host sorts run in threads (numpy's argsort releases the GIL)
    with ThreadPoolExecutor(max_workers=min(8, len(arrs))) as pool:
        padded = list(pool.map(lambda a: _pad_sorted(a, st), arrs))
    scans = [_to_device(p, len(a), st, prepare=k > 0)
             for k, (p, a) in enumerate(zip(padded, arrs))]
    eye = torch.eye(3, dtype=torch.float32, device=st.device)
    zero = torch.zeros(3, dtype=torch.float32, device=st.device)
    seed_r, seed_t = eye, zero
    rots, trs, iters, errs = [], [], [], []
    for k in range(len(scans) - 1):
        res = _register_pair(scans[k], scans[k + 1], seed_r, seed_t, eps, max_distance_squared,
                             max_iterations, patience, st)
        if seed_with_previous:
            seed_r, seed_t = res.transform.rotation, res.transform.translation
        rots.append(res.transform.rotation)
        trs.append(res.transform.translation)
        iters.append(res.iterations)
        errs.append(res.error)
    return rots, trs, iters, errs


class SequenceStream:
    """Incremental odometry (port of the JAX package's ``SequenceStream``):
    push scans one at a time as a sensor delivers them; each ``push``
    registers the previous scan onto the new one, seeded with the previous
    relative motion, returns the relative transform and appends the
    composed absolute pose to ``absolute``.

    Each scan is staged once (module docstring).  Every scan must fit one
    padded size, ``max_points`` (default: the first scan's size, rounded
    to 128 rows); a larger one raises ``ValueError``.  ``device`` as
    ``core.device.resolve_device``: None is the card, and raises where
    there is none."""

    def __init__(
        self,
        first_scan,
        eps: float = 1e-3,
        max_distance_squared: float = 1000.0,
        max_iterations: int = 50,
        patience: Optional[int] = None,
        use_spatial: Optional[bool] = None,
        max_points: Optional[int] = None,
        device: Optional[torch.device | str] = None,
    ):
        a = _host_points(first_scan)
        npad = round_up(max(max_points or len(a), len(a), 1), 128)
        self._st = _staging(npad, use_spatial, resolve_device(device))
        self._eps = eps
        self._max_d2 = max_distance_squared
        self._max_it = max_iterations
        self._patience = SEED_PATIENCE if patience is None else int(patience)
        self._rel_r = torch.eye(3, dtype=torch.float32, device=self._st.device)
        self._rel_t = torch.zeros(3, dtype=torch.float32, device=self._st.device)
        self.absolute: List[RigidTransform] = [_identity()]
        self._prev = _to_device(_pad_sorted(a, self._st), len(a), self._st, prepare=False)
        # the CUDA graph of the loop that every push replays (icp.graph_scope)
        self._graphs: dict = {}

    def push(self, scan) -> RigidTransform:
        """Register the previous scan onto ``scan``; returns the relative
        transform (host arrays) and appends the composed absolute pose."""
        a = _host_points(scan)
        new = _to_device(_pad_sorted(a, self._st), len(a), self._st, prepare=True)
        with graph_scope(self._graphs):
            res = _register_pair(self._prev, new, self._rel_r, self._rel_t, self._eps,
                                 self._max_d2, self._max_it, self._patience, self._st)
        # the seed stays on the device; only the pose's inputs go to the host
        self._rel_r, self._rel_t = res.transform.rotation, res.transform.translation
        self._prev = new
        rt = torch.cat([self._rel_r.reshape(-1), self._rel_t]).cpu().numpy()
        rel = _host_transform(rt[:9].reshape(3, 3), rt[9:])
        self.absolute.append(_compose(self.absolute[-1], _invert(rel)))
        return rel


def register_sequence(
    clouds: Sequence,
    eps: float = 1e-3,
    max_distance_squared: float = 1000.0,
    max_iterations: int = 50,
    seed_with_previous: bool = True,
    batch: bool = False,
    scan: Optional[bool] = None,
    use_spatial: Optional[bool] = None,
    patience: Optional[int] = None,
    pairs_per_dispatch: Optional[int] = None,
    device: Optional[torch.device | str] = None,
) -> SequenceResult:
    """Register ``clouds[k] -> clouds[k+1]`` for every consecutive pair and
    compose the absolute trajectory.  Clouds are host arrays, tensors or
    port ``Cloud``s of possibly different sizes, all padded to one size.

    ``scan`` (None: on unless ``batch``) picks the scan lowering, else the
    per-pair one; ``batch`` the batch lowering (module docstring).
    ``patience`` overrides the seeded best-so-far window (None:
    ``SEED_PATIENCE`` when seeded, 0 and the guard on when not; the
    per-pair lowering's pair 0 always runs cold).  ``pairs_per_dispatch``
    is accepted and ignored (module docstring).  ``device`` as
    ``core.device.resolve_device``: None is the card, and raises where
    there is none."""
    del pairs_per_dispatch
    if len(clouds) < 2:
        raise ValueError("register_sequence needs at least two clouds")
    device = resolve_device(device)
    arrs = [_host_points(c) for c in clouds]
    npad = max(round_up(max(len(a), 1), 128) for a in arrs)

    # the pairs share one shape: one CUDA graph of the loop serves them all
    with graph_scope():
        if batch:
            from tpuslam_torch.algorithms.batch import icp_register_batch, stack_clouds

            out = icp_register_batch(
                stack_clouds(arrs[:-1], multiple=npad, device=device),
                stack_clouds(arrs[1:], multiple=npad, device=device),
                eps=eps, max_distance_squared=max_distance_squared,
                max_iterations=max_iterations, use_spatial=use_spatial,
            )
            rots, trs = out.transform.rotation, out.transform.translation
            iters, errs = out.iterations, out.error
        elif scan or scan is None:
            rots, trs, iters, errs = _register_sequence_scanned(
                arrs, _staging(npad, use_spatial, device), eps, max_distance_squared,
                max_iterations, seed_with_previous, patience)
        else:
            padded = [pad_cloud(a, multiple=npad, device=device) for a in arrs]
            if patience is None:
                patience = SEED_PATIENCE
            rots, trs, iters, errs = [], [], [], []
            for k in range(len(arrs) - 1):
                resume = None
                if seed_with_previous and k > 0:
                    # the constant-velocity prior, handed over on the device
                    resume = ICPResume(
                        rotation=rots[-1],
                        translation=trs[-1],
                        error=torch.tensor(1e5, dtype=torch.float32, device=device),
                        prev_error=torch.tensor(FLT_MAX, dtype=torch.float32, device=device),
                    )
                res = icp_register(
                    padded[k], padded[k + 1], eps=eps, max_distance_squared=max_distance_squared,
                    max_iterations=max_iterations, use_spatial=use_spatial, resume=resume,
                    divergence_guard=resume is None, patience=0 if resume is None else patience,
                )
                rots.append(res.transform.rotation)
                trs.append(res.transform.translation)
                iters.append(res.iterations)
                errs.append(res.error)

    # one read back of every pair's transform and error
    n_pairs = len(arrs) - 1
    host = torch.cat([torch.stack(list(rots)).reshape(n_pairs, 9),
                      torch.stack(list(trs)), torch.stack(list(errs))[:, None]],
                     dim=1).cpu().numpy()
    rels = [_host_transform(row[:9].reshape(3, 3), row[9:12]) for row in host]
    absolute = [_identity()]
    for rel in rels:
        # x_{k+1} = rel_k(x_k), so T_{k+1} = T_k ∘ rel_k^-1
        absolute.append(_compose(absolute[-1], _invert(rel)))
    return SequenceResult(
        relative=rels,
        absolute=absolute,
        iterations=np.asarray(torch.as_tensor(iters).cpu(), np.int32).reshape(n_pairs),
        errors=host[:, 12].astype(np.float32),
    )
