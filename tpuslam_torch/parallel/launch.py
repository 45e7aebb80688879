"""Start a world of ranks on this host (no JAX original: the JAX package
runs its mesh in one process, ``torch.distributed`` needs a process a
rank).

``run_world(entry, world_size, backend, device, timeout, *args)`` spawns
``world_size`` processes (``torch.multiprocessing``, the spawn method:
CUDA cannot be forked), joins them by a ``file://`` rendezvous in a
fresh temporary directory, calls ``entry(mesh, *args)`` on every rank
and returns rank 0's result and every rank's.  ``entry`` is a function
of ``tpuslam_torch.parallel``, so the children import torch and the port
only.  The kernel library is built in the parent first (each rank only
loads it).  If a rank raises, the parent raises with that rank's
traceback as soon as it arrives and stops the other ranks; a rank that
dies without a word is reported by its exit code.  The process-group
``timeout`` turns a collective that waits for a stopped rank into an
error.

``run_cases`` is such an entry: a list of ``(kind, kwargs)`` cases run
in order on every rank, host arrays in and host arrays out
(``CASES``), each with the rank's kernel launches, K5's routes, its
collectives (``collectives.collective_log``) and the seconds the
registration itself took.  The cases share one ``graph_scope``, so a
case that repeats an earlier one's shapes replays the sharded loop's
kept CUDA graph (under NCCL).  It is how the tests, the smoke run and
``harness/scaling_bench.py`` drive the sharded layer.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.parallel.distributed import DEFAULT_TIMEOUT_S


def _rank_main(rank, world_size, backend, init_method, device, timeout, entry, args, out):
    """A rank's process: join the world, run ``entry``, post the result
    (or the traceback) to ``out``."""
    import torch.distributed as dist

    from tpuslam_torch.parallel.distributed import initialize
    from tpuslam_torch.parallel.mesh import make_mesh

    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        initialize(backend=backend, init_method=init_method, world_size=world_size,
                   rank=rank, timeout=timeout)
        result = entry(make_mesh(device), *args)
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def run_world(
    entry: Callable,
    world_size: int,
    backend: str,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
    *args,
) -> Tuple[object, List[object]]:
    """Run ``entry(mesh, *args)`` on ``world_size`` spawned ranks joined
    under ``backend`` (given explicitly: ``distributed.resolve_backend``)
    on ``device`` (None: the card, ``mesh.make_mesh``), with a
    process-group ``timeout`` in seconds.  Returns (rank 0's result,
    [every rank's result]).  Raises ``RuntimeError`` with a failing
    rank's traceback."""
    if not getattr(entry, "__module__", "").startswith("tpuslam_torch.parallel"):
        raise ValueError(f"entry must be a function of tpuslam_torch.parallel, got "
                         f"{getattr(entry, '__module__', None)}.{getattr(entry, '__name__', entry)}")
    if device is not None and torch.device(device).type == "cuda":
        from tpuslam_torch.kernels.build import build

        build()  # once, here: the ranks only load the library
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="tpuslam_world_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(rank, world_size, backend, init_method,
                          None if device is None else str(device), timeout, entry, args, out))
        for rank in range(world_size)
    ]
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            try:
                rank, ok, payload = out.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "before posting a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(60)
    finally:
        _stop(procs)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    ordered = [results[r] for r in range(world_size)]
    return ordered[0], ordered


# --- run_cases: host arrays in, host arrays out ------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# the open case's synchronising calls, where it asked for them (``syncs``)
_SYNCS: Optional[dict] = None


def _timed(mesh, fn):
    """``fn()`` and its seconds on the host's clock, the card synchronised
    on both sides; in a case that asked for its synchronising calls, on
    the card, counted inside (``benchkit.count_syncs``)."""
    _sync(mesh.device)
    t0 = time.perf_counter()
    if _SYNCS is not None and mesh.device.type == "cuda":
        from tpuslam_torch.harness.benchkit import count_syncs

        res, count, sites = count_syncs(fn)
        _SYNCS.update(count=count, sites=sites)
    else:
        res = fn()
    _sync(mesh.device)
    return res, time.perf_counter() - t0


def _result(res, seconds: float) -> dict:
    out = {
        "rotation": _np(res.transform.rotation),
        "translation": _np(res.transform.translation),
        "scale": _np(res.transform.scale),
        "iterations": _np(res.iterations),
        "error": _np(res.error),
        "seconds": seconds,
    }
    if res.em is not None:
        out["em"] = {f: _np(getattr(res.em, f)) for f in
                     ("rotation", "translation", "scale", "sigma2", "log_likelihood", "ntol")}
    return out


def _case_nn(mesh, src, tgt) -> dict:
    from tpuslam_torch.parallel.mesh import shard_cloud
    from tpuslam_torch.parallel.nn import sharded_nn_combine

    after = shard_cloud(tgt, mesh)
    s = torch.from_numpy(np.asarray(src, np.float32)).to(mesh.device)
    (gidx, dist, matched), seconds = _timed(mesh, lambda: sharded_nn_combine(s, after, mesh))
    return {"index": _np(gidx), "dist": _np(dist), "matched": _np(matched), "seconds": seconds}


def _case_icp(mesh, before, after, chunk: int = 0, prealign: bool = False,
              final_nn: bool = False, resume: Optional[dict] = None, **kw) -> dict:
    """Sharded ICP: cold, chunked (from ``resume``, a numpy ICPResume, if
    given) or prealigned; ``final_nn`` also returns, at the final
    transform, the arm's sources (its padding and order) with their
    sharded nearest neighbours."""
    from tpuslam_torch.interop import from_numpy_state
    from tpuslam_torch.ops.geometry import transform_points
    from tpuslam_torch.parallel import icp
    from tpuslam_torch.parallel.mesh import replicate_cloud, shard_cloud

    b, a = replicate_cloud(before, mesh), shard_cloud(after, mesh)
    if prealign:
        res, seconds = _timed(mesh, lambda: icp.icp_register_sharded_prealigned(b, a, mesh, **kw))
        return _result(res, seconds)
    if chunk:
        start = None if resume is None else from_numpy_state(resume, mesh.device)
        res, seconds = _timed(mesh, lambda: icp.icp_register_sharded_chunked(
            b, a, mesh, chunk=chunk, resume=start, **kw))
        return _result(res, seconds)
    arm = icp.sharded_arm(b, a, mesh, bool(kw.pop("use_spatial", False)))
    res, seconds = _timed(mesh, lambda: icp.register_on_arm(arm, **kw))
    out = _result(res, seconds)
    if final_nn:
        moved = transform_points(arm.src_points, res.transform.rotation,
                                 res.transform.translation)
        gidx, dist, _ = arm.query(moved, res.nn)
        out.update(final_src=_np(moved), final_mask=_np(arm.src_mask),
                   final_index=_np(gidx), final_dist=_np(dist))
    return out


def _case_nicp(mesh, before, after, **kw) -> dict:
    from tpuslam_torch.parallel.mesh import replicate_cloud, shard_cloud
    from tpuslam_torch.parallel.nicp import nicp_register_sharded

    b, a = replicate_cloud(before, mesh), shard_cloud(after, mesh)
    res, seconds = _timed(mesh, lambda: nicp_register_sharded(b, a, mesh, **kw))
    return _result(res, seconds)


def _case_cpd(mesh, before, after, chunk: int = 0, resume: Optional[dict] = None,
              **kw) -> dict:
    """Sharded CPD, whole or chunked (from ``resume``, a numpy CPDResume,
    if given)."""
    from tpuslam_torch.interop import from_numpy_state
    from tpuslam_torch.parallel import cpd
    from tpuslam_torch.parallel.mesh import replicate_cloud, shard_cloud

    b, a = replicate_cloud(before, mesh), shard_cloud(after, mesh)
    if chunk:
        start = None if resume is None else from_numpy_state(resume, mesh.device)
        res, seconds = _timed(mesh, lambda: cpd.cpd_register_sharded_chunked(
            b, a, mesh, chunk=chunk, resume=start, **kw))
    else:
        res, seconds = _timed(mesh, lambda: cpd.cpd_register_sharded(b, a, mesh, **kw))
    return _result(res, seconds)


def _case_estep(mesh, moving, target, sigma2, constant, trunc: bool) -> dict:
    """The reduced statistics of one sharded exact (``trunc``: truncated)
    E-step, rows in the given order (valid moving rows all weigh 1)."""
    from tpuslam_torch.parallel.cpd import estep_sharded
    from tpuslam_torch.parallel.mesh import replicate_cloud, shard_cloud, shard_mask

    b, a = replicate_cloud(moving, mesh), shard_cloud(target, mesh)
    # a host False runs the exact E-step as the solo exact path runs it
    flag = torch.tensor(True, device=mesh.device) if trunc else False
    mo, seconds = _timed(mesh, lambda: estep_sharded(
        b.points, b.mask(), a.points, shard_mask(a, mesh), float(sigma2), float(constant),
        flag, mesh))
    out = {k: _np(v) for k, v in mo._asdict().items()}
    out["seconds"] = seconds
    return out


def _case_pairs(mesh, befores, afters, **kw) -> dict:
    from tpuslam_torch.algorithms.batch import stack_clouds
    from tpuslam_torch.parallel.batch import icp_register_pairs_sharded, shard_pairs

    sb = shard_pairs(stack_clouds(befores, device="cpu"), mesh)
    sa = shard_pairs(stack_clouds(afters, device="cpu"), mesh)
    res, seconds = _timed(mesh, lambda: icp_register_pairs_sharded(sb, sa, mesh, **kw))
    return _result(res, seconds)


def _case_fault(mesh, rank: int) -> dict:
    """Rank ``rank`` raises before its first collective while the others
    wait in a ``psum``: the launcher's hang guard."""
    from tpuslam_torch.parallel.collectives import psum

    if mesh.rank == rank:
        raise ValueError(f"fault injected on rank {rank}")
    return {"sum": _np(psum(torch.ones(1, device=mesh.device), mesh))}


def _case_modules(mesh) -> dict:
    """The top-level modules loaded in this rank's process."""
    return {"modules": sorted({m.split(".")[0] for m in sys.modules})}


CASES = {
    "nn": _case_nn,
    "icp": _case_icp,
    "nicp": _case_nicp,
    "cpd": _case_cpd,
    "estep": _case_estep,
    "pairs": _case_pairs,
    "fault": _case_fault,
    "modules": _case_modules,
}


def _reset_counts() -> None:
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.kernels import cpd_cand, reset_launch_counts

    reset_launch_counts()
    cpd_cand.ROUTE_TRACE.clear()
    cpd.PHASE_TRACE.clear()


@contextmanager
def _loop(eager: bool):
    """The sharded loops as asked: with ``eager``, the eager loop of one
    iteration a chunk on any device (no CUDA graph), the loop a captured
    or chunked run is held to."""
    from tpuslam_torch.algorithms import device_loop

    saved = device_loop.CUDA_GRAPHS, device_loop.LOOP_CHUNK
    if eager:
        device_loop.CUDA_GRAPHS, device_loop.LOOP_CHUNK = False, 1
    try:
        yield
    finally:
        device_loop.CUDA_GRAPHS, device_loop.LOOP_CHUNK = saved


def run_cases(mesh, cases) -> List[dict]:
    """Run ``cases``, a list of ``(kind, kwargs)`` of ``CASES``, in order,
    inside one ``graph_scope``; for each: ``{"result", "launches",
    "routes", "phases", "collectives", "syncs", "wall"}``, the kernel
    launch counts set to 0 just before the case and read just after,
    ``collectives`` the case's ``collectives.Collective`` records (a
    replayed graph's with NaN seconds), ``phases`` the E-step of each CPD
    iteration that ran (``cpd.PHASE_TRACE``), ``wall`` the case's start
    and end on the host's clock (epoch seconds).  Two keys of ``kwargs``
    are the runner's: ``eager=True`` runs the case on the eager
    one-iteration loop (``_loop``), and ``syncs=True`` counts its
    registration's synchronising calls on the card (``syncs``:
    ``{"count", "sites"}``; else None)."""
    global _SYNCS
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.algorithms.device_loop import graph_scope
    from tpuslam_torch.kernels import cpd_cand, launch_counts
    from tpuslam_torch.parallel.collectives import collective_log

    out = []
    with graph_scope({}):
        for kind, kwargs in cases:
            kwargs = dict(kwargs)
            eager, syncs = kwargs.pop("eager", False), kwargs.pop("syncs", False)
            _reset_counts()
            _SYNCS = {} if syncs else None
            start = time.time()
            try:
                with collective_log() as log, _loop(eager):
                    result = CASES[kind](mesh, **kwargs)
            finally:
                counted, _SYNCS = _SYNCS, None
            out.append({"result": result, "launches": launch_counts(),
                        "routes": list(cpd_cand.ROUTE_TRACE),
                        "phases": list(cpd.PHASE_TRACE),
                        "collectives": list(log), "syncs": counted or None,
                        "wall": (start, time.time())})
    return out
