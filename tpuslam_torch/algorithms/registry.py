"""Method dispatch: one registration API over all algorithms (port of
``tpuslam/algorithms/registry.py``).

``run_with_configuration(before, after, config, device=None) ->
(rotation, translation, iterations, error)`` is the reference's
``SlamFunc`` contract (``testrunner.h:8``).  ICP (cold or
NICP-prealigned), NICP and CPD are ported.  ICP's NN arm is
``icp_register``'s default: the hierarchical search on CUDA from 8,192
target rows, the dense search otherwise.  CPD's exact E-step is
``cpd_register``'s default: kernels K5 and K4 on CUDA, the blocked
oracle on the CPU.

ICP and CPD run in one piece unless the environment asks for the
chunked drivers, as in the JAX package:

* ``TPUSLAM_ICP_CHUNK`` / ``TPUSLAM_CPD_CHUNK`` = N runs N iterations a
  chunk, 0 runs whole; a malformed value prints a notice and falls back
  to the automatic gate (``icp_chunk_size``, ``cpd_chunk_size``);
* ``TPUSLAM_ICP_CKPT`` / ``TPUSLAM_CPD_CKPT`` = path forces the chunked
  driver (10 iterations a chunk unless set) and checkpoints every
  boundary there, so a killed run continues from the file.

A chunked run follows the whole run's trajectory bit for bit.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.config.configuration import ComputationMethod, Configuration
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.spans import span
from tpuslam_torch.core.types import pad_cloud

# (rotation f32[3,3], translation f32[3], iterations, error)
SlamResult = Tuple[np.ndarray, np.ndarray, int, float]
SlamFunc = Callable[[np.ndarray, np.ndarray, Configuration, torch.device], SlamResult]

_REGISTRY: Dict[ComputationMethod, SlamFunc] = {}


def register(method: ComputationMethod):
    def deco(fn: SlamFunc) -> SlamFunc:
        _REGISTRY[method] = fn
        return fn

    return deco


def get_slam_func(method: ComputationMethod) -> SlamFunc:
    if method not in _REGISTRY:
        raise KeyError(f"no implementation registered for {method}")
    return _REGISTRY[method]


def _chunk_size(chunk_env: Optional[str], var: str) -> int:
    """Iterations per chunk (0: the whole loop at once): ``chunk_env``, the
    value of ``var``, as given (negative values as 0); when it is unset or
    malformed (with a notice: a typo must not silently change the run),
    the automatic gate, which is 0.  The JAX package chunks by work only
    on the TPU, whose relayed workers die under minutes-long programs, and
    returns 0 on every other backend; the card has no such limit."""
    if chunk_env is not None:
        try:
            return max(0, int(chunk_env))
        except ValueError:
            print(f"[tpuslam] ignoring malformed {var}={chunk_env!r}; using the automatic gate")
    return 0


def icp_chunk_size(chunk_env: Optional[str] = None) -> int:
    """ICP iterations per chunk from ``TPUSLAM_ICP_CHUNK`` (``_chunk_size``)."""
    return _chunk_size(chunk_env, "TPUSLAM_ICP_CHUNK")


def cpd_chunk_size(chunk_env: Optional[str] = None) -> int:
    """CPD EM iterations per chunk from ``TPUSLAM_CPD_CHUNK``
    (``_chunk_size``).  The JAX package's separate size for Hybrid's FGT
    phase comes from its gate too, so here it is the forced size, as there."""
    return _chunk_size(chunk_env, "TPUSLAM_CPD_CHUNK")


def run_with_configuration(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: Optional[torch.device | str] = None,
) -> SlamResult:
    """Register host ``f32[N, 3]`` clouds on ``device`` (see
    ``resolve_device``) with the method ``config`` names, inside the
    request's ``tpuslam.register`` span (``core/spans.py``)."""
    with span("tpuslam.register"):
        return get_slam_func(config.computation_method)(
            before, after, config, resolve_device(device)
        )


def _copy_in(before: np.ndarray, after: np.ndarray, device: torch.device):
    """Both clouds padded and on ``device``, in the ``tpuslam.entry.copy_in``
    span."""
    with span("tpuslam.entry.copy_in"):
        return pad_cloud(before, device=device), pad_cloud(after, device=device)


def _read_out(rotation: torch.Tensor, result) -> SlamResult:
    """The ``SlamResult`` of ``result`` with ``rotation``, read to the host in
    the ``tpuslam.entry.read_out`` span."""
    with span("tpuslam.entry.read_out"):
        return (
            rotation.cpu().numpy(),
            result.transform.translation.cpu().numpy(),
            int(result.iterations),
            float(result.error),
        )


@register(ComputationMethod.Icp)
def _run_icp(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: torch.device,
) -> SlamResult:
    """Mirrors ``CalculateICPWithConfiguration`` (``basicicp.cpp:12-21``);
    with ``icp_prealign``, the NICP-seeded loop."""
    from tpuslam_torch.algorithms.icp import (
        icp_register,
        icp_register_chunked,
        icp_register_prealigned,
    )

    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    common = dict(
        eps=config.convergence_epsilon,
        max_distance_squared=config.max_distance_squared,
        max_iterations=max_iterations,
    )
    chunk = icp_chunk_size(os.environ.get("TPUSLAM_ICP_CHUNK"))
    ckpt = os.environ.get("TPUSLAM_ICP_CKPT") or None
    before_c, after_c = _copy_in(before, after, device)
    if config.icp_prealign:
        result = icp_register_prealigned(
            before_c, after_c, subcloud_size=config.nicp_subcloud_size,
            seed=config.random_seed if config.random_seed is not None else 0,
            chunk=chunk, checkpoint_path=ckpt, **common,
        )
    elif chunk or ckpt:
        result = icp_register_chunked(before_c, after_c, chunk=chunk or 10,
                                      checkpoint_path=ckpt, **common)
    else:
        result = icp_register(before_c, after_c, **common)
    return _read_out(result.transform.rotation, result)


def nicp_widening(before: np.ndarray, after: np.ndarray, widen: Optional[int]):
    """(angles, axes) of the degenerate-spectrum widening for the config
    knob ``nicp-degenerate-widening``: absent = the host-side eigengap
    pre-pass (16 angles on each degenerate axis, none when there is
    none), 0 or 1 = off, N = N angles (on axis 0 when none is
    degenerate)."""
    from tpuslam_torch.algorithms.nicp import degenerate_axes_for

    if widen is None:
        axes = degenerate_axes_for(before, after)
        return (16 if axes else 0), axes
    if widen > 1:
        return widen, degenerate_axes_for(before, after) or (0,)
    return 0, ()


@register(ComputationMethod.NoniterativeIcp)
def _run_nicp(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: torch.device,
) -> SlamResult:
    """Mirrors ``CalculateNonIterativeWithConfiguration``
    (``noniterative.cpp:14-23``), with the JAX package's widening of the
    candidate set on a degenerate spectrum (``nicp_widening``)."""
    from tpuslam_torch.algorithms.nicp import nicp_register

    angles, axes = nicp_widening(before, after, config.nicp_degenerate_widening)
    before_c, after_c = _copy_in(before, after, device)
    result = nicp_register(
        before_c,
        after_c,
        eps=config.convergence_epsilon,
        approximation_type=config.approximation_type,
        subcloud_size=config.nicp_subcloud_size,
        seed=config.random_seed if config.random_seed is not None else 0,
        degenerate_angles=angles,
        degenerate_axes=axes,
    )
    return _read_out(result.transform.rotation, result)


@register(ComputationMethod.Cpd)
def _run_cpd(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: torch.device,
) -> SlamResult:
    """Mirrors ``CalculateCpdWithConfiguration``
    (``coherentpointdrift.cpp:43-65``).  A missing ``max-iterations`` maps
    to -1, and the EM loop then runs zero iterations (identity result),
    as the reference's does (``coherentpointdrift.cpp:104``)."""
    from tpuslam_torch.algorithms.cpd import cpd_register, cpd_register_chunked

    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    common = dict(
        eps=config.convergence_epsilon,
        weight=config.cpd_weight,
        const_scale=config.cpd_const_scale,
        max_iterations=max_iterations,
        tolerance=config.cpd_tolerance,
        approximation_type=config.approximation_type,
        ratio_of_far_field=config.ratio_of_far_field,
        order_of_truncation=config.order_of_truncation,
        use_fgt=config.cpd_use_fgt,
        centroid_init=config.cpd_centroid_init,
    )
    chunk = cpd_chunk_size(os.environ.get("TPUSLAM_CPD_CHUNK"))
    ckpt = os.environ.get("TPUSLAM_CPD_CKPT") or None
    before_c, after_c = _copy_in(before, after, device)
    if chunk or ckpt:
        result = cpd_register_chunked(before_c, after_c, chunk=chunk or 10,
                                      checkpoint_path=ckpt, **common)
    else:
        result = cpd_register(before_c, after_c, **common)
    # the reference returns (scale * R, t) (coherentpointdrift.cpp:123)
    return _read_out(result.transform.scale * result.transform.rotation, result)
