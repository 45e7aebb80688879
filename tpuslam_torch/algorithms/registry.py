"""Method dispatch: one registration API over all algorithms (port of
``tpuslam/algorithms/registry.py``).

``run_with_configuration(before, after, config, device=None) ->
(rotation, translation, iterations, error)`` is the reference's
``SlamFunc`` contract (``testrunner.h:8``).  Only ICP is ported; NICP,
CPD and the NICP-prealigned ICP raise ``NotImplementedError`` naming
their ROADMAP item.  ICP runs in one piece: the JAX package chunks
ICP only on the TPU (``icp_chunk_size`` is 0 elsewhere) or when asked to
checkpoint, which is not ported yet.  Its NN arm is ``icp_register``'s
default: the hierarchical search on CUDA from 8,192 target rows, the
dense search otherwise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.config.configuration import ComputationMethod, Configuration
from tpuslam_torch.core.device import resolve_device
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


def run_with_configuration(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: Optional[torch.device | str] = None,
) -> SlamResult:
    """Register host ``f32[N, 3]`` clouds on ``device`` (see
    ``resolve_device``) with the method ``config`` names."""
    return get_slam_func(config.computation_method)(
        before, after, config, resolve_device(device)
    )


@register(ComputationMethod.Icp)
def _run_icp(
    before: np.ndarray,
    after: np.ndarray,
    config: Configuration,
    device: torch.device,
) -> SlamResult:
    """Mirrors ``CalculateICPWithConfiguration`` (``basicicp.cpp:12-21``)."""
    from tpuslam_torch.algorithms.icp import icp_register

    if config.icp_prealign:
        raise NotImplementedError(
            "icp_prealign needs NICP: ROADMAP Queue 1 items 6-7"
        )
    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    result = icp_register(
        pad_cloud(before, device=device),
        pad_cloud(after, device=device),
        eps=config.convergence_epsilon,
        max_distance_squared=config.max_distance_squared,
        max_iterations=max_iterations,
    )
    return (
        result.transform.rotation.cpu().numpy(),
        result.transform.translation.cpu().numpy(),
        int(result.iterations),
        float(result.error),
    )


@register(ComputationMethod.NoniterativeIcp)
def _run_nicp(before, after, config, device) -> SlamResult:
    raise NotImplementedError("NICP: ROADMAP Queue 1 item 6")


@register(ComputationMethod.Cpd)
def _run_cpd(before, after, config, device) -> SlamResult:
    raise NotImplementedError("CPD: ROADMAP Queue 1 item 8")
