"""Method dispatch: one registration API over all algorithms (port of
``tpuslam/algorithms/registry.py``).

``run_with_configuration(before, after, config, device=None) ->
(rotation, translation, iterations, error)`` is the reference's
``SlamFunc`` contract (``testrunner.h:8``).  ICP (cold or
NICP-prealigned), NICP and CPD are ported.  ICP and CPD run in one
piece: the JAX package chunks them only on the TPU (``icp_chunk_size``
and ``cpd_chunk_size`` are 0 elsewhere, and a chunked run follows the
same trajectory) or when asked to checkpoint (``TPUSLAM_ICP_CKPT``,
``TPUSLAM_CPD_CKPT``), which is not ported yet and raises.  ICP's NN arm
is ``icp_register``'s default: the hierarchical search on CUDA from
8,192 target rows, the dense search otherwise.  CPD's exact E-step is
``cpd_register``'s default: kernels K5 and K4 on CUDA, the blocked
oracle on the CPU.
"""

from __future__ import annotations

import os
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
    """Mirrors ``CalculateICPWithConfiguration`` (``basicicp.cpp:12-21``);
    with ``icp_prealign``, the NICP-seeded loop."""
    from tpuslam_torch.algorithms.icp import icp_register, icp_register_prealigned

    if os.environ.get("TPUSLAM_ICP_CKPT"):
        what = "NICP-prealigned ICP" if config.icp_prealign else "ICP"
        raise NotImplementedError(
            f"{what} checkpointing (TPUSLAM_ICP_CKPT) needs icp_register_chunked: "
            "ROADMAP Queue 1 item 2"
        )
    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    common = dict(
        eps=config.convergence_epsilon,
        max_distance_squared=config.max_distance_squared,
        max_iterations=max_iterations,
    )
    before_c, after_c = pad_cloud(before, device=device), pad_cloud(after, device=device)
    if config.icp_prealign:
        result = icp_register_prealigned(
            before_c, after_c, subcloud_size=config.nicp_subcloud_size,
            seed=config.random_seed if config.random_seed is not None else 0,
            **common,
        )
    else:
        result = icp_register(before_c, after_c, **common)
    return (
        result.transform.rotation.cpu().numpy(),
        result.transform.translation.cpu().numpy(),
        int(result.iterations),
        float(result.error),
    )


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
    result = nicp_register(
        pad_cloud(before, device=device),
        pad_cloud(after, device=device),
        eps=config.convergence_epsilon,
        approximation_type=config.approximation_type,
        subcloud_size=config.nicp_subcloud_size,
        seed=config.random_seed if config.random_seed is not None else 0,
        degenerate_angles=angles,
        degenerate_axes=axes,
    )
    return (
        result.transform.rotation.cpu().numpy(),
        result.transform.translation.cpu().numpy(),
        int(result.iterations),
        float(result.error),
    )


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
    from tpuslam_torch.algorithms.cpd import cpd_register

    if os.environ.get("TPUSLAM_CPD_CKPT"):
        raise NotImplementedError(
            "CPD checkpointing (TPUSLAM_CPD_CKPT) needs cpd_register_chunked: "
            "ROADMAP Queue 1 item 2"
        )
    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    result = cpd_register(
        pad_cloud(before, device=device),
        pad_cloud(after, device=device),
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
    # the reference returns (scale * R, t) (coherentpointdrift.cpp:123)
    rotation = result.transform.scale * result.transform.rotation
    return (
        rotation.cpu().numpy(),
        result.transform.translation.cpu().numpy(),
        int(result.iterations),
        float(result.error),
    )
