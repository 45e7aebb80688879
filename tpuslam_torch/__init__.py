"""tpuslam_torch — the PyTorch and CUDA port of ``tpuslam``.

A second package beside the JAX one, which stays the reference: same
public functions, same padded shapes, tested against it on the same
inputs.  It imports ``torch`` and numpy, never JAX and never ``tpuslam``.

ICP runs on two exact nearest-neighbour arms: the dense search, kernel
K1 (``csrc/nn_dense.cu``), and from 8,192 target rows on CUDA the
hierarchical search, kernels K2 (``csrc/bound.cu``) and K3
(``csrc/nn_cand.cu``) with K1 as its overflow arm; ``icp_prealign``
seeds it with one NICP shot.  NICP scores its candidate rotations with
one K1 call.  CPD runs its exact E-step on kernel K5
(``csrc/cpd_cand.cu``, the block-skipping E-step) with K4
(``csrc/cpd_dense.cu``, the dense two-pass E-step) as its overflow arm,
and its Full/Hybrid fast phase on the Fast Gauss Transform from 74,018
rows.  ``register_pairs`` registers B pairs in one call, on the batch
forms of K1, K2 and K3 (CPD pair by pair).  The kernels are hand-written
CUDA for an NVIDIA Hopper card; on the CPU their plain PyTorch versions
run.  Sequences, the chunked and checkpointed drivers and the CLI are
not ported yet.
"""

__version__ = "0.1.0"

from tpuslam_torch.core.types import RigidTransform, Cloud, pad_cloud, unpad  # noqa: F401
from tpuslam_torch.config.configuration import (  # noqa: F401
    Configuration,
    ComputationMethod,
    ExecutionPolicy,
    ApproximationType,
)


def register(before, after, config=None, device=None, **overrides):
    """One-call registration: host ``f32[N,3]`` arrays in, (rotation,
    translation, iterations, error) out — the reference's ``SlamFunc``
    contract (``testrunner.h:8``) as a library call.

    ``config`` defaults to an ICP ``Configuration``; keyword overrides are
    applied on top.  ``device`` is where the registration runs
    (``tpuslam_torch.core.device.resolve_device``: None picks CUDA when
    there is a card)."""
    from dataclasses import replace

    from tpuslam_torch.algorithms.registry import run_with_configuration

    if config is None:
        config = Configuration()
    if overrides:
        config = replace(config, **overrides)
    return run_with_configuration(before, after, config, device=device)


def register_pairs(befores, afters, config=None, device=None, **overrides):
    """Batched multi-pair registration: sequences of host ``f32[N_i,3]``
    arrays in, per-pair (rotations f32[B,3,3], translations f32[B,3],
    iterations i32[B], errors f32[B]) as numpy arrays out.

    Same configuration contract as :func:`register`, and the same
    ``device`` (None: CUDA when there is a card); each pair's result
    equals its solo :func:`register` run (``algorithms/batch.py`` says
    how closely)."""
    from dataclasses import replace

    from tpuslam_torch.algorithms.batch import (
        cpd_register_batch,
        icp_register_batch,
        icp_register_prealigned_batch,
        nicp_register_batch,
        stack_clouds,
    )
    from tpuslam_torch.core.device import resolve_device

    if len(befores) != len(afters):
        raise ValueError(
            f"pair count mismatch: {len(befores)} befores vs {len(afters)} afters"
        )
    if config is None:
        config = Configuration()
    if overrides:
        config = replace(config, **overrides)
    device = resolve_device(device)
    b, a = stack_clouds(befores, device=device), stack_clouds(afters, device=device)
    max_iterations = (
        int(config.max_iterations) if config.max_iterations is not None else -1
    )
    seed = config.random_seed if config.random_seed is not None else 0
    method = config.computation_method
    if method == ComputationMethod.Icp:
        common = dict(eps=config.convergence_epsilon,
                      max_distance_squared=config.max_distance_squared,
                      max_iterations=max_iterations)
        if config.icp_prealign:
            res = icp_register_prealigned_batch(
                b, a, subcloud_size=config.nicp_subcloud_size, seed=seed, **common)
        else:
            res = icp_register_batch(b, a, **common)
        rotation = res.transform.rotation
    elif method == ComputationMethod.NoniterativeIcp:
        res = nicp_register_batch(
            b, a, eps=config.convergence_epsilon,
            approximation_type=config.approximation_type,
            subcloud_size=config.nicp_subcloud_size, seed=seed,
        )
        rotation = res.transform.rotation
    else:
        res = cpd_register_batch(
            b, a,
            eps=config.convergence_epsilon,
            weight=config.cpd_weight,
            const_scale=config.cpd_const_scale,
            max_iterations=max_iterations,
            tolerance=config.cpd_tolerance,
            approximation_type=config.approximation_type,
            use_fgt=config.cpd_use_fgt,
            order_of_truncation=config.order_of_truncation,
            ratio_of_far_field=config.ratio_of_far_field,
            centroid_init=config.cpd_centroid_init,
        )
        # the reference returns (scale * R, t) (coherentpointdrift.cpp:123)
        rotation = res.transform.scale[:, None, None] * res.transform.rotation
    return (
        rotation.cpu().numpy(),
        res.transform.translation.cpu().numpy(),
        res.iterations.cpu().numpy(),
        res.error.cpu().numpy(),
    )
