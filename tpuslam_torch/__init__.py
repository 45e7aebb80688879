"""tpuslam_torch — the PyTorch and CUDA port of ``tpuslam``.

A second package beside the JAX one, which stays the reference: same
public functions, same padded shapes, tested against it on the same
inputs.  It imports ``torch`` and numpy, never JAX and never ``tpuslam``.

This slice runs ICP on the dense nearest-neighbour arm: the search is the
hand-written CUDA kernel K1 (``csrc/nn_dense.cu``) on an NVIDIA Hopper
card, and its plain PyTorch version on the CPU.  NICP, CPD, the
hierarchical search, batching and sequences are not ported yet and raise
``NotImplementedError``.
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
