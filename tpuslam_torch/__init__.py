"""tpuslam_torch — the PyTorch and CUDA port of ``tpuslam``.

A second package beside the JAX one, which stays the reference: same
public functions, same padded shapes, tested against it on the same
inputs.  It imports ``torch`` and numpy, never JAX and never ``tpuslam``.

ICP runs on two exact nearest-neighbour arms: the dense search, kernel
K1 (``csrc/nn_dense.cu``), and from 8,192 target rows on CUDA the
hierarchical search, kernels K2 (``csrc/bound.cu``) and K3
(``csrc/nn_cand.cu``) with K1 as its overflow arm.  The kernels are
hand-written CUDA for an NVIDIA Hopper card; on the CPU their plain
PyTorch versions run.  NICP, CPD, batching and sequences are not ported
yet and raise ``NotImplementedError``.
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
