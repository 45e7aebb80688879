"""The hand-written CUDA kernels K1-K5, each behind a wrapper that keeps
its plain PyTorch version beside it.

Every wrapper adds one to its module's counter where it launches its
kernel and nowhere else; ``launch_counts`` reads all of them under one
set of names, ``launch_delta`` subtracts an earlier reading.
"""

from __future__ import annotations

KERNELS = ("K1", "K2", "K3", "K4_denom", "K4_moments", "K5_denom", "K5_moments")


def launch_counts() -> dict:
    """Each kernel's launches so far in this process, by its name in
    ``KERNELS``."""
    from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense

    return dict(zip(KERNELS, (
        nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES, cpd_dense.DENOM_LAUNCHES,
        cpd_dense.MOMENTS_LAUNCHES, cpd_cand.DENOM_LAUNCHES, cpd_cand.MOMENTS_LAUNCHES)))


def launch_delta(before: dict) -> dict:
    """The launches since ``before`` (a ``launch_counts()`` reading)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in KERNELS}


def reset_launch_counts() -> None:
    from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense

    nn_dense.LAUNCHES = bound.LAUNCHES = nn_cand.LAUNCHES = 0
    cpd_dense.DENOM_LAUNCHES = cpd_dense.MOMENTS_LAUNCHES = 0
    cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = 0
