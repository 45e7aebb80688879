"""Weighted Procrustes (rigid least-squares) via 3x3 SVD (port of
``tpuslam/ops/procrustes.py``).

The cross-covariance is a weighted sum with weights in {0,1}, so shapes
stay static.  The determinant correction ``R = U diag(1,1,det(U V^T)) V^T``
alone guarantees a proper rotation.

On the CPU these are the plain versions (``torch.sum`` and
``torch.linalg.svd``, as the JAX package leaves them to ``jnp``); on CUDA
they launch kernel P (``kernels/procrustes.py``, ``csrc/procrustes.cu``),
which reads nothing back to the host, so an ICP iteration holds no
synchronising call.  R is unique only when the singular values are
distinct, so tests compare R and t, never U or V.

Float32 products must run in full float32: a TF32 cross-covariance keeps
about three decimal digits, far too few for an SVD that feeds the next
iteration.  Both switches are PyTorch's defaults; they are set here so
that no caller can have turned them off before the loop runs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuslam_torch.kernels.procrustes import (
    mean_sq_error_batch,
    svd_rotation_det_batch,
    weighted_procrustes_batch,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def svd_rotation(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proper rotation nearest to the 3x3 cross-covariance ``h``.

    Returns ``(R, s)`` where ``s`` are the singular values.
    ``h[r, c] = sum_i w_i a_i[r] b_i[c]`` maps ``b`` (before) onto ``a``
    (after): ``a ≈ R @ b``.

    A non-finite ``h`` gives a NaN ``R`` and ``s``, as ``jnp.linalg.svd``
    does (the ICP loop then stops on its non-finite error)."""
    r, s, _ = svd_rotation_det(h)
    return r, s


def svd_rotation_det(
    h: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``svd_rotation`` plus ``det(U V^T)``, the sign the CPD M-step folds
    into its scale (``coherentpointdrift.cpp:258-260``); ``h`` f32[3, 3] or
    a batch f32[B, 3, 3]."""
    if h.dim() == 3:
        return svd_rotation_det_batch(h)
    r, s, det = svd_rotation_det_batch(h[None])
    return r[0], s[0], det[0]


def weighted_procrustes(
    before: torch.Tensor,
    after: torch.Tensor,
    weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid (R, t) minimizing ``sum_i w_i |R b_i + t - a_i|^2``.

    ``before``/``after`` are row-aligned ``f32[N, 3]``; ``weights`` is
    ``f32[N]`` (zeros drop correspondences).  With a leading pair axis
    (``f32[B, N, 3]``, ``f32[B, N]``) each pair gets the bits it gets
    alone (one launch of P for all pairs on CUDA; pair by pair on the
    CPU)."""
    weights = weights.to(before.dtype)
    if before.dim() == 3:
        return weighted_procrustes_batch(before, after, weights)
    r, t = weighted_procrustes_batch(before[None], after[None], weights[None])
    return r[0], t[0]


def mean_sq_error(diff: torch.Tensor, w: torch.Tensor, n_corr: torch.Tensor) -> torch.Tensor:
    """The ICP error ``sum_i w_i |diff_i|^2 / max(n_corr, 1)`` for
    ``diff`` f32[N, 3] or a batch f32[B, N, 3] (P's error entry on CUDA)."""
    if diff.dim() == 3:
        return mean_sq_error_batch(diff, w, n_corr)
    return mean_sq_error_batch(diff[None], w[None], n_corr.reshape(1))[0]
