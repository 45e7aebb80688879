"""Weighted Procrustes (rigid least-squares) via 3x3 SVD (port of
``tpuslam/ops/procrustes.py``).

The cross-covariance is a weighted sum with weights in {0,1}, so shapes
stay static.  The determinant correction ``R = U diag(1,1,det(U V^T)) V^T``
alone guarantees a proper rotation.

The 3x3 SVD stays ``torch.linalg.svd`` on the tensor's device, as the JAX
package left it to ``jnp.linalg.svd`` outside any kernel: on CUDA that is
one cuSOLVER call per iteration.  R is unique only when the singular
values are distinct, so tests compare R and t, never U or V.

Float32 products must run in full float32: a TF32 cross-covariance keeps
about three decimal digits, far too few for an SVD that feeds the next
iteration.  Both switches are PyTorch's defaults; they are set here so
that no caller can have turned them off before the loop runs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuslam_torch.ops.geometry import per_pair

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def svd_rotation(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proper rotation nearest to the 3x3 cross-covariance ``h``.

    Returns ``(R, s)`` where ``s`` are the singular values.
    ``h[r, c] = sum_i w_i a_i[r] b_i[c]`` maps ``b`` (before) onto ``a``
    (after): ``a ≈ R @ b``.

    A non-finite ``h`` gives a NaN ``R`` and ``s``, as ``jnp.linalg.svd``
    does (the ICP loop then stops on its non-finite error):
    ``torch.linalg.svd`` would raise instead, so it is given zeros and its
    result replaced, without a read back to the host."""
    r, s, _ = svd_rotation_det(h)
    return r, s


def svd_rotation_det(
    h: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``svd_rotation`` plus ``det(U V^T)``, the sign the CPD M-step folds
    into its scale (``coherentpointdrift.cpp:258-260``)."""
    finite = torch.isfinite(h).all()
    u, s, vt = torch.linalg.svd(
        torch.where(finite, h, torch.zeros_like(h)), full_matrices=False
    )
    det = torch.linalg.det(torch.matmul(u, vt))
    d = torch.cat(
        [torch.ones(2, dtype=h.dtype, device=h.device), det.reshape(1)]
    )
    r = torch.matmul(u * d[None, :], vt)
    nan = torch.full_like(r, float("nan"))
    return (torch.where(finite, r, nan), torch.where(finite, s, nan[0]),
            torch.where(finite, det, nan[0, 0]))


def weighted_procrustes(
    before: torch.Tensor,
    after: torch.Tensor,
    weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid (R, t) minimizing ``sum_i w_i |R b_i + t - a_i|^2``.

    ``before``/``after`` are row-aligned ``f32[N, 3]``; ``weights`` is
    ``f32[N]`` (zeros drop correspondences).  With a leading pair axis
    (``f32[B, N, 3]``, ``f32[B, N]``) each pair is solved by its own call
    (``geometry.per_pair``), so it gets the bits it gets alone."""
    if before.dim() == 3:
        return per_pair(weighted_procrustes, before, after, weights)
    w = weights.to(before.dtype)
    total = torch.clamp_min(torch.sum(w), 1e-12)
    mu_b = torch.sum(before * w[:, None], dim=0) / total
    mu_a = torch.sum(after * w[:, None], dim=0) / total
    bc = before - mu_b
    ac = after - mu_a
    # H = sum_i w_i ac_i bc_i^T  (common.cpp:530)
    h = torch.matmul((ac * w[:, None]).T, bc)
    r, _ = svd_rotation(h)
    t = mu_a - torch.matmul(r, mu_b)
    return r, t
