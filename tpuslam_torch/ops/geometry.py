"""Geometry math: transforms, masked statistics, MSE (port of
``tpuslam/ops/geometry.py``).

Plain elementwise tensor code; every reduction takes a validity mask so
padded rows never perturb results.
"""

from __future__ import annotations

import torch


def masked_mean(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Center of mass of the valid points (``common.cpp:281-284``)."""
    w = mask.to(points.dtype)
    total = torch.clamp_min(torch.sum(w), 1.0)
    return torch.sum(points * w[:, None], dim=0) / total


def masked_mse(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid rows of the squared row norms
    (the elementwise overload, ``common.cpp:270-279``)."""
    w = mask.to(diff.dtype)
    count = torch.clamp_min(torch.sum(w), 1.0)
    return torch.sum(torch.sum(diff * diff, dim=-1) * w) / count


def transform_points(
    points: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    scale=1.0,
) -> torch.Tensor:
    """``p -> scale * (R @ p) + t`` (``common.cpp:39-55``) for ``f32[N, 3]``
    points.

    The per-coordinate form, never ``points @ R.T``: the JAX package chose
    it because a matmul took the TPU's bf16 path, and keeping it here keeps
    the port's rounding within one or two ulps of the JAX package's.
    XLA on the CPU contracts each row to ``fma(z, r2, fma(x, r0, y*r1))``;
    torch eager does not fuse, so the two differ by up to a few 1e-7 at
    spread 10 (``tests/test_torch_procrustes.py`` states the tolerance)."""
    x = points[..., 0]
    y = points[..., 1]
    z = points[..., 2]
    out = torch.stack(
        [
            x * rotation[0, 0] + y * rotation[0, 1] + z * rotation[0, 2],
            x * rotation[1, 0] + y * rotation[1, 1] + z * rotation[1, 2],
            x * rotation[2, 0] + y * rotation[2, 1] + z * rotation[2, 2],
        ],
        dim=-1,
    )
    return scale * out + translation
