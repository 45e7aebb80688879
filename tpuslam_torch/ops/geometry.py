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
    points; with leading pair axes, ``f32[..., N, 3]`` points by
    ``f32[..., 3, 3]`` rotations and ``f32[..., 3]`` translations.

    The per-coordinate form, never ``points @ R.T``: the JAX package chose
    it because a matmul took the TPU's bf16 path, and keeping it here keeps
    the port's rounding within one or two ulps of the JAX package's.
    XLA on the CPU contracts each row to ``fma(z, r2, fma(x, r0, y*r1))``;
    torch eager does not fuse, so the two differ by up to a few 1e-7 at
    spread 10 (``tests/test_torch_procrustes.py`` states the tolerance)."""
    x = points[..., 0]
    y = points[..., 1]
    z = points[..., 2]
    r = rotation[..., None]  # each entry broadcast over the N rows
    out = torch.stack(
        [
            x * r[..., 0, 0, :] + y * r[..., 0, 1, :] + z * r[..., 0, 2, :],
            x * r[..., 1, 0, :] + y * r[..., 1, 1, :] + z * r[..., 1, 2, :],
            x * r[..., 2, 0, :] + y * r[..., 2, 1, :] + z * r[..., 2, 2, :],
        ],
        dim=-1,
    )
    return scale * out + translation[..., None, :]


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` f32[..., r, 3] and ``b`` f32[..., 3, c], as three
    products added left to right: elementwise, so each pair of a batch
    gets the bits it gets alone (the batched and unbatched kernels of
    ``torch.matmul`` round 3x3 products differently)."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` for ``a`` f32[..., 3, 3] and ``v`` f32[..., 3] (``matmul3``)."""
    return matmul3(a, v[..., None])[..., 0]


def per_pair(fn, *args):
    """``fn`` on each pair's slices of ``args`` (leading pair axis), the
    results stacked.  A reduction over a whole batch may add a pair's rows
    in another order than the same reduction over that pair alone (CUDA's
    reduction kernels pick their split from the shape); pair by pair, each
    result has the bits of the solo call."""
    outs = [fn(*(a[p] for a in args)) for p in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)
