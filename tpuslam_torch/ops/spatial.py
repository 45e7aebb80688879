"""Spatial sorting and tile bounds — the substrate of the hierarchical
exact NN (port of ``tpuslam/ops/spatial.py``).

Sorting a cloud along a Morton (Z-order) curve makes index-contiguous
tiles spatially compact, so each run of ``g`` sorted rows gets a tight
bounding sphere (``tile_bounds``).  Rigid motion preserves distances, so
a cloud sorted once keeps its tiles compact through every ICP iteration.

``morton_codes`` and ``morton_permutation`` give the JAX package's codes
and permutation bit for bit (same float32 arithmetic, stable sort), so
both packages visit and sum the sorted sources in the same order.
``host_morton_order`` is a numpy copy of
``tpuslam.ops.spatial.host_morton_order`` (importing any ``tpuslam``
module pulls in JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

IMAX = 2**31 - 1
BIG = 3.4e38


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and CUDA's
    ``sqrtf`` give it (taken in float64 and rounded once more, which is
    exact for a square root; torch's vectorised CPU ``sqrt`` may be off
    by one unit in the last place)."""
    return torch.sqrt(x.double()).float()


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` so consecutive bits land 3
    apart (the Morton magic-number sequence)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """i32[N] Z-order codes over a 1024^3 grid spanning the valid bbox;
    invalid rows get INT32_MAX so they sort to the end."""
    valid = mask[:, None] > 0
    big = torch.tensor(BIG, dtype=torch.float32, device=points.device)
    lo = torch.amin(torch.where(valid, points, big), dim=0)
    hi = torch.amax(torch.where(valid, points, -big), dim=0)
    extent = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp(
        ((points - lo) / extent * 1023.0).to(torch.int32), 0, 1023
    )
    code = (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << 1)
        | (_part1by2(q[:, 2]) << 2)
    )
    return torch.where(mask > 0, code, torch.full_like(code, IMAX))


def morton_permutation(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """i32[N] permutation sorting rows by Morton code (stable: equal codes
    keep their order; invalid rows go last)."""
    return torch.argsort(morton_codes(points, mask), stable=True).to(torch.int32)


def host_morton_order(points, n_valid: int) -> np.ndarray:
    """Host (numpy) replica of ``morton_codes`` plus a stable argsort,
    invalid/padded rows last.  Copied from
    ``tpuslam.ops.spatial.host_morton_order``."""
    n = len(points)
    codes = np.full(n, np.int32(2**31 - 1), dtype=np.int32)
    if n_valid > 0:
        pts = np.asarray(points[:n_valid], np.float32)
        lo = pts.min(axis=0)
        extent = np.maximum(pts.max(axis=0) - lo, 1e-12)
        q = np.clip(
            ((pts - lo) * (np.float32(1023.0) / extent)).astype(np.int32),
            0, 1023,
        )

        def part1by2(x):
            x = x & np.int32(0x3FF)
            x = (x | (x << 16)) & np.int32(0x030000FF)
            x = (x | (x << 8)) & np.int32(0x0300F00F)
            x = (x | (x << 4)) & np.int32(0x030C30C3)
            x = (x | (x << 2)) & np.int32(0x09249249)
            return x

        codes[:n_valid] = (
            part1by2(q[:, 0])
            | (part1by2(q[:, 1]) << 1)
            | (part1by2(q[:, 2]) << 2)
        )
    return np.argsort(codes, kind="stable")


class TileBounds(NamedTuple):
    centers: torch.Tensor  # f32[T, 3]
    radii: torch.Tensor  # f32[T] — bounding-sphere radius (to bbox corner)


def tile_bounds(
    sorted_points: torch.Tensor, sorted_mask: torch.Tensor, tile: int
) -> TileBounds:
    """Bounding sphere of each index-contiguous tile of a sorted cloud.
    Fully invalid tiles get a far centre (1e15) and radius 0, so they are
    never candidates."""
    t = sorted_points.shape[0] // tile
    pts = sorted_points.reshape(t, tile, 3)
    valid = sorted_mask.reshape(t, tile)[:, :, None] > 0
    big = torch.tensor(BIG, dtype=torch.float32, device=pts.device)
    lo = torch.amin(torch.where(valid, pts, big), dim=1)
    hi = torch.amax(torch.where(valid, pts, -big), dim=1)
    any_valid = torch.sum(sorted_mask.reshape(t, tile), dim=1) > 0
    center = torch.where(
        any_valid[:, None], (lo + hi) * 0.5,
        torch.tensor(1e15, dtype=torch.float32, device=pts.device),
    )
    span = hi - lo
    radius = torch.where(
        any_valid,
        0.5 * sqrt_rn(span[:, 0] * span[:, 0] + span[:, 1] * span[:, 1]
                      + span[:, 2] * span[:, 2]),
        torch.zeros((), dtype=torch.float32, device=pts.device),
    )
    return TileBounds(centers=center, radii=radius)
