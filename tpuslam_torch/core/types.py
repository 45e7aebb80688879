"""Core tensor types for the registration engine (port of
``tpuslam/core/types.py``).

A cloud is a dense ``f32[Npad, 3]`` tensor padded to a multiple of
``LANE`` rows, plus the count of valid leading rows as a 0-d int32
tensor on the same device.  Every reduction threads the validity mask
through, so padded rows never perturb centroids, errors or argmins.
The padding keeps the JAX package's shapes at the port's public
functions, so the parity tests compare like with like.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch.core.device import resolve_device

# Row multiple of every padded cloud (the JAX package's TPU lane width;
# kept so padded shapes match between the two packages).
LANE = 128


class RigidTransform(NamedTuple):
    """A rigid (optionally scaled) transform ``p -> scale * (R @ p) + t``.

    ``rotation`` is row-major: row r, col c of the mathematical matrix R,
    so points transform as ``points @ R.T * scale + t``."""

    rotation: torch.Tensor  # f32[3, 3]
    translation: torch.Tensor  # f32[3]
    scale: torch.Tensor  # f32[] scalar

    @staticmethod
    def identity(
        device: Optional[torch.device | str] = None,
        dtype: torch.dtype = torch.float32,
    ) -> "RigidTransform":
        return RigidTransform(
            rotation=torch.eye(3, dtype=dtype, device=device),
            translation=torch.zeros(3, dtype=dtype, device=device),
            scale=torch.ones((), dtype=dtype, device=device),
        )

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform ``f32[..., 3]`` points: ``scale * (R @ p) + t``."""
        from tpuslam_torch.ops.geometry import transform_points

        return transform_points(
            points, self.rotation, self.translation, self.scale
        )

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (apply ``other`` first, then ``self``)."""
        return RigidTransform(
            rotation=torch.matmul(self.rotation, other.rotation),
            translation=self.scale
            * torch.matmul(self.rotation, other.translation)
            + self.translation,
            scale=self.scale * other.scale,
        )


class Cloud(NamedTuple):
    """A padded point cloud: ``points`` is ``f32[Npad, 3]``, ``count`` the
    number of valid leading rows as a 0-d int32 tensor on the same device
    (padded rows are zeros).  A batch of clouds (``algorithms/batch.py``)
    has ``points`` f32[B, Npad, 3] and ``count`` i32[B]."""

    points: torch.Tensor  # f32[Npad, 3]
    count: torch.Tensor  # i32[] — number of valid points

    @property
    def padded_size(self) -> int:
        return self.points.shape[-2]

    def mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``dtype[..., Npad]`` validity mask: 1 for real points, 0 for
        padding."""
        idx = torch.arange(self.points.shape[-2], device=self.points.device)
        return (idx < self.count[..., None]).to(dtype)


class Sufficient(NamedTuple):
    """CPD E-step sufficient statistics (the reference's ``Probabilities``,
    ``cudaprobabilities.h:7-31``).  Defined here, beside the other core
    types, so the kernel wrappers need no algorithm module; the JAX
    package defines it in ``algorithms/cpd.py``, which re-exports it in
    the port too."""

    p1: torch.Tensor  # f32[M]   P @ 1
    pt1: torch.Tensor  # f32[N]  P^T @ 1
    px: torch.Tensor  # f32[M,3] P @ X
    error: torch.Tensor  # f32[]  negative log-likelihood


def round_up(n: int, multiple: int = LANE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pick_block(n: int, prefer=(1024, 512, 256, 128)) -> int:
    """Largest preferred block size dividing ``n`` (``n`` itself when none
    divides)."""
    for b in prefer:
        if n % b == 0:
            return b
    return n


def pad_cloud(
    points,
    multiple: int = LANE,
    device: Optional[torch.device | str] = None,
) -> Cloud:
    """Pad an ``[N, 3]`` array to a multiple-of-``multiple`` Cloud.

    ``points`` is a numpy array or a tensor.  The Cloud lies on
    ``device``; when that is None, on the tensor's own device, and for a
    numpy array where ``core.device.resolve_device`` puts it: on the card
    when there is one, as the JAX package's ``pad_cloud`` places a host
    array on JAX's default device.  A caller that wants the CPU says so."""
    if isinstance(points, torch.Tensor):
        if device is None:
            device = points.device
        points = points.detach().to("cpu", torch.float32).numpy()
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {points.shape}")
    n = points.shape[0]
    npad = max(round_up(max(n, 1), multiple), multiple)
    out = np.zeros((npad, 3), dtype=np.float32)
    out[:n] = points
    device = resolve_device(device)
    return Cloud(
        points=torch.from_numpy(out).to(device),
        count=torch.tensor(n, dtype=torch.int32, device=device),
    )


def unpad(cloud: Cloud) -> np.ndarray:
    """Return the valid points of a Cloud as a host ``f32[N, 3]`` array."""
    n = int(cloud.count)
    return cloud.points[:n].detach().cpu().numpy()
