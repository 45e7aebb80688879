"""Device selection for the port.

The JAX package runs wherever ``jax.default_backend()`` points.  The port
takes an explicit ``device`` everywhere; this is the one place that turns
a caller's request into a ``torch.device``.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``None`` picks the first CUDA device when there is one and the CPU
    otherwise.  An explicit CUDA request where CUDA is not available
    raises: it never falls back to the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available"
        )
    return device
