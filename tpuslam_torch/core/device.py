"""Device selection for the port.

The JAX package runs wherever ``jax.default_backend()`` points.  The port
takes an explicit ``device`` everywhere; this is the one place that turns
a caller's request into a ``torch.device``.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``None`` is the card: the first CUDA device, and an error where
    CUDA is not available.  The port never picks the CPU for a caller who
    did not ask for it; a caller who wants the CPU passes ``"cpu"``.  An
    explicit CUDA request where CUDA is not available raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tpuslam_torch runs on the card unless the "
                "caller asks for the CPU (pass device=\"cpu\")"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available"
        )
    return device
