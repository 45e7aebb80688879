"""Process-group set-up of the sharded layer (port of
``tpuslam/parallel/distributed.py``, 40 lines).

The JAX package calls ``jax.distributed.initialize`` once per host and
lets XLA pick the transport.  ``torch.distributed`` needs a backend, an
address, a world size and a rank.  ``initialize`` takes them from its
arguments, else from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

The backend is the caller's choice, never switched silently: ``None``
means NCCL, and is refused unless every rank has a card of its own.
Two ranks on one card need ``backend="gloo"`` (NCCL refuses them), and
gloo then stages each CUDA collective through the host.  A process-group
timeout always applies, so a rank that stops turns its peers' waiting
collective into an error, not a hang.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective may wait for the slowest rank before it raises
DEFAULT_TIMEOUT_S = 300.0


def resolve_backend(backend: Optional[str], world_size: int) -> str:
    """``backend`` as given; ``None`` is NCCL when every one of the
    ``world_size`` ranks has a card of its own, and an error otherwise."""
    if backend is not None:
        return backend
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > cards:
        raise ValueError(
            f"backend=None means NCCL, one card a rank, but {world_size} ranks "
            f"share {cards} card(s): pass backend=\"gloo\" to run them anyway "
            "(gloo stages every collective through the host)"
        )
    return "nccl"


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """``torch.distributed.init_process_group`` with an explicit backend
    (``resolve_backend``) and a ``timeout`` in seconds.  ``world_size``
    and ``rank`` default to ``WORLD_SIZE`` and ``RANK``, ``init_method``
    to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)."""
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = resolve_backend(backend, world_size)
    dist.init_process_group(
        backend=backend,
        init_method=init_method or "env://",
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1
