"""The collectives of the sharded layer: the counterparts of
``jax.lax.pmin``, ``psum`` and ``all_gather(tiled=True)`` over a
``Mesh`` (no JAX original: ``shard_map`` bodies call those directly).

Each returns a new tensor with the reduced (or gathered) value on every
rank.  Under gloo a CUDA tensor is staged through the host here, as gloo
would stage it itself; under NCCL it stays on the card.

Each call appends ``(op, dtype, shape, payload bytes, host seconds)`` to
the open ``collective_log``, if any.  The host seconds run from the
moment the card has finished the work queued before the collective
(under gloo) to the result back on the tensor's device; they include the
wait for the slowest rank.  The payload is the bytes of the
collective's output, what ``comm_model.py``'s byte models count; the
JAX package counts the same from the traced program instead
(``tpuslam/parallel/comm_model.py:99-137``).

Under NCCL a collective may be captured into a CUDA graph (the sharded
loops' chunks, ``algorithms/device_loop.py``): nothing here touches the
host then.  A captured collective has not run, so it is not logged; it
is recorded once in the open ``recording_capture`` list, and each replay
of the graph books those records again (``book_replay``) with their
seconds NaN: a replay gives a collective no host time of its own.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from tpuslam_torch.parallel.mesh import Mesh


class Collective(NamedTuple):
    op: str  # "pmin", "psum" or "all_gather"
    dtype: str
    shape: tuple  # of the output
    nbytes: int  # of the output
    seconds: float  # host time inside the call (staging included)


_log: Optional[List[Collective]] = None
# the collectives recorded into the CUDA graph being captured, while
# ``recording_capture`` is open
_captured: Optional[List[Collective]] = None


@contextlib.contextmanager
def collective_log() -> Iterator[List[Collective]]:
    """Record every collective of this process inside the block."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        _log = outer


@contextlib.contextmanager
def recording_capture() -> Iterator[List[Collective]]:
    """Within the block, the collectives recorded into a CUDA graph go to
    the returned list (their seconds NaN) instead of the log: what each
    replay of the graph runs."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def book_replay(captured: List[Collective]) -> None:
    """Add a replayed graph's collectives (its capture's records) to the
    open ``collective_log``."""
    if _log is not None:
        _log.extend(captured)


def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous copy of ``x`` where the backend can reduce it."""
    if x.device.type == "cuda" and mesh.backend == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def _start(x: torch.Tensor, mesh: Mesh) -> float:
    """The host clock where a collective starts.  Gloo's copy of a CUDA
    tensor to the host waits for the card anyway; waiting here first
    keeps the card's queued work out of the collective's recorded time."""
    if x.device.type == "cuda" and mesh.backend == "gloo":
        torch.cuda.current_stream(x.device).synchronize()
    return time.perf_counter()


def _record(op: str, out: torch.Tensor, t0: float) -> None:
    capturing = out.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    into = _captured if capturing else _log
    if into is not None:
        into.append(Collective(op, str(out.dtype).replace("torch.", ""), tuple(out.shape),
                               out.numel() * out.element_size(),
                               math.nan if capturing else time.perf_counter() - t0))


def _all_reduce(x: torch.Tensor, mesh: Mesh, op, name: str) -> torch.Tensor:
    t0 = _start(x, mesh)
    buf = _staged(x, mesh)
    dist.all_reduce(buf, op=op, group=mesh.group)
    out = buf.to(x.device)
    _record(name, out, t0)
    return out


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise minimum over the ranks (``jax.lax.pmin``)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN, "pmin")


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the ranks (``jax.lax.psum``)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM, "psum")


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order
    (``jax.lax.all_gather(..., tiled=True)``), by the list form of
    ``dist.all_gather``, which gloo and NCCL both take."""
    t0 = _start(x, mesh)
    buf = _staged(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    out = torch.cat(parts, dim=0).to(x.device)
    _record("all_gather", out, t0)
    return out
