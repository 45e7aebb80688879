"""The choices the device makes inside a device-resident loop (the
hierarchical search's arm, K5's route, CPD's E-step phase), recorded as
codes and booked to their host traces once a chunk.

A choice is booked where it is made, with its trace (a deque), the names
of its codes and the code: an int chosen on the host, or an i32 tensor
chosen on the device (one code an element).  Outside a ``recording`` it
is appended to the trace at once.  Inside one (a chunk of
``algorithms/device_loop.py``) it is kept on the device, and the chunk's
report carries it to the host with the chunk's one read.  After each
iteration the loop says whether the iteration ran (``ran``): the codes
booked since the last mark become ``FROZEN`` where it did not, and a
frozen code is not booked to its trace.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

# the code of a choice made in an iteration that did not run
FROZEN = -1


class Recording:
    """The codes booked since the recording opened: ``(trace, names,
    code)`` in the order of booking, each code a tensor on its device.
    With ``predicated`` a choice on CUDA is made on the device, with no
    host read, as a CUDA graph must."""

    def __init__(self, predicated: bool):
        self.predicated = predicated
        self.booked: List[Tuple[object, tuple, torch.Tensor]] = []
        self.marked = 0  # codes booked before the last ``ran``


# the open recording, or None
_OPEN: Optional[Recording] = None


@contextmanager
def recording(predicated: bool = False):
    """Within the block, booked choices go to the returned ``Recording``
    instead of their traces."""
    global _OPEN
    prev, _OPEN = _OPEN, Recording(predicated)
    try:
        yield _OPEN
    finally:
        _OPEN = prev


def is_recording() -> bool:
    return _OPEN is not None


def predicated() -> bool:
    """Whether the open recording asks for choices made on the device."""
    return _OPEN is not None and _OPEN.predicated


def book(trace, names: tuple, code, device=None) -> None:
    """Book a choice: ``names[code]`` to ``trace`` at once outside a
    recording (a tensor ``code`` is read), else ``code`` to the open
    recording (an int filled on ``device``: no blocking host-to-device
    copy)."""
    if _OPEN is None:
        trace.append(names[int(code)])
        return
    if not isinstance(code, torch.Tensor):
        code = torch.full((1,), code, dtype=torch.int32, device=device)
    _OPEN.booked.append((trace, names, code))


def ran(active: torch.Tensor) -> None:
    """The codes booked since the last call belong to an iteration that
    ran where ``active`` holds (broadcast over each code's elements) and
    are ``FROZEN`` elsewhere."""
    if _OPEN is None:
        return
    booked = _OPEN.booked
    for i in range(_OPEN.marked, len(booked)):
        trace, names, code = booked[i]
        booked[i] = (trace, names, torch.where(active, code, FROZEN))
    _OPEN.marked = len(booked)
