"""Device time under one of the port's spans, a registration: the body
the readers of the Fast Gauss Transform's set-up and of the CPD loop's
phase chunks share (``metrics/fgt.*``, ``metrics/loop.trunc_ms_per_reg``).

A device operation (kernel, copy or fill) counts where the host event
that launched it (``args.correlation``, as ``stages.py`` finds it; a
replay's kernels carry their ``cudaGraphLaunch``'s) starts inside a span
of the name, at any depth below it: a chunk's capture, a span of its
own inside the phase span, counts with the phase.
"""

from __future__ import annotations

import bisect
from typing import Optional

import stages


def device_ms_per_reg(trace, name: str) -> Optional[float]:
    """Device milliseconds a ``tpuslam.register`` span of the operations
    launched under a span ``name``.  None where the trace holds no
    ``tpuslam.register`` span, no span ``name`` or no device operation:
    the trace of a program without that span."""
    regs = stages.registrations(trace)
    inside = stages._union([(a, b) for a, b, n in stages.spans(trace) if n == name])
    if regs == 0 or not inside or not trace.device_ops:
        return None
    launch = {}
    for e in trace.host_ops:
        c = stages._correlation(e)
        if e.get("cat") in stages.LAUNCH_CATS and c is not None:
            launch[c] = float(e["ts"])
    starts = [a for a, _ in inside]
    us = 0.0
    for op in trace.device_ops:
        t = launch.get(stages._correlation(op))
        if t is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= inside[k][1]:
            us += float(op["dur"])
    return us / 1000.0 / regs
