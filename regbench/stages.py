"""The port's stages in a traced stretch, from its spans.

The port marks the stages of a registration with ``torch.profiler``
annotations (``tpuslam_torch/core/spans.py``): ``tpuslam.register``
around one request, ``tpuslam.entry.copy_in``, ``tpuslam.entry.prepare``
and ``tpuslam.entry.read_out`` around the entry's stages,
``tpuslam.loop`` around the chunk loop and ``tpuslam.loop.capture``
around a graph's capture.  A device operation (kernel, copy or fill)
belongs to the stage whose span launched it: the host event
(``cuda_runtime`` or ``cuda_driver``) with the same ``args.correlation``
gives the launch, and the innermost ``tpuslam.*`` span covering the
launch's start is the stage.  A graph replay's kernels carry the
correlation of their ``cudaGraphLaunch``.  Device idle time in a stage
is the window less the busy time (``Trace.busy``), intersected with the
union of the stage's spans.

A trace of a program without these spans holds no ``tpuslam.register``
span, and every reader of this module then returns None.
"""

from __future__ import annotations

import bisect
from typing import Callable, Optional

PREFIX = "tpuslam."
REGISTER = "tpuslam.register"
ENTRY = "tpuslam.entry."
LOOP = "tpuslam.loop"
CAPTURE = "tpuslam.loop.capture"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def is_entry(stage: Optional[str]) -> bool:
    return stage is not None and stage.startswith(ENTRY)


def is_loop(stage: Optional[str]) -> bool:
    return stage is not None and (stage == LOOP or stage.startswith(LOOP + "."))


def spans(trace) -> list:
    """The ``tpuslam.*`` spans of the stretch, as (start, end, name), outer
    before inner where two start together."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in trace.host_ops
           if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX)]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def registrations(trace) -> int:
    return sum(1 for s in spans(trace) if s[2] == REGISTER)


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def stage_of_ops(trace) -> list:
    """(device operation, its stage) for every device operation of the
    stretch; the stage is None where the launch lies under no ``tpuslam.*``
    span or no host event carries the operation's correlation."""
    launch = {}
    for e in trace.host_ops:
        c = _correlation(e)
        if e.get("cat") in LAUNCH_CATS and c is not None:
            launch[c] = float(e["ts"])
    ss = spans(trace)
    ops = [(launch.get(_correlation(op)), i, op) for i, op in enumerate(trace.device_ops)]
    timed = sorted((t, i) for t, i, _ in ops if t is not None)
    stage: dict = {}
    stack: list = []  # open spans, outermost first
    nxt = 0
    for t, i in timed:
        while nxt < len(ss) and ss[nxt][0] <= t:
            while stack and stack[-1][1] < ss[nxt][0]:
                stack.pop()
            stack.append(ss[nxt])
            nxt += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        stage[i] = stack[-1][2] if stack else None
    return [(op, stage.get(i)) for _, i, op in ops]


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_us(trace, where: Callable[[str], bool]) -> float:
    """Device idle microseconds while the host is inside a span whose name
    ``where`` accepts."""
    inside = _union([(max(a, trace.start), min(b, trace.end))
                     for a, b, name in spans(trace) if where(name)])
    busy = trace.busy
    starts = [a for a, _ in busy]
    total = 0.0
    for a, b in inside:
        covered = 0.0
        k = max(0, bisect.bisect_right(starts, a) - 1)
        while k < len(busy) and busy[k][0] < b:
            covered += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
        total += (b - a) - covered
    return total


def unclaimed_split(trace) -> dict:
    """Device microseconds of the kernels no family claims, split by the
    stage that launched them: ``entry`` (a ``tpuslam.entry.*`` span),
    ``loop`` (``tpuslam.loop`` or a child), ``register`` (under
    ``tpuslam.register`` alone), ``none`` (under no span, or no launch
    event carries the kernel's correlation); and ``total``, their sum."""
    out = {"entry": 0.0, "loop": 0.0, "register": 0.0, "none": 0.0}
    for op, stage in stage_of_ops(trace):
        if op.get("cat") != "kernel" or trace.layer_of(op["name"]) is not None:
            continue
        key = ("entry" if is_entry(stage) else "loop" if is_loop(stage)
               else "register" if stage == REGISTER else "none")
        out[key] += float(op["dur"])
    out["total"] = sum(out.values())
    return out
