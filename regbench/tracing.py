"""The traced stretch of a ``--trace 1`` run and what the per-layer
readers read from it.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside a ``regbench.window`` annotation, exports the chrome
trace to a temporary file and returns its events.  ``Trace`` holds what
the readers need: the device operations inside the window (kernels,
copies, fills), the window's length, the busy time (the union of the
device operations' intervals), the kernel families that name each
kernel's layer (``kernels/*.json``), the registrations of the stretch
and of the whole window, and the synchronising calls counted.
"""

from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "regbench.window"
TOP = 10


class Family(NamedTuple):
    name: str
    pattern: re.Pattern
    layer: str


def load_families(folder: Path) -> list:
    """Every kernel family (``<folder>/<name>.json``: a name pattern and a
    layer), in name order."""
    out = []
    for f in sorted(Path(folder).glob("*.json")):
        spec = json.loads(f.read_text())
        out.append(Family(f.stem, re.compile(spec["pattern"]), spec["layer"]))
    return out


def profile(fn: Callable, device_type: str):
    """(``fn()``'s result, the chrome trace's events) with ``fn`` profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if device_type == "cuda":
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return out, events


def _complete(events: list) -> list:
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """A traced stretch, as the per-layer readers see it."""

    def __init__(self, events: list, families: list, profiled: list, window: list,
                 syncs: Optional[tuple] = None):
        ev = _complete(events)
        marks = [e for e in ev if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if marks:
            self.start, self.end = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
        else:
            self.start = min((float(e["ts"]) for e in ev), default=0.0)
            self.end = max((float(e["ts"]) + float(e["dur"]) for e in ev), default=0.0)
        inside = [e for e in ev if self.start <= float(e["ts"]) < self.end]
        self.device_ops = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device_ops if e.get("cat") == "kernel"]
        self.host_ops = [e for e in inside if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
        self.families = families
        self.profiled = profiled  # registrations of the stretch: dicts with "iterations"
        self.window = window  # every registration of the measured window
        self.syncs = syncs  # (synchronising calls, registrations), or None
        self.busy = _union([(float(e["ts"]), min(self.end, float(e["ts"]) + float(e["dur"])))
                            for e in self.device_ops])

    @property
    def window_us(self) -> float:
        return self.end - self.start

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy)

    def layer_of(self, kernel: str) -> Optional[str]:
        for fam in self.families:
            if fam.pattern.search(kernel):
                return fam.layer
        return None

    def kernel_us(self, layer: Optional[str]) -> tuple:
        """(device microseconds, kernel count) of the kernels of ``layer``
        (None: the kernels no family claims)."""
        ks = [e for e in self.kernels if self.layer_of(e["name"]) == layer]
        return sum(float(e["dur"]) for e in ks), len(ks)

    def iterations(self) -> int:
        return sum(int(r["iterations"]) for r in self.profiled)

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps inside the window, each gap named by the innermost host
        activity under its middle."""
        by_name: dict = {}
        for e in self.device_ops:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            under = [e for e in self.host_ops
                     if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
            inner = min(under, key=lambda e: float(e["dur"]), default=None)
            named.append([inner["name"][:96] if inner else "host: no traced activity",
                          (b - a) * 1e-6])
        return {"device_ops": [[n[:96], us * 1e-6] for n, us in ops], "idle_gaps": named}
