"""What the port's measurement programs share: the device rule, the stamp
on every timed row, the timers, the output file and the sync counter.

The programs (``bench``, ``bench_report``, ``cpd_large``,
``cpd_crossover``, ``sweep_hier``, ``batch_diag``, ``sequence_bench``,
``scaling_bench``, ``convergence_study``; each ``python -m
tpuslam_torch.harness.<name>``) run on the card unless ``--device cpu``
is given; with no card and no ``--device cpu`` they raise and print no
number.  Each writes one file, ``bench_results/h100_<name>.json`` (or
``.jsonl``) on the card and ``build/bench_results/cpu_<name>.json`` on
the CPU, or the file ``--out`` names.

A timed row carries ``device`` (torch's name of the card, or ``"cpu"``),
``power_limit_w`` (nvidia-smi's, None on the CPU), ``fixture``
(``synthetic_fixture()``), ``reps`` with each timed call's ``ms`` and
their ``median_ms``, ``min_ms`` and ``max_ms``, and ``launches``: each
kernel's launches during the timed calls (``kernels.launch_delta``;
the CPU's plain versions launch nothing).  ``expects`` names the kernels
the row must have launched on the card.  Every row is timed after one
untimed call of the same work: a first launch at a new shape, a
cuSOLVER handle and the allocator's first blocks are cold costs.

Timing: the host clock around work that ends in
``torch.cuda.synchronize()``; a single kernel by CUDA events around each
call (``time_events``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.kernels import launch_counts, launch_delta

REPO_ROOT = Path(__file__).resolve().parents[2]
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def parser(description: str, reps: int) -> argparse.ArgumentParser:
    """An argument parser with the flags every program takes."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda[:N] or cpu; default the card, and an error where there is none")
    p.add_argument("--out", default=None, help="the output file (default: module docstring)")
    p.add_argument("--reps", type=int, default=reps, help="timed calls of each row")
    return p


def sizes_arg(p: argparse.ArgumentParser, full: dict) -> None:
    """``--sizes key=value,...``: override entries of ``full`` (a tuple
    entry takes ``a:b:c``)."""
    def parse(text: str) -> dict:
        out = dict(full)
        for item in filter(None, text.split(",")):
            key, value = item.split("=")
            if key not in full:
                raise argparse.ArgumentTypeError(f"unknown size {key!r}; known: {sorted(full)}")
            parts = tuple(int(v) for v in value.split(":") if v)
            out[key] = parts if isinstance(full[key], tuple) else parts[0]
        return out

    p.add_argument("--sizes", type=parse, default=dict(full),
                   help=f"key=value overrides of the full sizes {full}")


def bench_device(name: Optional[str]) -> torch.device:
    """The device a program measures: ``name``, or the card.  Raises where
    there is no card and the CPU was not asked for; loads the kernels on
    the card."""
    if name is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the measurement programs run on the card; "
            "pass --device cpu to run them on the CPU")
    dev = resolve_device(name)
    if dev.type == "cuda":
        from tpuslam_torch.kernels import build

        build.load_library()
    return dev


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def stamp(dev: torch.device) -> dict:
    """The fields every row of a run on ``dev`` carries."""
    from tpuslam_torch.data.loader import synthetic_fixture

    if dev.type == "cuda":
        line = smi_line()
        watts = float(line.rsplit(",", 1)[1].split()[0])
        return {"device": torch.cuda.get_device_name(dev), "power_limit_w": watts,
                "nvidia_smi": line, "fixture": synthetic_fixture()}
    return {"device": "cpu", "power_limit_w": None, "nvidia_smi": None,
            "fixture": synthetic_fixture()}


def timing(ms: list, launches: dict) -> dict:
    """The timing fields of a row from each timed call's ms."""
    return {"reps": len(ms), "ms": ms, "median_ms": statistics.median(ms),
            "min_ms": min(ms), "max_ms": max(ms), "launches": launches}


def sum_launches(launches: Iterable[dict]) -> dict:
    total: dict = {}
    for one in launches:
        for k, v in one.items():
            total[k] = total.get(k, 0) + v
    return total


class Bench:
    """One program's run on one device: its stamp, timers and rows."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stamp = stamp(dev)
        self.rows: list = []

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def time_calls(self, fn: Callable, reps: int, warm: Optional[Callable] = None):
        """(timing, last result): ``warm`` (default ``fn``) once untimed,
        then ``reps`` calls of ``fn``, each on the host clock from a
        synchronised start to a synchronised end."""
        (warm or fn)()
        self.sync()
        before = launch_counts()
        ms, out = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return timing(ms, launch_delta(before)), out

    def time_events(self, fn: Callable, reps: int):
        """(timing, last result) of a single kernel's call: CUDA events
        around each of ``reps`` calls after one untimed call (the host
        clock on the CPU)."""
        if self.dev.type != "cuda":
            return self.time_calls(fn, reps)
        fn()
        self.sync()
        before = launch_counts()
        events, out = [], None
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            events.append((start, stop))
        self.sync()
        return timing([a.elapsed_time(b) for a, b in events], launch_delta(before)), out

    def row(self, name: str, timed: dict, expects: Iterable[str] = (), **extra) -> dict:
        """A stamped row, kept in ``self.rows``."""
        row = {"name": name, **self.stamp, **timed, "expects": list(expects), **extra}
        self.rows.append(row)
        return row


def default_out(name: str, dev: torch.device, suffix: str = ".json") -> Path:
    if dev.type == "cuda":
        return REPO_ROOT / "bench_results" / f"h100_{name}{suffix}"
    return REPO_ROOT / "build" / "bench_results" / f"cpu_{name}{suffix}"


def write_json(path, obj) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
        fh.write("\n")
    return path


def count_syncs(fn: Callable):
    """``fn()`` under torch's CUDA sync debug mode: every synchronising call
    (a device-to-host read, a blocking host-to-device copy, a library call
    that waits) warns once; returns (result, count, count by calling line)."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    sites = Counter(f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in hits)
    return out, len(hits), dict(sites.most_common(8))
