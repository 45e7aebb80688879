"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result's line.

Everything a cell is comes from data found by name: the cell in
``BENCHMARK.json``; its configuration ``configs/<config>.json`` (the
``register`` settings, the protocol, the precision it states); its
traffic ``traffic/<traffic>.json`` (sizes in equal shares, the pool, the
registrations whose synchronising calls are counted); its check ``checks/<cell>.json`` (how many
registrations of each size are compared, and each number's limit); the
per-layer metrics ``metrics/<metric>.py``; the kernel families
``kernels/*.json``.

The window is a closed loop with one client: registration after
registration through ``tpuslam_torch.register(before, after, config)``,
each on a pair it has not sent before, all inside one ``graph_scope``
opened at set-up, after one warm-up registration of each size.  It runs
from its start to the first completion at or after ``--seconds`` once
each size has been sent (``--seconds 0``: one registration a size).
``--trace 1`` profiles the window's first registrations (at least
``TRACE_SECONDS``), counts the synchronising calls of the next
``sync_registrations``, and runs the rest untraced.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import compare  # noqa: E402
import pool as pools  # noqa: E402
import tracing as traces  # noqa: E402
from reference import cpd as ref_cpd  # noqa: E402
from reference import icp as ref_icp  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")
WARMUP_PER_SIZE = 1  # registrations a size before the window: each shape captured
TRACE_SECONDS = 1.0  # the least length of the profiled stretch of a --trace 1 run


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench_dir: Path, name: str) -> Cell:
    """The cell ``name`` of ``<bench_dir>/../BENCHMARK.json`` and its files."""
    spec = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]

    def data(kind: str, key: str) -> dict:
        return json.loads((bench_dir / kind / f"{key}.json").read_text())

    return Cell(name, data("configs", w["config"]), data("traffic", w["traffic"]),
                data("checks", name),
                [m for m in spec["end_to_end"] if _for_cell(m, name)],
                [m for m in spec["per_layer"] if _for_cell(m, name)])


def load_reader(bench_dir: Path, metric: str):
    """The module ``metrics/<metric>.py`` (its ``read`` and ``LAYER``)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"regbench_metric_{len(metric)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the system under test ---

class System:
    """``tpuslam_torch.register`` with the configuration's settings: host
    arrays in, (R, t, iterations, error) out."""

    def __init__(self, registration: dict, device: torch.device):
        from tpuslam_torch import register
        from tpuslam_torch.algorithms.device_loop import graph_scope
        from tpuslam_torch.config.configuration import (
            ApproximationType,
            ComputationMethod,
            Configuration,
            ExecutionPolicy,
        )

        enums = {"computation_method": ComputationMethod,
                 "approximation_type": ApproximationType,
                 "execution_policy": ExecutionPolicy}
        fields = {k: (enums[k](v) if k in enums else v) for k, v in registration.items()}
        self.config = Configuration(**fields)
        self.device = device
        self.register = register
        self.graph_scope = graph_scope
        if device.type == "cuda":
            from tpuslam_torch.kernels import build

            build.load_library()

    def __call__(self, before: np.ndarray, after: np.ndarray):
        return self.register(before, after, self.config, device=self.device)


def reference(config: dict, before: np.ndarray, after: np.ndarray, dtype, device):
    """The plain reference's result on one pair, in ``dtype``."""
    r = config["registration"]
    method = r["computation_method"]
    if method == "icp":
        return ref_icp.icp(before, after, eps=r["convergence_epsilon"],
                           max_distance_squared=r["max_distance_squared"],
                           max_iterations=r["max_iterations"], dtype=dtype, device=device)
    if method == "cpd":
        return ref_cpd.cpd(before, after, weight=r["cpd_weight"],
                           const_scale=r["cpd_const_scale"], tolerance=r["cpd_tolerance"],
                           eps=r["convergence_epsilon"], max_iterations=r["max_iterations"],
                           hybrid=r["approximation_type"] == "hybrid", dtype=dtype,
                           device=device)
    raise ValueError(f"no reference for method {method!r}")


def count_syncs(fn: Callable):
    """``fn()`` under torch's CUDA sync debug mode: (result, the number of
    synchronising calls it made).  The arithmetic of
    ``tpuslam_torch/harness/benchkit.py::count_syncs``."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum(1 for w in caught if "synchroniz" in str(w.message))


# --- the run ---

class Traffic:
    """The request sequence: the sizes in equal shares, round by round in
    an order drawn from the seed, each request on the next pair of its
    size's pool."""

    def __init__(self, traffic: dict, seed: int, pools_by_size: dict):
        self.sizes = [int(s) for s in traffic["sizes"]]
        self.seed = seed
        self.pools = pools_by_size
        self.sent = {n: 0 for n in self.sizes}
        self.order: list = []

    def next(self):
        """(size, index within the size, the pair)."""
        if not self.order:
            rnd = sum(self.sent.values()) // len(self.sizes)
            perm = pools.rng_for(self.seed, 7, rnd).permutation(len(self.sizes))
            self.order = [self.sizes[i] for i in perm]
        n = self.order.pop(0)
        k = self.sent[n]
        self.sent[n] += 1
        return n, k, pools.pair(self.pools[n], self.seed, k)


def _finite(result) -> bool:
    r, t, _, e = result
    return bool(np.all(np.isfinite(r)) and np.all(np.isfinite(t)) and math.isfinite(float(e)))


def run(bench_dir: Path, workload: str, seed: int, seconds: float, trace_on: bool,
        t_start: float, device: torch.device, system: Optional[Callable] = None,
        log=print) -> dict:
    """One run; returns the result line's object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], ``readings``: every
    number of ``compare.NUMBERS``, ``checks``: those the cell compares).
    ``system`` replaces the program: the control, or a planted fault."""
    cell = load_cell(bench_dir, workload)
    cfg, tr = cell.config, cell.traffic
    sut = System(cfg["registration"], device)
    call = system if system is not None else sut
    sizes = [int(s) for s in tr["sizes"]]
    per = int(tr["pool_pairs_per_size"])
    made = {n: pools.make_pool(seed, n, per, cfg["protocol"], device) for n in sizes}
    warm = {n: pools.make_pool(seed, n, WARMUP_PER_SIZE, cfg["protocol"], device, stream=1)
            for n in sizes}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    traffic = Traffic(tr, seed, made)
    records: list = []
    trace = None
    with sut.graph_scope() as graphs:
        for n in sizes:
            for i in range(len(warm[n].before)):
                call(warm[n].before[i], warm[n].after[i])
        if cuda:
            torch.cuda.synchronize()
        graphs_warm = len(graphs)
        t0 = time.perf_counter()
        setup_s = t0 - t_start

        def one(out: list) -> None:
            n, k, p = traffic.next()
            t1 = time.perf_counter()
            try:
                res = call(p.before, p.after)
                ok = _finite(res)
            except Exception as exc:  # a registration that raises is a failed request
                log(f"registration of size {n}, pair {k} raised: {exc!r}", file=sys.stderr)
                res, ok = None, False
            t2 = time.perf_counter()
            out.append({"size": n, "k": k, "ms": (t2 - t1) * 1e3, "ok": ok, "end": t2,
                        "result": res, "iterations": res[2] if ok else 0})

        if trace_on:
            def stretch():
                got: list = []
                t_s = time.perf_counter()
                while not got or time.perf_counter() - t_s < TRACE_SECONDS:
                    with torch.profiler.record_function("regbench.register"):
                        one(got)
                return got

            profiled, events = traces.profile(stretch, device.type)
            records += profiled
            syncs = None
            if cuda:
                _, nsync = count_syncs(lambda: [one(records) for _ in
                                                range(int(tr["sync_registrations"]))])
                syncs = (nsync, int(tr["sync_registrations"]))
            else:
                for _ in range(int(tr["sync_registrations"])):
                    one(records)
            trace = (events, [r for r in profiled if r["ok"]], syncs)
        while len(records) < len(sizes) or records[-1]["end"] - t0 < seconds:
            one(records)
        t_end = records[-1]["end"]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        graphs_new = len(graphs) - graphs_warm
    del graphs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if graphs_new:
        log(f"note: {graphs_new} CUDA graph(s) captured inside the window", file=sys.stderr)

    window_s = t_end - t0
    done = [r for r in records if r["ok"]]
    failed = len(records) - len(done)
    result: dict = {"correct": False, "attempted": len(records), "failed": failed}

    # the check: a sample of each size's registrations, drawn from the seed
    rng = pools.rng_for(seed, 11)
    rows = []
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg["precision"])
    for n in sizes:
        mine = [r for r in done if r["size"] == n]
        take = min(len(mine), int(cell.check["per_size"]))
        for j in sorted(rng.choice(len(mine), size=take, replace=False)) if take else []:
            r = mine[j]
            p = pools.pair(made[n], seed, r["k"])
            ref = reference(cfg, p.before, p.after, dtype, device)
            rows.append(compare.numbers(r["result"], ref))
    readings = compare.worst(rows) if rows else {k: float("nan") for k in compare.NUMBERS}
    checks = compare.held(readings, cell.check["limits"])
    result["correct"] = bool(rows) and failed == 0 and compare.passes(checks)

    metrics: dict = {}
    if trace_on:
        events, profiled, syncs = trace
        t = traces.Trace(events, traces.load_families(bench_dir / "kernels"), profiled,
                         done, syncs)
        for m in cell.per_layer:
            value = load_reader(bench_dir, m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": t.busy_us * 1e-6, "window_s": t.window_us * 1e-6}
        breakdown = t.breakdown()
    else:
        lat = [r["ms"] for r in done]
        values = {"registrations_per_s": len(done) / window_s,
                  "registration_p95_ms": float(np.percentile(lat, 95)) if lat else float("nan"),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        dev_extra, breakdown = {}, None
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
        **dev_extra,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = readings
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
