"""Two checkouts of the port on one CUDA card, in turns (OLD, NEW, NEW,
OLD): the measurement programs that the ICP loop's host reads move.

    python3 tpuslam_torch/harness/ab_loop.py OLD NEW [--out DIR] [--reps N]

OLD and NEW are directories that each hold a ``tpuslam_torch`` package
(for example the parent commit's, unpacked with ``git archive HEAD | tar
-x -C build/parent``, and ``.``).  Each program runs in a process of its
own from that directory, with it on ``PYTHONPATH`` (its kernels built
from its own ``csrc/``), so that a difference between the two is not the
card's drift.  A turn runs:

* ``bench --reps 10``: the headline, 50 iterations a call;
* ``bench_report``: ``icp_iter_100k_{hier,dense_model,hier_uniform,dense}``
  and the arm ladder at 8,192, 32,768 and 65,536 rows among its rows;
* ``sequence_bench``: 20 scans at 102,400 rows, the seeded pair's wall
  and synchronising calls a pair;
* ``batch_diag``: 16 x 16,384 and 16 x 2,048, batched and unrolled;
* ``scaling_bench``: the one-rank NCCL rung at 204,800 rows (the
  sharded loop, which is never captured);
* ``--serve`` in process (``SERVE_CHILD``): the sizes test set's 25 ICP
  sizes (1,000 to 97,000 rows, synthetic, rotation 0.2, translation 10,
  50 iterations) in order, twice, so each size is first met and then met
  again, with the requests that replayed a kept CUDA graph counted (the
  service's hit share); then 6 ICP requests at 102,400 rows (seed 19),
  ms a request.

Every program writes ``DIR/<turn>_<label>_<program>.json``; the last
line printed (and ``DIR/ab_loop_summary.json``) holds each turn's key
numbers.  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PROGRAMS = {
    "bench": ["-m", "tpuslam_torch.harness.bench", "--reps", "10"],
    "bench_report": ["-m", "tpuslam_torch.harness.bench_report"],
    "sequence_bench": ["-m", "tpuslam_torch.harness.sequence_bench"],
    "batch_diag": ["-m", "tpuslam_torch.harness.batch_diag"],
    "scaling_bench": ["-m", "tpuslam_torch.harness.scaling_bench"],
}
SERVE_REQUESTS = 6
# the --serve measurement, run from a checkout's root: argv[1] is the output
SERVE_CHILD = r"""
import io, json, sys, time
import torch
from tpuslam_torch.algorithms import icp
from tpuslam_torch.harness import cli
def icp_request(n, seed):
    return {"method": "icp", "before-path": f"synthetic://{n}",
            "after-path": f"synthetic://{n}", "cloud-spread": 10.0,
            "rotation-range": 0.2, "translation-range": 10.0, "random-seed": seed,
            "max-iterations": 50, "max-distance-squared": 10000.0}
hits = [0]
if hasattr(icp, "_ChunkGraph"):  # a kept graph is loaded on a hit, only then
    load = icp._ChunkGraph.load
    def counted(self, *args):
        hits[0] += 1
        return load(self, *args)
    icp._ChunkGraph.load = counted
def serve(requests):
    marks, before = [], hits[0]
    def lines():
        for r in requests:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield json.dumps(r) + "\n"
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    out = io.StringIO()
    assert cli.run_serve(lines(), out, device="cuda") == 0
    responses = [json.loads(x) for x in out.getvalue().splitlines()]
    assert all(r["ok"] for r in responses), responses
    return {"ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
            "iterations": [r.get("iterations") for r in responses],
            "error": [r.get("error") for r in responses],
            "hits": hits[0] - before if hasattr(icp, "_ChunkGraph") else None,
            "requests": len(requests)}
sizes = list(range(1000, 100001, 4000))
mixed = serve([icp_request(n, 19) for n in sizes] * 2)
same = serve([icp_request(102400, 19)] * %d)
json.dump({"ms": same["ms"], "iterations": same["iterations"], "error": same["error"],
           "hits": same["hits"], "mixed": {"sizes": sizes, **mixed}}, open(sys.argv[1], "w"))
""" % SERVE_REQUESTS


def run_turn(tree: str, label: str, turn: int, out_dir: str, reps) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    walls, paths = {}, {}
    for name, args in [*PROGRAMS.items(), ("serve", None)]:
        path = os.path.abspath(os.path.join(out_dir, f"{turn}_{label}_{name}.json"))
        cmd = ([sys.executable, "-c", SERVE_CHILD, path] if args is None
               else [sys.executable, *args, "--out", path]
               + (["--reps", str(reps)] if reps and name != "bench" else []))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              timeout=900)
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{label} {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        paths[name] = path
    return summarize(paths, walls)


def summarize(paths: dict, walls: dict) -> dict:
    """Each program's key numbers from its output file."""
    load = {k: json.load(open(v)) for k, v in paths.items()}
    rep = load["bench_report"]
    seq = load["sequence_bench"]
    return {
        "nvidia_smi": load["bench"].get("nvidia_smi"),
        "headline_ms_per_iter": load["bench"]["ms_per_iter"],
        "headline_call_ms": load["bench"]["call_ms"],
        "bench_report": {k: v for k, v in rep.items()
                         if k.startswith("icp_iter_") and k.endswith("_ms")},
        "bench_report_ladder": {r["name"]: r["median_ms"] for r in rep["rows"]
                                if r["name"].startswith("icp_iter_")},
        "sequence": {k: v for k, v in seq.items()
                     if k.startswith("scan_seeded") or k.startswith("perpair_seeded")},
        "batch_diag": load["batch_diag"]["summary"],
        "batch_diag_per_pair_iteration_ms": {
            r["name"]: r["ms_per_pair_iteration"] for r in load["batch_diag"]["rows"]
            if "ms_per_pair_iteration" in r},
        "serve_ms": load["serve"]["ms"],
        "serve_iterations": load["serve"]["iterations"],
        "serve_hits": load["serve"]["hits"],
        "serve_mixed_first_ms": load["serve"]["mixed"]["ms"][:25],
        "serve_mixed_again_ms": load["serve"]["mixed"]["ms"][25:],
        "serve_mixed_hits": load["serve"]["mixed"]["hits"],
        "scaling_one_rank": {k: load["scaling_bench"]["rows"][0][k] for k in (
            "median_ms", "ms", "iter_per_sec", "solo_max_abs_diff")},
        "program_walls_s": walls,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--out", default="build/ab_loop")
    p.add_argument("--reps", type=int, default=None,
                   help="--reps of every program but bench (default: each program's own)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for turn, (tree, label) in enumerate([(args.old, "old"), (args.new, "new"),
                                          (args.new, "new"), (args.old, "old")]):
        t0 = time.perf_counter()
        summary = run_turn(tree, label, turn, args.out, args.reps)
        runs.append({"turn": turn, "label": label, "tree": tree,
                     "wall_s": time.perf_counter() - t0, **summary})
        print(json.dumps({"turn": turn, "label": label,
                          "headline_ms_per_iter": summary["headline_ms_per_iter"],
                          "serve_ms": summary["serve_ms"]}), flush=True)
    with open(os.path.join(args.out, "ab_loop_summary.json"), "w") as fh:
        json.dump(runs, fh, indent=1)
    print(json.dumps({"ab_loop": [{k: r[k] for k in ("turn", "label",
                                                      "headline_ms_per_iter")}
                                  for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
