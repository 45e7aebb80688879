"""Two checkouts of the port on one CUDA card, in turns (OLD, NEW, NEW,
OLD): the measurement programs that the device-resident loops move.

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
  sharded loop, spawned by ``run_world``);
* ``sharded`` in process (``SHARDED_CHILD``): a one-rank NCCL world in
  the program's own process, all inside one ``icp.graph_scope``, each row
  ``SHARDED_REPS`` timed calls after an untimed one and the synchronising
  calls of one more: sharded hierarchical ICP on ``scaling_bench``'s
  204,800-row pair (20 iterations, eps 0, no guard) beside the solo
  loop on the same pair, and sharded Hybrid CPD at 102,400 (``cpd``'s
  Hybrid row: weight 0.1, constant scale, tolerance 0, 60 iterations)
  beside its solo run, ms an iteration;
* ``--serve`` in process (``SERVE_CHILD``): the sizes test set's 25 ICP
  sizes (1,000 to 97,000 rows, synthetic, rotation 0.2, translation 10,
  50 iterations) in order, twice, so each size is first met and then met
  again, with the requests that replayed a kept CUDA graph counted (the
  service's hit share); then 6 ICP requests at 102,400 rows (seed 19),
  ms a request;
* ``cpd`` in process (``CPD_CHILD``), on uniform boxes of side 10 moved
  by (0.1 rad, 0.5) from one seed, each row ``CPD_REPS`` timed calls
  after an untimed one, all inside one ``icp.graph_scope``: solo CPD
  exact at 20,480 rows to its stop (weight 0.1, tolerance 1e-5, at most
  100 iterations) and Hybrid at 102,400 (weight 0.1, constant scale,
  tolerance 0, 60 iterations), ms an EM iteration and the synchronising
  calls of one more call; the pair axis at 16 x 2,048 and 16 x 16,384
  (exact, constant scale, tolerance 0, 20 iterations), ms a
  pair-iteration;
* ``cpd_pairs`` in process (``CPD_PAIRS_CHILD``), Hybrid pair axes
  whose E-step runs pair by pair in one phase, each row
  ``CPD_PAIRS_REPS`` timed calls after an untimed one inside one
  ``icp.graph_scope``, ms a pair-iteration: 2 x 376,401 (``chip_smoke``'s
  phase 18 case: noise 0.01, tolerance 0, 60 iterations; K5 pair by pair
  in the slow phase), 3 x 102,400 with the FGT (rotations 0.05, 0.15 and
  0.3 rad; tolerance 1e-5 and at most 40 iterations, and tolerance 1e-3
  and at most 60, where the pairs stop apart; each pair's FGT iterations
  from its solo run) and 16 x 2,048 (rotations 0.05 to 0.35 rad, tolerance
  1e-5, at most 60 iterations);
* ``cpd_large --reps 2``: the 376,401-point rows, its 30-iteration
  Hybrid registration among them.

``--programs a,b,...`` runs only those (default: all).

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
    "cpd_large": ["-m", "tpuslam_torch.harness.cpd_large", "--reps", "2"],
}
# the programs run in process, from a script string: argv[1] is the output
CHILDREN = ("serve", "cpd", "cpd_pairs", "sharded")
CPD_REPS = 3
CPD_PAIRS_REPS = 2
SHARDED_REPS = 5
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
try:
    from tpuslam_torch.algorithms.device_loop import ChunkGraph
except ImportError:  # a checkout whose chunk graph lives in icp.py, or has none
    ChunkGraph = getattr(icp, "_ChunkGraph", None)
if ChunkGraph is not None:  # a kept graph is loaded on a hit, only then
    load = ChunkGraph.load
    def counted(self, *args):
        hits[0] += 1
        return load(self, *args)
    ChunkGraph.load = counted
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
            "hits": hits[0] - before if ChunkGraph is not None else None,
            "requests": len(requests)}
sizes = list(range(1000, 100001, 4000))
mixed = serve([icp_request(n, 19) for n in sizes] * 2)
same = serve([icp_request(102400, 19)] * %d)
json.dump({"ms": same["ms"], "iterations": same["iterations"], "error": same["error"],
           "hits": same["hits"], "mixed": {"sizes": sizes, **mixed}}, open(sys.argv[1], "w"))
""" % SERVE_REQUESTS
CPD_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from tpuslam_torch.algorithms import cpd, icp
from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
from tpuslam_torch.config.configuration import ApproximationType as A
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.data.synthesis import get_random_rotation_matrix, get_random_translation_vector
from tpuslam_torch.harness.benchkit import count_syncs
rng = np.random.Generator(np.random.PCG64(13))
def pair(n):
    b = (rng.random((n, 3)) * 10).astype(np.float32)
    r, t = get_random_rotation_matrix(rng, 0.1), get_random_translation_vector(rng, 0.5)
    return b, (b @ r.T + t).astype(np.float32)[rng.permutation(n)]
def timed(fn):
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(%d):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out
res = {}
with icp.graph_scope({}):
    for name, n, kw in (
            ("exact_20480", 20480, dict(approximation_type=A.NONE, weight=0.1, tolerance=1e-5,
                                        max_iterations=100)),
            ("hybrid_102400", 102400, dict(approximation_type=A.Hybrid, weight=0.1,
                                           tolerance=0.0, const_scale=True, max_iterations=60))):
        b, a = pair(n)
        bc, ac = pad_cloud(b, device="cuda"), pad_cloud(a, device="cuda")
        ms, out = timed(lambda: cpd.cpd_register(bc, ac, **kw))
        _, syncs, sites = count_syncs(lambda: cpd.cpd_register(bc, ac, **kw))
        it = int(out.iterations)
        res[name] = {"ms": ms, "iterations": it, "ms_per_iter": [m / it for m in ms],
                     "syncs": syncs, "sync_sites": sites}
    for name, b_, n in (("pairs_16x2048", 16, 2048), ("pairs_16x16384", 16, 16384)):
        clouds = [pair(n) for _ in range(b_)]
        bb = stack_clouds([c[0] for c in clouds], device="cuda")
        ba = stack_clouds([c[1] for c in clouds], device="cuda")
        kw = dict(approximation_type=A.NONE, weight=0.1, tolerance=0.0, eps=1e-6,
                  const_scale=True, max_iterations=20)
        ms, out = timed(lambda: cpd_register_batch(bb, ba, **kw))
        pit = int(out.iterations.sum())
        res[name] = {"ms": ms, "pair_iterations": pit, "ms_per_pair_iter": [m / pit for m in ms]}
json.dump(res, open(sys.argv[1], "w"))
""" % CPD_REPS
CPD_PAIRS_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from tpuslam_torch.algorithms import cpd, icp
from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
from tpuslam_torch.config.configuration import ApproximationType as A
from tpuslam_torch.core.types import Cloud
from tpuslam_torch.data.synthesis import get_random_rotation_matrix, get_random_translation_vector
rng = np.random.Generator(np.random.PCG64(18))
def pair(n, angle, noise):
    b = (rng.random((n, 3)) * 10).astype(np.float32)
    r, t = get_random_rotation_matrix(rng, angle), get_random_translation_vector(rng, 0.5)
    a = b @ r.T + t + (rng.normal(0, noise, b.shape) if noise else 0)
    return b, a.astype(np.float32)[rng.permutation(n)]
hybrid = dict(approximation_type=A.Hybrid, weight=0.1, const_scale=True)
res = {}
with icp.graph_scope({}):
    for name, b_, n, angles, noise, kw in (
            # chip_smoke's phase 18 case: K4's batch form in the fast phase,
            # K5 pair by pair in the slow one (CAND_MIN_ROWS)
            ("pairs_2x376401_hybrid", 2, 376401, (0.1, 0.1), 0.01,
             dict(hybrid, use_fgt=False, tolerance=0.0, eps=1e-6, max_iterations=60)),
            # the FGT pair by pair in the fast phase; pairs moved apart by
            # different amounts, so that they switch and stop apart
            ("pairs_3x102400_hybrid_fgt", 3, 102400, (0.05, 0.15, 0.3), 0.0,
             dict(hybrid, use_fgt=True, tolerance=1e-5, max_iterations=40)),
            ("pairs_3x102400_hybrid_fgt_stops", 3, 102400, (0.05, 0.15, 0.3), 0.0,
             dict(hybrid, use_fgt=True, tolerance=1e-3, max_iterations=60)),
            ("pairs_16x2048_hybrid", 16, 2048, tuple(0.05 + 0.02 * i for i in range(16)), 0.0,
             dict(hybrid, tolerance=1e-5, max_iterations=60))):
        clouds = [pair(n, angles[i], noise) for i in range(b_)]
        bb = stack_clouds([c[0] for c in clouds], device="cuda")
        ba = stack_clouds([c[1] for c in clouds], device="cuda")
        run = lambda: cpd_register_batch(bb, ba, **kw)
        run()
        torch.cuda.synchronize()
        ms = []
        for _ in range(%d):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        its = out.iterations.tolist()
        res[name] = {"ms": ms, "iterations": its,
                     "ms_per_pair_iter": [m / sum(its) for m in ms],
                     "sigma2": out.error.tolist()}
        if kw.get("use_fgt"):
            # each pair's FGT iterations, from its solo run (the same bits)
            fgt = []
            for p in range(b_):
                cpd.PHASE_TRACE.clear()
                cpd.cpd_register(Cloud(bb.points[p], bb.count[p]),
                                 Cloud(ba.points[p], ba.count[p]), **kw)
                fgt.append(list(cpd.PHASE_TRACE).count("fgt"))
            res[name]["fgt_iterations"] = fgt
json.dump(res, open(sys.argv[1], "w"))
""" % CPD_PAIRS_REPS

SHARDED_CHILD = r"""
import json, os, sys, tempfile, time
import numpy as np
import torch
import torch.distributed as dist
from tpuslam_torch.algorithms import cpd, icp
from tpuslam_torch.config.configuration import ApproximationType as A
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.data.synthesis import get_random_rotation_matrix, get_random_translation_vector
from tpuslam_torch.harness.benchkit import count_syncs
from tpuslam_torch.harness.scaling_bench import make_clouds
from tpuslam_torch.parallel import cpd as pcpd
from tpuslam_torch.parallel import icp as picp
from tpuslam_torch.parallel.distributed import initialize
from tpuslam_torch.parallel.mesh import make_mesh, replicate_cloud, shard_cloud
tmp = tempfile.mkdtemp()
initialize(backend="nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
           world_size=1, rank=0)
mesh = make_mesh()
def timed(fn):
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(%d):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _, syncs, sites = count_syncs(fn)
    it = int(out.iterations)
    return {"ms": ms, "iterations": it, "ms_per_iter": [m / it for m in ms],
            "syncs": syncs, "sync_sites": sites}
rng = np.random.Generator(np.random.PCG64(13))
b = (rng.random((102400, 3)) * 10).astype(np.float32)
r, t = get_random_rotation_matrix(rng, 0.1), get_random_translation_vector(rng, 0.5)
a = (b @ r.T + t).astype(np.float32)[rng.permutation(102400)]
src, tgt = make_clouds(204800)
icp_kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=20, divergence_guard=False)
cpd_kw = dict(approximation_type=A.Hybrid, weight=0.1, tolerance=0.0, const_scale=True,
              max_iterations=60)
res = {}
with icp.graph_scope({}):
    rs, sh = replicate_cloud(src, mesh), shard_cloud(tgt, mesh)
    ps, pt = pad_cloud(src, device="cuda"), pad_cloud(tgt, device="cuda")
    res["sharded_icp_hier_204800"] = timed(
        lambda: picp.icp_register_sharded(rs, sh, mesh, use_spatial=True, **icp_kw))
    res["solo_icp_hier_204800"] = timed(
        lambda: icp.icp_register(ps, pt, use_spatial=True, **icp_kw))
    rb, sa = replicate_cloud(b, mesh), shard_cloud(a, mesh)
    pb, pa = pad_cloud(b, device="cuda"), pad_cloud(a, device="cuda")
    res["sharded_cpd_hybrid_102400"] = timed(
        lambda: pcpd.cpd_register_sharded(rb, sa, mesh, **cpd_kw))
    res["solo_cpd_hybrid_102400"] = timed(lambda: cpd.cpd_register(pb, pa, **cpd_kw))
dist.destroy_process_group()
json.dump(res, open(sys.argv[1], "w"))
""" % SHARDED_REPS


def run_turn(tree: str, label: str, turn: int, out_dir: str, reps, programs) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    walls, paths = {}, {}
    children = {"serve": SERVE_CHILD, "cpd": CPD_CHILD, "cpd_pairs": CPD_PAIRS_CHILD,
                "sharded": SHARDED_CHILD}
    for name in programs:
        args = PROGRAMS.get(name)
        path = os.path.abspath(os.path.join(out_dir, f"{turn}_{label}_{name}.json"))
        cmd = ([sys.executable, "-c", children[name], path] if args is None
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
    """Each program's key numbers from its output file (the programs
    that ran)."""
    load = {k: json.load(open(v)) for k, v in paths.items()}
    out = {"program_walls_s": walls}
    if "bench" in load:
        out.update(nvidia_smi=load["bench"].get("nvidia_smi"),
                   headline_ms_per_iter=load["bench"]["ms_per_iter"],
                   headline_call_ms=load["bench"]["call_ms"])
    if "bench_report" in load:
        rep = load["bench_report"]
        out["bench_report"] = {k: v for k, v in rep.items()
                               if k.startswith("icp_iter_") and k.endswith("_ms")}
        out["bench_report_ladder"] = {r["name"]: r["median_ms"] for r in rep["rows"]
                                      if r["name"].startswith("icp_iter_")}
    if "sequence_bench" in load:
        out["sequence"] = {k: v for k, v in load["sequence_bench"].items()
                           if k.startswith("scan_seeded") or k.startswith("perpair_seeded")}
    if "batch_diag" in load:
        out["batch_diag"] = load["batch_diag"]["summary"]
        out["batch_diag_per_pair_iteration_ms"] = {
            r["name"]: r["ms_per_pair_iteration"] for r in load["batch_diag"]["rows"]
            if "ms_per_pair_iteration" in r}
    if "serve" in load:
        serve = load["serve"]
        out.update(serve_ms=serve["ms"], serve_iterations=serve["iterations"],
                   serve_hits=serve["hits"], serve_mixed_first_ms=serve["mixed"]["ms"][:25],
                   serve_mixed_again_ms=serve["mixed"]["ms"][25:],
                   serve_mixed_hits=serve["mixed"]["hits"])
    if "scaling_bench" in load:
        row = load["scaling_bench"]["rows"][0]
        out["scaling_one_rank"] = {k: row.get(k) for k in (
            "median_ms", "ms", "iter_per_sec", "solo_max_abs_diff", "solo_ms_per_iter",
            "syncs_per_registration", "sync_sites")}
    if "cpd" in load:
        out["cpd"] = load["cpd"]
    if "cpd_pairs" in load:
        out["cpd_pairs"] = load["cpd_pairs"]
    if "sharded" in load:
        out["sharded"] = load["sharded"]
    if "cpd_large" in load:
        out["cpd_large"] = {k: v for k, v in load["cpd_large"].items()
                            if k.startswith(("hybrid_30iter", "estep_", "mstep"))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--out", default="build/ab_loop")
    p.add_argument("--reps", type=int, default=None,
                   help="--reps of every program but bench (default: each program's own)")
    p.add_argument("--programs", type=lambda v: v.split(","),
                   default=[*PROGRAMS, *CHILDREN], help="a comma list (default: all)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for turn, (tree, label) in enumerate([(args.old, "old"), (args.new, "new"),
                                          (args.new, "new"), (args.old, "old")]):
        t0 = time.perf_counter()
        summary = run_turn(tree, label, turn, args.out, args.reps, args.programs)
        runs.append({"turn": turn, "label": label, "tree": tree,
                     "wall_s": time.perf_counter() - t0, **summary})
        print(json.dumps({"turn": turn, "label": label,
                          **{k: summary[k] for k in ("headline_ms_per_iter", "serve_ms")
                             if k in summary}}), flush=True)
    with open(os.path.join(args.out, "ab_loop_summary.json"), "w") as fh:
        json.dump(runs, fh, indent=1)
    print(json.dumps({"ab_loop": [{k: r.get(k) for k in ("turn", "label",
                                                          "headline_ms_per_iter")}
                                  for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
