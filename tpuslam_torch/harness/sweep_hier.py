"""Tile-parameter sweep of the hierarchical NN's ICP loop (port of
``tools/sweep_hier.py``): the measurement behind
``ops/nn_hier.py::auto_tile_params``.

    python -m tpuslam_torch.harness.sweep_hier [N] [--device cpu]
        [--reps 3] [--triples auto,256:256:160,...] [--iters 50] [--out FILE]

Times a whole 50-iteration ICP loop on the hierarchical arm at N points
(102,400) for each ``(g, gsrc, L)`` triple: target rows a tile, source
rows a group, the candidate budget.  The grid is the JAX tool's six
triples and ``auto``, ``auto_tile_params``' own choice at N.  The loop
is the JAX tool's ``make_icp``: ``prepare_hier_target(g)`` once, then a
transform, ``nearest_neighbors_hier(g, gsrc, l_budget)`` (K2, then K3 on
the fine or coarse table, or K1 where a group overflows), the matched
rows and ``weighted_procrustes``.  The pair: a uniform box of side 10
moved by (0.2 rad, 10), PCG64 seed 666, the sources Morton-sorted once.
Each row: the median of ``--reps`` loops after an untimed one, ms an
iteration, and the arm of each query.  A triple that fails (a kernel
refusing its geometry) is a row with ``failed``, its error.  Writes
``bench_results/h100_sweep_hier.json``; ``auto_tile_params`` is not
changed here.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tpuslam_torch.harness import benchkit

N_POINTS = 102_400
ITERS = 50
GRID = [(256, 256, 160), (256, 128, 160), (256, 256, 96), (512, 256, 96), (128, 128, 256),
        (256, 512, 160)]


def make_pair(n: int, device):
    """(sources Morton-sorted f32[N, 3], their mask, the target Cloud)."""
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.ops.spatial import morton_permutation

    rng = np.random.Generator(np.random.PCG64(666))
    before = (rng.random((n, 3), dtype=np.float64) * 10.0).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 10.0)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    cb, ca = pad_cloud(before, device=device), pad_cloud(after, device=device)
    mask = cb.mask()
    perm = morton_permutation(cb.points, mask).long()
    return cb.points[perm].contiguous(), mask[perm], ca


def icp_loop(src, src_mask, target, g: int, gsrc: int, l_budget: int, iters: int,
             record=None):
    """The timed loop: ``iters`` ICP iterations on the hierarchical arm;
    returns (R, t, the last query's summed distance).  ``record``, a
    list, gets each query's (positions, idx, dist)."""
    import torch

    from tpuslam_torch.ops.nn_hier import hier_state_init, nearest_neighbors_hier
    from tpuslam_torch.ops.procrustes import weighted_procrustes

    dev = src.device
    rot = torch.eye(3, dtype=torch.float32, device=dev)
    tr = torch.zeros(3, dtype=torch.float32, device=dev)
    state = hier_state_init(src.shape[0], device=dev)
    for _ in range(iters):
        moved = src @ rot.T + tr
        idx, dist, state = nearest_neighbors_hier(moved, src_mask, target, state,
                                                  l_budget=l_budget, g=g, gsrc=gsrc)
        matched = target.original_points[idx.long()]
        w = ((dist < 1e18) & (src_mask > 0)).to(torch.float32)
        r_step, t_step = weighted_procrustes(moved, matched, w)
        rot, tr = r_step @ rot, r_step @ tr + t_step
        if record is not None:
            record.append((moved, idx, dist))
    return rot, tr, dist.sum()


def parse_triples(text: str, n: int) -> list:
    from tpuslam_torch.ops.nn_hier import auto_tile_params

    out = []
    for item in text.split(","):
        out.append(tuple(auto_tile_params(n)) if item == "auto"
                   else tuple(int(v) for v in item.split(":")))
    return out


def run(bench: benchkit.Bench, n: int, triples, reps: int, iters: int) -> list:
    from tpuslam_torch.ops import nn_hier

    src, mask, ca = make_pair(n, bench.dev)
    auto = tuple(nn_hier.auto_tile_params(ca.points.shape[0]))
    for g, gsrc, l_budget in triples:
        tag = {"g": g, "gsrc": gsrc, "l_budget": l_budget, "auto": (g, gsrc, l_budget) == auto}
        name = f"g{g}_gsrc{gsrc}_L{l_budget}"
        try:
            target = nn_hier.prepare_hier_target(ca.points, ca.mask(), ca.count, g=g)

            def loop(target=target, g=g, gsrc=gsrc, l_budget=l_budget):
                nn_hier.ARM_TRACE.clear()
                return icp_loop(src, mask, target, g, gsrc, l_budget, iters)

            timed, _ = bench.time_calls(loop, reps)
        except (RuntimeError, ValueError) as e:  # a geometry a kernel refuses
            bench.row(name, {"reps": 0, "launches": {}}, failed=f"{type(e).__name__}: {e}",
                      **tag)
            print(f"{name}: FAIL {type(e).__name__}: {str(e)[:120]}", flush=True)
            continue
        arms = list(nn_hier.ARM_TRACE)
        row = bench.row(name, timed, ("K2", "K3"), n_points=n, iters=iters,
                        ms_per_iter=timed["median_ms"] / iters,
                        arms={a: arms.count(a) for a in ("fine", "coarse", "dense")}, **tag)
        print(f"{name}: {row['ms_per_iter']:.3f} ms/iter, arms {row['arms']}", flush=True)
    return bench.rows


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    p.add_argument("n", nargs="?", type=int, default=N_POINTS)
    p.add_argument("--triples", default=None,
                   help="g:gsrc:L or auto, comma-separated (default: the grid and auto)")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    triples = (parse_triples(args.triples, args.n) if args.triples
               else GRID + parse_triples("auto", args.n))
    rows = run(bench, args.n, triples, args.reps, args.iters)
    benchkit.write_json(args.out or benchkit.default_out("sweep_hier", dev),
                        {"program": "sweep_hier", **bench.stamp, "reps": args.reps,
                         "n_points": args.n, "rows": rows})
    print(json.dumps({"rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
