"""The exact-against-FGT crossover of the CPD fast phase (port of
``tools/cpd_crossover.py``): the measurement behind
``algorithms/cpd.py::CPD_FGT_CROSSOVER``.

    python -m tpuslam_torch.harness.cpd_crossover [size ...] [--device cpu]
        [--reps 3] [--out FILE]

For each size (default ``DEFAULT_SIZES``: the JAX tool's five, 50,000 to
376,401, and 20,480), the ``synthetic://`` cloud registered onto itself
in the wide-sigma^2 regime of the fast phase (sigma^2 = sigma^2_0, no
truncation, Morton-sorted rows), three E-steps, each the median of
``--reps`` timed calls after an untimed one:

* exact: ``cpd_estep_cand(trunc=False)``, which goes straight to K4;
* FGT with both clusterings made once (``k_center`` hoisted, as the EM
  loop caches them): the arm the crossover gates;
* FGT uncached: the clusterings made in the call.

Rows keep the JAX schema (``size``, ``exact_s_per_iter``,
``fgt_s_per_iter``, ``fgt_uncached_s_per_iter``, ``fgt_speedup``) beside
the stamp and each arm's timing under ``arms``.  ``crossover_size`` is
the midpoint between the largest size where exact wins and the smallest
where the FGT wins (None where the FGT never wins).  Writes
``bench_results/h100_cpd_crossover.json``; the gate is not moved here.
"""

from __future__ import annotations

import json
import sys

from tpuslam_torch.harness import benchkit

DEFAULT_SIZES = [20_480, 50_000, 100_000, 150_000, 200_000, 376_401]
K4 = ("K4_denom", "K4_moments")


def crossover(rows: list):
    exact_wins = [r["size"] for r in rows if r["fgt_speedup"] < 1.0]
    fgt_wins = [r["size"] for r in rows if r["fgt_speedup"] >= 1.0]
    lo = max(exact_wins) if exact_wins else 0
    hi = min(fgt_wins) if fgt_wins else None
    return (lo + hi) // 2 if hi is not None else None


def run(bench: benchkit.Bench, sizes, reps: int) -> list:
    import torch

    from tpuslam_torch.algorithms.cpd import (
        cpd_estep_fgt,
        sigma_squared_init,
        uniform_constant,
    )
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.loader import load_cloud
    from tpuslam_torch.kernels.cpd_cand import cpd_estep_cand
    from tpuslam_torch.ops.fgt import k_center
    from tpuslam_torch.ops.spatial import morton_permutation

    rows = []
    for size in sizes:
        cm = pad_cloud(load_cloud(f"synthetic://{size}"), device=bench.dev)
        mm = cm.mask()
        perm = morton_permutation(cm.points, mm).long()
        mv, mvm = cm.points[perm].contiguous(), mm[perm]
        count = torch.sum(mvm)
        s2 = sigma_squared_init(mv, mvm, mv, mvm)
        # the fast phase's constant, from the current sigma^2
        const = uniform_constant(s2, 0.1, count, count)
        fgt_kw = dict(fgt_k=128, fgt_p=8, ratio_of_far_field=10.0, sigma2_init=s2)
        cy, iy = k_center(mv, mvm, 128)
        arms = {
            "exact": lambda: cpd_estep_cand(mv, mvm, mv, mvm, s2, const, False),
            "fgt": lambda: cpd_estep_fgt(mv, mvm, mv, mvm, s2, 0.1, count, count,
                                         clusters=(cy, iy, cy, iy), **fgt_kw),
            "fgt_uncached": lambda: cpd_estep_fgt(mv, mvm, mv, mvm, s2, 0.1, count, count,
                                                  **fgt_kw),
        }
        timed = {name: bench.time_calls(fn, reps)[0] for name, fn in arms.items()}
        sec = {name: t["median_ms"] / 1e3 for name, t in timed.items()}
        row = {
            "size": size,
            "exact_s_per_iter": sec["exact"],
            "fgt_s_per_iter": sec["fgt"],
            "fgt_uncached_s_per_iter": sec["fgt_uncached"],
            "fgt_speedup": sec["exact"] / sec["fgt"],
        }
        rows.append(bench.row(f"crossover_{size}", {
            "reps": reps, "launches": benchkit.sum_launches(t["launches"] for t in timed.values())},
            K4, **row, arms=timed))
        print(json.dumps(row), flush=True)
        del cm, mv, cy, iy
    return rows


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    p.add_argument("sizes", nargs="*", type=int, default=DEFAULT_SIZES)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    rows = run(bench, args.sizes, args.reps)
    results = {"program": "cpd_crossover", **bench.stamp, "reps": args.reps, "rows": rows,
               "crossover_size": crossover(rows)}
    benchkit.write_json(args.out or benchkit.default_out("cpd_crossover", dev), results)
    print(json.dumps({"crossover_size": results["crossover_size"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
