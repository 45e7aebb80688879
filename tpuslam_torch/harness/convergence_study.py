"""Convergence rates of ICP, NICP and CPD on the card (port of
``tools/convergence_study.py``), the reference's methodology
(``GetConvergenceTestSet``, ``testset.cpp:119-187``).

    python -m tpuslam_torch.harness.convergence_study [--device cpu]
        [--methods icp,nicp,cpd] [--sizes icp=20000:40000,...] [--repeats 5]
        [--prealign] [--out FILE]

Each method's size ladder (``SIZES``) x the 9 (rotation, translation)
combinations (``COMBOS``) x ``--repeats`` seeds (1000, 1001, ...): a
self-registration of the ``synthetic://`` cloud with a known injected
motion, through ``run_with_configuration`` with ``run_one``'s
configuration (100 iterations at most, spread 10, Hybrid CPD with weight
0.1, tolerance 1e-4 and const scale, NICP subcloud 5000).  A run has
converged when the ground-truth MSE of its recovered motion is below 5 %
of spread^2.  ``--prealign`` runs the ICP ladder with ``icp-prealign``.
``--sizes``, ``--repeats`` and ``--methods`` cut the ladder.

Each row is one run, stamped (its wall as ``ms``, reps 1, the kernels'
launches) and carrying its fixture: on the uniform box the rates are the
box's, not the JAX records' bunny rates.  Each (method, size) starts
with one untimed run.  Writes ``bench_results/h100_convergence.jsonl``
(``_prealign``) and, beside it, ``..._summary.txt``: the rate of each
method overall, by combination and by size.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from tpuslam_torch.config.configuration import (
    ApproximationType,
    ComputationMethod,
    Configuration,
    ExecutionPolicy,
)
from tpuslam_torch.harness import benchkit

COMBOS = [(r, t) for t in (10.0, 20.0, 30.0) for r in (0.2, 0.4, 0.6)]
# the reference's full ladders (testset.cpp:119-187): 5 sizes per method
SIZES = {
    ComputationMethod.Icp: [20000, 40000, 60000, 80000, 100000],
    ComputationMethod.Cpd: [4000, 8000, 12000, 16000, 20000],
    ComputationMethod.NoniterativeIcp: [
        250000, 500000, 750000, 1000000, 1250000,
    ],
}
REPEATS = 5  # reference: 5 repeats per cell
SPREAD_SQ = 100.0  # cloud-spread 10
EXPECTS = {ComputationMethod.Icp: ("K2", "K3"), ComputationMethod.NoniterativeIcp: ("K1",),
           ComputationMethod.Cpd: ("K4_denom", "K4_moments")}


def run_one(method, size, rot, trans, seed, prealign=False, device=None):
    """One run of the study, as the JAX tool's ``run_one`` (the wall
    unrounded)."""
    from tpuslam_torch.algorithms.registry import run_with_configuration
    from tpuslam_torch.data.synthesis import get_clouds_from_config
    from tpuslam_torch.harness.testsets import get_object_with_min_size

    config = Configuration(
        computation_method=method,
        before_path=get_object_with_min_size(size),
        after_path=get_object_with_min_size(size),
        max_iterations=100,
        cloud_spread=10.0,
        max_distance_squared=10000.0,
        transformation_parameters=(rot, trans),
        cloud_before_resize=size,
        cloud_after_resize=size,
        execution_policy=ExecutionPolicy.Parallel,
        approximation_type=(
            ApproximationType.Hybrid
            if method == ComputationMethod.Cpd
            else ApproximationType.NONE
        ),
        nicp_subcloud_size=5000,
        nicp_batch_size=1,
        nicp_iterations=16,
        cpd_weight=0.1,
        cpd_tolerance=1e-4,
        # the reference struct's default (configuration.h:34): its
        # convergence generator bypasses the parser
        cpd_const_scale=True,
        random_seed=seed,
        icp_prealign=prealign,
    )
    before, after, (gt_r, gt_t) = get_clouds_from_config(config)
    t0 = time.perf_counter()
    rotation, translation, iterations, error = run_with_configuration(
        before, after, config, device=device
    )
    wall = time.perf_counter() - t0
    target = before @ gt_r.T + gt_t
    mse = float(
        np.mean(
            np.sum((before @ rotation.T + translation - target) ** 2, -1)
        )
    )
    return {
        "method": method.value,
        "size": size,
        "rotation": rot,
        "translation": trans,
        "seed": seed,
        "iterations": int(iterations),
        "error": float(error),
        "gt_mse": mse,
        "converged": mse < 0.05 * SPREAD_SQ,
        "wall_s": wall,
    }


def summary(rows: list) -> str:
    lines = ["=== convergence rates ==="]
    for method_name in dict.fromkeys(r["method"] for r in rows):
        mrows = [r for r in rows if r["method"] == method_name]
        total = sum(r["converged"] for r in mrows) / len(mrows)
        lines.append(f"{method_name}: overall {total:.2f}")
        for rot, trans in COMBOS:
            sub = [r for r in mrows if r["rotation"] == rot and r["translation"] == trans]
            if sub:
                rate = sum(r["converged"] for r in sub) / len(sub)
                lines.append(f"  rot={rot} trans={trans}: {rate:.2f}")
        for size in dict.fromkeys(r["size"] for r in mrows):
            sub = [r for r in mrows if r["size"] == size]
            lines.append(f"  size={size}: {sum(r['converged'] for r in sub) / len(sub):.2f}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from tpuslam_torch.kernels import launch_counts, launch_delta

    full = {m.value: tuple(s) for m, s in SIZES.items()}
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=1)
    benchkit.sizes_arg(p, full)
    p.add_argument("--methods", default="icp,nicp,cpd")
    p.add_argument("--repeats", type=int, default=REPEATS)
    p.add_argument("--prealign", action="store_true",
                   help="the ICP ladder with icp-prealign (the NICP seed)")
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    wanted = {m.strip() for m in args.methods.split(",")}
    if args.prealign:
        wanted &= {"icp"}
    suffix = "_prealign" if args.prealign else ""
    out = Path(args.out or benchkit.default_out(f"convergence{suffix}", dev, ".jsonl"))
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with open(out, "w") as fh:
        for method in SIZES:
            if method.value not in wanted:
                continue
            for size in args.sizes[method.value]:
                run_one(method, size, *COMBOS[0], 999, args.prealign, dev)  # untimed
                for rot, trans in COMBOS:
                    for rep in range(args.repeats):
                        before = launch_counts()
                        one = run_one(method, size, rot, trans, 1000 + rep, args.prealign, dev)
                        row = bench.row(
                            f"{method.value}_{size}_{rot}_{trans}_{rep}",
                            benchkit.timing([one["wall_s"] * 1e3], launch_delta(before)),
                            EXPECTS[method], **one, prealign=args.prealign)
                        rows.append(row)
                        fh.write(json.dumps(row) + "\n")
                        fh.flush()
                        print(f"{one['method']} n={size} rot={rot} tr={trans} rep={rep}: "
                              f"conv={one['converged']} mse={one['gt_mse']:.3f} "
                              f"{one['wall_s']:.3f}s", flush=True)
    text = summary(rows)
    out.with_name(out.stem + "_summary.txt").write_text(text)
    print("\n" + text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
