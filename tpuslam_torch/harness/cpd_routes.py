"""Where the batched CPD loop should send a pair's truncated E-step.

Hybrid CPD's slow phase truncates the Gaussian, so most block pairs of
two large clouds add +0.0.  ``algorithms/batch.py::cpd_register_batch``
can send such an E-step into K4's batch form with the other stepping
pairs, or to K5 (``cpd_estep_cand``) on its own, which skips those block
pairs at the price of an admission and one host read.  Both give the
same bits (K5 = K4), so the choice is one of time, set by
``batch.CAND_MIN_ROWS``.  This script times three routes on the same
pairs, in turns (A B C, then C B A):

* ``batch``: every truncated E-step in K4's batch form
  (``CAND_MIN_ROWS`` above the clouds);
* ``cand``: every truncated E-step on K5 pair by pair (``CAND_MIN_ROWS``
  0);
* ``solo``: the pairs one by one through solo ``cpd_register`` (what
  ``cpd_register_batch`` did before its pair-axis loop);

and checks that each pair ends with the same bits on all three.  Pairs:
uniform boxes of side 10 moved by (0.1 rad, 0.5) with noise 0.01 and
their rows permuted, Hybrid without the FGT, weight 0.1, const scale,
tolerance 0, so every pair runs ``--iters`` iterations (Hybrid's switch
comes at iteration 21 at 2,048 points and 33 at 102,400 to 376,401).
The default sizes take about four minutes on an H100.

    PYTHONPATH=. python3 tpuslam_torch/harness/cpd_routes.py
        [--sizes 16384:16,102400:4] [--iters 60] [--device cuda] [--out FILE]

Prints one JSON line per size, with each run's wall (host clock around a
synchronised call), the E-steps of each kind, the K4 and K5 launches,
and per truncated E-step the difference of the routes' walls.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def make_pairs(rng, n_pairs: int, n: int):
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    befores, afters = [], []
    for _ in range(n_pairs):
        x = (rng.random((n, 3)) * 10).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.1)
        y = (x @ r.T + get_random_translation_vector(rng, 0.5)
             + rng.normal(0, 0.01, x.shape)).astype(np.float32)
        befores.append(x)
        afters.append(y[rng.permutation(n)])
    return befores, afters


def run_sizes(sizes, iters: int, device: str) -> list:
    from tpuslam_torch.algorithms import batch, cpd
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import Cloud
    from tpuslam_torch.kernels import cpd_cand, cpd_dense

    dev = torch.device(device)
    if dev.type == "cuda":
        from tpuslam_torch.kernels import build

        build.load_library()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    kw = dict(eps=1e-6, weight=0.1, const_scale=True, max_iterations=iters, tolerance=0.0,
              approximation_type=ApproximationType.Hybrid, use_fgt=False,
              use_kernels=True)  # the plain versions on the CPU
    rng = np.random.Generator(np.random.PCG64(2048))
    default = batch.CAND_MIN_ROWS
    out = []
    for n, n_pairs in sizes:
        befores, afters = make_pairs(rng, n_pairs, n)
        bb = batch.stack_clouds(befores, device=dev)
        ba = batch.stack_clouds(afters, device=dev)

        def batched(threshold):
            batch.CAND_MIN_ROWS = threshold
            try:
                res = batch.cpd_register_batch(bb, ba, **kw)
            finally:
                batch.CAND_MIN_ROWS = default
            return [(res.transform.rotation[p], res.transform.translation[p],
                     int(res.iterations[p]), res.error[p]) for p in range(n_pairs)]

        def solo():
            res = [cpd.cpd_register(Cloud(bb.points[p], bb.count[p]),
                                    Cloud(ba.points[p], ba.count[p]), **kw)
                   for p in range(n_pairs)]
            return [(r.transform.rotation, r.transform.translation, int(r.iterations), r.error)
                    for r in res]

        routes = {"batch": lambda: batched(1 << 62), "cand": lambda: batched(0), "solo": solo}
        # an untimed call: the first of a process loads CUDA libraries
        batch.cpd_register_batch(Cloud(bb.points[:2], bb.count[:2]),
                                 Cloud(ba.points[:2], ba.count[:2]), **dict(kw, max_iterations=2))
        runs = {name: [] for name in routes}
        results = {}
        for name in list(routes) + list(reversed(routes)):
            cpd.PHASE_TRACE.clear()
            cpd_cand.ROUTE_TRACE.clear()
            k4 = sum(cpd_dense.BATCH_LAUNCHES.values())
            k5 = cpd_cand.DENOM_LAUNCHES
            sync()
            t0 = time.perf_counter()
            got = routes[name]()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            phases = list(cpd.PHASE_TRACE)
            runs[name].append({"ms": ms, "exact": phases.count("exact"),
                               "trunc": phases.count("trunc"),
                               "k4_launches": sum(cpd_dense.BATCH_LAUNCHES.values()) - k4,
                               "k5_launches": cpd_cand.DENOM_LAUNCHES - k5,
                               "routes": {r: list(cpd_cand.ROUTE_TRACE).count(r)
                                          for r in ("k4", "k5")}})
            results[name] = got
            if name == "solo":
                # solo runs append their phases pair after pair
                switch = [(phases[p * iters:(p + 1) * iters] + ["trunc"]).index("trunc")
                          for p in range(n_pairs)]
        first = results["batch"]
        equal = {name: all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
                           and torch.equal(a[3], b[3]) for a, b in zip(got, first))
                 for name, got in results.items()}
        trunc = runs["batch"][0]["trunc"]
        ms = {name: [r["ms"] for r in rs] for name, rs in runs.items()}
        mean = {name: float(np.mean(v)) for name, v in ms.items()}
        row = {"n": n, "pairs": n_pairs, "iterations": iters,
               # each pair's first truncated iteration (iters if none)
               "first_truncated_iteration": switch,
               "runs": runs, "equal_bits": equal,
               "ms_per_pair_iteration": {k: v / (n_pairs * iters) for k, v in mean.items()},
               "batch_minus_cand_ms_per_trunc_estep":
                   (mean["batch"] - mean["cand"]) / trunc if trunc else None}
        out.append(row)
        print(json.dumps(row), flush=True)
        del bb, ba
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes",
                        default="16384:16,32768:8,65536:4,102400:4,262144:2,376401:2",
                        help="points:pairs, comma-separated")
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = parser.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split(":")) for s in args.sizes.split(",")]
    rows = run_sizes(sizes, args.iters, args.device)
    bad = [(r["n"], name) for r in rows for name, ok in r["equal_bits"].items() if not ok]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if bad:
        print(f"cpd_routes: routes disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
