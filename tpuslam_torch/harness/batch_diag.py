"""Batched against solo ICP on the card (port of ``tools/batch_diag.py``):
the measurement behind ``algorithms/batch.py``'s lowering rule
(``_UNROLL_MAX_B``, ``_UNROLL_MIN_PAIRWORK``; on CUDA never unrolled).

    python -m tpuslam_torch.harness.batch_diag [N ...] [--device cpu]
        [--reps 3] [--pairs 16] [--iters 20] [--out FILE]

For each N (default 16,384 and 2,048), 16 uniform source and target
boxes of side 10 (``default_rng(0)``, as the JAX tool), each row the
median of ``--reps`` timed calls after an untimed one (inside one
``icp.graph_scope``, so the untimed call captures the loop's CUDA graph
and the timed ones replay it, as the JAX tool's first call compiles):

* ``nn_batched``: K1's batch form, one launch with B = 16, against
  ``nn_solo``: 16 launches with B = 1 (CUDA events around each call);
* ``icp_batched_dense`` and ``icp_batched_hier``: ``icp_register_batch``
  forced to the batched lowering (``unroll=False``) on each NN arm, 20
  iterations, eps 0, no guard;
* ``icp_solo_dense`` and ``icp_solo_default``: the 16 pairs one by one
  through ``icp_register`` on the dense arm and on the default arm
  (hierarchical on the card from 8,192 target rows) — the unrolled
  lowering's work.

Writes ``bench_results/h100_batch_diag.json``; the rule is not moved here.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tpuslam_torch.harness import benchkit

SIZES = [16_384, 2_048]
PAIRS = 16
ITERS = 20
K1, HIER = ("K1",), ("K2", "K3")


def run(bench: benchkit.Bench, sizes, pairs: int, iters: int, reps: int) -> dict:
    import torch

    from tpuslam_torch.algorithms.batch import icp_register_batch
    from tpuslam_torch.algorithms.icp import graph_scope, icp_register
    from tpuslam_torch.core.types import Cloud
    from tpuslam_torch.kernels.nn_dense import nearest_neighbors_dense_batch

    dev = bench.dev
    summary = {}
    kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=iters,
              divergence_guard=False)
    for n in sizes:
        rng = np.random.default_rng(0)
        src = torch.from_numpy(rng.random((pairs, n, 3), dtype=np.float32) * 10).to(dev)
        tgt = torch.from_numpy(rng.random((pairs, n, 3), dtype=np.float32) * 10).to(dev)
        counts = torch.full((pairs,), n, dtype=torch.int32, device=dev)
        befores, afters = Cloud(src, counts), Cloud(tgt, counts)
        solo = [(Cloud(src[p], counts[p]), Cloud(tgt[p], counts[p])) for p in range(pairs)]
        hier = dev.type == "cuda" and n >= 8192  # the default arm of a solo run
        cases = {
            "nn_batched": (lambda: nearest_neighbors_dense_batch(src, tgt, counts), K1, True),
            "nn_solo": (lambda: [nearest_neighbors_dense_batch(src[p:p + 1], tgt[p:p + 1],
                                                               counts[p:p + 1])
                                 for p in range(pairs)], K1, True),
            "icp_batched_dense": (lambda: icp_register_batch(
                befores, afters, unroll=False, use_spatial=False, **kw), K1, False),
            "icp_batched_hier": (lambda: icp_register_batch(
                befores, afters, unroll=False, use_spatial=True, **kw), HIER, False),
            "icp_solo_dense": (lambda: [icp_register(b, a, use_spatial=False, **kw)
                                        for b, a in solo], K1, False),
            "icp_solo_default": (lambda: [icp_register(b, a, **kw) for b, a in solo],
                                 HIER if hier else K1, False),
        }
        ms = {}
        for name, (fn, expects, events) in cases.items():
            with graph_scope():
                timed, _ = (bench.time_events if events else bench.time_calls)(fn, reps)
            extra = {} if events else {"ms_per_pair_iteration": timed["median_ms"]
                                       / (pairs * iters)}
            bench.row(f"{name}_{pairs}x{n}", timed, expects, pairs=pairs, n_points=n,
                      iters=0 if events else iters, **extra)
            ms[name] = timed["median_ms"]
        summary[f"{pairs}x{n}"] = {
            **ms,
            "nn_batched_over_solo": ms["nn_batched"] / ms["nn_solo"],
            "icp_batched_dense_over_solo_dense": ms["icp_batched_dense"] / ms["icp_solo_dense"],
            "icp_batched_hier_over_solo_default": ms["icp_batched_hier"]
                                                  / ms["icp_solo_default"],
        }
        print(json.dumps({f"{pairs}x{n}": summary[f"{pairs}x{n}"]}), flush=True)
        del src, tgt, befores, afters, solo
    return summary


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    p.add_argument("sizes", nargs="*", type=int, default=SIZES)
    p.add_argument("--pairs", type=int, default=PAIRS)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    summary = run(bench, args.sizes, args.pairs, args.iters, args.reps)
    benchkit.write_json(args.out or benchkit.default_out("batch_diag", dev),
                        {"program": "batch_diag", **bench.stamp, "reps": args.reps,
                         "summary": summary, "rows": bench.rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
