"""The headline: ICP iterations per second at 100k points on one card
(port of the JAX repository's ``bench.py``).

    python -m tpuslam_torch.harness.bench [--device cpu] [--reps 5]
        [--n-points 102400] [--out FILE]

Prints ONE JSON line, last: ``{"metric": "icp_iters_per_sec_100k_gpu",
"value": ..., "unit": "iter/s", "vs_baseline": ...}`` (``_cpu`` under
``--device cpu``).  The numbers come from ``measure_icp_100k()``: the
published protocol's pair (spread 10, 0.2 rad, translation 10), the
hierarchical arm on the card, 50 iterations a call, one untimed call,
then ``--reps`` calls; the rate is the median call's.  ``vs_baseline``
is against the reference's published GPU figure, under 100 ms an
iteration at 100k points (10 iterations/s).

Writes ``bench_results/h100_headline_100k.json`` (module ``benchkit``):
the measurement, each call's ms, the kernels' launches in the timed
calls, the card's name and power limit.  Without a card and without
``--device cpu`` it raises and prints no line: a missing device is an
error, never a zero.
"""

from __future__ import annotations

import json
import sys

from tpuslam_torch.harness import benchkit
from tpuslam_torch.harness.measure import ITERS_PER_CALL, N_POINTS, measure_icp_100k


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=5)
    p.add_argument("--n-points", type=int, default=N_POINTS)
    p.add_argument("--iters", type=int, default=ITERS_PER_CALL)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    m = measure_icp_100k(n_points=args.n_points, iters=args.iters, reps=args.reps,
                         device=dev)
    row = bench.row("headline", benchkit.timing(m["call_ms"], m["launches"]),
                    expects=("K2", "K3") if m["nn_arm"] == "hier" else ("K1",),
                    **{k: v for k, v in m.items() if k not in ("call_ms", "launches", "reps",
                                                               "device")})
    out = args.out or benchkit.default_out("headline_100k", dev)
    benchkit.write_json(out, {"program": "bench", **bench.stamp, **m, "rows": [row]})
    suffix = "gpu" if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"icp_iters_per_sec_{m['n_points'] // 1024}k_{suffix}",
        "value": m["iters_per_sec"],
        "unit": "iter/s",
        "vs_baseline": m["vs_baseline"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
