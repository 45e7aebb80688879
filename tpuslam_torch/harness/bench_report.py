"""The benchmark report (port of ``tools/bench_report.py``): the rows of
the reference's published claims, measured on one card.

    python -m tpuslam_torch.harness.bench_report [--device cpu] [--reps 5]
        [--sizes key=value,...] [--perf-csv FILE] [--out FILE]

Rows, each under the JAX report's key wherever it has the row (the keys
name the protocol; a cut size is recorded in ``sizes`` and each row's
``n_points``), each the median of ``--reps`` timed calls after an untimed
one, with its spread in ``rows``:

* ``nn_100k_ms``, ``nn_gpairs_per_sec``: K1 at 102,400 x 102,400 (CUDA
  events around each call);
* ``icp_iter_100k_{dense,dense_model,hier,hier_uniform}_ms`` and
  ``icp_iters_per_sec_100k_*``: ``measure_icp_100k`` on the dense arm (10
  iterations a call) on a uniform pair of this report's draws, on the
  dense arm and the default arm (the headline) on ``build_headline_pair``
  (50), and on the hierarchical arm on the uniform pair (50); then
  ``icp_iter_100k_ms``, ``icp_vs_ref_gpu_100ms_per_iter``,
  ``icp_hier_speedup_vs_dense`` and ``icp_mpoints_per_sec_chip_100k``;
* ``nicp_full_run_1M_ms``, ``nicp_vs_ref_gpu_500ms``: ``nicp_register``
  at 1,048,576 points, subcloud 1000, seed 1;
* ``cpd_estep_20k_ms`` and its pairs/s: ``cpd_estep_auto``, exact (K4);
* ``cpd_estep_{8k,20k}_amortized_ms`` and pairs/s: 20 chained exact
  E-steps between two synchronises, the in-loop cost (the JAX report's
  ``lax.scan`` chain);
* ``batch_16x16k_*``, ``batch_16x2k_*``, ``batch_vs_solo_speedup[_small]``:
  ``icp_register_batch`` (the automatic lowering) against the same 16
  pairs one by one through ``icp_register``, 20 iterations, eps 0;
* ``icp_iter_largest_rung_*``, ``icp_iter_1M_plus_median_ms``,
  ``icp_vs_ref_gpu_10s_per_iter_1M``: from the performance-set CSV that
  ``--perf-csv`` names (``python -m tpuslam_torch --test-set
  performance``), else measured by ``measure_icp_100k`` at 1,048,576
  and 1,310,720 points;
* ``icp_iter_{n}_{dense,hier}_ms`` at 8,192, 32,768 and 65,536 points on
  ``build_headline_pair``: with the 100k rows, the ladder behind
  ``algorithms/icp.py::SPATIAL_MIN_ROWS``.

The pairs are the JAX report's: one PCG64(666) stream drawn in its order
(``draw_pairs``), then the ladder.  Left out: ``nn_sustained_gops``, a
count of TPU vector operations.  Writes
``bench_results/h100_bench_report.json`` (``benchkit``).
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np

from tpuslam_torch.harness import benchkit

FULL = dict(nn=102_400, nicp=1_048_576, cpd=20_480, amortized=(8_192, 20_480), chain=20,
            batch_pairs=16, batch_large=16_384, batch_small=2_048, batch_iters=20,
            rungs=(1_048_576, 1_310_720), ladder=(8_192, 32_768, 65_536))
BASELINE_ITER_S = 0.1  # the reference GPU: under 100 ms an ICP iteration at 100k
BASELINE_NICP_S = 0.5  # under 500 ms a NICP run above 1M
BASELINE_1M_ITER_S = 10.0  # under 10 s an ICP iteration above 1M
K1, HIER, K4 = ("K1",), ("K2", "K3"), ("K4_denom", "K4_moments")


def make_pair(rng, n: int, angle: float = 0.2, trans: float = 10.0):
    """The JAX report's ``make_pair``: a uniform box of side 10 and its
    copy moved by (``angle``, ``trans``), rows permuted; host arrays."""
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    before = (rng.random((n, 3), dtype=np.float64) * 10.0).astype(np.float32)
    r = get_random_rotation_matrix(rng, angle)
    t = get_random_translation_vector(rng, trans)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    return before, after


def draw_pairs(sizes: dict) -> dict:
    """Every pair of the report from one PCG64(666) stream, drawn in the
    JAX report's order: NN, NICP, the CPD E-step, the amortized E-steps,
    the large then the small batch."""
    rng = np.random.Generator(np.random.PCG64(666))
    return {
        "nn": make_pair(rng, sizes["nn"]),
        "nicp": make_pair(rng, sizes["nicp"]),
        "cpd": make_pair(rng, sizes["cpd"], trans=1.0),
        "amortized": [make_pair(rng, n, trans=1.0) for n in sizes["amortized"]],
        "batch_large": [make_pair(rng, sizes["batch_large"])
                        for _ in range(sizes["batch_pairs"])],
        "batch_small": [make_pair(rng, sizes["batch_small"])
                        for _ in range(sizes["batch_pairs"])],
    }


def perf_csv_rows(path: str) -> list:
    """(points, per-iteration seconds) of each row of a performance-set CSV
    with iterations (``test-no;cloud-size;...;time(ms);iterations;error``)."""
    with open(path) as fh:
        rows = [r.strip().split(";") for r in fh][1:]
    return [(int(r[1]), float(r[4]) / 1000.0 / int(r[5])) for r in rows if r and int(r[5]) > 0]


def run(bench: benchkit.Bench, sizes: dict, reps: int, perf_csv=None) -> dict:
    from tpuslam_torch.algorithms.batch import icp_register_batch, stack_clouds
    from tpuslam_torch.algorithms.cpd import cpd_estep_auto, sigma_squared_init, uniform_constant
    from tpuslam_torch.algorithms.icp import icp_register
    from tpuslam_torch.algorithms.nicp import nicp_register
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k
    from tpuslam_torch.kernels.nn_dense import nearest_neighbors_dense

    dev = bench.dev
    report: dict = {"backend": dev.type}
    pairs = draw_pairs(sizes)

    def cloud_pair(pair):
        return pad_cloud(pair[0], device=dev), pad_cloud(pair[1], device=dev)

    def icp_row(name, m):
        keep = {k: v for k, v in m.items() if k not in ("call_ms", "launches", "reps", "device")}
        return bench.row(name, benchkit.timing(m["call_ms"], m["launches"]),
                         HIER if m["nn_arm"] == "hier" else K1, **keep)

    # --- K1 at 100k x 100k ---------------------------------------------------
    n = sizes["nn"]
    cb, ca = cloud_pair(pairs["nn"])
    timed, _ = bench.time_events(lambda: nearest_neighbors_dense(cb.points, ca.points, ca.count),
                                 reps)
    bench.row("nn_100k", timed, K1, n_points=n)
    report["nn_100k_ms"] = timed["median_ms"]
    report["nn_gpairs_per_sec"] = n * n / (timed["median_ms"] / 1e3) / 1e9

    # --- ICP per iteration at 100k -------------------------------------------
    sb, sa = build_headline_pair(n, device=dev)
    for label, pair, use_spatial, iters in (
        ("dense", (cb, ca), False, 10),
        ("dense_model", (sb, sa), False, 50),
        ("hier", (sb, sa), None, 50),  # the headline row
        ("hier_uniform", (cb, ca), True, 50),
    ):
        m = measure_icp_100k(iters=iters, reps=reps, use_spatial=use_spatial, pair=pair)
        icp_row(f"icp_iter_100k_{label}", m)
        report[f"icp_iter_100k_{label}_ms"] = m["ms_per_iter"]
        report[f"icp_iters_per_sec_100k_{label}"] = m["iters_per_sec"]
    report["icp_iter_100k_ms"] = report["icp_iter_100k_hier_ms"]
    report["icp_iters_per_sec_100k"] = report["icp_iters_per_sec_100k_hier"]
    report["icp_vs_ref_gpu_100ms_per_iter"] = report["icp_iters_per_sec_100k"] * BASELINE_ITER_S
    report["icp_hier_speedup_vs_dense"] = (report["icp_iters_per_sec_100k_hier"]
                                           / report["icp_iters_per_sec_100k_dense_model"])
    report["icp_mpoints_per_sec_chip_100k"] = n / 1e6 * report["icp_iters_per_sec_100k"]
    del cb, ca, sb, sa

    # --- NICP full run at 1M --------------------------------------------------
    nb, na = cloud_pair(pairs["nicp"])
    timed, _ = bench.time_calls(lambda: nicp_register(nb, na, subcloud_size=1000, seed=1), reps)
    bench.row("nicp_full_run_1M", timed, K1, n_points=sizes["nicp"])
    report["nicp_full_run_1M_ms"] = timed["median_ms"]
    report["nicp_vs_ref_gpu_500ms"] = BASELINE_NICP_S / (timed["median_ms"] / 1e3)
    del nb, na

    # --- CPD E-step at 20k, one call and amortized over a chain ---------------
    def estep_operands(pair):
        mb, ma = cloud_pair(pair)
        s2 = sigma_squared_init(mb.points, mb.mask(), ma.points, ma.mask())
        c = uniform_constant(s2, 0.1, mb.count.float(), ma.count.float())
        return mb, ma, s2, c

    def estep(ty, mb, ma, s2, c):
        return cpd_estep_auto(ty, mb.mask(), ma.points, ma.mask(), s2, c, False)

    ops = estep_operands(pairs["cpd"])
    timed, _ = bench.time_calls(lambda: estep(ops[0].points, *ops), reps)
    n = sizes["cpd"]
    bench.row("cpd_estep_20k", timed, K4, n_points=n)
    report["cpd_estep_20k_ms"] = timed["median_ms"]
    report["cpd_estep_20k_gpairs_per_sec"] = n * n / (timed["median_ms"] / 1e3) / 1e9

    chain = sizes["chain"]
    for label, n, pair in zip(("8k", "20k"), sizes["amortized"], pairs["amortized"]):
        ops = estep_operands(pair)

        def chained(ops=ops):
            # each E-step starts from the last one's output, as in the
            # JAX report's scan, so none can be skipped or reordered
            ty = ops[0].points
            for _ in range(chain):
                out = estep(ty, *ops)
                ty = ty * (1.0 + 1e-7) + out.px * 1e-12
            return out

        timed, _ = bench.time_calls(chained, reps)
        per_ms = timed["median_ms"] / chain
        bench.row(f"cpd_estep_{label}_amortized", timed, K4, n_points=n, chain=chain,
                  per_estep_ms=per_ms)
        report[f"cpd_estep_{label}_amortized_ms"] = per_ms
        report[f"cpd_estep_{label}_amortized_gpairs_per_sec"] = n * n / (per_ms / 1e3) / 1e9
    del ops

    # --- batched multi-pair registration against the pairs one by one ---------
    kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=sizes["batch_iters"],
              divergence_guard=False)
    n_pairs = sizes["batch_pairs"]
    for key, tag, suffix in (("batch_large", "16x16k", ""), ("batch_small", "16x2k", "_small")):
        group = pairs[key]
        bb = stack_clouds([b for b, _ in group], device=dev)
        ba = stack_clouds([a for _, a in group], device=dev)
        solo = [cloud_pair(p) for p in group]
        n = len(group[0][0])
        arm = HIER if (dev.type == "cuda" and n >= 8192) else K1
        t_batch, _ = bench.time_calls(lambda: icp_register_batch(bb, ba, **kw), reps)
        t_solo, _ = bench.time_calls(lambda: [icp_register(b, a, **kw) for b, a in solo], reps)
        bench.row(f"batch_{tag}", t_batch, arm, pairs=n_pairs, n_points=n)
        bench.row(f"batch_{tag}_solo", t_solo, arm, pairs=n_pairs, n_points=n)
        report[f"batch_{tag}_pairs_per_sec"] = n_pairs / (t_batch["median_ms"] / 1e3)
        report[f"batch_{tag}_ms"] = t_batch["median_ms"]
        report[f"batch_vs_solo_speedup{suffix}"] = t_solo["median_ms"] / t_batch["median_ms"]
        del bb, ba, solo

    # --- the large rungs ------------------------------------------------------
    if perf_csv:
        rungs = perf_csv_rows(perf_csv)
        report["perf_csv"] = str(perf_csv)
    else:
        rungs = []
        for n in sizes["rungs"]:
            m = measure_icp_100k(n_points=n, reps=reps, device=dev)
            icp_row(f"icp_iter_{n}", m)
            rungs.append((n, m["ms_per_iter"] / 1e3))
    if rungs:
        size, per_iter = max(rungs)
        report["icp_iter_largest_rung_points"] = size
        report["icp_iter_largest_rung_ms"] = per_iter * 1e3
        above = [s for n, s in rungs if n >= 1_000_000]
        if above:
            med = statistics.median(above)
            report["icp_iter_1M_plus_median_ms"] = med * 1e3
            report["icp_vs_ref_gpu_10s_per_iter_1M"] = BASELINE_1M_ITER_S / med

    # --- the arm ladder below 100k ----------------------------------------------
    for n in sizes["ladder"]:
        pair = build_headline_pair(n, device=dev)
        for label, use_spatial in (("dense", False), ("hier", True)):
            m = measure_icp_100k(reps=reps, use_spatial=use_spatial, pair=pair)
            icp_row(f"icp_iter_{n}_{label}", m)
            report[f"icp_iter_{n}_{label}_ms"] = m["ms_per_iter"]
        del pair
    return report


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=5)
    benchkit.sizes_arg(p, FULL)
    p.add_argument("--perf-csv", default=None,
                   help="a performance-set CSV of the port to read the large rungs from")
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    report = run(bench, args.sizes, args.reps, args.perf_csv)
    out = args.out or benchkit.default_out("bench_report", dev)
    benchkit.write_json(out, {"program": "bench_report", **bench.stamp, "reps": args.reps,
                              "sizes": args.sizes, **report, "rows": bench.rows})
    for k, v in report.items():
        print(f"{k}: {v}")
    print(json.dumps({"out": str(out), "rows": len(bench.rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
