"""The device-resident ICP loop's chunk on the card: how many iterations
run between host reads (``algorithms/device_loop.py::LOOP_CHUNK``).

    python -m tpuslam_torch.harness.loop_chunk [--device cpu] [--reps 5]
        [--sizes 102400:8192] [--chunks 1:2:4:8] [--out FILE]

For each size (``build_headline_pair``) and NN arm (hierarchical, dense),
the loop eagerly at one iteration a read (``eager``: no CUDA graph, the
loop as it runs before its first capture), then each chunk ``k`` with
its captured graph; two rows each, the median of ``--reps`` timed calls
after an untimed one (which captures the graph):

* ``fixed``: ``measure_icp_100k``'s protocol, 50 iterations a call, eps
  0, no guard: ms an iteration (the headline's);
* ``converge``: ``icp_register`` run to its stop (eps 1e-4, the guard on,
  at most 100 iterations) inside one ``icp.graph_scope``, so the timed
  calls replay the graph the untimed one captured (a hit): ms a
  registration, its iterations, and the synchronising calls of one more
  call by calling line (``benchkit.count_syncs``; the card only);
* ``miss`` (chunks with a graph): the same registration, each call in a
  new scope, as a shape met for the first time runs it: one eager chunk,
  the capture, then replays; with the bytes the allocator reserved for
  one such call after ``torch.cuda.empty_cache`` (the graph's private
  pool and the eager chunk's tensors; the card only).

A chunk past the stop runs its remaining iterations frozen, so a larger
``k`` reads the host less and wastes up to ``k - 1`` iterations of
device time.  Writes ``bench_results/h100_loop_chunk.json``.

With ``--cpd`` the program sweeps the same chunk on the CPD loop
instead, on uniform boxes of side 10
moved by (0.1 rad, 0.5) made from one seed (``--cpd-sizes``, default
20,480:102,400): at the first size the exact mode run to its stop
(weight 0.1, tolerance 1e-5, at most 100 iterations), at the second
Hybrid (the FGT fast phase, then the slow phase; weight 0.1, constant
scale, tolerance 0, 60 iterations, ``chip_smoke.py`` phase 10's
protocol): the eager one-iteration loop, then each ``k`` replaying the
graphs one untimed call captured (a hit, inside one
``icp.graph_scope``), ms an EM iteration and the synchronising calls of
one more call (the card only).  Writes
``bench_results/h100_loop_chunk_cpd.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from tpuslam_torch.harness import benchkit

SIZES = (102_400, 8_192)
CHUNKS = (1, 2, 4, 8)
FIXED_ITERS = 50
CONVERGE = dict(eps=1e-4, max_distance_squared=1e4, max_iterations=100)


def run(bench: benchkit.Bench, sizes, chunks, reps: int) -> dict:
    from tpuslam_torch.algorithms import device_loop, icp
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k

    dev = bench.dev
    summary = {}
    saved = (device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS)
    try:
        for n in sizes:
            pair = build_headline_pair(n, device=dev)
            for arm, use_spatial in (("hier", True), ("dense", False)):
                for label, k, graphs in [("eager", 1, False),
                                         *((f"k{k}", k, True) for k in chunks)]:
                    device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS = k, graphs
                    m = measure_icp_100k(n_points=n, iters=FIXED_ITERS, reps=reps, pair=pair,
                                         use_spatial=use_spatial)
                    fixed = bench.row(
                        f"fixed_{n}_{arm}_{label}", benchkit.timing(m["call_ms"], m["launches"]),
                        chunk=k, graphs=graphs, n_points=n, arm=arm,
                        iterations=m["iterations_run"], ms_per_iter=m["ms_per_iter"])

                    def converge():
                        return icp.icp_register(*pair, use_spatial=use_spatial, **CONVERGE)

                    def miss():
                        with icp.graph_scope({}):
                            return converge()

                    with icp.graph_scope({}):
                        timed, res = bench.time_calls(converge, reps)
                        syncs = sites = None
                        if dev.type == "cuda":
                            _, syncs, sites = benchkit.count_syncs(converge)
                    conv = bench.row(
                        f"converge_{n}_{arm}_{label}", timed, chunk=k, graphs=graphs,
                        n_points=n, arm=arm, iterations=int(res.iterations), syncs=syncs,
                        sync_sites=sites)
                    summary[f"{n}_{arm}_{label}"] = {
                        "fixed_ms_per_iter": fixed["ms_per_iter"],
                        "converge_ms": conv["median_ms"],
                        "converge_iterations": conv["iterations"],
                        "converge_syncs": syncs,
                    }
                    if graphs:
                        timed, res = bench.time_calls(miss, reps)
                        reserved = None
                        if dev.type == "cuda":
                            torch.cuda.empty_cache()
                            start = torch.cuda.memory_reserved(dev)
                            miss()
                            reserved = torch.cuda.memory_reserved(dev) - start
                        row = bench.row(
                            f"miss_{n}_{arm}_{label}", timed, chunk=k, graphs=graphs,
                            n_points=n, arm=arm, iterations=int(res.iterations),
                            reserved_bytes=reserved)
                        summary[f"{n}_{arm}_{label}"].update(
                            miss_ms=row["median_ms"], miss_reserved_bytes=reserved)
                    print(json.dumps({f"{n}_{arm}_{label}": summary[f"{n}_{arm}_{label}"]}),
                          flush=True)
    finally:
        device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS = saved
    return summary


CPD_SIZES = (20_480, 102_400)


def run_cpd(bench: benchkit.Bench, sizes, chunks, reps: int) -> dict:
    """The CPD loop's chunk sweep (module docstring)."""
    import numpy as np

    from tpuslam_torch.algorithms import cpd, device_loop, icp
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    dev = bench.dev
    rng = np.random.Generator(np.random.PCG64(13))
    modes = (
        ("exact", dict(approximation_type=ApproximationType.NONE, weight=0.1,
                       tolerance=1e-5, max_iterations=100)),
        ("hybrid", dict(approximation_type=ApproximationType.Hybrid, weight=0.1,
                        tolerance=0.0, const_scale=True, max_iterations=60)),
    )
    summary = {}
    saved = (device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS)
    try:
        for n, (mode, kw) in zip(sizes, modes):
            before = (rng.random((n, 3)) * 10).astype(np.float32)
            r = get_random_rotation_matrix(rng, 0.1)
            t = get_random_translation_vector(rng, 0.5)
            after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
            pair = (pad_cloud(before, device=dev), pad_cloud(after, device=dev))
            for label, k, graphs in [("eager", 1, False),
                                     *((f"k{k}", k, True) for k in chunks)]:
                device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS = k, graphs

                def call():
                    return cpd.cpd_register(*pair, **kw)

                with icp.graph_scope({}):
                    timed, res = bench.time_calls(call, reps)
                    syncs = sites = None
                    if dev.type == "cuda":
                        _, syncs, sites = benchkit.count_syncs(call)
                iters = int(res.iterations)
                row = bench.row(f"cpd_{mode}_{n}_{label}", timed, chunk=k, graphs=graphs,
                                n_points=n, mode=mode, iterations=iters, syncs=syncs,
                                sync_sites=sites, ms_per_iter=timed["median_ms"] / iters)
                summary[f"{mode}_{n}_{label}"] = {
                    "ms_per_iter": row["ms_per_iter"],
                    "ms_per_iter_min": timed["min_ms"] / iters,
                    "ms_per_iter_max": timed["max_ms"] / iters,
                    "iterations": iters, "syncs": syncs}
                print(json.dumps({f"{mode}_{n}_{label}": summary[f"{mode}_{n}_{label}"]}),
                      flush=True)
    finally:
        device_loop.LOOP_CHUNK, device_loop.CUDA_GRAPHS = saved
    return summary


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=5)
    p.add_argument("--sizes", type=lambda s: tuple(int(v) for v in s.split(":")),
                   default=SIZES)
    p.add_argument("--chunks", type=lambda s: tuple(int(v) for v in s.split(":")),
                   default=CHUNKS)
    p.add_argument("--cpd", action="store_true", help="the CPD loop's chunk instead")
    p.add_argument("--cpd-sizes", type=lambda s: tuple(int(v) for v in s.split(":")),
                   default=CPD_SIZES)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    if args.cpd:
        summary = run_cpd(bench, args.cpd_sizes, args.chunks, args.reps)
    else:
        summary = run(bench, args.sizes, args.chunks, args.reps)
    name = "loop_chunk_cpd" if args.cpd else "loop_chunk"
    benchkit.write_json(args.out or benchkit.default_out(name, dev),
                        {"program": name, **bench.stamp, "reps": args.reps,
                         "summary": summary, "rows": bench.rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
