"""Points/s of sharded ICP for each world size (port of
``tools/scaling_bench.py``), on ``parallel/launch.py::run_world``.

    python -m tpuslam_torch.harness.scaling_bench [--device cpu] [--reps 3]
        [--virtual] [--ranks R] [--size 204800] [--iters 20] [--out FILE]

For each world size d = 1, 2, 4, ... up to R (and R), a world of d ranks
registers a 204,800-point uniform box onto its copy turned 0.2 rad about
z and shifted by 1 (PCG64 seed 7): the source replicated, the target
split over the ranks (``parallel/icp.py``), 20 iterations, eps 0, no
guard, the hierarchical arm a block on the card (the dense arm on the
CPU, where the plain versions are slow).  Each rung: one untimed
registration (under NCCL it captures the loop's CUDA graph, which the
world's later registrations replay), then ``--reps`` timed ones in the
same world (the slowest rank's synchronised host time of each), then
one whose synchronising calls rank 0 counts on the card
(``syncs_per_registration``, ``sync_sites``), iterations/s, Mpoints/s,
``efficiency_vs_1`` against the one-rank rung, the kernels' launches on
all ranks, and ``comm_model.predicted_efficiency`` with the collectives'
bytes of ``comm_model.icp_comm_bytes`` over an assumed link (NVLink 4's
published 450 GB/s one way, ``LINK_BYTES_PER_S``, and 10 us a
collective); the rung's result is held to a solo ``icp_register`` of
this process (``solo_max_abs_diff``, ``equal_to_solo``), whose own ms an
iteration (one untimed call, then ``--reps`` timed ones in one
``graph_scope``) stands beside each rung (``solo_ms_per_iter``).

R defaults to the cards on the host, one rank a card under NCCL: on one
card the sweep is the one-rank rung and ``complete_sweep`` is false, as
the JAX tool records on one chip.  ``--virtual`` runs the whole sweep
(R default 4) on gloo ranks sharing one device: the rows are labelled
``"correctness_only": true``, since ranks sharing a device and staging
collectives through the host say nothing of speed across cards.  Writes
``bench_results/h100_scaling.json``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tpuslam_torch.harness import benchkit

SIZE = 204_800
ITERS = 20
TIMEOUT_S = 300.0
# the prediction's link, an assumption until a host with several cards
# measures it: NVLink 4 one way, and a collective's fixed cost
LINK_BYTES_PER_S = 450e9
COLLECTIVE_LATENCY_S = 10e-6


def make_clouds(size: int):
    """The JAX tool's pair: host f32[size, 3] source and target."""
    rng = np.random.Generator(np.random.PCG64(7))
    src = (rng.random((size, 3), np.float32) * 10.0).astype(np.float32)
    th = 0.2
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    return src, (src @ rot.T + np.float32(1.0)).astype(np.float32)


def world_sizes(ranks: int) -> list:
    out, d = [], 1
    while d <= ranks:
        out.append(d)
        d *= 2
    if out[-1] != ranks:
        out.append(ranks)
    return out


def run(bench: benchkit.Bench, size: int, iters: int, reps: int, ranks: int,
        virtual: bool) -> dict:
    from tpuslam_torch.algorithms.icp import graph_scope, icp_register
    from tpuslam_torch.core.types import pad_cloud, round_up
    from tpuslam_torch.parallel import comm_model
    from tpuslam_torch.parallel.launch import run_cases, run_world

    dev = bench.dev
    on_card = dev.type == "cuda"
    backend = "gloo" if virtual or not on_card else "nccl"
    use_spatial = on_card
    src, tgt = make_clouds(size)
    kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=iters,
              divergence_guard=False)
    b, a = pad_cloud(src, device=dev), pad_cloud(tgt, device=dev)
    with graph_scope({}):
        solo_timed, solo = bench.time_calls(
            lambda: icp_register(b, a, use_spatial=use_spatial, **kw), reps)
    solo_ms_per_iter = solo_timed["median_ms"] / iters
    solo_rt = [solo.transform.rotation.cpu().numpy(), solo.transform.translation.cpu().numpy()]
    comm = comm_model.icp_comm_bytes(round_up(size))
    rungs, base = [], None
    for d in world_sizes(ranks):
        case = ("icp", dict(before=src, after=tgt, use_spatial=use_spatial, **kw))
        # the first untimed, the last counting its synchronising calls
        cases = [case] * (reps + 1) + [(case[0], dict(case[1], syncs=True))]
        _, per_rank = run_world(run_cases, d, backend, None if on_card else "cpu", TIMEOUT_S,
                                cases)
        seconds = [max(r[i]["result"]["seconds"] for r in per_rank) for i in range(1, reps + 1)]
        launches = benchkit.sum_launches(r[i]["launches"] for r in per_rank
                                         for i in range(1, reps + 1))
        timed = benchkit.timing([s * 1e3 for s in seconds], launches)
        ips = iters / (timed["median_ms"] / 1e3)
        base = ips if base is None else base
        last = per_rank[0][-1]["result"]
        syncs = per_rank[0][-1]["syncs"] or {}
        diff = max(float(np.max(np.abs(last["rotation"] - solo_rt[0]))),
                   float(np.max(np.abs(last["translation"] - solo_rt[1]))))
        equal = (diff == 0.0 and int(last["iterations"]) == int(solo.iterations)
                 and float(last["error"]) == float(solo.error))
        row = bench.row(
            f"devices_{d}", timed, ("K2", "K3") if use_spatial else ("K1",), devices=d,
            backend=backend, correctness_only=virtual, iter_per_sec=ips,
            mpoints_per_sec=ips * size / 1e6, efficiency_vs_1=ips / (base * d),
            predicted_efficiency=comm_model.predicted_efficiency(
                comm["total"], comm["n_collectives"], 1.0 / base, d, LINK_BYTES_PER_S,
                COLLECTIVE_LATENCY_S),
            solo_max_abs_diff=diff, equal_to_solo=equal, solo_ms_per_iter=solo_ms_per_iter,
            syncs_per_registration=syncs.get("count"), sync_sites=syncs.get("sites"))
        rungs.append(row)
        shown = ("iter_per_sec", "efficiency_vs_1", "predicted_efficiency", "equal_to_solo",
                 "solo_ms_per_iter", "syncs_per_registration")
        print(f"devices={d}: {json.dumps({k: row[k] for k in shown})}", flush=True)
    return {
        "backend": backend,
        "honest_numbers": on_card and not virtual,
        "correctness_only": virtual,
        "cloud_size": size,
        "iters": iters,
        "link_bytes_per_s": LINK_BYTES_PER_S,
        "collective_latency_s": COLLECTIVE_LATENCY_S,
        "comm_bytes_per_iter": comm["total"],
        "complete_sweep": len(rungs) > 1,
        "note": ("one card: the rungs across cards need a host with several"
                 if len(rungs) == 1 else
                 "ranks share one device under gloo: correctness only" if virtual
                 else "measured across cards"),
    }


def main(argv=None) -> int:
    import torch

    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    p.add_argument("--virtual", action="store_true",
                   help="the whole sweep on gloo ranks sharing one device (correctness only)")
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    ranks = args.ranks or (4 if args.virtual else
                           torch.cuda.device_count() if dev.type == "cuda" else 1)
    res = run(bench, args.size, args.iters, args.reps, ranks, args.virtual)
    benchkit.write_json(args.out or benchkit.default_out("scaling", dev),
                        {"program": "scaling_bench", **bench.stamp, "reps": args.reps, **res,
                         "rows": bench.rows})
    print(json.dumps({k: res[k] for k in ("backend", "complete_sweep", "note")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
