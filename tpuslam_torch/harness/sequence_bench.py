"""Sequence odometry on the card (port of ``tools/sequence_bench.py``): a
20-scan stream at 102,400 points a scan through ``register_sequence``.

    python -m tpuslam_torch.harness.sequence_bench [--device cpu] [--reps 3]
        [--patience-sweep] [--cpu-smoke] [--sizes key=value,...] [--out FILE]

The stream (``make_stream``, the JAX tool's): the ``synthetic://`` parent
cloud of 153,600 points normalized to spread 10, moving with a smoothly
precessing velocity (about 0.05 rad and 0.5 a step), each scan resampled
from the parent (102,400 of its rows) and shuffled; PCG64 seed 666.
Rows, each ``register_sequence(max_iterations=50, eps=1e-4)``, the median
of ``--reps`` timed runs after an untimed run on the stream's first
three scans:

* ``scan_seeded`` / ``scan_unseeded``: the scan lowering, with and
  without the constant-velocity seed;
* ``perpair_seeded``: the per-pair lowering (``scan=False``);
* ``--patience-sweep``: the seeded scan at patience 0, 2, 4, 8 and 12.

Each row records its walls, scans/s, mean iterations a pair, the drift
RMS of the last pose (``drift_rms``) and, on the card, its synchronising
calls per pair, counted in one more run under torch's CUDA sync debug
mode (``benchkit.count_syncs``), by calling line.  ``--cpu-smoke`` runs
6 scans of 1,920 points (parent 3,000) on the CPU.  Writes
``bench_results/h100_sequence_100k.json``.  Left out: the JAX tool's
transfer and program-only breakdown, which timed its compiled scan
program apart from the host's staging; the port compiles no program.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from tpuslam_torch.harness import benchkit

FULL = dict(n_scans=20, n_points=102_400, parent=153_600)
SMOKE = dict(n_scans=6, n_points=1_920, parent=3_000)
PATIENCES = (0, 2, 4, 8, 12)


def rot_axis_angle(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return (
        np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    ).astype(np.float32)


def make_stream(n_scans, n_points, parent_n, seed=666):
    """(parent cloud, true absolute poses, scans): scan k is the parent
    resampled and seen from pose k."""
    from tpuslam_torch.data.loader import synthetic_cloud
    from tpuslam_torch.data.synthesis import normalize_cloud

    rng = np.random.Generator(np.random.PCG64(seed))
    parent = normalize_cloud(
        synthetic_cloud(parent_n).astype(np.float64), 10.0
    ).astype(np.float32)[:parent_n]

    # ground-truth absolute poses: a smoothly precessing, nearly constant
    # velocity (the regime the seed targets)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    axis = np.array([0.3, 1.0, 0.2])
    vel = np.array([0.45, 0.2, -0.1], np.float32)
    for k in range(1, n_scans):
        d_axis = axis + 0.1 * np.sin(0.4 * k) * np.array([1.0, 0, 0.5])
        dr = rot_axis_angle(d_axis, 0.05 + 0.01 * np.sin(0.7 * k))
        dt = vel + 0.05 * np.array(
            [np.sin(0.3 * k), np.cos(0.5 * k), np.sin(0.2 * k)],
            np.float32,
        )
        r_prev, t_prev = poses[-1]
        poses.append((dr @ r_prev, dr @ t_prev + dt))

    scans = []
    for k, (r, t) in enumerate(poses):
        sel = rng.permutation(len(parent))[:n_points]
        scans.append((parent[sel] @ r.T + t).astype(np.float32))
    return parent, poses, scans


def drift_rms(parent, poses, out, n_scans):
    """Trajectory drift: composed absolute pose k maps scan k -> scan
    0's frame; the ground-truth inverse does the same."""
    probe = parent[:: max(1, len(parent) // 4096)][:4096]
    drifts = []
    for k in range(1, n_scans):
        r_gt, t_gt = poses[k]
        pts_k = probe @ r_gt.T + t_gt  # scan-k view of probe
        a = out.absolute[k]
        back = pts_k @ np.asarray(a.rotation).T + np.asarray(a.translation)
        drifts.append(
            float(np.sqrt(np.mean(np.sum((back - probe) ** 2, -1))))
        )
    return drifts


def run(bench: benchkit.Bench, sizes: dict, reps: int, perpair: bool, sweep: bool) -> dict:
    import tpuslam_torch

    dev = bench.dev
    n_scans = sizes["n_scans"]
    parent, poses, scans = make_stream(n_scans, sizes["n_points"], sizes["parent"])
    results = {"n_scans": n_scans, "n_points": sizes["n_points"]}
    expects = ("K2", "K3") if sizes["n_points"] >= 8192 else ("K1",)

    def register(stream, **kw):
        return tpuslam_torch.register_sequence(stream, max_iterations=50, eps=1e-4,
                                               device=dev, **kw)

    def run_case(label, **kw):
        extra = {}
        if dev.type == "cuda":
            register(scans[:3], **kw)
            _, syncs, sites = benchkit.count_syncs(lambda: register(scans, **kw))
            extra = {"syncs_per_pair": syncs / (n_scans - 1), "sync_sites": sites}
            results[f"{label}_syncs_per_pair"] = extra["syncs_per_pair"]
        timed, out = bench.time_calls(lambda: register(scans, **kw), reps,
                                      warm=lambda: register(scans[:3], **kw))
        iters = np.asarray(out.iterations)
        drifts = drift_rms(parent, poses, out, n_scans)
        wall = timed["median_ms"] / 1e3
        results[f"{label}_wall_s"] = wall
        results[f"{label}_wall_all_s"] = [ms / 1e3 for ms in timed["ms"]]
        results[f"{label}_scans_per_sec"] = (n_scans - 1) / wall
        results[f"{label}_mean_iters"] = float(iters.mean())
        results[f"{label}_final_drift_rms"] = drifts[-1]
        bench.row(label, timed, expects, n_scans=n_scans, n_points=sizes["n_points"],
                  mean_iters=float(iters.mean()), final_drift_rms=drifts[-1], **kw, **extra)
        print(f"{label}: {wall:.3f} s median of {timed['ms']} ms "
              f"({(n_scans - 1) / wall:.2f} scans/s), mean iters {iters.mean():.1f}, "
              f"final drift RMS {drifts[-1]:.4f}", flush=True)

    run_case("scan_seeded", seed_with_previous=True)
    run_case("scan_unseeded", seed_with_previous=False)
    if perpair:
        run_case("perpair_seeded", scan=False, seed_with_previous=True)
    if sweep:
        for p in PATIENCES:
            run_case(f"scan_patience{p}", seed_with_previous=True, patience=p)
    if perpair:
        results["dispatch_amortization_speedup"] = (results["perpair_seeded_wall_s"]
                                                    / results["scan_seeded_wall_s"])
    results["seed_iteration_savings"] = (results["scan_unseeded_mean_iters"]
                                         - results["scan_seeded_mean_iters"])
    return results


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    benchkit.sizes_arg(p, FULL)
    p.add_argument("--patience-sweep", action="store_true")
    p.add_argument("--cpu-smoke", action="store_true",
                   help="a tiny stream on the CPU (6 scans of 1,920 points)")
    args = p.parse_args(argv)
    if args.cpu_smoke:
        args.device, args.sizes = "cpu", dict(SMOKE)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    t0 = time.perf_counter()
    results = run(bench, args.sizes, args.reps, not args.cpu_smoke, args.patience_sweep)
    out = args.out or benchkit.default_out("sequence_100k", dev)
    benchkit.write_json(out, {"program": "sequence_bench", **bench.stamp, "reps": args.reps,
                              **results, "wall_s": time.perf_counter() - t0,
                              "rows": bench.rows})
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
