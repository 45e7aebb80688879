"""Large-cloud CPD (port of ``tools/cpd_large.py``): BASELINE config 4,
CPD on the mustang's 376,401 points, here the ``synthetic://`` cloud of
that size normalized to spread 10.

    python -m tpuslam_torch.harness.cpd_large [size] [--device cpu]
        [--reps 3] [--iters 30] [--out FILE]

Rows, each the median of ``--reps`` timed calls after an untimed one, in
the JAX tool's keys (seconds an iteration):

* ``estep_exact_s_per_iter`` (and pairs/s): the exact E-step of the
  self pair, ``cpd_estep_auto`` at sigma^2_0 without truncation (K4);
* ``estep_fgt_s_per_iter``, ``fgt_speedup_vs_exact``: the FGT E-step
  (k 128, p 8, far field 10, the adaptive centre count), and
  ``estep_fgt_cached_s_per_iter`` with both clusterings made once, as
  the EM loop does;
* ``estep_cand_{wide_exact,hybrid_switch,late_trunc}_s_per_iter`` (and
  the speedup against the exact row): ``cpd_estep_cand`` on the
  Morton-sorted pair at sigma^2_0 without truncation, and truncated at
  0.015 and 0.002 x sigma^2_0; each row records K5's route (K5, or K4
  where the admission overflows);
* ``mstep_s_per_iter``: one M-step;
* ``hybrid_30iter_*``: a Hybrid registration of the cloud onto its copy
  moved by (0.2 rad, 10) (PCG64 seed 666), weight 0.1, const scale,
  tolerance 0 and ``--iters`` iterations (30), through ``cpd_register``:
  wall, iterations, gt-MSE against the true motion (absolute and over
  spread^2), the E-step of each iteration (FGT, exact or truncated) and
  K5's routes.  One protocol, where the JAX records ran 15 iterations at
  tolerance 1e-4: on the uniform box that can stop before the slow phase.

Left out: the JAX tool's chunk sizes (the port's automatic CPD chunking
is off on every device) and its wall budget from sampled slow-phase
rates (the Hybrid row records each iteration's E-step instead).  Writes
``bench_results/h100_cpd_large.json`` (``_1m`` from 1,000,000 points).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tpuslam_torch.harness import benchkit

SIZE = 376_401
HYBRID_ITERS = 30
K4, K5 = ("K4_denom", "K4_moments"), ("K5_denom", "K5_moments")
CAND_ROWS = (("wide_exact", 1.0, False), ("hybrid_switch", 0.015, True),
             ("late_trunc", 0.002, True))


def run(bench: benchkit.Bench, size: int, reps: int, iters: int) -> dict:
    import torch

    from tpuslam_torch.algorithms.cpd import (
        PHASE_TRACE,
        cpd_estep_auto,
        cpd_estep_fgt,
        cpd_mstep,
        cpd_register,
        sigma_squared_init,
        uniform_constant,
    )
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import Sufficient, pad_cloud
    from tpuslam_torch.data.loader import load_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
        normalize_cloud,
    )
    from tpuslam_torch.kernels.cpd_cand import ROUTE_TRACE, cpd_estep_cand
    from tpuslam_torch.ops.fgt import k_center
    from tpuslam_torch.ops.spatial import morton_permutation

    dev = bench.dev
    res: dict = {"size": size}
    rng = np.random.Generator(np.random.PCG64(666))
    # normalized to spread 10 before the motion, as the published protocol
    pts = normalize_cloud(load_cloud(f"synthetic://{size}").astype(np.float64),
                          10.0).astype(np.float32)
    cm = cn = pad_cloud(pts, device=dev)
    mm = nm = cm.mask()
    count = torch.sum(mm)
    s2 = sigma_squared_init(cm.points, mm, cn.points, nm)
    const = uniform_constant(s2, 0.1, count, count)
    res["sigma2_init"] = float(s2)

    def seconds(name, timed, expects=(), **extra):
        bench.row(name, timed, expects, n_points=size, **extra)
        return timed["median_ms"] / 1e3

    timed, _ = bench.time_calls(
        lambda: cpd_estep_auto(cm.points, mm, cn.points, nm, s2, const, False), reps)
    dt = res["estep_exact_s_per_iter"] = seconds("estep_exact", timed, K4)
    res["estep_exact_gpairs_per_sec"] = size * size / dt / 1e9

    fgt_kw = dict(fgt_k=128, fgt_p=8, ratio_of_far_field=10.0, sigma2_init=s2)
    timed, _ = bench.time_calls(
        lambda: cpd_estep_fgt(cm.points, mm, cn.points, nm, s2, 0.1, count, count, **fgt_kw),
        reps)
    dt_f = res["estep_fgt_s_per_iter"] = seconds("estep_fgt", timed)
    res["fgt_speedup_vs_exact"] = dt / dt_f
    cy, iy = k_center(cm.points, mm, 128)
    timed, _ = bench.time_calls(
        lambda: cpd_estep_fgt(cm.points, mm, cn.points, nm, s2, 0.1, count, count,
                              clusters=(cy, iy, cy, iy), **fgt_kw), reps)
    res["estep_fgt_cached_s_per_iter"] = seconds("estep_fgt_cached", timed)

    perm = morton_permutation(cm.points, mm).long()
    sorted_pts, sorted_mask = cm.points[perm].contiguous(), mm[perm]
    for label, frac, trunc in CAND_ROWS:
        s2_r = s2 * frac

        def cand(s2_r=s2_r, trunc=trunc):
            ROUTE_TRACE.clear()  # the routes of the last call
            return cpd_estep_cand(sorted_pts, sorted_mask, sorted_pts, sorted_mask, s2_r,
                                  const, torch.tensor(trunc, device=dev))

        timed, _ = bench.time_calls(cand, reps)
        routes = list(ROUTE_TRACE)
        # the tight truncation must take K5 on the card (the smoke's check)
        dt_c = seconds(f"estep_cand_{label}", timed, K5 if label == "late_trunc" else (),
                       sigma2=float(s2_r), trunc=trunc,
                       routes={r: routes.count(r) for r in ("k4", "k5")})
        res[f"estep_cand_{label}_s_per_iter"] = dt_c
        res[f"estep_cand_{label}_speedup_vs_dense"] = dt / dt_c

    stats = Sufficient(p1=mm * 0.5, pt1=nm * 0.5, px=cn.points * mm[:, None] * 0.5,
                       error=torch.tensor(1.0, device=dev))
    one = torch.tensor(1.0, device=dev)
    timed, _ = bench.time_calls(lambda: cpd_mstep(cm.points, cn.points, stats, True, one), reps)
    res["mstep_s_per_iter"] = seconds("mstep", timed)

    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 10.0)
    moved = (pts @ r.T + t)[rng.permutation(size)].astype(np.float32)
    before, after = cm, pad_cloud(moved, device=dev)
    kw = dict(weight=0.1, const_scale=True, tolerance=0.0,
              approximation_type=ApproximationType.Hybrid)

    def hybrid():
        PHASE_TRACE.clear()
        ROUTE_TRACE.clear()
        return cpd_register(before, after, max_iterations=iters, **kw)

    timed, out = bench.time_calls(hybrid, reps,
                                  warm=lambda: cpd_register(before, after, max_iterations=2, **kw))
    rot = out.transform.rotation.cpu().numpy()
    tr = out.transform.translation.cpu().numpy()
    gt_mse = float(np.mean(np.sum((pts @ rot.T + tr - (pts @ r.T + t)) ** 2, -1)))
    phases, routes = list(PHASE_TRACE), list(ROUTE_TRACE)
    tag = f"hybrid_{iters}iter"
    res[f"{tag}_wall_s"] = seconds(
        tag, timed, iterations=int(out.iterations), gt_mse=gt_mse,
        phases={p: phases.count(p) for p in ("fgt", "exact", "trunc")},
        first_truncated_iteration=(phases.index("trunc") + 1 if "trunc" in phases else None),
        routes={k: routes.count(k) for k in ("k4", "k5")})
    res[f"{tag}_gt_mse"] = gt_mse
    # the cloud is normalized to spread 10: gt-MSE over spread^2
    res[f"{tag}_gt_mse_rel_spread2"] = gt_mse / 100.0
    res[f"{tag}_iterations"] = int(out.iterations)
    return res


def main(argv=None) -> int:
    p = benchkit.parser(__doc__.split("\n\n")[0], reps=3)
    p.add_argument("size", nargs="?", type=int, default=SIZE)
    p.add_argument("--iters", type=int, default=HYBRID_ITERS,
                   help="Hybrid iterations (tolerance 0)")
    args = p.parse_args(argv)
    dev = benchkit.bench_device(args.device)
    bench = benchkit.Bench(dev)
    res = run(bench, args.size, args.reps, args.iters)
    suffix = "_1m" if args.size >= 1_000_000 else ""
    out = args.out or benchkit.default_out(f"cpd_large{suffix}", dev)
    benchkit.write_json(out, {"program": "cpd_large", **bench.stamp, "reps": args.reps,
                              **res, "rows": bench.rows})
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
