"""Time kernels K2 (bound pass) and K3 (candidate rescore), the
hierarchical query and the 100k headline of two checkouts of the port,
in turns, on one CUDA card.

    python3 tpuslam_torch/harness/ab_kernels.py OLD NEW [--out DIR]
        [--skip-1m] [--sweep]

OLD and NEW are directories that each hold a ``tpuslam_torch`` package:
for example the parent commit's, unpacked with ``git archive HEAD
tpuslam_torch | tar -x -C build/parent``, and ``.``.  Each is measured in
a process of its own (``PYTHONPATH`` set to it, its kernels built from
its own ``csrc/``), in the order OLD, NEW, NEW, OLD, so that a
difference between the two is not the card's drift.  Every run writes
``DIR/ab_<label>.json`` (default ``build/ab``) and the cubin's SASS
beside it, and prints one JSON line.  A run measures:

* at 102,400 points (the headline pair, warm after 12 iterations): K2
  warm and cold, K3 on the fine and the coarse table (identity with the
  plain versions included), the device events of one hierarchical query
  (``torch.profiler``) and its time;
* first, before any profiler (which slows the host for the rest of the
  process), the headline (``measure_icp_100k``): three calls on the
  hierarchical arm and one on the dense arm; at the end a profiler window
  over the last 10 of 30 warm iterations on the hierarchical arm (device
  time by kernel, device events, synchronisations and copies);
* at 1,048,576 points, warm after 8 iterations (``--skip-1m`` leaves it
  out): K2 and K3 as above;
* with ``--sweep``, for a checkout that has the launch geometry
  (``cand_geometry``, ``bound_geometry``): K3's and K2's times over a
  few geometries.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


HEADLINE_CALLS = 3  # measure_icp_100k calls per run (each: warm-up + 3 x 50 iterations)


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def worker(tree: str, label: str, out_dir: str, skip_1m: bool, sweep: bool) -> dict:
    """One run on the package under ``tree``; returns its results."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.algorithms.icp import icp_register, prepare_spatial
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k
    from tpuslam_torch.kernels import bound, build, nn_cand
    from tpuslam_torch.ops import nn_hier
    from tpuslam_torch.ops.geometry import transform_points

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    package = os.path.dirname(os.path.abspath(tpuslam_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {package}, not the one under {tree}")
    time_ms = lambda fn, reps: _time_ms(torch, fn, reps)  # noqa: E731
    res = {"label": label, "tree": os.path.abspath(tree)}
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    build.build(force=True)
    res["build_s"] = build.last_build["seconds"]
    res["ptxas"] = [line.strip() for line in build.last_build["log"].splitlines()
                    if "registers" in line or "spill" in line or "entry function" in line]
    build.load_library()
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        with open(os.path.join(out_dir, f"ab_{label}.sass"), "w") as f:
            f.write(subprocess.run([cuobjdump, "-sass", build.last_build["path"]],
                                   capture_output=True, text=True).stdout)
    dev = torch.device("cuda", 0)

    def tables(adm, m, g, gsrc, l_budget):
        """The fine and the coarse (cand, counts, g) of the arms."""
        counts = adm.sum(1, dtype=torch.int32)
        fine = (nn_hier._build_cand_table(adm, counts, nn_hier.table_width(m, g, l_budget)),
                torch.clamp_max(counts, min(l_budget, m // g)), g)
        g2 = nn_hier._coarse_tile_rows(g, gsrc)
        adm2 = nn_hier.coarse_admission(adm, g, g2)
        counts2 = adm2.sum(1, dtype=torch.int32)
        c2 = m // g2
        coarse = (nn_hier._build_cand_table(adm2, counts2, -(-min(l_budget, c2) // 8) * 8),
                  torch.clamp_max(counts2, min(l_budget, (5 * c2) // 8)), g2)
        return {"fine": fine, "coarse": coarse}

    def measure(setup, pos, state):
        target, g, gsrc, l_budget = setup.target, setup.g, setup.gsrc, setup.l_budget
        m, n = target.packed.shape[0], pos.shape[0]
        out = {"g": g, "gsrc": gsrc, "C": m // g, "groups": n // gsrc}
        saug, aux, eps = nn_hier.bound_operands(pos, setup.src_mask, target, state)
        args = (saug, aux, target.caug, target.radii, eps, state.warm)
        adm = bound.bound_pass(*args, gsrc)
        ref = bound.bound_pass_ref(*[a[None] for a in args], gsrc)[0]
        out["k2_mismatch"] = int((adm != ref).sum())
        out["k2_warm_ms"] = [time_ms(lambda: bound.bound_pass(*args, gsrc), 20)
                             for _ in range(2)]
        cold = nn_hier.hier_state_init(n, dev)
        c_saug, c_aux, c_eps = nn_hier.bound_operands(pos, setup.src_mask, target, cold)
        c_args = (c_saug, c_aux, target.caug, target.radii, c_eps, cold.warm)
        out["k2_cold_ms"] = time_ms(lambda: bound.bound_pass(*c_args, gsrc), 20)
        out["admitted_mean"] = float(adm.sum(1).float().mean())
        arms = tables(adm, m, g, gsrc, l_budget)
        for arm, (cand, cnt, gg) in arms.items():
            call = lambda: nn_cand.nearest_neighbors_cand(  # noqa: E731
                pos, target.packed, cand, cnt, g=gg, gsrc=gsrc)
            if n <= 200_000:
                idx, dist = call()
                r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
                    pos[None], target.packed[None], cand[None], cnt[None], gg, gsrc)
                out[f"k3_{arm}_mismatch"] = int((idx != r_idx[0]).sum()
                                                + (dist != r_dist[0]).sum())
            out[f"k3_{arm}_live_mean"] = float(cnt.float().mean())
            out[f"k3_{arm}_pairs"] = int(cnt.long().sum()) * gg * gsrc
            out[f"k3_{arm}_ms"] = [time_ms(call, 20) for _ in range(2)]
        if sweep and hasattr(nn_cand, "cand_geometry"):
            cand, cnt, gg = arms["fine"]
            times, keep = {}, (nn_cand.BLOCKS_TARGET, nn_cand.STAGE_ROWS, nn_cand.RING_DEPTH)
            for bt in (528, 1056, 2112, 4224):
                for rows, depth in ((512, 3), (256, 4), (1024, 2)):
                    nn_cand.BLOCKS_TARGET, nn_cand.STAGE_ROWS, nn_cand.RING_DEPTH = bt, rows, depth
                    geo = nn_cand.cand_geometry(1, cand.shape[0], cand.shape[1], gsrc)
                    times[f"target{bt}_rows{rows}_depth{depth}_splits{geo.splits}"] = time_ms(
                        lambda: nn_cand.nearest_neighbors_cand(
                            pos, target.packed, cand, cnt, g=gg, gsrc=gsrc), 20)
            nn_cand.BLOCKS_TARGET, nn_cand.STAGE_ROWS, nn_cand.RING_DEPTH = keep
            out["k3_fine_sweep"] = times
        if sweep and hasattr(bound, "bound_geometry"):
            times, keep = {}, (bound.BLOCKS_TARGET, bound.STAGE_TILES)
            for bt in (132, 528, 2112):
                for stage in (256, 64):
                    bound.BLOCKS_TARGET, bound.STAGE_TILES = bt, stage
                    geo = bound.bound_geometry(1, n, m // g, gsrc)
                    key = f"target{bt}_stage{stage}_{geo.chunks}x{geo.splits}"
                    times[key + "_warm"] = time_ms(lambda: bound.bound_pass(*args, gsrc), 20)
                    times[key + "_cold"] = time_ms(lambda: bound.bound_pass(*c_args, gsrc), 20)
                    times[key + "_identical"] = bool(torch.equal(bound.bound_pass(*args, gsrc),
                                                                 ref))
            bound.BLOCKS_TARGET, bound.STAGE_TILES = keep
            out["k2_sweep"] = times

        def query():
            return nn_hier.nearest_neighbors_hier(pos, setup.src_mask, target, state,
                                                  l_budget=l_budget, g=g, gsrc=gsrc)
        query()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                query()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        out["query_device_events"] = sum(names.values()) / 5
        out["query_device_event_names"] = names
        out["query_arm"] = nn_hier.ARM_TRACE[-1]
        out["query_ms"] = time_ms(query, 20)
        return out

    # the headline first: a profiler, once started, slows the host for the
    # rest of the process
    cb, ca = build_headline_pair(102_400, device=dev)
    heads = []
    for _ in range(HEADLINE_CALLS):
        nn_hier.ARM_TRACE.clear()
        head = measure_icp_100k(pair=(cb, ca))
        arms = list(nn_hier.ARM_TRACE)
        head["arms"] = {a: arms.count(a) for a in ("fine", "coarse", "dense")}
        heads.append(head)
    res["headline"] = heads
    res["headline_ms_per_iter"] = [h["ms_per_iter"] for h in heads]
    res["headline_dense_ms_per_iter"] = measure_icp_100k(
        pair=(cb, ca), use_spatial=False)["ms_per_iter"]

    # 102,400 points, warm ---------------------------------------------------
    setup = prepare_spatial(cb, ca)
    mid = icp_register(cb, ca, eps=0.0, max_distance_squared=1e18, max_iterations=12,
                       divergence_guard=False, use_spatial=True)
    pos = transform_points(setup.src_points, mid.transform.rotation, mid.transform.translation)
    res["100k"] = measure(setup, pos, mid.nn)

    def profiled(iters):
        run = lambda: icp_register(  # noqa: E731
            cb, ca, eps=0.0, max_distance_squared=1e18, max_iterations=iters,
            divergence_guard=False, use_spatial=True)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels, events = {}, 0
        for e in prof.events():
            if e.device_type.name == "CUDA":
                events += 1
                kernels[e.name[:50]] = kernels.get(e.name[:50], 0.0) + e.device_time_total / 1e3
        reads = sum(1 for e in prof.events() if e.device_type.name == "CPU"
                    and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                   "cudaMemcpyAsync"))
        return kernels, events, reads

    # the last 10 of 30 warm iterations: a 30-iteration call less a
    # 20-iteration one (device times; the profiler slows the host clock)
    k30, e30, r30 = profiled(30)
    k20, e20, r20 = profiled(20)
    per_iter = {k: (v - k20.get(k, 0.0)) / 10 for k, v in k30.items()}
    res["profile_last10"] = {
        "device_ms_per_iter": sum(per_iter.values()),
        "device_events_per_iter": (e30 - e20) / 10,
        "sync_or_copy_calls_per_iter": (r30 - r20) / 10,
        "kernel_ms_per_iter": sorted(per_iter.items(), key=lambda kv: -kv[1])[:12],
    }

    # 1,048,576 points --------------------------------------------------------
    if not skip_1m:
        rng = np.random.Generator(np.random.PCG64(7))
        n = 1_048_576
        before = (rng.random((n, 3)) * 10).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.1)
        t = get_random_translation_vector(rng, 0.5)
        after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
        lb, la = pad_cloud(before, device=dev), pad_cloud(after, device=dev)
        big = icp_register(lb, la, max_iterations=8, use_spatial=True)
        setup = prepare_spatial(lb, la)
        pos = transform_points(setup.src_points, big.transform.rotation,
                               big.transform.translation)
        res["1m"] = measure(setup, pos, big.nn)
    with open(os.path.join(out_dir, f"ab_{label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="OLD NEW (or one tree with --worker)")
    parser.add_argument("--worker", metavar="LABEL", help="one run on the first tree")
    parser.add_argument("--out", default="build/ab")
    parser.add_argument("--skip-1m", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    a = parser.parse_args(argv)
    out_dir = os.path.abspath(a.out)
    if a.worker:
        res = worker(a.trees[0], a.worker, out_dir, a.skip_1m, a.sweep)
        print(json.dumps({k: v for k, v in res.items() if k != "ptxas"}))
        return 0
    old, new = a.trees
    extra = ["--out", out_dir] + ["--skip-1m"] * a.skip_1m + ["--sweep"] * a.sweep
    rc = 0
    for tree, label in ((old, "old_1"), (new, "new_1"), (new, "new_2"), (old, "old_2")):
        cmd = [sys.executable, os.path.abspath(__file__), tree, "--worker", label, *extra]
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
        print(f"== {label} ({tree}): exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(proc.stdout[-4000:] if proc.returncode == 0 else proc.stderr[-4000:],
              flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
