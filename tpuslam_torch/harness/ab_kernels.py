"""Time kernels K2 (bound pass) and K3 (candidate rescore), the
hierarchical query and the 100k headline of two checkouts of the port,
in turns, on one CUDA card; with ``--cpd``, kernels K4 and K5 and the
376k CPD Hybrid registration instead; with ``--nn``, kernel K1, the
headline's dense arm and the FGT E-step; with ``--fgt``, the FGT's E-step
and its kernels K6 and K7.

    python3 tpuslam_torch/harness/ab_kernels.py OLD NEW [--out DIR]
        [--skip-1m] [--sweep] [--cpd | --nn | --procrustes | --fgt]

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

With ``--cpd`` a run measures instead (``cpd_worker``), on Morton-sorted
uniform boxes of side 10 made from one seed: at 20,480^2 and 376,401^2
K4's two passes without truncation at the initial sigma^2 and K4's
whole exact E-step; at 376,401^2 K5's two passes (its kernels alone,
under the tables the checkout builds; fat blocks left out) and its
whole E-step at the Hybrid window (0.015 sigma^2_0) and at sigma^2
0.002, with the admitted fraction of block pairs and the pairs each
pass visits; one 376,401-point Hybrid registration (30 iterations,
tolerance 0: ``chip_smoke.py`` phase 10's protocol); where the checkout
has K5's plan kernel, its rows (``plan_rows``: 4,096 to 376,401 rows,
the kernel against the torch composition, both in CUDA graphs); last,
the device time by kernel of one of each 376k E-step
(``torch.profiler``).

With ``--procrustes`` a run measures instead (``p_worker``) kernel P's
entries on one seed's uniform rows: the Procrustes entry and the error
entry at [1, 102,400, 3], the SVD entry on [1, 3, 3], the M-step's
moments entry (where the checkout has it) and the whole CPD M-step
(``cpd.cpd_mstep``) at 20,480 rows, and ``torch.linalg.svd`` on the same
[1, 3, 3]: each by a CUDA graph of many calls (device time, the host's
Python left out) and by back-to-back eager calls timed by CUDA events
(the host included), with the kernels one call launches
(``torch.profiler``'s device events).

With ``--nn`` a run measures instead (``nn_worker``), on uniform boxes
of side 10 made from one seed: K1 (identity with its plain version
included, up to 102,400^2) at 102,400^2, 8,192^2, 16 x 2,048^2, 16,384^2,
32,768^2, 65,536^2 and 1,048,576 x 102,400 (``--skip-1m`` leaves the
last out), each by CUDA graphs of many launches and back to back, with the
pairs/s and, from the SASS of the checkout's K1 (the innermost loop:
its instructions over its distances), the instructions a pair and the
share of the card's issue rate (132 SMs x 128 lanes x 1.98 GHz) they
reach, and the SM clock and power while K1 runs at 102,400^2;
``measure_icp_100k`` on the dense arm at 102,400 and on both arms at
8,192 and 65,536; the FGT E-step at 376,401^2 with the loop's cached
clusterings (and their segment order, where the checkout has one) and
without, whether two E-steps on the same inputs give equal bits, and
last the device time by kernel of one of each (``torch.profiler``);
with ``--sweep``, K1 at each shape over its sources a thread, number of
splits and ring stage.

With ``--fgt`` a run measures instead (``fgt_worker``) the FGT at 100,000
and 376,401 rows (uniform boxes of side 10, 128 centres, order 8, far
field 10), at a fast phase's first and last bandwidth: the target
cloud's W = 4 expansion, the W = 1 and W = 4 predictions (by CUDA graphs
of a few calls; whatever the checkout's ``ops/fgt.py`` runs) and the
whole E-step with the loop's cached clusterings (eager, CUDA events),
whether two E-steps give equal bits; and, where the checkout has the
FGT's kernels, ``fgt_rows``: K6 and K7 against their plain versions.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

if __name__ == "__main__":
    # run as a script: its own directory, which holds harness/logging.py,
    # must not shadow the standard library's module of that name
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]


HEADLINE_CALLS = 3  # measure_icp_100k calls per run (each: warm-up + 3 x 50 iterations)
ISSUE_RATE = 132 * 128 * 1.98e9  # lane-instructions/s: 132 SMs x 4 schedulers x 32 lanes


def sass_loop_stats(sass: str, kernel: str) -> list:
    """For each function of ``sass`` (cuobjdump -sass: branch targets as
    addresses; nvdisasm: as labels) whose name holds ``kernel``: the hot
    loop, taken as the backward branch whose
    body holds the most FFMA, with its instructions, its distances (two
    FFMA each, the shared ``sq_dist``) and instructions a distance.  The
    count is static: a branch around a few instructions counts them."""
    import re

    out = []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        addr_of, insns = {}, []  # label -> address; (address, text)
        pending = []
        for line in block.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if ins:
                a = int(ins.group(1), 16)
                for lb in pending:
                    addr_of[lb] = a
                pending = []
                insns.append((a, ins.group(2).strip()))
        best = None
        for a, text in insns:
            tgt = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
            if not tgt:
                continue
            lo = addr_of.get(tgt.group(1), a + 1) if tgt.group(1) else int(tgt.group(2), 16)
            if lo > a:
                continue
            body = [t for x, t in insns if lo <= x <= a]
            ffma = sum(1 for t in body if re.search(r"\bFFMA\b", t))
            if ffma and (best is None or ffma > best["ffma"]):
                best = {"function": name[:80], "instructions": len(body), "ffma": ffma,
                        "pairs": ffma / 2, "per_pair": len(body) / (ffma / 2),
                        "fmnmx": sum(1 for t in body if "FMNMX" in t),
                        "branches": sum(1 for t in body if "BRA" in t)}
        if best:
            out.append(best)
    return out


def graph_ms(torch, fn, reps):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, timed by CUDA events, so the host's Python between
    launches does not count (it can exceed a small kernel's time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


PLAN_ROWS = (4096, 20_480, 102_400, 376_401)  # cloud rows of plan_rows' sizes


def plan_rows(torch, dev, rows=PLAN_ROWS, seed=19) -> list:
    """K5's plan (``cpd_cand.cand_plan``, ``csrc/cpd_plan.cu``) at each size
    of ``rows``, on Morton-sorted boxes of side 10 at the Hybrid window
    (0.015 sigma^2_0, truncation on): the outputs that differ from the
    plain version (the torch composition) and the largest difference, the
    kernel's device ms and the composition's, each by a CUDA graph of many
    calls (``graph_ms``), and the bytes of its bound: both clouds and masks
    read once (16 bytes a row), the padded copies, tables and fat subsets
    written (``chip_smoke.py`` turns them into the bound's time)."""
    import numpy as np

    from tpuslam_torch.algorithms.cpd import sigma_squared_init
    from tpuslam_torch.kernels import cpd_cand
    from tpuslam_torch.ops.spatial import morton_permutation

    rng = np.random.Generator(np.random.PCG64(seed))
    out = []
    for n in rows:
        def box():
            p = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev)
            return p[morton_permutation(p, torch.ones(n, device=dev)).long()].contiguous()

        mov, tgt = box(), box()
        ones = torch.ones(n, device=dev)
        s2 = (sigma_squared_init(mov, ones, tgt, ones) * 0.015).reshape(())
        args = (mov, ones, tgt, ones, s2, torch.tensor(0.01, device=dev),
                torch.tensor(True, device=dev))
        got, want = cpd_cand.cand_plan(*args), cpd_cand.cand_plan_ref(*args)
        fields = list(zip(cpd_cand.Plan._fields, got, want))
        differ = [f for f, a, b in fields if not torch.equal(a, b)]
        err = max((float((a.double() - b.double()).abs().max()) if a.shape == b.shape
                   else float("inf")) for _, a, b in fields if a.numel())
        reps = 50 if n <= 20_480 else 10
        kernel_ms = [graph_ms(torch, lambda: cpd_cand.cand_plan(*args), reps) for _ in range(2)]
        torch_ms = [graph_ms(torch, lambda: cpd_cand.cand_plan_ref(*args), max(2, reps // 5))
                    for _ in range(2)]
        written = sum(t.numel() * t.element_size() for t in got)
        out.append({"rows": n, "differing_fields": differ, "max_abs_err": err,
                    "read": got.read.tolist(), "ms": kernel_ms, "torch_ms": torch_ms,
                    "bytes": 2 * n * 16 + written})
    return out


FGT_ROWS = (100_000, 376_401)  # cloud rows of fgt_rows' sizes
FGT_K, FGT_P, FGT_FAR = 128, 8, 10.0  # the CPD loop's centres, order and far field


def fgt_pairs_in_cut(torch, targets, centers, h, e_param=FGT_FAR) -> int:
    """(target, centre) pairs inside the far-field radius, as the plain
    prediction decides them (float32 |dy|^2 <= e_param)."""
    count = 0
    for lo in range(0, targets.shape[0], 65_536):
        dy = (targets[lo:lo + 65_536, None, :] - centers[None, :, :]) / h
        count += int((torch.sum(dy * dy, dim=-1) <= e_param).sum())
    return count


def fgt_rows(torch, dev, rows=FGT_ROWS, seed=21) -> list:
    """K6 and K7 (``kernels/fgt.py``, ``csrc/fgt.cu``) against their plain
    versions (the torch composition), and the whole FGT E-step with the
    loop's cached clusterings on the kernels and on the plain versions, at
    each size of ``rows``: two uniform boxes of side 10, 128 centres,
    order 8, far field 10, at the bandwidth of a fast phase's first EM
    iteration (sigma^2_0: every pair inside the cut) and of its last
    (``HYBRID_SWITCH`` x sigma^2_0).  Per prediction (W = 1: Kt1 on the
    target rows; W = 4: P1 and PX on the moving rows) and expansion: the
    device ms of the kernel and of the plain version, each by a CUDA graph
    of many calls (``graph_ms``), the largest difference relative to the
    plain version's largest value, the float32 operations (a Taylor term's
    monomial product and W FMAs, an FMA counted as two) on all pairs and,
    for K6, on the pairs inside the cut, and the bytes (each operand read
    once, the result written once).  Per E-step: ms on the kernels and on
    the plain versions (CUDA events, eager), whether two E-steps on the
    kernels give equal bits, and the statistics' largest relative
    difference from the plain E-step's."""
    import numpy as np

    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.kernels import fgt as kfgt
    from tpuslam_torch.ops import fgt

    rng = np.random.Generator(np.random.PCG64(seed))
    pd = fgt.pd_size(FGT_P)
    stats = ("p1", "pt1", "px", "error")
    out = []
    for n in rows:
        mov, tgt = (torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev)
                    for _ in range(2))
        m1 = torch.ones(n, device=dev)
        cy, iy, oy = fgt.k_center_ordered(mov, m1, FGT_K)
        cx, ix, ox = fgt.k_center_ordered(tgt, m1, FGT_K)
        s2_0 = cpd.sigma_squared_init(mov, m1, tgt, m1).reshape(())
        cnt, weight = torch.sum(m1), torch.tensor(0.1, device=dev)
        w4 = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(dev)
        for when, scale in (("first", 1.0), ("last", cpd.HYBRID_SWITCH)):
            s2 = s2_0 * scale
            hs = torch.sqrt(2.0 * s2)
            row = {"rows": n, "k": FGT_K, "p": FGT_P, "pd": pd, "sigma2": float(s2),
                   "when": when}
            # K7: the moving cloud's W = 1 expansion, the target's W = 4 one
            for name, pts, w, cl in (("K7_w1", mov, m1[:, None], (cy, iy, oy)),
                                     ("K7_w4", tgt, w4, (cx, ix, ox))):
                args = (pts, w.contiguous(), m1, hs, *cl, FGT_P)
                got, want = kfgt.expand(*args), kfgt.expand_plain(*args)
                width = w.shape[1]
                row[name] = {
                    "ms": [graph_ms(torch, lambda: kfgt.expand(*args), 20) for _ in range(2)],
                    "plain_ms": [graph_ms(torch, lambda: kfgt.expand_plain(*args), 4)],
                    "max_rel_err": float((got - want).abs().max() / want.abs().max()),
                    "flops": float(n) * pd * (1 + 2 * width),
                    "bytes": float(n) * (12 + 4 * width + 4 + 8) + FGT_K * (pd * width * 4 + 8),
                }
            model_y = kfgt.expand_plain(mov, m1[:, None], m1, hs, cy, iy, oy, FGT_P)
            model_x = kfgt.expand_plain(tgt, w4, m1, hs, cx, ix, ox, FGT_P)
            # K6: Kt1 (W = 1) on the target rows, P1 and PX (W = 4) on the moving rows
            for name, pts, centers, ak in (("K6_w1", tgt, cy, model_y),
                                           ("K6_w4", mov, cx, model_x)):
                args = (pts, centers, ak, hs, FGT_FAR, FGT_P)
                got, want = kfgt.predict(*args), kfgt.predict_plain(*args)
                width, inside = ak.shape[2], fgt_pairs_in_cut(torch, pts, centers, hs)
                row[name] = {
                    "ms": [graph_ms(torch, lambda: kfgt.predict(*args), 20) for _ in range(2)],
                    "plain_ms": [graph_ms(torch, lambda: kfgt.predict_plain(*args), 2)],
                    "max_rel_err": float((got - want).abs().max() / want.abs().max()),
                    "pairs": float(n) * FGT_K, "pairs_in_cut": inside,
                    "flops": float(n) * FGT_K * pd * (1 + 2 * width),
                    "flops_in_cut": float(inside) * pd * (1 + 2 * width),
                    "bytes": float(n) * (12 + 4 * width) + FGT_K * (pd * width * 4 + 12),
                }

            def estep():
                return cpd.cpd_estep_fgt(mov, m1, tgt, m1, s2, weight, cnt, cnt, FGT_K, FGT_P,
                                         FGT_FAR, sigma2_init=s2_0, clusters=(cy, iy, cx, ix),
                                         orders=(oy, ox))

            a, b = estep(), estep()
            row["estep_ms"] = [_time_ms(torch, estep, 10) for _ in range(2)]
            keep = (kfgt.predict, kfgt.expand)
            kfgt.predict, kfgt.expand = kfgt.predict_plain, kfgt.expand_plain
            try:
                plain = estep()
                row["estep_plain_ms"] = [_time_ms(torch, estep, 2)]
            finally:
                kfgt.predict, kfgt.expand = keep
            torch.cuda.synchronize()
            row["estep_bit_equal"] = all(torch.equal(getattr(a, f), getattr(b, f))
                                         for f in stats)
            row["estep_max_rel_err"] = max(
                float((getattr(a, f) - getattr(plain, f)).abs().max()
                      / getattr(plain, f).abs().max()) for f in stats)
            out.append(row)
    return out


def _clocks_during(torch, fn, seconds=2.0):
    """The SM clock (MHz) and power draw (W) nvidia-smi reports every
    100 ms while ``fn`` runs back to back for about ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    out = proc.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.count(",") == 1]
    rows = rows[2:] or rows  # the first samples may precede the load
    return {"sm_mhz": [r[0] for r in rows], "power_w": [r[1] for r in rows]}


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
    _build_and_dump(build, res, out_dir, label)
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


def cpd_worker(tree: str, label: str, out_dir: str) -> dict:
    """One ``--cpd`` run on the package under ``tree`` (module docstring);
    works on checkouts with block tables (K5 before its sub-tile masks)
    and with per-CTA tables (``cpd_cand.cta_tables``)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.config.configuration import ApproximationType, ComputationMethod
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.kernels import build, cpd_cand, cpd_dense
    from tpuslam_torch.ops.spatial import morton_permutation

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    package = os.path.dirname(os.path.abspath(tpuslam_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {package}, not the one under {tree}")
    time_ms = lambda fn, reps: _time_ms(torch, fn, reps)  # noqa: E731
    res = {"label": label, "tree": os.path.abspath(tree), "mode": "cpd"}
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build_and_dump(build, res, out_dir, label)
    dev = torch.device("cuda", 0)
    tile = cpd_dense.TILE
    rng = np.random.Generator(np.random.PCG64(376))

    def f32(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def box(n):
        p = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev)
        return p[morton_permutation(p, torch.ones(n, device=dev)).long()].contiguous()

    def tables(adm, n_rows, m_rows):
        """The checkout's K5 tables (fat blocks served elsewhere) and the
        pairs each pass visits."""
        if hasattr(cpd_cand, "cta_tables"):
            geo = cpd_dense.cpd_geometry
            tm, cn = cpd_cand.cta_tables(adm.sub_adm, adm.f_sub, geo(n_rows).cta_rows,
                                         ~adm.fat_n, adm.width_m)
            tn, cm = cpd_cand.cta_tables(adm.sub_adm.T, adm.f_sub, geo(m_rows).cta_rows,
                                         ~adm.fat_m, adm.width_n)
            pairs = (cpd_cand.visited_pairs(tm, cn, n_rows // len(cn)),
                     cpd_cand.visited_pairs(tn, cm, m_rows // len(cm)))
            # segments each CTA of the denominator pass folds: the spread
            # behind the pass's tail
            segs = cpd_cand.segments_per_cta(tm, cn).float()
            spread = {"mean": float(segs.mean()), "max": float(segs.max()),
                      "p99": float(torch.quantile(segs, 0.99))}
            return (tm, cn, tn, cm), pairs, spread
        from tpuslam_torch.ops.nn_hier import _build_cand_table

        cn = torch.where(adm.fat_n, 0, adm.counts_n)
        cm = torch.where(adm.fat_m, 0, adm.counts_m)
        tm = _build_cand_table(adm.adm, cn, adm.width_m)
        tn = _build_cand_table(adm.adm.T, cm, adm.width_n)
        return ((tm, cn, tn, cm), (int(cn.sum()) * tile * tile, int(cm.sum()) * tile * tile),
                None)

    def profiled(fn):
        """Device ms by kernel (the top 8) and in all, over one call."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + e.device_time_total / 1e3
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        return {"device_ms": sum(kernels.values()), "events": len(kernels), "top": top}

    profiles = {}
    for n in (20_480, 376_401):
        mov, tgt = box(n), box(n)
        m1 = torch.ones(n, device=dev)
        s0 = float(cpd.sigma_squared_init(mov, m1, tgt, m1))
        mov_p, mm, tgt_p, tm_ = (cpd_dense.pad_rows(x[None], -(-n // tile) * tile)[0]
                                 for x in (mov, m1, tgt, m1))
        ty = torch.where(mm[:, None] > 0, mov_p,
                         torch.full_like(mov_p, cpd_dense.SENTINEL)).contiguous()
        tgt_p = tgt_p.contiguous()
        reps = 20 if n < 100_000 else 3
        out = {"sigma2_0": s0, "rows": len(tgt_p)}
        for key, s2, trunc in (("k4_exact", s0, False), ("k5_window", 0.015 * s0, True),
                               ("k5_tight", 0.002, True)):
            if trunc and n < 100_000:
                continue
            scal = cpd_dense.estep_scalars(f32(s2), f32(0.3),
                                           torch.tensor([trunc], device=dev), 1e-3)
            dn = cpd_dense.denom_pass_batch(scal, ty[None], tgt_p[None])
            _, w4 = cpd_dense.moment_weights(dn[:, 0], tgt_p[None], tm_[None], f32(0.3))
            row = {"sigma2": s2}
            if not trunc:
                row["denom_ms"] = [time_ms(lambda: cpd_dense.denom_pass_batch(
                    scal, ty[None], tgt_p[None]), reps) for _ in range(2)]
                row["moments_ms"] = [time_ms(lambda: cpd_dense.moments_pass_batch(
                    scal, ty[None], tgt_p[None], w4), reps) for _ in range(2)]
                args = (mov, m1, tgt, m1, s2, 0.3, False)
                row["estep_ms"] = [time_ms(lambda: cpd_dense.cpd_estep_dense(*args), reps)
                                   for _ in range(2)]
                if n > 100_000:
                    profiles[key] = lambda a=args: cpd_dense.cpd_estep_dense(*a)
            else:
                adm = cpd_cand.block_admission(mov_p, mm, tgt_p, tm_, f32(s2)[0],
                                               torch.tensor(True, device=dev))
                (t_m, c_n, t_n, c_m), pairs, spread = tables(adm, len(tgt_p), len(ty))
                row["denom_segments_per_cta"] = spread
                row["admitted_block"] = float(adm.adm.float().mean())
                if hasattr(adm, "sub_adm"):
                    row["admitted_sub_tile"] = float(adm.sub_adm.float().mean())
                row["visited"] = [p / (len(tgt_p) * len(ty)) for p in pairs]
                row["fat"] = [int(adm.fat_n.sum()), int(adm.fat_m.sum())]
                row["denom_ms"] = [time_ms(lambda: cpd_cand.denom_cand(
                    scal[0], ty, tgt_p, t_m, c_n), 5) for _ in range(2)]
                row["moments_ms"] = [time_ms(lambda: cpd_cand.moments_cand(
                    scal[0], ty, tgt_p, w4[0], t_n, c_m), 5) for _ in range(2)]
                args = (mov, m1, tgt, m1, s2, 0.3, torch.tensor(True, device=dev))
                row["estep_ms"] = [time_ms(lambda: cpd_cand.cpd_estep_cand(*args), 5)
                                   for _ in range(2)]
                row["route"] = cpd_cand.ROUTE_TRACE[-1]
                profiles[key] = lambda a=args: cpd_cand.cpd_estep_cand(*a)
            out[key] = row
        res[str(n)] = out

    n = 376_401
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.1)
    t_true = get_random_translation_vector(rng, 0.5)
    after = (before @ r_true.T + t_true).astype(np.float32)[rng.permutation(n)]
    cpd.PHASE_TRACE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rot, trans, iters, err = tpuslam_torch.register(
        before, after, device=dev, computation_method=ComputationMethod.Cpd,
        approximation_type=ApproximationType.Hybrid, cpd_weight=0.1, cpd_const_scale=True,
        cpd_tolerance=0.0, max_iterations=30)
    wall = time.perf_counter() - t0
    cos = (np.trace(rot.astype(np.float64).T @ r_true.astype(np.float64)) - 1) / 2
    res["hybrid_376k"] = {"wall_s": wall, "iterations": iters, "phases": list(cpd.PHASE_TRACE),
                          "rotation_err_deg": float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
                          "sigma2": float(err)}
    if hasattr(cpd_cand, "cand_plan"):
        res["plan"] = plan_rows(torch, dev)
    # the profiler last: once started it slows the host for the process
    res["profile_376k"] = {k: profiled(fn) for k, fn in profiles.items()}
    with open(os.path.join(out_dir, f"ab_{label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def nn_worker(tree: str, label: str, out_dir: str, skip_1m: bool, sweep: bool) -> dict:
    """One ``--nn`` run on the package under ``tree`` (module docstring)."""
    sys.path.insert(0, os.path.abspath(tree))
    import inspect

    import numpy as np
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k
    from tpuslam_torch.kernels import build, nn_dense
    from tpuslam_torch.ops import fgt

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    package = os.path.dirname(os.path.abspath(tpuslam_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {package}, not the one under {tree}")
    time_ms = lambda fn, reps: _time_ms(torch, fn, reps)  # noqa: E731
    res = {"label": label, "tree": os.path.abspath(tree), "mode": "nn"}
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build_and_dump(build, res, out_dir, label)
    sass_path = os.path.join(out_dir, f"ab_{label}.sass")
    loops = []
    if os.path.exists(sass_path):
        with open(sass_path) as f:
            loops = sass_loop_stats(f.read(), "nn_dense_kernel")
    res["sass_k1"] = loops
    dev = torch.device("cuda", 0)
    rng = np.random.Generator(np.random.PCG64(102))

    def box(*shape):
        return torch.from_numpy((rng.random(shape) * 10).astype(np.float32)).to(dev)

    shapes = {"102400^2": (1, 102_400, 102_400), "8192^2": (1, 8192, 8192),
              "16x2048^2": (16, 2048, 2048), "16384^2": (1, 16_384, 16_384),
              "32768^2": (1, 32_768, 32_768), "65536^2": (1, 65_536, 65_536)}
    if not skip_1m:
        shapes["1048576x102400"] = (1, 1_048_576, 102_400)
    per_pair = max((lp["per_pair"] for lp in loops), default=None)
    k1 = {}
    for key, (b, n, m) in shapes.items():
        src, tgt = box(b, n, 3), box(b, m, 3)
        count = torch.full((b,), m, dtype=torch.int32, device=dev)
        row = {"pairs": float(b) * n * m}
        if n * m <= 102_400 ** 2:
            idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
            r_idx, r_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
            row["mismatch"] = int((idx != r_idx).sum() + (dist != r_dist).sum())
        reps = 3 if n * m > 102_400 ** 2 else (20 if n * m >= 102_400 ** 2 else 100)
        call = lambda a=(src, tgt, count): nn_dense.nearest_neighbors_dense_batch(*a)  # noqa: E731
        # CUDA graphs: the host's Python between launches does not count
        row["ms"] = [graph_ms(torch, call, reps) for _ in range(2)]
        row["ms_back_to_back"] = time_ms(call, reps)
        ms = min(row["ms"])
        row["pairs_per_s"] = row["pairs"] / ms * 1e3
        if per_pair is not None:
            row["issue_share"] = row["pairs"] * per_pair / (ms * 1e-3) / ISSUE_RATE
        if hasattr(nn_dense, "dense_geometry"):
            row["geometry"] = nn_dense.dense_geometry(b, n, m)._asdict()
        if n * m == 102_400 ** 2:
            row["clocks"] = _clocks_during(torch, call)
        k1[key] = row
    res["k1"] = k1
    if sweep and hasattr(nn_dense, "dense_geometry"):
        # K1 over its sources a thread, number of splits and ring stage
        keep = (nn_dense.BLOCKS_TARGET, nn_dense.STAGE_ROWS, nn_dense.FILL_BLOCKS)
        sweeps = {}
        for key, (b, n, m) in shapes.items():
            src, tgt = box(b, n, 3), box(b, m, 3)
            count = torch.full((b,), m, dtype=torch.int32, device=dev)
            times = {}
            for fill in (0, 10 ** 9):  # four sources a thread, then two
                for stage in (256, 512):
                    for splits in range(1, nn_dense.MAX_SPLITS + 1):
                        nn_dense.FILL_BLOCKS, nn_dense.STAGE_ROWS = fill, stage
                        rpt = nn_dense.dense_geometry(b, n, m).rows_per_thread
                        nn_dense.BLOCKS_TARGET = b * -(-n // (128 * rpt)) * splits
                        geo = nn_dense.dense_geometry(b, n, m)
                        times[f"r{rpt}_splits{geo.splits}_stage{geo.stage_rows}"] = graph_ms(
                            torch, lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, count),
                            3 if n * m > 102_400 ** 2 else 20)
            sweeps[key] = times
        nn_dense.BLOCKS_TARGET, nn_dense.STAGE_ROWS, nn_dense.FILL_BLOCKS = keep
        res["k1_sweep"] = sweeps

    cb, ca = build_headline_pair(102_400, device=dev)
    res["dense_headline_ms_per_iter"] = [measure_icp_100k(
        pair=(cb, ca), use_spatial=False)["ms_per_iter"] for _ in range(2)]
    for size in (8192, 65_536):  # the hierarchical gate's range
        pair = build_headline_pair(size, device=dev)
        res[f"headline_{size}_ms_per_iter"] = {
            arm: measure_icp_100k(pair=pair, use_spatial=flag)["ms_per_iter"]
            for arm, flag in (("hier", True), ("dense", False))}

    # the FGT E-step at 376,401^2 (cpu-made boxes, as chip_smoke.py phase 11)
    n = 376_401
    mov, tgt = box(n, 3), box(n, 3)
    m1 = torch.ones(n, device=dev)
    s2 = cpd.sigma_squared_init(mov, m1, tgt, m1)
    cnt, w = torch.sum(m1), torch.tensor(0.1, device=dev)
    clusters = (*fgt.k_center(mov, m1, 128), *fgt.k_center(tgt, m1, 128))
    kw = {}
    if "orders" in inspect.signature(cpd.cpd_estep_fgt).parameters:
        kw["orders"] = (fgt.segment_order(clusters[1], 128), fgt.segment_order(clusters[3], 128))
    cached = lambda: cpd.cpd_estep_fgt(  # noqa: E731
        mov, m1, tgt, m1, s2, w, cnt, cnt, 128, 8, 10.0, sigma2_init=s2, clusters=clusters, **kw)
    own = lambda: cpd.cpd_estep_fgt(  # noqa: E731
        mov, m1, tgt, m1, s2, w, cnt, cnt, 128, 8, 10.0, sigma2_init=s2)
    a, b = cached(), cached()
    torch.cuda.synchronize()
    res["fgt_estep_376k"] = {
        "cached_ms": [time_ms(cached, 5) for _ in range(2)],
        "own_clusterings_ms": [time_ms(own, 3) for _ in range(2)],
        "differing_elements_two_runs": sum(
            int((getattr(a, f) != getattr(b, f)).sum()) for f in ("p1", "pt1", "px", "error")),
    }
    # last: a profiler, once started, slows the host for the process
    from torch.profiler import ProfilerActivity, profile

    for key, fn in (("cached", cached), ("own_clusterings", own)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + e.device_time_total / 1e3
        res["fgt_estep_376k"][f"{key}_device_ms"] = sum(kernels.values())
        res["fgt_estep_376k"][f"{key}_top"] = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    with open(os.path.join(out_dir, f"ab_{label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def fgt_worker(tree: str, label: str, out_dir: str) -> dict:
    """``--fgt``: the FGT E-step of the checkout under ``tree`` (module
    docstring)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.kernels import build
    from tpuslam_torch.ops import fgt

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    package = os.path.dirname(os.path.abspath(tpuslam_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {package}, not the one under {tree}")
    res = {"label": label, "tree": os.path.abspath(tree), "mode": "fgt"}
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build_and_dump(build, res, out_dir, label)
    dev = torch.device("cuda", 0)
    rng = np.random.Generator(np.random.PCG64(21))
    rows = []
    for n in FGT_ROWS:
        mov, tgt = (torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev)
                    for _ in range(2))
        m1 = torch.ones(n, device=dev)
        cy, iy, oy = fgt.k_center_ordered(mov, m1, FGT_K)
        cx, ix, ox = fgt.k_center_ordered(tgt, m1, FGT_K)
        s2_0 = cpd.sigma_squared_init(mov, m1, tgt, m1).reshape(())
        cnt, weight = torch.sum(m1), torch.tensor(0.1, device=dev)
        w4 = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(dev)
        for when, scale in (("first", 1.0), ("last", cpd.HYBRID_SWITCH)):
            s2 = s2_0 * scale
            hs = torch.sqrt(2.0 * s2)
            model_y = fgt.compute_fgt_model_multi(mov, m1[:, None], m1, hs, FGT_K, FGT_P,
                                                  clustering=(cy, iy), order=oy)
            model_x = fgt.compute_fgt_model_multi(tgt, w4, m1, hs, FGT_K, FGT_P,
                                                  clustering=(cx, ix), order=ox)

            def estep():
                return cpd.cpd_estep_fgt(mov, m1, tgt, m1, s2, weight, cnt, cnt, FGT_K, FGT_P,
                                         FGT_FAR, sigma2_init=s2_0, clusters=(cy, iy, cx, ix),
                                         orders=(oy, ox))

            a, b = estep(), estep()
            torch.cuda.synchronize()
            rows.append({
                "rows": n, "when": when, "sigma2": float(s2),
                "expand_w4_ms": [graph_ms(torch, lambda: fgt.compute_fgt_model_multi(
                    tgt, w4, m1, hs, FGT_K, FGT_P, clustering=(cx, ix), order=ox), 4)
                    for _ in range(2)],
                "predict_w1_ms": [graph_ms(torch, lambda: fgt.fgt_predict(
                    tgt, fgt.FGTModel(model_y.centers, model_y.ak[..., 0]), hs, FGT_FAR,
                    FGT_P), 2) for _ in range(2)],
                "predict_w4_ms": [graph_ms(torch, lambda: fgt.fgt_predict_multi(
                    mov, model_x, hs, FGT_FAR, FGT_P), 2) for _ in range(2)],
                "estep_ms": [_time_ms(torch, estep, 5) for _ in range(2)],
                "estep_bit_equal": all(torch.equal(getattr(a, f), getattr(b, f))
                                       for f in ("p1", "pt1", "px", "error")),
                "p1_sum": float(a.p1.double().sum()), "error": float(a.error),
            })
    res["fgt_estep"] = rows
    if os.path.exists(os.path.join(package, "kernels", "fgt.py")):
        res["fgt_rows"] = fgt_rows(torch, dev)
    with open(os.path.join(out_dir, f"ab_{label}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def p_worker(tree: str, label: str, out_dir: str) -> dict:
    """``--procrustes``: kernel P's entries in the checkout under ``tree``
    (module docstring)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.core.types import Sufficient
    from tpuslam_torch.kernels import build, procrustes

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    package = os.path.dirname(os.path.abspath(tpuslam_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {package}, not the one under {tree}")
    res = {"label": label, "tree": os.path.abspath(tree)}
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    _build_and_dump(build, res, out_dir, label)
    dev = torch.device("cuda", 0)
    rng = np.random.Generator(np.random.PCG64(13))

    def rand(*shape, lo=0.0, hi=10.0):
        return torch.from_numpy((lo + rng.random(shape) * (hi - lo)).astype(np.float32)).to(dev)

    def launches(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

    n, m = 102_400, 20_480
    before = rand(1, n, 3)
    after = before + rand(1, n, 3, lo=-0.05, hi=0.05)
    w = (rand(1, n, hi=1.0) > 0.3).float()
    diff, h = after - before, rand(1, 3, 3, lo=-1.0, hi=1.0)
    stats = Sufficient(p1=rand(m, hi=1.0), pt1=rand(m, hi=1.0), px=rand(m, 3), error=None)
    mv, tg, one = rand(m, 3), rand(m, 3), torch.ones((), device=dev)
    calls = {
        "procrustes": lambda: procrustes.weighted_procrustes_batch(before, after, w),
        "svd": lambda: procrustes.svd_rotation_det_batch(h),
        "error": lambda: procrustes.mean_sq_error_batch(diff, w, w.sum(1)),
        "mstep_20480": lambda: cpd.cpd_mstep(mv, tg, stats, False, one),
    }
    if hasattr(procrustes, "mstep_moments_batch"):
        calls["moments_20480"] = lambda: procrustes.mstep_moments_batch(
            stats.p1[None], mv[None], stats.px[None], stats.pt1[None], tg[None])
    for name, fn in calls.items():
        res[name] = {"graph_ms": graph_ms(torch, fn, 200), "eager_ms": _time_ms(torch, fn, 200),
                     "kernels": launches(fn)}
    res["torch_linalg_svd"] = {"eager_ms": _time_ms(torch, lambda: torch.linalg.svd(h), 50)}
    return res


def _build_and_dump(build, res, out_dir, label) -> None:
    """Build the checkout's kernels; keep ptxas's report and the SASS."""
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


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="OLD NEW (or one tree with --worker)")
    parser.add_argument("--worker", metavar="LABEL", help="one run on the first tree")
    parser.add_argument("--out", default="build/ab")
    parser.add_argument("--skip-1m", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--cpd", action="store_true", help="K4, K5 and CPD instead")
    parser.add_argument("--nn", action="store_true", help="K1, the dense arm and the FGT instead")
    parser.add_argument("--procrustes", action="store_true", help="kernel P's entries instead")
    parser.add_argument("--fgt", action="store_true", help="the FGT's E-step, K6 and K7 instead")
    a = parser.parse_args(argv)
    out_dir = os.path.abspath(a.out)
    if a.worker:
        if a.cpd:
            res = cpd_worker(a.trees[0], a.worker, out_dir)
        elif a.nn:
            res = nn_worker(a.trees[0], a.worker, out_dir, a.skip_1m, a.sweep)
        elif a.procrustes:
            res = p_worker(a.trees[0], a.worker, out_dir)
        elif a.fgt:
            res = fgt_worker(a.trees[0], a.worker, out_dir)
        else:
            res = worker(a.trees[0], a.worker, out_dir, a.skip_1m, a.sweep)
        print(json.dumps({k: v for k, v in res.items() if k != "ptxas"}))
        return 0
    old, new = a.trees
    extra = (["--out", out_dir] + ["--skip-1m"] * a.skip_1m + ["--sweep"] * a.sweep
             + ["--cpd"] * a.cpd + ["--nn"] * a.nn + ["--procrustes"] * a.procrustes
             + ["--fgt"] * a.fgt)
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
