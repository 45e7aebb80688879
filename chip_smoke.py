#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpuslam_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed as it ends; the first failure raises and the script
exits non-zero without printing a result:

1. device — the card's name and power limit (nvidia-smi) and torch's view;
2. build — kernels K1 (``csrc/nn_dense.cu``), K2 (``csrc/bound.cu``) and
   K3 (``csrc/nn_cand.cu``) from source, one nvcc per source, started
   together; ptxas's registers and spills per kernel;
3. K1 against its plain PyTorch version on the card, bit for bit (idx and
   dist equal; tolerance 0): the 102,400 x 102,400 headline pair, a
   ragged count, planted ties, count 0 and a batch of two; then K1's and
   the plain version's times at 102,400 x 102,400;
4. K2 and K3 against their plain versions on the headline pair's
   hierarchical set-up (C = 800 tiles, 100 source groups): K2 cold, warm
   after one dense step, warm in mid-registration, and a batch of two
   (admitted sets identical, and a superset of every valid source's true
   tile); K3 on the fine (g = 128) and coarse (g2 = 512) tables and a
   batch of two (idx and dist identical); the whole hierarchical search
   against K1 (tolerance 0); then K2's, K3's and the plain versions'
   times;
5. the slice — ``tpuslam_torch.register`` on a 102,400-point uniform box
   moved by (0.1 rad, 0.5), which takes the hierarchical arm; K1, K2 and
   K3 must each have been launched, the error finite and the rotation
   within 1 degree of the truth; the iterations on each arm; then one
   8,192-point registration on the CPU (plain versions) and on the card
   (kernels), R and t within 1e-4, once by default and once on the
   hierarchical arm on both (equal iterations);
6. large cloud — one 1,048,576-point uniform-box registration, at most
   20 iterations, on the hierarchical arm: ms per iteration and the arm of
   each; then at its final warm state the hierarchical search against K1
   (tolerance 0);
7. headline — ``measure_icp_100k()`` on the hierarchical arm (the default
   on CUDA) and on the dense arm; both arms again at 8,192 points.

The last lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# cloud sizes of the phases
FULL = dict(headline=102_400, small=8192, large=1_048_576, large_iters=20,
            mid_iters=12)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def main(dev=None, sizes=FULL) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import tpuslam_torch
    from tpuslam_torch.algorithms.icp import icp_register, prepare_spatial
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k
    from tpuslam_torch.kernels import bound, build, nn_cand, nn_dense
    from tpuslam_torch.ops import nn_hier
    from tpuslam_torch.ops.geometry import transform_points

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0) if dev is None else dev
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind}, {torch.cuda.device_count()} device(s)")

    # 2. build ----------------------------------------------------------------
    build.build(force=True)
    log(f"[build] K1, K2, K3 built by nvcc in {build.last_build['seconds']:.3f} s "
        f"-> {build.last_build['path']}")
    for line in build.last_build["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    build.load_library()

    def time_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    # 3. K1 against its plain version -----------------------------------------
    def compare(name, src, tgt, count):
        idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
        ref_idx, ref_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
        torch.cuda.synchronize()
        bad_idx = int((idx != ref_idx).sum())
        bad_dist = int((dist != ref_dist).sum())
        err = float((dist.double() - ref_dist.double()).abs().max())
        log(f"[k1] {name}: {tuple(src.shape)} x {tuple(tgt.shape)}, "
            f"idx mismatches {bad_idx}, dist mismatches {bad_dist}, "
            f"max_abs_err {err} (tolerance 0: bit-identical)")
        check(bad_idx == 0 and bad_dist == 0, f"K1 differs from plain ({name})")
        return idx, dist, err

    n_head = sizes["headline"]
    cb, ca = build_headline_pair(n_head, device=dev)
    src, tgt, count = cb.points[None], ca.points[None], ca.count.reshape(1)
    errs = [compare(f"headline {n_head}", src, tgt, count)[2]]
    ragged = torch.tensor([n_head * 3 // 4 + 1], dtype=torch.int32, device=dev)
    errs.append(compare("ragged count", src, tgt, ragged)[2])
    none = torch.zeros(1, dtype=torch.int32, device=dev)
    idx0, dist0, err = compare("count 0", src, tgt, none)
    errs.append(err)
    check(bool((idx0 == 0).all()) and bool((dist0 == nn_dense.BIG).all()),
          "count 0 must give (0, 3.4e38)")
    rng = np.random.Generator(np.random.PCG64(11))
    lattice = (rng.integers(-40, 40, size=(8192, 3)) * 4).astype(np.float32)
    ties = np.concatenate([lattice + [1, 0, 0], lattice - [1, 0, 0],
                           lattice + [1, 0, 0]]).astype(np.float32)
    t_src = torch.from_numpy(lattice)[None].to(dev)
    t_tgt = torch.from_numpy(ties)[None].to(dev)
    t_count = torch.tensor([len(ties)], dtype=torch.int32, device=dev)
    idx_t, dist_t, err = compare("planted ties", t_src, t_tgt, t_count)
    errs.append(err)
    check(bool((dist_t == 1.0).all()) and bool((idx_t < 8192).all()),
          "planted ties: the first index must win")
    b_src = torch.from_numpy((rng.random((2, 8192, 3)) * 10).astype(np.float32))
    b_tgt = torch.from_numpy((rng.random((2, 10000, 3)) * 10).astype(np.float32))
    b_count = torch.tensor([10000, 6000], dtype=torch.int32)
    errs.append(compare("batch of 2", b_src.to(dev), b_tgt.to(dev),
                        b_count.to(dev))[2])

    plain_ms = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_ref(src, tgt, count), 3)
    k1_ms = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, count), 20)
    plain_ms_2 = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_ref(src, tgt, count), 3)
    k1_ms_2 = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, count), 20)
    log(f"[k1] time at {n_head} x {n_head} on {smi}: K1 {k1_ms:.4f} / "
        f"{k1_ms_2:.4f} ms, plain {plain_ms:.3f} / {plain_ms_2:.3f} ms")

    # 4. K2 and K3 against their plain versions ---------------------------------
    setup = prepare_spatial(cb, ca)
    target, g, gsrc, l_budget = setup.target, setup.g, setup.gsrc, setup.l_budget
    m = target.packed.shape[0]
    n_src = setup.src_points.shape[0]
    valid = setup.src_mask > 0
    log(f"[hier] set-up at {n_head}: g {g}, gsrc {gsrc}, L {l_budget}, "
        f"C {m // g}, groups {n_src // gsrc}")
    # the sorted-target tile of each original target row
    tile_of = torch.empty(m, dtype=torch.long, device=dev)
    real = target.packed[:, 3] < 1e30
    tile_of[target.packed[real, 3].long()] = (
        torch.arange(m, device=dev)[real] // g)
    group_of = torch.arange(n_src, device=dev) // gsrc

    def k2_compare(name, pos, state):
        saug, aux, eps = nn_hier.bound_operands(pos, setup.src_mask, target, state)
        adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps,
                               state.warm, gsrc)
        ref = bound.bound_pass_ref(saug[None], aux[None], target.caug[None],
                                   target.radii[None], eps[None],
                                   state.warm[None], gsrc)[0]
        k1_idx, k1_dist = nn_dense.nearest_neighbors_dense(
            pos, target.original_points, target.count)
        torch.cuda.synchronize()
        bad = int((adm != ref).sum())
        missed = int((~adm[group_of[valid], tile_of[k1_idx.long()][valid]]).sum())
        counts = adm.sum(1)
        log(f"[k2] {name}: adm {tuple(adm.shape)}, admitted per group mean "
            f"{float(counts.float().mean()):.1f} max {int(counts.max())}, "
            f"mismatches against plain {bad} (tolerance 0), true tiles "
            f"not admitted {missed} (must be 0)")
        check(bad == 0, f"K2 differs from plain ({name})")
        check(missed == 0, f"K2 admission misses a true tile ({name})")
        k2_errs.append(float(bad > 0))
        return (saug, aux, eps), adm, (k1_idx, k1_dist)

    k2_errs = []  # 1.0 where an admitted set differed from plain, else 0.0
    cold = nn_hier.hier_state_init(n_src, dev)
    k2_compare("cold", setup.src_points, cold)
    k1_idx, _ = nn_dense.nearest_neighbors_dense(
        setup.src_points, target.original_points, target.count)
    after_dense = nn_hier.HierState(
        target.original_points.index_select(0, k1_idx),
        torch.ones((), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev))
    k2_compare("warm after one dense step", setup.src_points, after_dense)
    nn_hier.ARM_TRACE.clear()
    mid = icp_register(cb, ca, eps=0.0, max_distance_squared=1e18,
                       max_iterations=sizes["mid_iters"], divergence_guard=False,
                       use_spatial=True)
    log(f"[hier] mid-registration state after {mid.iterations} iterations, "
        f"arms {list(nn_hier.ARM_TRACE)}")
    pos = transform_points(setup.src_points, mid.transform.rotation,
                           mid.transform.translation)
    ops, adm, (k1_idx, k1_dist) = k2_compare("warm mid-registration", pos, mid.nn)
    cold_ops = nn_hier.bound_operands(pos, setup.src_mask, target, cold)
    warm2 = torch.stack([mid.nn.warm, cold.warm])
    pair_args = ([torch.stack([a, b]) for a, b in zip(ops[:2], cold_ops[:2])]
                 + [torch.stack([target.caug] * 2), torch.stack([target.radii] * 2),
                    torch.stack([ops[2], cold_ops[2]]), warm2])
    adm_b = bound.bound_pass_batch(*pair_args, gsrc)
    ref_b = bound.bound_pass_ref(*pair_args, gsrc)
    torch.cuda.synchronize()
    bad_b = int((adm_b != ref_b).sum())
    log(f"[k2] batch of 2 (warm, cold): mismatches against plain {bad_b}")
    check(bad_b == 0 and torch.equal(adm_b[0], adm), "K2 batch differs")
    k2_errs.append(float(bad_b > 0))
    k2_args = (ops[0], ops[1], target.caug, target.radii, ops[2], mid.nn.warm)
    k2_ms = time_ms(lambda: bound.bound_pass(*k2_args, gsrc), 20)
    k2_plain_ms = time_ms(lambda: bound.bound_pass_ref(
        *[a[None] for a in k2_args], gsrc), 3)
    log(f"[k2] time at {n_src} sources x {m // g} tiles on {smi}: K2 "
        f"{k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms")

    counts = adm.sum(1, dtype=torch.int32)
    l_eff = min(l_budget, m // g)
    fine = (nn_hier._build_cand_table(adm, counts, nn_hier.table_width(m, g, l_budget)),
            torch.clamp_max(counts, l_eff), g)
    g2 = nn_hier._coarse_tile_rows(g, gsrc)
    adm2 = nn_hier.coarse_admission(adm, g, g2)
    counts2 = adm2.sum(1, dtype=torch.int32)
    c2 = m // g2
    coarse = (nn_hier._build_cand_table(adm2, counts2, -(-min(l_budget, c2) // 8) * 8),
              torch.clamp_max(counts2, min(l_budget, (5 * c2) // 8)), g2)
    k3_errs = []
    for name, (cand, cnt, gg) in (("fine", fine), ("coarse", coarse)):
        idx, dist = nn_cand.nearest_neighbors_cand(pos, target.packed, cand, cnt,
                                                   g=gg, gsrc=gsrc)
        r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
            pos[None], target.packed[None], cand[None], cnt[None], gg, gsrc)
        torch.cuda.synchronize()
        bad_i = int((idx != r_idx[0]).sum())
        bad_d = int((dist != r_dist[0]).sum())
        cut = int((adm.sum(1) > l_eff).sum()) if name == "fine" else int(
            (counts2 > coarse[1]).sum())
        finite = torch.isfinite(dist) & torch.isfinite(r_dist[0]) & (dist < 1e37)
        k3_errs.append(float((dist[finite].double() - r_dist[0][finite].double())
                             .abs().max()) if bool(finite.any()) else 0.0)
        same_k1 = int(((idx != k1_idx) | (dist != k1_dist))[valid].sum())
        log(f"[k3] {name} arm (g {gg}, table {tuple(cand.shape)}, live slots "
            f"mean {float(cnt.float().mean()):.1f} max {int(cnt.max())}, groups "
            f"over budget {cut}): idx mismatches {bad_i}, dist mismatches "
            f"{bad_d} (tolerance 0); rows differing from K1 {same_k1}")
        check(bad_i == 0 and bad_d == 0, f"K3 differs from plain ({name})")
        if cut == 0:
            check(same_k1 == 0, f"K3 within budget differs from K1 ({name})")
    ragged_counts = fine[1].clone()
    ragged_counts[::3] = 0
    ragged_counts[1::3] //= 2
    pair = (torch.stack([pos, pos]), torch.stack([target.packed] * 2),
            torch.stack([fine[0]] * 2), torch.stack([fine[1], ragged_counts]))
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(*pair, g, gsrc)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(*pair, g, gsrc)
    torch.cuda.synchronize()
    bad_b = int((b_idx != r_idx).sum() + (b_dist != r_dist).sum())
    log(f"[k3] batch of 2 (full, ragged counts): mismatches against plain {bad_b}")
    check(bad_b == 0, "K3 batch differs from plain")

    h_idx, h_dist, h_state = nn_hier.nearest_neighbors_hier(
        pos, setup.src_mask, target, mid.nn, l_budget=l_budget, g=g, gsrc=gsrc)
    torch.cuda.synchronize()
    bad_h = int(((h_idx != k1_idx) | (h_dist != k1_dist))[valid].sum())
    log(f"[hier] nearest_neighbors_hier ({nn_hier.ARM_TRACE[-1]} arm) against K1 "
        f"on {int(valid.sum())} valid sources: rows differing {bad_h} (tolerance 0)")
    check(bad_h == 0, "the hierarchical search differs from K1")

    cand, cnt, _ = fine
    k3_ms = time_ms(lambda: nn_cand.nearest_neighbors_cand(
        pos, target.packed, cand, cnt, g=g, gsrc=gsrc), 20)
    k3_plain_ms = time_ms(lambda: nn_cand.nearest_neighbors_cand_ref(
        pos[None], target.packed[None], cand[None], cnt[None], g, gsrc), 3)
    hier_ms = time_ms(lambda: nn_hier.nearest_neighbors_hier(
        pos, setup.src_mask, target, mid.nn, l_budget=l_budget, g=g, gsrc=gsrc), 20)
    log(f"[k3] time on the fine table on {smi}: K3 {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.3f} ms; whole hierarchical search {hier_ms:.4f} ms "
        f"(arm {nn_hier.ARM_TRACE[-1]}; host clock, one read-back per call)")

    # 5. the slice --------------------------------------------------------------
    rng = np.random.Generator(np.random.PCG64(2024))
    before = (rng.random((n_head, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.1)
    t_true = get_random_translation_vector(rng, 0.5)
    after = (before @ r_true.T + t_true).astype(np.float32)[rng.permutation(n_head)]
    nn_dense.LAUNCHES = bound.LAUNCHES = nn_cand.LAUNCHES = 0
    nn_hier.ARM_TRACE.clear()
    t0 = time.perf_counter()
    rot, trans, iters, err = tpuslam_torch.register(
        before, after, device=dev, max_iterations=100
    )
    wall = time.perf_counter() - t0
    launches = {"K1": nn_dense.LAUNCHES, "K2": bound.LAUNCHES, "K3": nn_cand.LAUNCHES}
    arms = list(nn_hier.ARM_TRACE)
    cos = (np.trace(rot.astype(np.float64).T @ r_true.astype(np.float64)) - 1) / 2
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    log(f"[slice] register {n_head}-point uniform box on {kind}: {iters} "
        f"iterations, error {err}, rotation off by {angle} deg, translation "
        f"off by {float(np.abs(trans - t_true).max())}, launches {launches}, "
        f"arms fine {arms.count('fine')} / coarse {arms.count('coarse')} / "
        f"dense {arms.count('dense')} ({''.join(a[0] for a in arms)}), "
        f"{wall:.3f} s")
    for name, k in launches.items():
        check(k > 0, f"the registration did not launch {name}")
    check(rot.shape == (3, 3) and trans.shape == (3,), "result shapes")
    check(bool(np.isfinite(rot).all() and np.isfinite(trans).all()),
          "non-finite transform")
    check(bool(np.isfinite(err)), "non-finite error")
    check(angle < 1.0, f"rotation {angle} deg from the truth")

    n_small = sizes["small"]
    small_before = (rng.random((n_small, 3)) * 10).astype(np.float32)
    r_small = get_random_rotation_matrix(rng, 0.1)
    t_small = get_random_translation_vector(rng, 0.5)
    small_after = (small_before @ r_small.T + t_small).astype(np.float32)[
        rng.permutation(n_small)]
    on_cpu = tpuslam_torch.register(small_before, small_after, device="cpu",
                                    max_iterations=100)
    on_card = tpuslam_torch.register(small_before, small_after, device=dev,
                                     max_iterations=100)
    d_rot = float(np.abs(on_cpu[0] - on_card[0]).max())
    d_trans = float(np.abs(on_cpu[1] - on_card[1]).max())
    log(f"[slice] {n_small} points, CPU (plain, dense arm) vs card (default "
        f"arm): iterations {on_cpu[2]} / {on_card[2]}, |dR| {d_rot}, "
        f"|dt| {d_trans}, error {on_cpu[3]} / {on_card[3]}")
    check(d_rot <= 1e-4 and d_trans <= 1e-4, "CPU and card disagree")
    kw = dict(max_iterations=100, use_spatial=True)
    h_cpu = icp_register(pad_cloud(small_before), pad_cloud(small_after), **kw)
    h_card = icp_register(pad_cloud(small_before, device=dev),
                          pad_cloud(small_after, device=dev), **kw)
    d_rot = float((h_cpu.transform.rotation - h_card.transform.rotation.cpu())
                  .abs().max())
    d_trans = float((h_cpu.transform.translation
                     - h_card.transform.translation.cpu()).abs().max())
    log(f"[slice] {n_small} points, hierarchical arm on both, CPU (plain) vs "
        f"card (K2, K3): iterations {h_cpu.iterations} / {h_card.iterations}, "
        f"|dR| {d_rot}, |dt| {d_trans}")
    check(h_cpu.iterations == h_card.iterations, "hier iterations differ")
    check(d_rot <= 1e-4 and d_trans <= 1e-4, "hier CPU and card disagree")

    # 6. large cloud --------------------------------------------------------------
    n_large = sizes["large"]
    big_before = (rng.random((n_large, 3)) * 10).astype(np.float32)
    r_big = get_random_rotation_matrix(rng, 0.1)
    t_big = get_random_translation_vector(rng, 0.5)
    big_after = (big_before @ r_big.T + t_big).astype(np.float32)[
        rng.permutation(n_large)]
    lb, la = pad_cloud(big_before, device=dev), pad_cloud(big_after, device=dev)
    torch.cuda.synchronize()
    nn_hier.ARM_TRACE.clear()
    t0 = time.perf_counter()
    big = icp_register(lb, la, max_iterations=sizes["large_iters"], use_spatial=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    arms = list(nn_hier.ARM_TRACE)
    cos = (np.trace(big.transform.rotation.cpu().numpy().astype(np.float64).T
                    @ r_big.astype(np.float64)) - 1) / 2
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    big_setup = prepare_spatial(lb, la)
    log(f"[large] {n_large}-point uniform box on {kind} ({smi}): g "
        f"{big_setup.g}, gsrc {big_setup.gsrc}, L {big_setup.l_budget}, C "
        f"{big_setup.target.packed.shape[0] // big_setup.g}; {big.iterations} "
        f"iterations, {len(arms)} queries, {wall:.3f} s including set-up, "
        f"{wall / max(len(arms), 1) * 1000:.3f} ms per query, error "
        f"{float(big.error)}, rotation off by {angle} deg, arms "
        f"{''.join(a[0] for a in arms)}")
    check(bool(torch.isfinite(big.error)), "large: non-finite error")
    pos = transform_points(big_setup.src_points, big.transform.rotation,
                           big.transform.translation)
    h_idx, h_dist, _ = nn_hier.nearest_neighbors_hier(
        pos, big_setup.src_mask, big_setup.target, big.nn,
        l_budget=big_setup.l_budget, g=big_setup.g, gsrc=big_setup.gsrc)
    arm = nn_hier.ARM_TRACE[-1]
    t0 = time.perf_counter()
    k1_idx, k1_dist = nn_dense.nearest_neighbors_dense(
        pos, big_setup.target.original_points, big_setup.target.count)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    big_valid = big_setup.src_mask > 0
    bad = int(((h_idx != k1_idx) | (h_dist != k1_dist))[big_valid].sum())
    log(f"[large] warm query ({arm} arm) against K1 ({k1_s:.3f} s) on "
        f"{int(big_valid.sum())} valid sources: rows differing {bad} "
        f"(tolerance 0)")
    check(bad == 0, "large: the hierarchical search differs from K1")
    del lb, la, big, big_setup, pos, h_idx, h_dist, k1_idx, k1_dist

    # 7. headline -----------------------------------------------------------------
    heads = {}
    for name, n_pts, arm in (("hier", n_head, None), ("dense", n_head, False),
                             ("hier_8192", sizes["small"], True),
                             ("dense_8192", sizes["small"], False)):
        nn_hier.ARM_TRACE.clear()
        h = measure_icp_100k(n_points=n_pts, device=dev, use_spatial=arm)
        h["nvidia_smi"] = smi
        arms = list(nn_hier.ARM_TRACE)
        if arms:
            h["arms"] = {a: arms.count(a) for a in ("fine", "coarse", "dense")}
        heads[name] = h
        log(f"[headline] {name}: {json.dumps(h)}")
        check(h["iterations_run"] == h["iters_per_call"],
              f"the headline run stopped early ({name})")
    check(heads["hier"]["nn_arm"] == "hier", "the default headline is not hier")

    log(smi)
    log(json.dumps({"kernels": [
        {
            "name": "nn_dense (K1)",
            "route": "cuda",
            "source": "tpuslam_torch/csrc/nn_dense.cu",
            "replaces": "tpuslam/kernels/pallas_nn.py:116",
            "launches": launches["K1"],
            "max_abs_err": max(errs),
            "ms": k1_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "bound_pass (K2)",
            "route": "cuda",
            "source": "tpuslam_torch/csrc/bound.cu",
            "replaces": "tpuslam/kernels/pallas_bound.py:65",
            "launches": launches["K2"],
            "max_abs_err": max(k2_errs),
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
        {
            "name": "nn_cand (K3)",
            "route": "cuda",
            "source": "tpuslam_torch/csrc/nn_cand.cu",
            "replaces": "tpuslam/kernels/pallas_nn_cand.py:104",
            "launches": launches["K3"],
            "max_abs_err": max(k3_errs),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
