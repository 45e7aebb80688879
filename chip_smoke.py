#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpuslam_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed as it ends; the first failure raises and the script
exits non-zero without printing a result:

1. device — the card's name and power limit (nvidia-smi) and torch's view;
2. build — kernels K1 (``csrc/nn_dense.cu``), K2 (``csrc/bound.cu``),
   K3 (``csrc/nn_cand.cu``), K4 (``csrc/cpd_dense.cu``) and K5
   (``csrc/cpd_cand.cu``) from source, one nvcc per source, started
   together; ptxas's registers and spills per kernel;
3. K1 against its plain PyTorch version on the card, bit for bit (idx and
   dist equal; tolerance 0), each case at the geometry (sources a thread,
   splits of the target range) ``dense_geometry`` gives it: the 102,400 x
   102,400 headline pair, two counts that end inside a split, a stage and
   a segment, count 0, planted ties whose equal targets sit in different
   splits, a batch of two, 8,192^2, a batch of 16 x 2,048 with ragged
   counts, and NaN and inf source and target rows (held to the plain
   version read under K1's contract, ``plain_under_contract``: the plain
   argmin takes a NaN, K1 never does); then K1's and the plain version's
   times at 102,400 x 102,400, and K1's at 8,192^2 and 16 x 2,048^2 (one
   CUDA graph of 50 launches, so the host's Python between launches does
   not count);
4. K2 and K3 against their plain versions on the headline pair's
   hierarchical set-up (C = 800 tiles, 100 source groups): K2 cold, warm
   after one dense step, warm in mid-registration, and a batch of two
   (admitted sets identical, and a superset of every valid source's true
   tile); K3 on the fine (g = 128) and coarse (g2 = 512) tables and a
   batch of two (idx and dist identical); the whole hierarchical search
   against K1 (tolerance 0); then K2's, K3's and the plain versions'
   times, with each kernel's bound (the pairs these inputs need: all
   sources x tiles for K2, each group's live rows x its sources for K3);
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
   (tolerance 0), K2 against its plain version (admitted sets identical,
   every true tile admitted), and K2's and K3's times there (fine table);
7. headline — ``measure_icp_100k()`` on the hierarchical arm (the default
   on CUDA) and on the dense arm; both arms again at 8,192 points; the
   launches of K1, K2 and K3 per headline call on each arm;
8. K4 against its plain version at 20,480 x 20,480 (the JAX records'
   E-step row): exact, truncated, ragged masks (20,000 and 17,000 valid
   rows) and a batch of two; each statistic within 1e-5 of the largest
   plain value, the log-likelihood within 1e-5 relative; the count of
   differing Gaussians on one 1024 x 1024 tile against ``torch.exp``;
   K4's and the plain passes' times;
9. K5 against K4, bit for bit (tolerance 0), on Morton-sorted uniform
   boxes of 20,480 and 376,401 points at a wide, a Hybrid-window, a tight
   and an exact sigma^2 (route, admitted fraction of block pairs and of
   sub-tile pairs, the share of pairs K5's passes visit, fat blocks of
   each; the checked form against the unchecked one; at 376,401^2 the
   window and tight settings must run K5, not its route to K4), and on
   20 separate clusters of 1,024 points, one per block, with one block a
   side refilled from every cluster (heavy skipping with fat blocks),
   where K5's passes are also held to their plain versions (tolerance as
   K4's) and timed; at 376,401^2, the main path's size, K4's passes (at
   the initial sigma^2 without truncation, and at the Hybrid-window
   sigma^2 with it) and K5's passes (at the window, under its admission)
   against the plain running totals over all 368 blocks of the other
   cloud on the valid rows of the first, middle and last 1,024-row
   block (K5: of the blocks it serves), within 1e-5 of the largest
   plain value; these
   errors are the ``max_abs_err`` of the kernels line; K4's exact E-step
   and K5's tight E-step timed at 376,401^2, then each pass alone there
   (K4 at the initial sigma^2 without truncation, K5's kernels at the
   window and at sigma^2 0.002 under their tables), with the admitted
   fractions and each time's bound on the pairs it visits;
10. the CPD slice — ``tpuslam_torch.register`` with CPD, Hybrid, on a
   376,401-point uniform box moved by (0.1 rad, 0.5), weight 0.1, const
   scale (the JAX records' protocol), for 30 iterations: tolerance 0
   instead of the protocol's 1e-4, and 30 iterations instead of 15,
   because the box reaches the Hybrid switch only at iteration 18 or 19
   and its log-likelihood can stall there (the relative change fell to
   1.7e-5 at the switch in one run), which would end the run before the
   slow phase.  Printed: the E-step of each iteration (both phases must
   run, the slow one on K5), wall, s/iter, rotation error, a finite
   result; then the same pair in the exact mode for 3 iterations, whose
   full admission routes every E-step to K4; the K4 and K5 launches of
   the two runs together must all be > 0; then 8,192 points on
   the CPU (plain versions, ``use_kernels=True``) and on the card in None
   and in Hybrid without the FGT, 100 iterations at most: equal
   iterations, R and t within 1e-4, rotation within 1 degree;
11. E-step rows at 376,401^2: two FGT E-steps on the same inputs, which
   must be bit-equal (the segment sums add in a fixed order); exact K4
   against the FGT E-step (with and without the loop's cached clusterings
   and their order), and the FGT prediction at three chunk sizes.
12. NICP — K1 at NICP's rescore shape (8 candidates x 1,024 subcloud rows
   against 1,048,576 targets) against its plain version, bit for bit;
   ``tpuslam_torch.register`` with NICP (seed 1) on a 1,048,576-point
   anisotropic box ([0,40] x [0,20] x [0,10]) moved by (2.0 rad, 30),
   timed after an untimed call: within 1 degree of the truth, K1
   launched; ``nicp_register`` direct on a 1,048,576-point uniform box of
   side 10, subcloud 1000, seed 1, three timed runs after a warm-up (the
   JAX records' row), and the same box through ``register``, whose
   eigengap pre-pass widens it (candidates scored and ms printed); a
   degenerate cylinder, two disjoint samples of 102,400 points, 70
   degrees about its axis: widened, within 1 degree;
13. prealigned ICP — ``register(icp_prealign=True)`` on a 102,400-point
   anisotropic box moved by (2.0 rad, 30), with noise of 0.01 on the
   moved copy: within 1 degree, K1 launched (the NICP shot), K2 and K3
   launched (the hierarchical loop); the cold run of the same pair
   printed beside it, unchecked;
14. batching — ``tpuslam_torch.register_pairs`` with ICP on 16 x 2,048
   boxes of sides (10, 5, 2.5) (the batched dense lowering: K1's batch
   form must launch with B = 16), each pair equal to its solo
   ``register`` bit for bit (iterations, R and t); 16 x 16,384 pairs on
   the auto (unrolled) lowering and forced to the batched hierarchical
   one (K2's and K3's batch forms must launch), each pair equal to its
   solo hierarchical run bit for bit;
   ms per call and per pair-iteration of the four lowerings (batched or
   unrolled, dense or hierarchical) at both sizes, 20 iterations a pair;
   NICP on 16 x 16,384 anisotropic pairs, each within 1 degree; CPD on
   4 x 2,048 pairs, 10 iterations, each equal to its solo run bit for
   bit.

The launch counts each path is checked by are set to 0 just before it
runs and read just after.

The last lines are the card's name and power limit, one JSON object
describing each kernel (with its bound: the larger of its float32
operations, or for K4 and K5 the exponentials on the special-function
units, over the card's peak rate and its bytes over the memory rate; and
for K1, K2 and K3 the launches per warm headline iteration; for K1 also
its launches per NICP run of phase 12 and its time at the rescore
shape), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# cloud sizes of the phases
FULL = dict(headline=102_400, small=8192, large=1_048_576, large_iters=20,
            mid_iters=12, cpd_small=20_480, cpd_large=376_401, cpd_iters=30,
            cpd_exact_iters=3, cpd_cpu=8192, nicp_large=1_048_576,
            nicp_cylinder=102_400, prealign=102_400, batch_pairs=16,
            batch_small=2048, batch_large=16_384, cpd_batch=2048)

# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores and HBM3; and the special-function units' exp2,
# 16 a clock on each of 132 SMs at the 1.98 GHz boost clock
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
# float32 operations per (source, target) pair, an FMA counted as two:
# the NN distance (3 subtractions, a product, 2 FMAs); K2's 12-term
# centre distance (a product, 11 FMAs, + s2) with its bound term (+ eps,
# sqrt, + r) and admission test ((ub + r)^2 + eps); the CPD Gaussian's
# distance and scale, then + the denominator or 4 weighted FMAs
FLOPS_NN, FLOPS_BOUND = 8, 30
FLOPS_DENOM, FLOPS_MOMENTS = 10, 17


def bound_of(flops: float, nbytes: float, exps: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    ops_ms = max(flops / PEAK_FP32, exps / PEAK_EXP) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cpd_phases(dev, smi, kind, sizes, time_ms) -> list:
    """Phases 8-11 (module docstring); returns the kernels' JSON entries."""
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.config.configuration import ApproximationType, ComputationMethod
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.kernels import cpd_cand, cpd_dense
    from tpuslam_torch.ops import fgt
    from tpuslam_torch.ops.spatial import morton_permutation

    rng = np.random.Generator(np.random.PCG64(376))
    stats = ("p1", "pt1", "px", "error")

    def f32(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def sort_rows(p):
        return p[morton_permutation(p, torch.ones(len(p), device=dev)).long()].contiguous()

    def box(n):
        return sort_rows(torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev))

    def k4_launches():
        return cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES

    def plain_estep(transformed, moving_mask, target, target_mask, sigma2, constant, trunc):
        """``cpd_estep_dense_batch`` spelled out with the plain passes
        (``denom_pass_ref``, ``moments_pass_ref``) on the card's tensors;
        no kernel may launch."""
        before = k4_launches()
        b, m0, _ = transformed.shape
        n0 = target.shape[1]
        m, n = (-(-r // cpd_dense.TILE) * cpd_dense.TILE for r in (m0, n0))
        moving_mask = cpd_dense.pad_rows(moving_mask, m)
        target = cpd_dense.pad_rows(target, n).contiguous()
        target_mask = cpd_dense.pad_rows(target_mask, n)
        transformed = cpd_dense.pad_rows(transformed, m)
        ty = torch.where(moving_mask[:, :, None] > 0, transformed,
                         torch.full_like(transformed, cpd_dense.SENTINEL)).contiguous()
        scal = cpd_dense.estep_scalars(sigma2, constant, trunc, 1e-3)
        denom = cpd_dense.denom_pass_ref(scal, ty, target).reshape(b, n)
        pt1, w4 = cpd_dense.moment_weights(denom, target, target_mask, constant)
        acc = cpd_dense.moments_pass_ref(scal, ty, target, w4)
        out = cpd_dense.sufficient_from(acc, denom, pt1, moving_mask, target_mask,
                                        sigma2, m0, n0)
        check(k4_launches() == before, "the plain E-step launched K4")
        return out

    def rel_errs(got, want):
        """Per statistic: max |got - want| / max |want| (the error's own
        relative error)."""
        out = {}
        for f in stats:
            g, w = getattr(got, f).double(), getattr(want, f).double()
            out[f] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        return out

    # 8. K4 against its plain version ------------------------------------------
    n = sizes["cpd_small"]
    a, b = box(n), box(n)
    ones = torch.ones(n, device=dev)
    rows = torch.arange(n, device=dev)
    # 20,000 moving and 17,000 target rows valid at 20,480
    ragged_m = (rows < n * 20_000 // 20_480).float()
    ragged_t = (rows < n * 17_000 // 20_480).float()
    cases = {
        "exact": ((a[None], ones[None], b[None], ones[None]), (1.0,), (0.3,), (False,)),
        "truncated": ((a[None], ones[None], b[None], ones[None]), (0.05,), (0.01,), (True,)),
        "ragged": ((a[None], ragged_m[None], b[None], ragged_t[None]), (0.2,), (0.1,), (True,)),
        "batch of 2": ((torch.stack([a, b]), torch.stack([ones, ragged_m]),
                        torch.stack([b, a]), torch.stack([ones, ragged_t])),
                       (1.0, 0.05), (0.3, 0.01), (False, True)),
    }
    for name, (clouds, s2, c, tr) in cases.items():
        args = (*clouds, f32(*s2), f32(*c), torch.tensor(tr, device=dev))
        got, want = cpd_dense.cpd_estep_dense_batch(*args), plain_estep(*args)
        torch.cuda.synchronize()
        errs = rel_errs(got, want)
        abs_err = max(float((getattr(got, f) - getattr(want, f)).abs().max())
                      for f in ("p1", "pt1", "px"))
        log(f"[k4] {name} at {n} x {n}: relative errors against plain "
            + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
            + f" (tolerance 1e-5); max abs {abs_err:.3e}")
        check(max(errs.values()) <= 1e-5, f"K4 differs from plain ({name})")
    # the Gaussian term by term: pair i of a batch of 1024 keeps moving row i
    # alone (the rest at the sentinel) and c = 0, so its denominators are
    # that row's Gaussians against the 1024 targets
    ty = torch.full((1024, 1024, 3), cpd_dense.SENTINEL, device=dev)
    idx = torch.arange(1024, device=dev)
    ty[idx, idx] = a[:1024]
    sc = cpd_dense.estep_scalars(torch.ones(1024, device=dev), torch.zeros(1024, device=dev),
                                 torch.zeros(1024, dtype=torch.bool, device=dev), 1e-3)
    g_k = cpd_dense.denom_pass_batch(sc, ty, b[:1024].expand(1024, 1024, 3).contiguous())[:, 0]
    g_p = cpd_dense.gauss_tile(b[:1024], a[:1024], sc[0]).T
    torch.cuda.synchronize()
    g_diff = int((g_k != g_p).sum())
    log(f"[k4] Gaussians on one 1024 x 1024 tile differing from torch.exp: {g_diff} of "
        f"{1024 * 1024}, max relative {float(((g_k - g_p).abs() / g_p).max()):.3e}")
    args = cases["exact"]
    args = (*args[0], f32(*args[1]), f32(*args[2]), torch.tensor(args[3], device=dev))
    y_pad = a[None].contiguous()
    scal = cpd_dense.estep_scalars(f32(1.0), f32(0.3), torch.tensor([False], device=dev), 1e-3)
    dn = cpd_dense.denom_pass_ref(scal, y_pad, b[None])
    _, w4 = cpd_dense.moment_weights(dn[:, 0], b[None], ones[None], f32(0.3))
    times = {
        "denom": time_ms(lambda: cpd_dense.denom_pass_batch(scal, y_pad, b[None]), 20),
        "denom_plain": time_ms(lambda: cpd_dense.denom_pass_ref(scal, y_pad, b[None]), 2),
        "moments": time_ms(lambda: cpd_dense.moments_pass_batch(scal, y_pad, b[None], w4), 20),
        "moments_plain": time_ms(
            lambda: cpd_dense.moments_pass_ref(scal, y_pad, b[None], w4), 2),
        "estep": time_ms(lambda: cpd_dense.cpd_estep_dense_batch(*args), 20),
        "estep_plain": time_ms(lambda: plain_estep(*args), 2),
    }
    log(f"[k4] times at {n} x {n} on {smi}: denom {times['denom']:.4f} ms (plain "
        f"{times['denom_plain']:.3f}), moments {times['moments']:.4f} ms (plain "
        f"{times['moments_plain']:.3f}), whole E-step {times['estep']:.4f} ms (plain "
        f"{times['estep_plain']:.3f})")

    # 9. K5 against K4, bit for bit ------------------------------------------------
    def k5_tables(adm):
        """K5's per-CTA tables under an admission, as ``cpd_estep_cand``
        builds them (fat blocks served by K4)."""
        n_rows, m_rows = (len(x) * cpd_dense.TILE for x in (adm.fat_n, adm.fat_m))
        table_m, counts_n = cpd_cand.cta_tables(
            adm.sub_adm, adm.f_sub, cpd_dense.cpd_geometry(n_rows).cta_rows, ~adm.fat_n,
            adm.width_m)
        table_n, counts_m = cpd_cand.cta_tables(
            adm.sub_adm.T, adm.f_sub, cpd_dense.cpd_geometry(m_rows).cta_rows, ~adm.fat_m,
            adm.width_n)
        return table_m, counts_n, table_n, counts_m

    def fractions(adm):
        """Admitted share of block pairs and of sub-tile pairs, and the
        share of (row, row) pairs K5's two passes visit, with those pairs."""
        table_m, counts_n, table_n, counts_m = k5_tables(adm)
        n_rows, m_rows = (len(x) * cpd_dense.TILE for x in (adm.fat_n, adm.fat_m))
        visited = (cpd_cand.visited_pairs(table_m, counts_n, n_rows // len(counts_n)),
                   cpd_cand.visited_pairs(table_n, counts_m, m_rows // len(counts_m)))
        return {"block": float(adm.adm.float().mean()),
                "sub_tile": float(adm.sub_adm.float().mean()),
                "visited_denom": visited[0] / (n_rows * m_rows),
                "visited_moments": visited[1] / (n_rows * m_rows)}, visited

    def k5_against_k4(name, mov, tgt, s2, trunc, c=0.3):
        m1 = torch.ones(len(mov), device=dev)
        t1 = torch.ones(len(tgt), device=dev)
        args = (mov, m1, tgt, t1, s2, c)
        pad = [cpd_dense.pad_rows(x[None], -(-len(x) // 1024) * 1024)[0]
               for x in (mov, m1, tgt, t1)]
        adm = cpd_cand.block_admission(*pad, f32(s2)[0], torch.tensor(trunc, device=dev))
        dense = cpd_dense.cpd_estep_dense(*args, trunc)
        cand = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=dev))
        route = cpd_cand.ROUTE_TRACE[-1]
        checked, ovf = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=dev),
                                               checked=True)
        torch.cuda.synchronize()
        bad = sum(int((getattr(dense, f) != getattr(cand, f)).sum()) for f in stats)
        bad_checked = sum(int((getattr(checked, f) != getattr(cand, f)).sum()) for f in stats)
        frac, _ = fractions(adm)
        # on overflow the checked form's statistics are invalid by contract
        checked_note = ("discarded on overflow" if bool(ovf)
                        else f"differing {bad_checked} (tolerance 0)")
        log(f"[k5] {name}: sigma^2 {s2:.4g}, truncation {trunc}, route {route}, admitted "
            f"{frac['block']:.4f} of {adm.adm.numel()} block pairs, {frac['sub_tile']:.4f} of "
            f"{adm.sub_adm.numel()} sub-tile pairs (f_sub {adm.f_sub}), visited (denom, "
            f"moments) {frac['visited_denom']:.4f}, {frac['visited_moments']:.4f} of the pairs; "
            f"fat {int(adm.fat_n.sum())} target / {int(adm.fat_m.sum())} moving blocks, overflow "
            f"{bool(ovf)}; elements differing from K4 {bad} (tolerance 0); checked form "
            f"{checked_note}")
        check(bad == 0, f"K5 differs from K4 ({name})")
        check(bool(ovf) or bad_checked == 0, f"the checked form differs ({name})")
        return route, adm

    tile = cpd_dense.TILE

    def block_ids(n_blocks, skip=None):
        """The first, middle and last block, of those not flagged in
        ``skip``."""
        ids = torch.arange(n_blocks, device=dev)
        ids = (ids if skip is None else ids[~skip]).tolist()
        return sorted({ids[0], ids[len(ids) // 2], ids[-1]})

    def blocks_err(got, plain, ids, valid):
        """Max abs and relative error of ``got`` [..., rows] on the valid
        rows (``valid`` bool[rows]) of the blocks ``ids`` against
        ``plain(block rows)``."""
        err = top = 0.0
        for i in ids:
            sl = slice(i * tile, (i + 1) * tile)
            want = plain(sl).double()[..., valid[sl]]
            err = max(err, float((got[..., sl].double()[..., valid[sl]] - want).abs().max()))
            top = max(top, float(want.abs().max()))
        return err, err / top

    def passes_at_scale(label, mov, tgt, s2, trunc, c=0.3):
        """The main path's passes at its size: K4's, and under truncation
        K5's under its admission, against the plain running totals over
        every block of the other cloud, on the first, middle and last
        block (K5: of those it serves, not fat).  Padded rows are not
        compared: the statistics mask them out, and K5's bounds leave the
        padded target rows out, so their denominators may differ."""
        m1 = torch.ones(len(mov), device=dev)
        mov_p, mm, tgt_p, tm_ = (cpd_dense.pad_rows(x[None], -(-len(x) // tile) * tile)[0]
                                 for x in (mov, m1, tgt, m1))
        ty = torch.where(mm[:, None] > 0, mov_p,
                         torch.full_like(mov_p, cpd_dense.SENTINEL)).contiguous()
        tgt_p = tgt_p.contiguous()
        nb = len(tgt_p) // tile
        every = range(nb)
        scal = cpd_dense.estep_scalars(f32(s2), f32(c), torch.tensor([trunc], device=dev), 1e-3)
        dn = cpd_dense.denom_pass_batch(scal, ty[None], tgt_p[None])[0, 0]
        _, w4 = cpd_dense.moment_weights(dn[None], tgt_p[None], tm_[None], f32(c))
        acc = cpd_dense.moments_pass_batch(scal, ty[None], tgt_p[None], w4)[0]
        w4 = w4[0]

        def plain_denom(sl):
            return cpd_dense.denom_rows(scal[0], ty, tgt_p[sl], every)

        def plain_moments(sl):
            return cpd_dense.moments_rows(scal[0], ty[sl], tgt_p, w4, every)

        t_valid, m_valid = tm_ > 0, mm > 0
        errs = {"K4 denom": blocks_err(dn, plain_denom, block_ids(nb), t_valid),
                "K4 moments": blocks_err(acc, plain_moments, block_ids(nb), m_valid)}
        if trunc:
            adm = cpd_cand.block_admission(mov_p, mm, tgt_p, tm_, f32(s2)[0],
                                           torch.tensor(True, device=dev))
            check(not bool(adm.overflow), f"{label}: the admission overflows")
            table_m, counts_n, table_n, counts_m = k5_tables(adm)
            d5 = cpd_cand.denom_cand(scal[0], ty, tgt_p, table_m, counts_n)
            a5 = cpd_cand.moments_cand(scal[0], ty, tgt_p, w4, table_n, counts_m)
            errs["K5 denom"] = blocks_err(d5, plain_denom, block_ids(nb, adm.fat_n), t_valid)
            errs["K5 moments"] = blocks_err(a5, plain_moments, block_ids(nb, adm.fat_m),
                                            m_valid)
        torch.cuda.synchronize()
        log(f"[k4/k5] passes at {len(mov)}^2, {label} (sigma^2 {s2:.4g}, truncation {trunc}) "
            f"against the plain running totals over all {nb} blocks, on the first, middle "
            f"and last block: max abs, relative "
            + ", ".join(f"{k} {a:.3e}, {r:.3e}" for k, (a, r) in errs.items())
            + " (tolerance 1e-5 relative)")
        for k, (_, r) in errs.items():
            check(r <= 1e-5, f"{k} differs from its plain version at {len(mov)}^2 ({label})")
        return {k: a for k, (a, _) in errs.items()}

    def passes_timed(mov, tgt, s0, c=0.3):
        """The main path's passes at its size, by CUDA events: K4's at the
        initial sigma^2 without truncation, K5's (its kernels alone, fat
        blocks left to K4) at the Hybrid window and at sigma^2 0.002, with
        the admitted fractions and each time's bound on the pairs it
        visits."""
        m1 = torch.ones(len(mov), device=dev)
        mov_p, mm, tgt_p, tm_ = (cpd_dense.pad_rows(x[None], -(-len(x) // tile) * tile)[0]
                                 for x in (mov, m1, tgt, m1))
        ty = torch.where(mm[:, None] > 0, mov_p,
                         torch.full_like(mov_p, cpd_dense.SENTINEL)).contiguous()
        tgt_p = tgt_p.contiguous()
        rows = float(len(tgt_p))
        io = 2 * rows * 12 + 16
        out = {}
        for label, s2, trunc in (("K4 exact, initial sigma^2", s0, False),
                                 ("K5 window", 0.015 * s0, True), ("K5 tight", 0.002, True)):
            scal = cpd_dense.estep_scalars(f32(s2), f32(c), torch.tensor([trunc], device=dev),
                                           1e-3)
            dn = cpd_dense.denom_pass_batch(scal, ty[None], tgt_p[None])
            _, w4 = cpd_dense.moment_weights(dn[:, 0], tgt_p[None], tm_[None], f32(c))
            row = {"sigma2": s2}
            if not trunc:
                pairs = (rows * rows, rows * rows)
                row["denom_ms"] = time_ms(
                    lambda: cpd_dense.denom_pass_batch(scal, ty[None], tgt_p[None]), 3)
                row["moments_ms"] = time_ms(
                    lambda: cpd_dense.moments_pass_batch(scal, ty[None], tgt_p[None], w4), 3)
            else:
                adm = cpd_cand.block_admission(mov_p, mm, tgt_p, tm_, f32(s2)[0],
                                               torch.tensor(True, device=dev))
                frac, pairs = fractions(adm)
                table_m, counts_n, table_n, counts_m = k5_tables(adm)
                row.update(frac, fat=(int(adm.fat_n.sum()), int(adm.fat_m.sum())))
                row["denom_ms"] = time_ms(lambda: cpd_cand.denom_cand(
                    scal[0], ty, tgt_p, table_m, counts_n), 5)
                row["moments_ms"] = time_ms(lambda: cpd_cand.moments_cand(
                    scal[0], ty, tgt_p, w4[0], table_n, counts_m), 5)
                pairs = tuple(float(p) for p in pairs)
            row["pairs"] = pairs
            row["denom_bound"] = bound_of(FLOPS_DENOM * pairs[0], io + rows * 4, pairs[0])
            row["moments_bound"] = bound_of(FLOPS_MOMENTS * pairs[1], io + rows * 32, pairs[1])
            out[label] = row
        return out

    routes = {}
    main_errs = {}
    for n in (sizes["cpd_small"], sizes["cpd_large"]):
        mov, tgt = box(n), box(n)
        m1 = torch.ones(n, device=dev)
        s0 = float(cpd.sigma_squared_init(mov, m1, tgt, m1))
        for label, s2, trunc in (("wide", s0, True), ("window", 0.015 * s0, True),
                                 ("tight", 0.002, True), ("exact", 0.05, False)):
            routes[(n, label)] = k5_against_k4(f"{label} at {n}^2", mov, tgt, s2, trunc)[0]
        if n == sizes["cpd_large"]:
            # the main path's K5 settings must run K5, not its route to K4
            check(routes[(n, "window")] == "k5" and routes[(n, "tight")] == "k5",
                  f"the window and tight settings at {n}^2 did not run K5")
            for label, s2, trunc in (("exact at the initial sigma^2", s0, False),
                                     ("Hybrid window", 0.015 * s0, True)):
                for k, e in passes_at_scale(label, mov, tgt, s2, trunc).items():
                    main_errs[k] = max(main_errs.get(k, 0.0), e)
            ex = (mov, m1, tgt, m1, 0.05, 0.3, False)
            tight = (mov, m1, tgt, m1, 0.002, 0.3, torch.tensor(True, device=dev))
            large = {"k4_exact_s": time_ms(lambda: cpd_dense.cpd_estep_dense(*ex), 3) / 1e3,
                     "k5_tight_s": time_ms(lambda: cpd_cand.cpd_estep_cand(*tight), 3) / 1e3}
            log(f"[k5] times at {n}^2 on {smi}: K4 exact E-step {large['k4_exact_s']:.4f} s, "
                f"K5 tight E-step {large['k5_tight_s']:.4f} s (route "
                f"{cpd_cand.ROUTE_TRACE[-1]})")
            log(f"[k4/k5] passes at {n}^2 on {smi}: "
                + json.dumps(passes_timed(mov, tgt, s0)))
    # 20 clusters of 1,024 on a grid 100 apart, one cluster per block, then
    # one block a side refilled with points drawn from every cluster:
    # heavy skipping, with one fat block a side
    grid = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)][:20],
                    np.float32) * 100.0
    pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + g for g in grid])
    mov_c, tgt_c = pts.copy(), (pts + 0.01).astype(np.float32)
    mov_c[3 * 1024:4 * 1024] = pts[rng.permutation(len(pts))[:1024]]
    tgt_c[7 * 1024:8 * 1024] = tgt_c[rng.permutation(len(pts))[:1024]]
    mov_c = torch.from_numpy(mov_c).to(dev)
    tgt_c = torch.from_numpy(tgt_c).to(dev)
    route, adm = k5_against_k4("clusters at 20,480^2", mov_c, tgt_c, 0.05, True)
    check(route == "k5" and bool(adm.fat_n.any()), "the cluster case must run K5 with fat blocks")
    # K5's passes against their plain versions on that case
    m1 = torch.ones(len(mov_c), device=dev)
    ty5 = mov_c.contiguous()
    sc5 = cpd_dense.estep_scalars(f32(0.05), f32(0.3), torch.tensor([True], device=dev), 1e-3)[0]
    cand_m, counts_n, cand_n, counts_m = k5_tables(adm)
    _, (k5_denom_pairs, k5_moments_pairs) = fractions(adm)
    d5 = cpd_cand.denom_cand(sc5, ty5, tgt_c, cand_m, counts_n)
    d5_ref = cpd_cand.denom_cand_ref(sc5, ty5, tgt_c, cand_m, counts_n)
    _, w5 = cpd_dense.moment_weights(d5_ref[None], tgt_c[None], m1[None], f32(0.3))
    w5 = w5[0]
    a5 = cpd_cand.moments_cand(sc5, ty5, tgt_c, w5, cand_n, counts_m)
    a5_ref = cpd_cand.moments_cand_ref(sc5, ty5, tgt_c, w5, cand_n, counts_m)
    torch.cuda.synchronize()
    k5_err = {"denom": float((d5 - d5_ref).abs().max()),
              "moments": float((a5 - a5_ref).abs().max())}
    k5_rel = {"denom": k5_err["denom"] / float(d5_ref.abs().max()),
              "moments": k5_err["moments"] / float(a5_ref.abs().max())}
    log(f"[k5] passes against their plain versions on the cluster case: max abs "
        f"{k5_err}, relative {k5_rel} (tolerance 1e-5)")
    check(max(k5_rel.values()) <= 1e-5, "K5 differs from its plain version")
    k5_times = {
        "denom": time_ms(lambda: cpd_cand.denom_cand(sc5, ty5, tgt_c, cand_m, counts_n), 20),
        "denom_plain": time_ms(
            lambda: cpd_cand.denom_cand_ref(sc5, ty5, tgt_c, cand_m, counts_n), 2),
        "moments": time_ms(
            lambda: cpd_cand.moments_cand(sc5, ty5, tgt_c, w5, cand_n, counts_m), 20),
        "moments_plain": time_ms(
            lambda: cpd_cand.moments_cand_ref(sc5, ty5, tgt_c, w5, cand_n, counts_m), 2),
    }
    log(f"[k5] times on the cluster case on {smi}: denom {k5_times['denom']:.4f} ms (plain "
        f"{k5_times['denom_plain']:.3f}), moments {k5_times['moments']:.4f} ms (plain "
        f"{k5_times['moments_plain']:.3f})")

    # 10. the CPD slice -------------------------------------------------------------
    n = sizes["cpd_large"]
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.1)
    t_true = get_random_translation_vector(rng, 0.5)
    after = (before @ r_true.T + t_true).astype(np.float32)[rng.permutation(n)]

    def launch_counts():
        return {"K4 denom": cpd_dense.DENOM_LAUNCHES,
                "K4 moments": cpd_dense.MOMENTS_LAUNCHES,
                "K5 denom": cpd_cand.DENOM_LAUNCHES,
                "K5 moments": cpd_cand.MOMENTS_LAUNCHES}

    def register_cpd(mode, max_iterations):
        """One CPD registration through the entry point; returns its result,
        wall time, E-step phases and K5 routes."""
        cpd.PHASE_TRACE.clear()
        cpd_cand.ROUTE_TRACE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tpuslam_torch.register(
            before, after, device=dev, computation_method=ComputationMethod.Cpd,
            approximation_type=mode, cpd_weight=0.1, cpd_const_scale=True,
            cpd_tolerance=0.0, max_iterations=max_iterations)
        wall = time.perf_counter() - t0
        rot, trans, iters, err = out
        cos = (np.trace(rot.astype(np.float64).T @ r_true.astype(np.float64)) - 1) / 2
        angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        log(f"[cpd] register CPD {mode.value} on a {n}-point uniform box on {kind} "
            f"({smi}): {iters} iterations, E-steps {list(cpd.PHASE_TRACE)}, K5 routes "
            f"{list(cpd_cand.ROUTE_TRACE)}, launches so far {launch_counts()}, "
            f"{wall:.3f} s, {wall / max(iters, 1):.4f} s/iter, sigma^2 {err}, rotation "
            f"off by {angle} deg, translation off by {float(np.abs(trans - t_true).max())}")
        check(bool(np.isfinite(rot).all() and np.isfinite(trans).all()
                   and np.isfinite(err)), f"non-finite CPD result ({mode.value})")
        return out, wall, list(cpd.PHASE_TRACE), list(cpd_cand.ROUTE_TRACE)

    # the main path, counted: Hybrid (FGT fast phase, K5 slow phase), then
    # the exact mode, whose full admission overflows K5's table and routes
    # every E-step to K4
    cpd_dense.DENOM_LAUNCHES = cpd_dense.MOMENTS_LAUNCHES = 0
    cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = 0
    _, _, phases, _ = register_cpd(ApproximationType.Hybrid, sizes["cpd_iters"])
    check("fgt" in phases and "trunc" in phases, "the run must take both Hybrid phases")
    check(cpd_cand.DENOM_LAUNCHES > 0 and cpd_cand.MOMENTS_LAUNCHES > 0,
          "the Hybrid slow phase did not launch K5")
    _, _, phases, _ = register_cpd(ApproximationType.NONE, sizes["cpd_exact_iters"])
    check(set(phases) == {"exact"}, "the exact mode ran another E-step")
    launches = launch_counts()
    for name, k in launches.items():
        check(k > 0, f"the CPD registrations did not launch {name}")

    n_small = sizes["cpd_cpu"]
    small_b = (rng.random((n_small, 3)) * 10).astype(np.float32)
    r_small = get_random_rotation_matrix(rng, 0.1)
    t_small = get_random_translation_vector(rng, 0.5)
    small_a = (small_b @ r_small.T + t_small).astype(np.float32)[rng.permutation(n_small)]
    for mode in (ApproximationType.NONE, ApproximationType.Hybrid):
        kw = dict(weight=0.1, max_iterations=100, tolerance=1e-4, approximation_type=mode,
                  use_fgt=False, use_kernels=True)
        t0 = time.perf_counter()
        on_cpu = cpd.cpd_register(pad_cloud(small_b, device="cpu"),
                                  pad_cloud(small_a, device="cpu"), **kw)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_card = cpd.cpd_register(pad_cloud(small_b, device=dev),
                                   pad_cloud(small_a, device=dev), **kw)
        card_s = time.perf_counter() - t0
        d_rot = float((on_cpu.transform.rotation - on_card.transform.rotation.cpu()).abs().max())
        d_t = float((on_cpu.transform.translation
                     - on_card.transform.translation.cpu()).abs().max())
        rc = on_card.transform.rotation.cpu().numpy().astype(np.float64)
        ang = float(np.degrees(np.arccos(np.clip(
            (np.trace(rc.T @ r_small.astype(np.float64)) - 1) / 2, -1.0, 1.0))))
        log(f"[cpd] {n_small} points, {mode.value}: CPU (plain) vs card (K4/K5) iterations "
            f"{on_cpu.iterations} / {on_card.iterations}, |dR| {d_rot}, |dt| {d_t}, "
            f"rotation off by {ang} deg, {cpu_s:.1f} s / {card_s:.3f} s")
        check(on_cpu.iterations == on_card.iterations, f"CPD iterations differ ({mode.value})")
        check(d_rot <= 1e-4 and d_t <= 1e-4, f"CPD CPU and card disagree ({mode.value})")
        check(ang < 1.0, f"CPD rotation {ang} deg from the truth ({mode.value})")

    # 11. E-step rows at 376k -----------------------------------------------------
    n = sizes["cpd_large"]
    mov, tgt = box(n), box(n)
    m1 = torch.ones(n, device=dev)
    s2 = cpd.sigma_squared_init(mov, m1, tgt, m1)
    cnt = torch.sum(m1)
    w = f32(0.1)[0]
    exact_ms = time_ms(lambda: cpd_dense.cpd_estep_dense(mov, m1, tgt, m1, s2, 0.3, False), 3)
    cy, iy, oy = fgt.k_center_ordered(mov, m1, 128)
    cx, ix, ox = fgt.k_center_ordered(tgt, m1, 128)
    clusters = (cy, iy, cx, ix)

    def fgt_cached():
        return cpd.cpd_estep_fgt(mov, m1, tgt, m1, s2, w, cnt, cnt, 128, 8, 10.0,
                                 sigma2_init=s2, clusters=clusters, orders=(oy, ox))

    # the segment sums add in an order the data fixes: equal bits in two runs
    first, second = fgt_cached(), fgt_cached()
    torch.cuda.synchronize()
    differing = sum(int((getattr(first, f) != getattr(second, f)).sum()) for f in stats)
    log(f"[estep] two FGT E-steps at {n}^2 on the same inputs: elements differing "
        f"{differing} of {sum(getattr(first, f).numel() for f in stats)} (must be 0)")
    check(differing == 0, "two FGT E-steps on the same inputs differ")
    fgt_cached_ms = time_ms(fgt_cached, 5)
    fgt_ms = time_ms(lambda: cpd.cpd_estep_fgt(
        mov, m1, tgt, m1, s2, w, cnt, cnt, 128, 8, 10.0, sigma2_init=s2), 3)
    hs = torch.sqrt(2.0 * s2)
    model = fgt.compute_fgt_model_multi(tgt, torch.ones(n, 4, device=dev), m1, hs, 128, 8,
                                        clustering=clusters[2:])
    chunks = {c: time_ms(lambda c=c: fgt.fgt_predict_multi(mov, model, hs, 10.0, 8, chunk=c), 3)
              for c in (2048, fgt.predict_chunk(dev, 128, 8), 16384)}
    log(f"[estep] {n}^2 on {smi}: exact K4 E-step {exact_ms:.3f} ms; FGT E-step "
        f"{fgt_cached_ms:.3f} ms with the loop's cached clusterings, {fgt_ms:.3f} ms with "
        f"its own; FGT predict (W=4) by chunk {chunks} ms")

    # bounds of the timed work: K4's passes at cpd_small^2, K5's on the
    # pairs its tables visit in the cluster case
    k4_pairs = float(sizes["cpd_small"]) ** 2
    n_c = float(sizes["cpd_small"])
    io = 2 * n_c * 12 + 16
    bounds = {
        "K4 denom": bound_of(FLOPS_DENOM * k4_pairs, io + n_c * 4, k4_pairs),
        "K4 moments": bound_of(FLOPS_MOMENTS * k4_pairs, io + n_c * 16 + n_c * 16, k4_pairs),
        "K5 denom": bound_of(FLOPS_DENOM * k5_denom_pairs,
                             io + n_c * 4 + cand_m.numel() * 4, k5_denom_pairs),
        "K5 moments": bound_of(FLOPS_MOMENTS * k5_moments_pairs,
                               io + n_c * 32 + cand_n.numel() * 4, k5_moments_pairs),
    }
    log(f"[bounds] K4 at {sizes['cpd_small']}^2, K5 on the cluster case ({k5_denom_pairs:.4g} / "
        f"{k5_moments_pairs:.4g} visited pairs): {bounds}")
    return [
        {"name": "cpd_denom (K4)", "route": "cuda", "source": "tpuslam_torch/csrc/cpd_dense.cu",
         "replaces": "tpuslam/kernels/pallas_cpd.py:209", "launches": launches["K4 denom"],
         "max_abs_err": main_errs["K4 denom"], "ms": times["denom"], "plain_ms": times["denom_plain"],
         **bounds["K4 denom"], "library_ms": None},
        {"name": "cpd_moments (K4)", "route": "cuda", "source": "tpuslam_torch/csrc/cpd_dense.cu",
         "replaces": "tpuslam/kernels/pallas_cpd.py:241", "launches": launches["K4 moments"],
         "max_abs_err": main_errs["K4 moments"], "ms": times["moments"], "plain_ms": times["moments_plain"],
         **bounds["K4 moments"], "library_ms": None},
        {"name": "cpd_denom_cand (K5)", "route": "cuda", "source": "tpuslam_torch/csrc/cpd_cand.cu",
         "replaces": "tpuslam/kernels/pallas_cpd_cand.py:181", "launches": launches["K5 denom"],
         "max_abs_err": main_errs["K5 denom"], "ms": k5_times["denom"],
         "plain_ms": k5_times["denom_plain"], **bounds["K5 denom"], "library_ms": None},
        {"name": "cpd_moments_cand (K5)", "route": "cuda",
         "source": "tpuslam_torch/csrc/cpd_cand.cu",
         "replaces": "tpuslam/kernels/pallas_cpd_cand.py:181", "launches": launches["K5 moments"],
         "max_abs_err": main_errs["K5 moments"], "ms": k5_times["moments"],
         "plain_ms": k5_times["moments_plain"], **bounds["K5 moments"], "library_ms": None},
    ]


def cylinder(rng, n):
    """A near-degenerate spectrum: a cylinder about z (radius 1, height 4)
    and three thin ridges at {0, 90, 210} degrees on mixed halves
    (``tests/test_nicp.py::degenerate_cylinder``; its (l2, l3) gap is
    under NICP's 5 % threshold, and the ridges fix the in-plane angle)."""
    theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    z = rng.uniform(-2, 2, n).astype(np.float32)
    pts = [np.stack([np.cos(theta), np.sin(theta), z], axis=1).astype(np.float32)]
    nr = max(n // 33, 1)
    for ang, (zlo, zhi) in ((0.0, (0.5, 2)), (90.0, (-2, -0.5)), (210.0, (0.5, 2))):
        a = np.radians(ang)
        pts.append(np.stack([
            np.full(nr, 1.35 * np.cos(a), np.float32) + rng.normal(0, 0.01, nr).astype(np.float32),
            np.full(nr, 1.35 * np.sin(a), np.float32) + rng.normal(0, 0.01, nr).astype(np.float32),
            rng.uniform(zlo, zhi, nr).astype(np.float32),
        ], axis=1))
    return np.concatenate(pts)


def rotation_error_deg(rot, r_true) -> float:
    cos = (np.trace(np.asarray(rot, np.float64).T @ np.asarray(r_true, np.float64)) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def nicp_batch_phases(dev, smi, kind, sizes, time_ms) -> dict:
    """Phases 12-14 (module docstring); returns K1's NICP and batch numbers
    for the kernels line."""
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import batch
    from tpuslam_torch.algorithms.icp import icp_register
    from tpuslam_torch.algorithms.nicp import nicp_register
    from tpuslam_torch.config.configuration import ComputationMethod
    from tpuslam_torch.core.types import Cloud, pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.kernels import bound, nn_cand, nn_dense
    from tpuslam_torch.ops import nn_hier

    rng = np.random.Generator(np.random.PCG64(1207))
    wrappers = {"K1": nn_dense, "K2": bound, "K3": nn_cand}
    nicp_method = ComputationMethod.NoniterativeIcp

    def reset():
        for w in wrappers.values():
            w.LAUNCHES = 0
            w.BATCH_LAUNCHES.clear()

    def launches():
        return {k: w.LAUNCHES for k, w in wrappers.items()}

    def moved(before, angle, trans):
        r = get_random_rotation_matrix(rng, angle)
        t = get_random_translation_vector(rng, trans)
        return (before @ r.T + t).astype(np.float32)[rng.permutation(len(before))], r, t

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # 12. NICP ------------------------------------------------------------------
    n = sizes["nicp_large"]
    # K1 at NICP's rescore shape: 8 candidates x 1,024 subcloud rows against
    # the whole target
    src = torch.from_numpy((rng.random((1, 8 * 1024, 3)) * 10).astype(np.float32)).to(dev)
    tgt = torch.from_numpy((rng.random((1, n, 3)) * 10).astype(np.float32)).to(dev)
    cnt = torch.tensor([n], dtype=torch.int32, device=dev)
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, cnt)
    r_idx, r_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, cnt, chunk=256)
    torch.cuda.synchronize()
    bad = int((idx != r_idx).sum() + (dist != r_dist).sum())
    k1_err = float((dist.double() - r_dist.double()).abs().max())
    geo = nn_dense.dense_geometry(1, src.shape[1], n)
    k1_rescore = {"ms": time_ms(lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, cnt), 20),
                  "plain_ms": time_ms(lambda: nn_dense.nearest_neighbors_dense_ref(
                      src, tgt, cnt, chunk=256), 2),
                  **bound_of(FLOPS_NN * float(src.shape[1]) * n, src.shape[1] * 20 + n * 12)}
    log(f"[nicp] K1 at the rescore shape {tuple(src.shape)} x {tuple(tgt.shape)} "
        f"({geo.rows_per_thread} sources a thread, {geo.splits} splits): mismatches against "
        f"plain {bad} (tolerance 0), max_abs_err {k1_err}; on {smi}: K1 "
        f"{k1_rescore['ms']:.4f} ms, plain {k1_rescore['plain_ms']:.3f} ms, bound "
        f"{k1_rescore['bound_ms']:.4f} ms")
    check(bad == 0, "K1 differs from plain at NICP's rescore shape")
    del src, tgt, idx, dist, r_idx, r_dist

    nicp_runs = {}
    # the main path: register(NICP) on an anisotropic box, (2.0 rad, 30)
    before = (rng.random((n, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    after, r_true, t_true = moved(before, 2.0, 30.0)
    # an untimed call first: the first eigh, sort and solve of a process
    # load their CUDA libraries
    tpuslam_torch.register(before, after, device=dev, computation_method=nicp_method,
                           random_seed=1)
    reset()
    (rot, trans, iters, err), ms = wall(lambda: tpuslam_torch.register(
        before, after, device=dev, computation_method=nicp_method, random_seed=1))
    got = launches()
    ang = rotation_error_deg(rot, r_true)
    nicp_runs["anisotropic"] = {"n": n, "ms": ms, "candidates": iters, "K1": got["K1"],
                                "angle_deg": ang}
    log(f"[nicp] register NICP on a {n}-point anisotropic box [0,40]x[0,20]x[0,10] moved by "
        f"(2.0 rad, 30) on {kind} ({smi}): {iters} candidates scored, error {err}, rotation "
        f"off by {ang} deg, translation off by {float(np.abs(trans - t_true).max())}, "
        f"{ms:.3f} ms (host arrays in, transfer and pre-pass included), launches {got}")
    check(got["K1"] > 0, "the NICP registration did not launch K1")
    check(bool(np.isfinite(rot).all() and np.isfinite(err)), "non-finite NICP result")
    check(ang < 1.0, f"NICP rotation {ang} deg from the truth")

    # the JAX record's row (tools/bench_report.py:134-144): nicp_register
    # on a uniform box of side 10, subcloud 1000, seed 1, 3 timed calls
    # after a warm-up
    box = (rng.random((n, 3)) * 10.0).astype(np.float32)
    box_after, r_box, _ = moved(box, 0.2, 10.0)
    cb, ca = pad_cloud(box, device=dev), pad_cloud(box_after, device=dev)
    nicp_register(cb, ca, subcloud_size=1000, seed=1)
    reset()
    direct = []
    for _ in range(3):
        res, ms = wall(lambda: nicp_register(cb, ca, subcloud_size=1000, seed=1))
        direct.append(ms)
    nicp_runs["box_direct"] = {"n": n, "ms": direct, "candidates": res.iterations,
                               "K1": launches()["K1"] / 3}
    log(f"[nicp] nicp_register direct on a {n}-point uniform box of side 10 (the JAX "
        f"record's row), subcloud 1000, seed 1, on {smi}: {direct} ms per run, "
        f"{res.iterations} candidates, K1 launches per run {launches()['K1'] / 3}, rotation "
        f"off by {rotation_error_deg(res.transform.rotation.cpu().numpy(), r_box)} deg (a "
        f"cube's axes are arbitrary: not checked)")
    # the same box through register: the eigengap pre-pass widens it
    reset()
    (rot, _, iters, _), ms = wall(lambda: tpuslam_torch.register(
        box, box_after, device=dev, computation_method=nicp_method, random_seed=1))
    nicp_runs["box_register"] = {"n": n, "ms": ms, "candidates": iters, "K1": launches()["K1"],
                                 "angle_deg": rotation_error_deg(rot, r_box)}
    log(f"[nicp] register NICP on the same box: {iters} candidates scored (widened), "
        f"{ms:.3f} ms, K1 launches {launches()['K1']}, rotation off by "
        f"{nicp_runs['box_register']['angle_deg']} deg (not checked)")
    del cb, ca

    # a degenerate cylinder: two disjoint samples, 70 degrees about its axis
    nc = sizes["nicp_cylinder"]
    allp = cylinder(rng, 2 * nc)
    perm = rng.permutation(len(allp))
    c_before = allp[perm[:nc]]
    c, s = np.cos(np.radians(70.0)), np.sin(np.radians(70.0))
    r_cyl = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    c_after = (allp[perm[nc:2 * nc]] @ r_cyl.T + np.array([0.5, -1.0, 2.0], np.float32)
               ).astype(np.float32)
    reset()
    (rot, _, iters, _), ms = wall(lambda: tpuslam_torch.register(
        c_before, c_after, device=dev, computation_method=nicp_method, random_seed=1,
        nicp_subcloud_size=2000))
    ang = rotation_error_deg(rot, r_cyl)
    nicp_runs["cylinder"] = {"n": nc, "ms": ms, "candidates": iters, "K1": launches()["K1"],
                             "angle_deg": ang}
    log(f"[nicp] register NICP on a degenerate cylinder of {nc} points a side, 70 deg about "
        f"its axis: {iters} candidates scored, rotation off by {ang} deg, {ms:.3f} ms, "
        f"K1 launches {launches()['K1']}")
    check(iters == 4 * 16, "the cylinder was not widened")
    check(ang < 1.0, f"widened NICP rotation {ang} deg from the truth")

    # 13. prealigned ICP ---------------------------------------------------------
    n = sizes["prealign"]
    before = (rng.random((n, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    after, r_true, _ = moved(before, 2.0, 30.0)
    # noise of 0.01 keeps ICP iterating from the NICP seed (an exact copy
    # converges at its first, cold query), so its warm queries run K3
    after = (after + rng.normal(0, 0.01, after.shape)).astype(np.float32)
    kw = dict(device=dev, max_iterations=60, max_distance_squared=1e9,
              convergence_epsilon=1e-6, random_seed=1)
    reset()
    nn_hier.ARM_TRACE.clear()
    (rot, _, iters, err), ms = wall(lambda: tpuslam_torch.register(
        before, after, icp_prealign=True, **kw))
    got = launches()
    arms = "".join(a[0] for a in nn_hier.ARM_TRACE)
    ang = rotation_error_deg(rot, r_true)
    (c_rot, _, c_iters, c_err), c_ms = wall(lambda: tpuslam_torch.register(before, after, **kw))
    prealign = {"n": n, "ms": ms, "iterations": iters, "angle_deg": ang, "launches": got,
                "cold": {"ms": c_ms, "iterations": c_iters,
                         "angle_deg": rotation_error_deg(c_rot, r_true)}}
    log(f"[prealign] register ICP with icp_prealign on a {n}-point anisotropic box moved by "
        f"(2.0 rad, 30), noise 0.01, on {smi}: {iters} iterations, error {err}, rotation "
        f"off by {ang} deg, "
        f"{ms:.3f} ms, launches {got}, arms {arms}; cold ICP on the same pair: {c_iters} "
        f"iterations, error {c_err}, rotation off by {prealign['cold']['angle_deg']} deg, "
        f"{c_ms:.3f} ms (not checked)")
    check(got["K1"] > 0 and got["K2"] > 0 and got["K3"] > 0,
          "prealigned ICP did not launch K1 (NICP shot), K2 and K3 (hierarchical loop)")
    check(ang < 1.0, f"prealigned ICP rotation {ang} deg from the truth")

    # 14. batching ------------------------------------------------------------------
    b = sizes["batch_pairs"]
    reg = dict(max_iterations=50, convergence_epsilon=1e-5, max_distance_squared=1e4)

    def box_pairs(n, angle=0.2, trans=1.0, scale=(10.0, 5.0, 2.5)):
        pairs = [(rng.random((n, 3)) * np.array(scale)).astype(np.float32) for _ in range(b)]
        moved_ = [moved(p, angle, trans) for p in pairs]
        return pairs, [m[0] for m in moved_], [m[1] for m in moved_]

    def against_solo(name, got, solos):
        """Each pair of a batched run against its solo run, bit for bit:
        the batched step sums each pair's rows by the solo call."""
        d_rot = max(float(np.abs(got[0][i] - s[0]).max()) for i, s in enumerate(solos))
        d_t = max(float(np.abs(got[1][i] - s[1]).max()) for i, s in enumerate(solos))
        same_it = all(int(got[2][i]) == int(s[2]) for i, s in enumerate(solos))
        log(f"[batch] {name}: against the solo runs max |dR| {d_rot}, |dt| {d_t}, "
            f"iterations {list(map(int, got[2]))} equal {same_it} (tolerance 0)")
        check(same_it and d_rot == 0 and d_t == 0, f"{name}: a pair differs from solo")
        return d_rot, d_t

    small = sizes["batch_small"]
    befores, afters, _ = box_pairs(small)
    reset()
    got = tpuslam_torch.register_pairs(befores, afters, device=dev, **reg)
    batch_launch = {k: dict(w.BATCH_LAUNCHES) for k, w in wrappers.items()}
    log(f"[batch] register_pairs ICP on {b} x {small} (vmapped dense lowering): launches by "
        f"batch size {batch_launch}")
    check(nn_dense.BATCH_LAUNCHES[b] > 0, f"K1's batch form did not launch with B = {b}")
    solos = [tpuslam_torch.register(x, y, device=dev, **reg) for x, y in zip(befores, afters)]
    batch_err = {"ICP dense": against_solo(f"ICP {b} x {small}", got, solos)}

    large = sizes["batch_large"]
    l_befores, l_afters, _ = box_pairs(large)
    bb, ba = batch.stack_clouds(l_befores, device=dev), batch.stack_clouds(l_afters, device=dev)
    got = tpuslam_torch.register_pairs(l_befores, l_afters, device=dev, **reg)
    log(f"[batch] register_pairs ICP on {b} x {large} (auto: unrolled): iterations "
        f"{got[2].tolist()}")
    icp_kw = dict(eps=reg["convergence_epsilon"], max_distance_squared=reg["max_distance_squared"],
                  max_iterations=reg["max_iterations"])
    reset()
    forced = batch.icp_register_batch(bb, ba, unroll=False, use_spatial=True, **icp_kw)
    batch_launch = {k: dict(w.BATCH_LAUNCHES) for k, w in wrappers.items()}
    log(f"[batch] {b} x {large} forced unroll=False, use_spatial=True: launches by batch "
        f"size {batch_launch}")
    check(bound.BATCH_LAUNCHES[b] > 0 and nn_cand.BATCH_LAUNCHES[b] > 0,
          f"K2's and K3's batch forms did not launch with B = {b}")
    solos = []
    for p in range(b):
        s_ = icp_register(Cloud(bb.points[p], bb.count[p]), Cloud(ba.points[p], ba.count[p]),
                          use_spatial=True, **icp_kw)
        solos.append((s_.transform.rotation.cpu().numpy(),
                      s_.transform.translation.cpu().numpy(), s_.iterations))
    batch_err["ICP hier"] = against_solo(
        f"ICP {b} x {large} batched hierarchical",
        (forced.transform.rotation.cpu().numpy(), forced.transform.translation.cpu().numpy(),
         forced.iterations.cpu().numpy()), solos)

    # ms per call and per pair-iteration of each lowering: 20 iterations a
    # pair (eps 0, no guard), one warm-up call, then two timed calls
    lowering_ms = {}
    for n_pts, (xb, xa) in ((small, (befores, afters)), (large, (l_befores, l_afters))):
        sb, sa = batch.stack_clouds(xb, device=dev), batch.stack_clouds(xa, device=dev)
        for unroll in (False, True):
            for arm in (False, True):
                def call(unroll=unroll, arm=arm):
                    return batch.icp_register_batch(
                        sb, sa, eps=0.0, max_distance_squared=1e18, max_iterations=20,
                        divergence_guard=False, unroll=unroll, use_spatial=arm)
                call()
                runs = [wall(call) for _ in range(2)]
                pair_iters = int(runs[0][0].iterations.sum())
                name = (f"{b}x{n_pts} {'unrolled' if unroll else 'batched'} "
                        f"{'hier' if arm else 'dense'}")
                lowering_ms[name] = {"ms": [r[1] for r in runs],
                                     "ms_per_pair_iter": [r[1] / pair_iters for r in runs]}
    log(f"[batch] ICP lowerings on {smi}, {b} pairs x 20 iterations: " + json.dumps(lowering_ms))

    # NICP on anisotropic pairs
    n_befores, n_afters, n_truths = box_pairs(large, 2.0, 30.0, (40.0, 20.0, 10.0))
    reset()
    (rots, _, iters, _), ms = wall(lambda: tpuslam_torch.register_pairs(
        n_befores, n_afters, device=dev, computation_method=nicp_method, random_seed=1))
    angs = [rotation_error_deg(rots[i], n_truths[i]) for i in range(b)]
    log(f"[batch] register_pairs NICP on {b} x {large} anisotropic pairs: {ms:.3f} ms, "
        f"candidates {iters.tolist()}, K1 launches by batch size {dict(nn_dense.BATCH_LAUNCHES)}, "
        f"worst rotation error {max(angs)} deg")
    check(max(angs) < 1.0, "a batched NICP pair is more than 1 deg from its truth")

    # CPD, pair by pair
    cb_ = sizes["cpd_batch"]
    c_befores, c_afters, _ = box_pairs(cb_, 0.1, 0.5)
    c_befores, c_afters = c_befores[:4], c_afters[:4]
    cpd = dict(computation_method=ComputationMethod.Cpd, max_iterations=10, cpd_weight=0.1,
               cpd_const_scale=True)
    got, ms = wall(lambda: tpuslam_torch.register_pairs(c_befores, c_afters, device=dev, **cpd))
    solos = [tpuslam_torch.register(x, y, device=dev, **cpd) for x, y in zip(c_befores, c_afters)]
    same = all(np.array_equal(got[0][i], s_[0]) and np.array_equal(got[1][i], s_[1])
               and int(got[2][i]) == s_[2] for i, s_ in enumerate(solos))
    log(f"[batch] register_pairs CPD on 4 x {cb_}, 10 iterations: {ms:.3f} ms, each pair "
        f"equal to its solo run {same} (tolerance 0)")
    check(same, "a batched CPD pair differs from its solo run")
    return {"nicp_runs": nicp_runs, "k1_rescore": k1_rescore, "k1_rescore_err": k1_err,
            "prealign": prealign, "lowering_ms": lowering_ms, "batch_err": batch_err}


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
    from tpuslam_torch.harness.ab_kernels import graph_ms
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
    def compare(name, src, tgt, count, contract=False):
        """K1 against its plain version, bit for bit; with ``contract``
        (NaN or inf rows) against the plain version read under K1's
        contract (``plain_under_contract``: argmin would take a NaN)."""
        idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
        plain = (nn_dense.plain_under_contract if contract
                 else nn_dense.nearest_neighbors_dense_ref)
        ref_idx, ref_dist = plain(src, tgt, count)
        torch.cuda.synchronize()
        bad_idx = int((idx != ref_idx).sum())
        bad_dist = int((dist != ref_dist).sum())
        err = float((dist.double() - ref_dist.double()).abs().max())
        geo = nn_dense.dense_geometry(src.shape[0], src.shape[1], tgt.shape[1])
        log(f"[k1] {name}: {tuple(src.shape)} x {tuple(tgt.shape)}, "
            f"{geo.rows_per_thread} sources a thread, {geo.splits} splits, "
            f"idx mismatches {bad_idx}, dist mismatches {bad_dist}, "
            f"max_abs_err {err} (tolerance 0: bit-identical)")
        check(bad_idx == 0 and bad_dist == 0, f"K1 differs from plain ({name})")
        return idx, dist, err

    n_head = sizes["headline"]
    cb, ca = build_headline_pair(n_head, device=dev)
    src, tgt, count = cb.points[None], ca.points[None], ca.count.reshape(1)
    errs = [compare(f"headline {n_head}", src, tgt, count)[2]]
    # counts that end inside a split, a stage and a segment
    for c in (n_head * 3 // 4 + 1, n_head // 2 + 1):
        ragged = torch.tensor([c], dtype=torch.int32, device=dev)
        errs.append(compare(f"ragged count {c}", src, tgt, ragged)[2])
    none = torch.zeros(1, dtype=torch.int32, device=dev)
    idx0, dist0, err = compare("count 0", src, tgt, none)
    errs.append(err)
    check(bool((idx0 == 0).all()) and bool((dist0 == nn_dense.BIG).all()),
          "count 0 must give (0, 3.4e38)")
    rng = np.random.Generator(np.random.PCG64(11))
    lattice = (rng.integers(-40, 40, size=(8192, 3)) * 4).astype(np.float32)
    # three copies 8,192 rows apart: equal targets in different splits
    ties = np.concatenate([lattice + [1, 0, 0], lattice - [1, 0, 0],
                           lattice + [1, 0, 0]]).astype(np.float32)
    t_src = torch.from_numpy(lattice)[None].to(dev)
    t_tgt = torch.from_numpy(ties)[None].to(dev)
    t_count = torch.tensor([len(ties)], dtype=torch.int32, device=dev)
    idx_t, dist_t, err = compare("planted ties across splits", t_src, t_tgt, t_count)
    errs.append(err)
    check(bool((dist_t == 1.0).all()) and bool((idx_t < 8192).all()),
          "planted ties: the first index must win")
    b_src = torch.from_numpy((rng.random((2, 8192, 3)) * 10).astype(np.float32))
    b_tgt = torch.from_numpy((rng.random((2, 10000, 3)) * 10).astype(np.float32))
    b_count = torch.tensor([10000, 6000], dtype=torch.int32)
    errs.append(compare("batch of 2", b_src.to(dev), b_tgt.to(dev),
                        b_count.to(dev))[2])
    n_small = sizes["small"]
    s_src = torch.from_numpy((rng.random((1, n_small, 3)) * 10).astype(np.float32)).to(dev)
    s_tgt = torch.from_numpy((rng.random((1, n_small, 3)) * 10).astype(np.float32)).to(dev)
    s_count = torch.tensor([n_small], dtype=torch.int32, device=dev)
    errs.append(compare(f"{n_small}^2", s_src, s_tgt, s_count)[2])
    q_src = torch.from_numpy((rng.random((16, 2048, 3)) * 10).astype(np.float32)).to(dev)
    q_tgt = torch.from_numpy((rng.random((16, 2048, 3)) * 10).astype(np.float32)).to(dev)
    q_count = torch.tensor([2048, 2047, 1500, 1, 0, 33, 257, 1024, 2000, 999, 2048, 7, 1800,
                            31, 32, 1283], dtype=torch.int32, device=dev)
    errs.append(compare("16 x 2048, ragged counts", q_src, q_tgt, q_count)[2])
    # NaN and inf sources; inf and NaN targets inside the count, NaN past it
    nan_src = (rng.random((4096, 3)) * 10).astype(np.float32)
    nan_src[3], nan_src[7, 1], nan_src[11], nan_src[13, 2] = np.nan, np.nan, np.inf, -np.inf
    nan_src[17] = 1e30  # every distance overflows to +inf
    nan_tgt = (rng.random((8192, 3)) * 10).astype(np.float32)
    nan_tgt[5], nan_tgt[9, 0], nan_tgt[4000:4040], nan_tgt[8000:] = np.inf, np.nan, np.nan, np.nan
    n_idx, n_dist, _ = compare(
        "NaN and inf rows", torch.from_numpy(nan_src)[None].to(dev),
        torch.from_numpy(nan_tgt)[None].to(dev),
        torch.tensor([8000], dtype=torch.int32, device=dev), contract=True)
    check(bool((n_idx[0, [3, 7, 11, 13, 17]] == 0).all())
          and bool((n_dist[0, [3, 7, 11, 13, 17]] == nn_dense.BIG).all()),
          "NaN and inf sources must give (0, 3.4e38)")

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
    # the small grids the target splits are for
    k1_small_ms = {}
    for name, args in ((f"{n_small}^2", (s_src, s_tgt, s_count)),
                       ("16 x 2048^2", (q_src, q_tgt, q_count.clone().fill_(2048)))):
        b_, n_, _ = args[0].shape
        ms = graph_ms(torch, lambda a=args: nn_dense.nearest_neighbors_dense_batch(*a), 50)
        k1_small_ms[name] = ms
        log(f"[k1] time at {name} on {smi}: K1 {ms:.4f} ms; bound "
            f"{bound_of(FLOPS_NN * float(b_ * n_) * args[1].shape[1], b_ * n_ * 32)}")
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
    k2_bound = bound_of(FLOPS_BOUND * float(n_src) * (m // g),
                        n_src * (24 + 16) + (m // g) * (24 + 4) + 8
                        + (n_src // gsrc) * (m // g))
    log(f"[k2] time at {n_src} sources x {m // g} tiles on {smi}: K2 "
        f"{k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms; bound {k2_bound}")

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
    # the pairs this table needs: each group's live rows x its sources
    k3_pairs = float(cnt.sum()) * g * gsrc
    k3_bound = bound_of(FLOPS_NN * k3_pairs, n_src * (12 + 8) + m * 16 + cand.numel() * 4
                        + cnt.numel() * 4)
    k3_ms = time_ms(lambda: nn_cand.nearest_neighbors_cand(
        pos, target.packed, cand, cnt, g=g, gsrc=gsrc), 20)
    k3_plain_ms = time_ms(lambda: nn_cand.nearest_neighbors_cand_ref(
        pos[None], target.packed[None], cand[None], cnt[None], g, gsrc), 3)
    hier_ms = time_ms(lambda: nn_hier.nearest_neighbors_hier(
        pos, setup.src_mask, target, mid.nn, l_budget=l_budget, g=g, gsrc=gsrc), 20)
    log(f"[k3] time on the fine table on {smi}: K3 {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.3f} ms ({k3_pairs:.4g} pairs, {k3_pairs / k3_ms / 1e9:.4g}e12 "
        f"pairs/s; bound {k3_bound}); whole hierarchical search {hier_ms:.4f} ms "
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
    h_cpu = icp_register(pad_cloud(small_before, device="cpu"),
                         pad_cloud(small_after, device="cpu"), **kw)
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
    # K2 against its plain version at this warm state, every true tile
    # admitted; then K2's and K3's times there (K3 on the fine table)
    bt = big_setup.target
    bm, bg, bgsrc = bt.packed.shape[0], big_setup.g, big_setup.gsrc
    ops = nn_hier.bound_operands(pos, big_setup.src_mask, bt, big.nn)
    b_args = (ops[0], ops[1], bt.caug, bt.radii, ops[2], big.nn.warm)
    adm = bound.bound_pass(*b_args, bgsrc)
    ref = bound.bound_pass_ref(*[a[None] for a in b_args], bgsrc)[0]
    b_tile = torch.empty(bm, dtype=torch.long, device=dev)
    b_real = bt.packed[:, 3] < 1e30
    b_tile[bt.packed[b_real, 3].long()] = torch.arange(bm, device=dev)[b_real] // bg
    b_group = torch.arange(pos.shape[0], device=dev) // bgsrc
    missed = int((~adm[b_group[big_valid], b_tile[k1_idx.long()][big_valid]]).sum())
    torch.cuda.synchronize()
    bad = int((adm != ref).sum())
    counts = adm.sum(1, dtype=torch.int32)
    log(f"[large] K2 at the warm state: adm {tuple(adm.shape)}, admitted per group mean "
        f"{float(counts.float().mean()):.1f} max {int(counts.max())}, mismatches against "
        f"plain {bad} (tolerance 0), true tiles not admitted {missed} (must be 0)")
    check(bad == 0, "large: K2 differs from plain")
    check(missed == 0, "large: K2 admission misses a true tile")
    k2_errs.append(float(bad > 0))
    l_eff = min(big_setup.l_budget, bm // bg)
    b_cand = nn_hier._build_cand_table(adm, counts, nn_hier.table_width(bm, bg, big_setup.l_budget))
    b_cnt = torch.clamp_max(counts, l_eff)
    large_ms = {
        "K2": time_ms(lambda: bound.bound_pass(*b_args, bgsrc), 10),
        "K3": time_ms(lambda: nn_cand.nearest_neighbors_cand(
            pos, bt.packed, b_cand, b_cnt, g=bg, gsrc=bgsrc), 10),
    }
    b_pairs = float(b_cnt.sum()) * bg * bgsrc
    log(f"[large] times at the warm state on {smi}: K2 {large_ms['K2']:.4f} ms "
        f"({pos.shape[0]} sources x {bm // bg} tiles), K3 {large_ms['K3']:.4f} ms on the fine "
        f"table (g {bg}, live slots mean {float(b_cnt.float().mean()):.1f}, {b_pairs:.4g} pairs, "
        f"{b_pairs / large_ms['K3'] / 1e9:.4g}e12 pairs/s)")
    del lb, la, big, big_setup, bt, pos, h_idx, h_dist, k1_idx, k1_dist, ops, b_args, adm, ref

    # 7. headline -----------------------------------------------------------------
    heads = {}
    for name, n_pts, arm in (("hier", n_head, None), ("dense", n_head, False),
                             ("hier_8192", sizes["small"], True),
                             ("dense_8192", sizes["small"], False)):
        nn_hier.ARM_TRACE.clear()
        before = (nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES)
        h = measure_icp_100k(n_points=n_pts, device=dev, use_spatial=arm)
        h["nvidia_smi"] = smi
        # the warm-up call and the timed ones, each of iters_per_call
        calls = h["reps"] + 1
        h["launches_per_call"] = {
            k: (after - b) / calls for k, after, b in zip(
                ("K1", "K2", "K3"), (nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES),
                before)}
        arms = list(nn_hier.ARM_TRACE)
        if arms:
            h["arms"] = {a: arms.count(a) for a in ("fine", "coarse", "dense")}
        heads[name] = h
        log(f"[headline] {name}: {json.dumps(h)}")
        check(h["iterations_run"] == h["iters_per_call"],
              f"the headline run stopped early ({name})")
    check(heads["hier"]["nn_arm"] == "hier", "the default headline is not hier")
    per_call = heads["hier"]["launches_per_call"]
    check(per_call["K2"] > 0 and per_call["K3"] > 0, "the hier headline did not launch K2, K3")
    iters = heads["hier"]["iterations_run"]
    per_iter = {k: v / iters for k, v in per_call.items()}
    k1_bound = bound_of(FLOPS_NN * float(n_head) * n_head, n_head * (12 + 12 + 8))

    cpd_kernels = cpd_phases(dev, smi, kind, sizes, time_ms)
    slice7 = nicp_batch_phases(dev, smi, kind, sizes, time_ms)
    log(f"[nicp] summary: {json.dumps(slice7)}")

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
            **k1_bound,
            "ms_small_grids": k1_small_ms,
            "library_ms": None,
            "launches_per_iter": per_iter["K1"],
            "launches_per_nicp_run": {k: v["K1"] for k, v in slice7["nicp_runs"].items()},
            "ms_nicp_rescore": slice7["k1_rescore"]["ms"],
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
            **k2_bound,
            "library_ms": None,
            "launches_per_iter": per_iter["K2"],
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
            **k3_bound,
            "library_ms": None,
            "launches_per_iter": per_iter["K3"],
        },
        *cpd_kernels,
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
