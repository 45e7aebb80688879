#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpuslam_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed as it ends; the first failure raises and the script
exits non-zero without printing a result:

1. device — the card's name and power limit (nvidia-smi) and torch's view;
2. build — kernels K1 (``csrc/nn_dense.cu``), K2 (``csrc/bound.cu``),
   K3 (``csrc/nn_cand.cu``), K4 (``csrc/cpd_dense.cu``), K5
   (``csrc/cpd_cand.cu``, its plan ``csrc/cpd_plan.cu``), P
   (``csrc/procrustes.cu``) and the FGT's K6 and K7 (``csrc/fgt.cu``) from source, one
   nvcc per source, started together; ptxas's registers and spills per
   kernel;
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
   moved by (0.1 rad, 0.5), which takes the hierarchical arm; K1, K2, K3
   and P must each have been launched, the launches the wrappers counted
   (the replayed CUDA graph's booked from the device) equal to those the
   kernels counted on the device (``kernels.tally``), K3 must have done
   work (a launch that was not skipped as an unselected arm), the error
   finite and the rotation within 1 degree of the truth; the iterations
   on each arm; then one
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
   launches of K1, K2, K3 and P per headline call on each arm, and those
   of K1 and K3 that were skipped as unselected arms;
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
   fractions and each time's bound on the pairs it visits; then K5's
   plan kernel (``csrc/cpd_plan.cu``: admission, tables, fat subsets)
   against its plain version, the torch composition, every output bit
   for bit at 4,096, 20,480, 102,400 and 376,401 rows, with its device
   time and the composition's, each in a CUDA graph, and its bound
   (``ab_kernels.plan_rows``);
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
   must be bit-equal (the sums add in a fixed order); exact K4 against the
   FGT E-step (with and without the loop's cached clusterings and their
   order); then the FGT's K6 (prediction) and K7 (expansion) against
   their plain versions at 100,000 and 376,401 rows, at a fast phase's
   first and last bandwidth (``ab_kernels.fgt_rows``): each kernel within
   1e-4 of its plain version relative to its largest value, the E-step on
   the kernels within 1e-3 of the plain E-step and equal to itself in two
   runs, with each kernel's and plain version's device time and bound.
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
   the auto lowering and forced to the batched hierarchical
   one (K2's and K3's batch forms must launch), each pair equal to its
   solo hierarchical run bit for bit;
   ms per call and per pair-iteration of the four lowerings (batched or
   unrolled, dense or hierarchical) at both sizes, 20 iterations a pair;
   NICP on 16 x 16,384 anisotropic pairs, each within 1 degree; CPD on
   4 x 2,048 pairs, 10 iterations, each equal to its solo run bit for
   bit.

15. sequence odometry — ``tpuslam_torch.register_sequence`` on 20 scans of
   a 102,400-point uniform box of side 10 seen from a drifting pose (steps
   of 0.08 rad and 0.4, rows permuted; ``bench_results/sequence_100k.json``'s
   protocol, ``tests/test_sequence.py::_make_trajectory``'s construction),
   after an untimed 3-scan call: the scan lowering seeded and unseeded,
   the per-pair lowering and the batch lowering, each timed (host clock
   around a synchronised call) and then run again under torch's CUDA sync
   debug mode, which counts its synchronising calls (device-to-host reads,
   blocking copies) and the lines that make them; every absolute pose
   within 1 degree and 0.15 of the truth, K2 and K3 launched on each;
   printed: ms, scans/s, iterations per pair, the drift RMS (translation
   error over all poses), launches of K1-K3 and synchronising calls per
   pair;
16. streaming push — ``tpuslam_torch.sequence_stream`` over the same 20
   scans and over 5 scans of 1,048,576 points (at most 300 iterations a
   push there: the structure-free box converges more slowly the denser
   it is): ms per push (host clock), median and max after the first,
   queries per push by arm, synchronising calls per push (a second
   stream, counted); every pose within 1 degree; at 100k the poses within
   1e-5 of the scan lowering's;
17. chunked and checkpointed drivers — phase 6's 1,048,576-point
   hierarchical registration run again by ``icp_register_chunked`` at
   chunk 5 with a checkpoint file: equal to phase 6's whole run bit for bit
   (R, t, iterations, error); the same run stopped at 10 iterations and
   resumed from its file in a new process (``resume_child``): equal bit for
   bit; phase 10's 376,401-point Hybrid CPD by ``cpd_register_chunked`` at
   chunk 5 and chunk_fast 19: equal to phase 10's run bit for bit, K5
   launched in its slow phase; ``register`` with ICP and with CPD at 8,192
   points under ``TPUSLAM_ICP_CKPT`` and ``TPUSLAM_CPD_CKPT``: equal to the
   runs without, the files written;
18. pair-axis CPD — ``tpuslam_torch.register_pairs`` with CPD on 16 x 2,048
   and 16 x 16,384 box pairs (moved by (0.1 rad, 0.5), noise 0.01), in None
   (20 iterations a pair) and in Hybrid without the FGT (60, so that the
   slow phase truncates), and in Hybrid on 4 x 102,400 pairs (truncated
   E-steps in K4's batch form) and 2 x 376,401 pairs (truncated E-steps on
   K5 pair by pair, from ``batch.CAND_MIN_ROWS`` rows); tolerance 0,
   after an untimed two-pair call: each pair equal to its
   solo ``register`` bit for bit (R, t, iterations, sigma^2), K4's batch
   form launched with B > 1, truncated E-steps in the batch form below
   ``CAND_MIN_ROWS`` and on K5 above it; the batch form's first and last
   call of each run against the plain version on the same operands (both
   passes on the first, middle and last block of each pair, and the whole
   E-step at 2,048 rows; within 1e-5 of the largest plain value); the
   last K5 E-step at 376,401 equal to K4 bit for bit, and K4 there against
   the plain version; ms per pair-iteration beside the pairs run one by
   one through solo ``cpd_register`` (the pair-by-pair lowering
   ``cpd_register_batch`` had before its pair-axis loop) in the same call;
   K4's two passes alone at 16 x 16,384^2 (CUDA events), then against the
   plain running totals on the same operands.
19. the front end — (a) ``python3 -m tpuslam_torch cfg.json`` in a new
   process with no ``--device`` (the card by default): ICP on
   ``synthetic://102400`` (spread 10, motion ranges (0.2, 10), seed 19, 50
   iterations) saving the moved cloud; rc 0, the result on stdout, the card
   named on stderr, the saved cloud read back equal to
   ``transform_cloud(before, R, t)`` of the same parsed config run in this
   process bit for bit, R within 1 degree of the truth, K1, K2 and K3
   launched by the CLI process (which runs the module through ``runpy``
   and prints its own launch counts on stderr as it ends); its wall beside
   a bare torch start-up's; then
   ``--device cuda`` with no visible card must exit non-zero; (b)
   ``cli.run_serve`` in this process on ICP at 102,400 twice (cold, warm),
   NICP at 200,000, CPD Hybrid on noise config 38's parameters, a malformed
   line and an unknown method: one response a request, the bad ones
   ``{"ok": false}``, each good one equal to ``run_with_configuration`` bit
   for bit, K1-K3 launched by each ICP request, K1 by NICP, K4 or K5 by
   CPD; ms a request; (c) ``main(["--test-set", "sizes", "--methods",
   "icp,nicp,cpd", ...])`` in full (25, 50 and 10 rows): the CSV header,
   the row counts, finite errors, K1-K3 launched by the ICP rows, K1 by
   NICP, K4 by CPD; wall and median ``time(ms)`` a method; (d) the
   performance set's top rungs (ICP at 1,300,000, NICP at 300,000) through
   ``TestRunner`` with the warm-up: one row each, finite, K2 and K3 (ICP)
   or K1 (NICP) launched; (e) ``--test-set noise --methods cpd`` in full:
   39 CSV rows and 39 tier rows, K4 or K5 launched, and on the
   ``synthetic://`` fixture of the JAX package's table (its verdicts at full
   size on the CPU, ``tpuslam_torch/harness/data/noise_suite_reference.jsonl``,
   made by ``tests/test_torch_noise_reference.py``) each config's verdict
   equal to the table's and its ground-truth MSE within 1e-2 of the
   table's, relative, or 1e-3 of its identity MSE, whichever is larger;
   on a fixture the table does not hold, every config ``ok``.
20. the sharded layer (``tpuslam_torch.parallel``) — two worlds started
   by ``parallel/launch.py::run_world``, each case against a solo run of
   this process on the same inputs: (a) one rank under NCCL, the sharded
   loops captured as CUDA graphs with their collectives: dense ICP on the headline pair (50 iterations, eps 0, no guard),
   hierarchical ICP on phase 6's box and Hybrid CPD at 102,400 (as in
   (b5)), each run four times in the world's one ``graph_scope`` (the
   first captures, the next two replay, the last of them counting its
   synchronising calls) and once on the eager one-iteration loop
   (``run_cases``' ``eager``): every captured run equal to the eager one
   bit for bit (R, t, scale, iterations, error, E-steps); dense ICP equal
   to solo ``icp_register(use_spatial=False)`` bit for bit, hierarchical
   ICP within 1e-4 of phase 6's run, Hybrid CPD within 2e-4 in R of solo
   ``cpd_register``; each prints ms per iteration captured and eager,
   its host reads (at most one a chunk at ``device_loop.py``, none in
   the search, the kernels' fronts, P or the collectives), each kernel's
   launches and skipped launches, and the collectives and bytes of each
   iteration the loop ran against ``comm_model`` (``icp_comm_bytes``;
   ``cpd_fgt_comm_bytes`` or ``cpd_comm_bytes`` by the iteration's
   E-step), which must equal it; (b) four
   ranks under gloo on one card: (1) the same dense ICP, bit for bit, every
   rank equal; (2) hierarchical ICP on phase 6's 1,048,576-point box, 20
   iterations, R and t within 1e-4 of phase 6's run and, at the final
   state, the sharded NN equal to K1 on the whole cloud; (3) chunked dense
   ICP (chunk 5) equal to the unchunked sharded run, prealigned ICP at
   102,400 from (2.0 rad, 30) within 1 degree; (4) NICP at 1,048,576
   (anisotropic, subcloud 1000, seed 1) within 1 degree; (5) the E-step's
   reduced statistics at 376,401^2, sigma^2 0.002, exact (K4 on every
   block) and truncated (K5, or, where no block takes it, K5 in the solo
   E-step), within 1e-5 relative of solo ``cpd_estep_auto``, each block's
   route printed; Hybrid CPD at 102,400 (phase 18's boxes, weight 0.1,
   const scale, tolerance 0, 60 iterations: FGT then K5/K4 per block)
   within 1 degree of the truth and 2e-4 in R of solo ``cpd_register``,
   and chunked (chunk 5) equal to it bit for bit; (6)
   ``icp_register_pairs_sharded`` on 16 x 16,384 pairs, 4 a rank, each
   equal to its solo run bit for bit.  Each case prints ms per iteration,
   collectives and bytes per iteration beside the model, gloo's host ms
   inside collectives per rank and each kernel's launches per rank; K1-K4
   must launch on the ranks.
21. the measurement programs (``tpuslam_torch/harness/``), each once at its
   full size with 2 repeats: ``python -m tpuslam_torch.harness.bench`` in a
   new process (rc 0, its last stdout line one JSON object with the keys
   metric, value, unit and vs_baseline, the metric ending ``_gpu``, the
   value > 0), then ``bench_report``, ``cpd_large`` (376,401),
   ``cpd_crossover`` at one rung (376,401), ``sweep_hier`` at one triple
   (``auto_tile_params``' own), ``batch_diag``, ``sequence_bench``,
   ``scaling_bench`` (the one-rank NCCL rung, within 1e-4 of the solo run)
   and ``convergence_study`` at the first rung of each method with one
   repeat, each through its ``main`` in this process, each writing into a
   temporary directory; every row it writes must name the card and its
   power limit, not have ``failed``, and show a launch that did its work
   (not skipped as an unselected arm) of each kernel it names
   (``expects``: K1 on the NN and dense rows, K2 and K3 on the
   hierarchical ones and the sweep, K4 on the exact E-steps and the
   crossover's exact arm, K5 on ``cpd_large``'s truncated E-step at 0.002
   x sigma^2_0); K1-K5 and P must each launch in the phase.  Printed: each
   program's rows, wall and launches, and the phase's wall.
22. the device-resident ICP loop and kernel P (``csrc/procrustes.cu``):
   (a) P at the headline's shape (the rows of one dense query of the
   102,400-point pair) against its plain version evaluated in float64 on
   the same inputs, R within 1e-6 and t within 1e-6 x (1 + the largest
   coordinate) (t's float32 rounding grows with the means), the error
   entry within 1e-6 relative; on 16 x 2,048 random pairs each pair equal
   to its solo call bit for bit; the SVD entry on 16 random 3x3 within
   1e-6 in R, singular values descending and non-negative; (b) P's,
   its plain version's and ``torch.linalg.svd``'s times; (c) at 102,400
   on both arms, a registration run to its stop (eps 1e-4, the guard on)
   by the device loop (``LOOP_CHUNK`` iterations a read, a replayed CUDA
   graph, the second call of one ``graph_scope`` replaying the graph the
   first captured) equal bit for bit to the eager loop of one iteration
   a read (R, t, error, iterations, arms); (d) a 5-scan seeded sequence at
   102,400 and (e) ``icp_register_batch`` on 16 x 2,048 (batched
   lowering), each equal to its eager loop bit for bit; (f) a warm
   headline registration (50 iterations, its graph captured by an
   earlier call of the same scope) under ``count_syncs``: no
   synchronising call in ``procrustes.py`` or ``nn_hier.py``, at most
   ceil(50 / k) plus the set-up's (``prepare_spatial``'s, counted alone).

23. the device-resident CPD loop and kernel P's redesign
   (``cpd_loop_phases``): (a) P's moments entry (the CPD M-step's
   float64 sums) on 16 x 20,480 pairs against its float64 plain version
   within 1e-12 relative; the moments, error and SVD entries each give a
   pair the same bits at B = 1 and B = 16; the error entry within 1e-6
   relative of its float64 plain version; the SVD entry on random,
   rank-2 and non-finite H (R within 1e-6 of float64 plain, NaN for
   NaN); the entries' device times (a CUDA graph of 200 calls) beside
   their plain versions' and ``torch.linalg.svd``'s; (b) solo CPD exact
   at 20,480 rows to its stop and Hybrid at 102,400 (phase 10's
   protocol, 60 iterations: the FGT fast phase, then the slow phase on
   K4's route and on K5's) by the graph loop (``device_loop.LOOP_CHUNK``
   iterations a read, the second call of one ``graph_scope`` replaying
   the graphs the first captured) equal bit for bit to the eager loop
   of one iteration a read (R, t, scale, sigma^2, iterations, E-steps,
   K5 routes); a warm registration's synchronising calls, of which
   those not in its set-up (``cpd._EM``, counted alone) must be chunk
   reads (``icp.py``, ``cpd.py``), at most one a chunk and the first
   phase's; the launches of these runs counted by the wrappers (each
   replay booked from the device) equal to the device's tally, K4 and K5
   skipped at least once; (c) ``cpd_register_batch`` on 16 x 2,048
   Hybrid pairs that switch and stop at different iterations: graph
   against eager and each pair against its solo run, bit for bit.

The launch counts each path is checked by are set to 0 just before it
runs and read just after (on the ranks of phase 20, before each case).

The last lines are the card's name and power limit, one JSON object
describing each kernel (with its bound: the larger of its float32
operations, or for K4 and K5 the exponentials on the special-function
units, over the card's peak rate and its bytes over the memory rate; and
for K1, K2 and K3 the launches per warm headline iteration and per
sequence pair of phase 15; for K1 and K3 their launches that returned at
once as an unselected arm, in phase 5 and per warm headline iteration
(``launches_skipped``, ``launches_skipped_per_iter``); for K1 also its
launches per NICP run of
phase 12 and its time at the rescore shape; for K4 its launches per
iteration of phase 18's batched loop, its time at 16 x 16,384^2 and its
error there; for K5 its launches in each run of phase 18; for every
kernel its launches in phase 19, ``front_end_launches``, on the
ranks of phase 20, ``launches_sharded``, and in phase 21 by program,
``launches_bench``; for P its time at the headline's shape, its
launches in phase 5's registration and per warm headline iteration, and
``torch.linalg.svd``'s time on the same [1, 3, 3] batch as
``library_ms``; for P's SVD, error and moments entries their launches in
phase 23, and for K4 and K5 their launches and skipped launches there),
and
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
            batch_small=2048, batch_large=16_384, cpd_batch=2048, seq_scans=20,
            seq_points=102_400, stream_large=1_048_576, stream_large_scans=5,
            stream_large_iters=300, batch_hybrid_iters=60, batch_mid=102_400,
            batch_mid_pairs=4, batch_cand=376_401, batch_cand_pairs=2,
            front_icp=102_400, front_nicp=200_000, front_perf=("icp", "nicp"),
            shard_ranks=4, shard_estep=376_401, shard_cpd=102_400, shard_cpd_iters=60,
            shard_pairs=16, shard_pair_points=16_384, bench_reps=2, loop_scans=5,
            cpd_loop_iters=60, plan_rows=(4096, 20_480, 102_400, 376_401),
            fgt_rows=(100_000, 376_401))

# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores and HBM3; and the special-function units' exp2,
# 16 a clock on each of 132 SMs at the 1.98 GHz boost clock
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
# float64 outside the tensor cores (the same data sheet): kernel P's sums
PEAK_FP64 = 34e12
# float32 operations per (source, target) pair, an FMA counted as two:
# the NN distance (3 subtractions, a product, 2 FMAs); K2's 12-term
# centre distance (a product, 11 FMAs, + s2) with its bound term (+ eps,
# sqrt, + r) and admission test ((ub + r)^2 + eps); the CPD Gaussian's
# distance and scale, then + the denominator or 4 weighted FMAs
FLOPS_NN, FLOPS_BOUND = 8, 30
FLOPS_DENOM, FLOPS_MOMENTS = 10, 17


def bound_of(flops: float, nbytes: float, exps: float = 0.0, flops64: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    ops_ms = max(flops / PEAK_FP32, exps / PEAK_EXP, flops64 / PEAK_FP64) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


STATS = ("p1", "pt1", "px", "error")


def estep_operands(transformed, moving_mask, target, target_mask, sigma2, constant, trunc):
    """The operands ``cpd_estep_dense_batch`` hands K4's passes: (scalars,
    moving rows padded to 1,024-row blocks at the sentinel, padded target,
    padded moving and target masks)."""
    import torch

    from tpuslam_torch.kernels import cpd_dense

    m, n = (-(-r // cpd_dense.TILE) * cpd_dense.TILE for r in (transformed.shape[1],
                                                                target.shape[1]))
    moving_mask = cpd_dense.pad_rows(moving_mask, m)
    transformed = cpd_dense.pad_rows(transformed, m)
    ty = torch.where(moving_mask[:, :, None] > 0, transformed,
                     torch.full_like(transformed, cpd_dense.SENTINEL)).contiguous()
    return (cpd_dense.estep_scalars(sigma2, constant, trunc, 1e-3), ty,
            cpd_dense.pad_rows(target, n).contiguous(), moving_mask,
            cpd_dense.pad_rows(target_mask, n))


def plain_estep(transformed, moving_mask, target, target_mask, sigma2, constant, trunc):
    """``cpd_estep_dense_batch`` spelled out with the plain passes
    (``denom_pass_ref``, ``moments_pass_ref``) on the card's tensors; no
    kernel may launch."""
    from tpuslam_torch.kernels import cpd_dense

    def k4_launches():
        return cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES

    before = k4_launches()
    b, m0, _ = transformed.shape
    n0 = target.shape[1]
    scal, ty, target, moving_mask, target_mask = estep_operands(
        transformed, moving_mask, target, target_mask, sigma2, constant, trunc)
    denom = cpd_dense.denom_pass_ref(scal, ty, target).reshape(b, target.shape[1])
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
    for f in STATS:
        g, w = getattr(got, f).double(), getattr(want, f).double()
        out[f] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return out


def k4_batch_against_plain(scal, ty, target, weights4=None, moving_mask=None,
                           target_mask=None):
    """K4's batch form, both passes launched here on ``scal`` f32[B, 4],
    ``ty`` f32[B, M, 3] (invalid rows at the sentinel) and ``target``
    f32[B, N, 3], against the plain running totals over every block of
    the other cloud, on the first, middle and last 1,024-row block of
    each pair, valid rows only (masks f32[B, rows], all valid if None).
    ``weights4`` None: the moments' weights from the kernel's
    denominators, as the E-step makes them.  Returns {pass: (max abs,
    max abs / largest plain value)}."""
    import torch

    from tpuslam_torch.kernels import cpd_dense

    tile = cpd_dense.TILE
    b, m, _ = ty.shape
    n = target.shape[1]
    m_valid = (torch.ones((b, m), device=ty.device) if moving_mask is None
               else moving_mask) > 0
    t_valid = (torch.ones((b, n), device=ty.device) if target_mask is None
               else target_mask) > 0
    denom = cpd_dense.denom_pass_batch(scal, ty, target)[:, 0]
    if weights4 is None:
        _, weights4 = cpd_dense.moment_weights(denom, target, t_valid.float(), scal[:, 1])
    acc = cpd_dense.moments_pass_batch(scal, ty, target, weights4)
    err = {"denom": [0.0, 0.0], "moments": [0.0, 0.0]}  # max abs, largest plain value
    for p in range(b):
        for name, got, rows, other, valid in (
                ("denom", denom[p], n, m, t_valid[p]),
                ("moments", acc[p], m, n, m_valid[p])):
            nb = rows // tile
            for i in sorted({0, nb // 2, nb - 1}):
                sl = slice(i * tile, (i + 1) * tile)
                if name == "denom":
                    want = cpd_dense.denom_rows(scal[p], ty[p], target[p, sl], range(other // tile))
                else:
                    want = cpd_dense.moments_rows(scal[p], ty[p, sl], target[p], weights4[p],
                                                  range(other // tile))
                keep = valid[sl]
                want = want.double()[..., keep]
                err[name][0] = max(err[name][0],
                                   float((got[..., sl].double()[..., keep] - want).abs().max()))
                err[name][1] = max(err[name][1], float(want.abs().max()))
    return {k: (a, a / top) for k, (a, top) in err.items()}


def cpd_phases(dev, smi, kind, sizes, time_ms) -> tuple:
    """Phases 8-11 (module docstring); returns the kernels' JSON entries of
    K4's and K5's passes, that of K5's plan, those of the FGT's K6 and K7,
    and phase 10's Hybrid run (its clouds and result, for phase 17)."""
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import cpd
    from tpuslam_torch.config.configuration import ApproximationType, ComputationMethod
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.ab_kernels import fgt_rows
    from tpuslam_torch.kernels import cpd_cand, cpd_dense
    from tpuslam_torch.kernels import fgt as kfgt
    from tpuslam_torch.ops import fgt
    from tpuslam_torch.ops.spatial import morton_permutation

    rng = np.random.Generator(np.random.PCG64(376))
    stats = STATS

    def f32(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def sort_rows(p):
        return p[morton_permutation(p, torch.ones(len(p), device=dev)).long()].contiguous()

    def box(n):
        return sort_rows(torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev))

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
    # K5's plan: the kernel against the torch composition
    from tpuslam_torch.harness.ab_kernels import plan_rows

    plan = [{**r, **bound_of(0.0, r["bytes"])} for r in plan_rows(torch, dev, sizes["plan_rows"])]
    for r in plan:
        r["share"] = r["bound_ms"] / min(r["ms"])
    log(f"[plan] K5's plan kernel against the torch composition on {smi} (device ms in CUDA "
        f"graphs): {json.dumps(plan)}")
    check(not any(r["differing_fields"] for r in plan), "K5's plan differs from its plain version")

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
                "K5 moments": cpd_cand.MOMENTS_LAUNCHES,
                "K5 plan": cpd_cand.PLAN_LAUNCHES}

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
    cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = cpd_cand.PLAN_LAUNCHES = 0
    kfgt.PREDICT_LAUNCHES = kfgt.EXPAND_LAUNCHES = 0
    plain_fgt = kfgt.PLAIN_CALLS["cuda"]
    hybrid, _, phases, _ = register_cpd(ApproximationType.Hybrid, sizes["cpd_iters"])
    phase10 = {"before": before, "after": after, "result": hybrid,
               "max_iterations": sizes["cpd_iters"]}
    check("fgt" in phases and "trunc" in phases, "the run must take both Hybrid phases")
    fgt_launches = {"K6": kfgt.PREDICT_LAUNCHES, "K7": kfgt.EXPAND_LAUNCHES}
    log(f"[cpd] the Hybrid run's FGT launches {fgt_launches} for {phases.count('fgt')} "
        f"fast-phase E-steps; torch compositions run on the card "
        f"{kfgt.PLAIN_CALLS['cuda'] - plain_fgt}")
    check(fgt_launches["K6"] == fgt_launches["K7"] >= 2 * phases.count("fgt") > 0,
          "the Hybrid fast phase did not launch K6 and K7 twice an E-step")
    check(kfgt.PLAIN_CALLS["cuda"] == plain_fgt, "an FGT E-step on the card ran the torch composition")
    check(cpd_cand.DENOM_LAUNCHES > 0 and cpd_cand.MOMENTS_LAUNCHES > 0,
          "the Hybrid slow phase did not launch K5")
    check(cpd_cand.PLAN_LAUNCHES == 3 * cpd_cand.DENOM_LAUNCHES,
          f"the Hybrid run booked {cpd_cand.PLAN_LAUNCHES} plan launches for "
          f"{cpd_cand.DENOM_LAUNCHES} K5 calls (three a call)")
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
    log(f"[estep] {n}^2 on {smi}: exact K4 E-step {exact_ms:.3f} ms; FGT E-step "
        f"{fgt_cached_ms:.3f} ms with the loop's cached clusterings, {fgt_ms:.3f} ms with "
        f"its own")
    # K6 and K7 against their plain versions (the torch composition), and the
    # FGT E-step on each, at cpd-conv.100k's rows and at cpd_large's
    frows = fgt_rows(torch, dev, rows=sizes["fgt_rows"])
    for r in frows:
        for name in ("K6_w1", "K6_w4", "K7_w1", "K7_w4"):
            r[name]["share"] = bound_of(r[name].get("flops_in_cut", r[name]["flops"]),
                                        r[name]["bytes"])["bound_ms"] / min(r[name]["ms"])
    log(f"[fgt] K6 and K7 against the torch composition on {smi} (device ms in CUDA graphs; "
        f"the E-step eager): {json.dumps(frows)}")
    for r in frows:
        where = f"at {r['rows']} rows, sigma^2 {r['when']}"
        check(r["estep_bit_equal"], f"two FGT E-steps on the kernels differ {where}")
        # the sums run in another fixed order than the plain version's
        check(max(r[k]["max_rel_err"] for k in ("K6_w1", "K6_w4", "K7_w1", "K7_w4")) <= 1e-4,
              f"K6 or K7 off its plain version {where}")
        check(r["estep_max_rel_err"] <= 1e-3, f"the FGT E-step off the plain one {where}")
    fgt_entries = []
    for kernel, name, key in (("K6", "fgt_predict (K6)", "K6_w4"),
                              ("K7", "fgt_expand (K7)", "K7_w4")):
        head = frows[0][key]
        fgt_entries.append({
            "name": name, "route": "cuda", "source": "tpuslam_torch/csrc/fgt.cu",
            "replaces": None, "launches": fgt_launches[kernel],
            "max_rel_err": max(r[k]["max_rel_err"] for r in frows for k in (key, kernel + "_w1")),
            "ms": min(head["ms"]), "plain_ms": min(head["plain_ms"]),
            **bound_of(head.get("flops_in_cut", head["flops"]), head["bytes"]),
            "library_ms": None,
            "rows": [{k: r[k] for k in ("rows", "when", "sigma2", kernel + "_w1", key)}
                     for r in frows]})

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
    ], {
        # no Pallas kernel: the JAX package's admission is XLA's
        "name": "cpd_plan (K5 plan)", "route": "cuda", "source": "tpuslam_torch/csrc/cpd_plan.cu",
        "replaces": None, "launches": launches["K5 plan"],
        "max_abs_err": max(r["max_abs_err"] for r in plan),
        "ms": min(plan[-1]["ms"]), "plain_ms": min(plan[-1]["torch_ms"]),
        "bound_ms": plan[-1]["bound_ms"], "bound_by": plan[-1]["bound_by"],
        "library_ms": None, "rows": plan}, fgt_entries, phase10


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
    log(f"[batch] register_pairs ICP on {b} x {large} (auto lowering, batched on the card "
        f"since the device-resident loop): iterations "
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


def trajectory(rng, n_scans, n_pts, step_angle=0.08, step_trans=0.4):
    """A scene of ``n_pts`` points in a uniform box of side 10 scanned from a
    drifting sensor pose, as ``tests/test_sequence.py::_make_trajectory``
    builds one: (scans, true poses P_k with P_0 = I); scan k is the scene in
    sensor frame k, its rows permuted."""
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    scene = (rng.random((n_pts, 3)) * 10.0).astype(np.float32)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    for _ in range(n_scans - 1):
        dr = get_random_rotation_matrix(rng, step_angle)
        dt = get_random_translation_vector(rng, step_trans)
        r_prev, t_prev = poses[-1]
        poses.append(((r_prev @ dr).astype(np.float32), (r_prev @ dt + t_prev).astype(np.float32)))
    scans = [((scene - t) @ r)[rng.permutation(n_pts)].astype(np.float32) for r, t in poses]
    return scans, poses


def pose_errors(absolute, poses):
    """Per pose: (rotation error in degrees, translation error)."""
    return [(rotation_error_deg(a.rotation, r), float(np.linalg.norm(a.translation - t)))
            for a, (r, t) in zip(absolute, poses)]


def resume_child(data_path: str, ckpt_path: str, out_path: str, device: str) -> None:
    """Phase 17's second process: continue the chunked 1,048,576-point
    registration from the checkpoint file on ``device`` and save its
    result."""
    import torch

    from tpuslam_torch.algorithms.icp import icp_register_chunked
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.kernels import build

    dev = torch.device(device)
    if dev.type == "cuda":
        build.load_library()
    with np.load(data_path) as z:
        before, after, iters = z["before"], z["after"], int(z["iters"])
    res = icp_register_chunked(pad_cloud(before, device=dev), pad_cloud(after, device=dev),
                               max_iterations=iters, chunk=5, use_spatial=True,
                               checkpoint_path=ckpt_path)
    np.savez(out_path, rotation=res.transform.rotation.cpu().numpy(),
             translation=res.transform.translation.cpu().numpy(),
             iterations=np.int32(res.iterations), error=res.error.cpu().numpy())


def drivers_phases(dev, smi, kind, sizes, time_ms, phase6, phase10) -> dict:
    """Phases 15-18 (module docstring); returns the numbers of the kernels
    line (launches per sequence pair, K4's batch form)."""
    import os
    import tempfile

    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import batch, cpd
    from tpuslam_torch.algorithms.cpd import cpd_register, cpd_register_chunked
    from tpuslam_torch.algorithms.icp import icp_register_chunked
    from tpuslam_torch.config.configuration import (
        ApproximationType,
        ComputationMethod,
        Configuration,
    )
    from tpuslam_torch.core.types import Cloud, pad_cloud
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.benchkit import count_syncs
    from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense, procrustes
    from tpuslam_torch.ops import nn_hier

    rng = np.random.Generator(np.random.PCG64(808))
    nn_wrappers = {"K1": nn_dense, "K2": bound, "K3": nn_cand, "P": procrustes}

    def reset():
        for w in nn_wrappers.values():
            w.LAUNCHES = 0
        cpd_dense.BATCH_LAUNCHES.clear()
        cpd_dense.DENOM_LAUNCHES = cpd_dense.MOMENTS_LAUNCHES = 0
        cpd_cand.DENOM_LAUNCHES = cpd_cand.MOMENTS_LAUNCHES = 0

    def nn_launches():
        return {k: w.LAUNCHES for k, w in nn_wrappers.items()}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    out = {}
    # 15. sequence odometry ----------------------------------------------------------
    n_scans, n = sizes["seq_scans"], sizes["seq_points"]
    scans, poses = trajectory(rng, n_scans, n)
    kw = dict(max_iterations=60, max_distance_squared=1e6)
    pairs = n_scans - 1
    lowerings = {"scan seeded": {}, "scan unseeded": dict(seed_with_previous=False),
                 "per pair": dict(scan=False), "batch": dict(batch=True)}
    # an untimed warm-up: the first call of a process loads CUDA libraries
    tpuslam_torch.register_sequence(scans[:3], device=dev, **kw)
    seq = {}
    for name, lk in lowerings.items():
        reset()
        nn_hier.ARM_TRACE.clear()
        res, ms = wall(lambda: tpuslam_torch.register_sequence(scans, device=dev, **lk, **kw))
        got = nn_launches()
        arms = {a: list(nn_hier.ARM_TRACE).count(a) for a in ("fine", "coarse", "dense")}
        errs = pose_errors(res.absolute, poses)
        drift = float(np.sqrt(np.mean([e[1] ** 2 for e in errs])))
        _, syncs, sites = count_syncs(
            lambda: tpuslam_torch.register_sequence(scans, device=dev, **lk, **kw))
        seq[name] = {"ms": ms, "scans_per_s": n_scans / (ms / 1e3),
                     "mean_iterations": float(np.mean(res.iterations)),
                     "drift_rms": drift, "worst_deg": max(e[0] for e in errs),
                     "worst_trans": max(e[1] for e in errs),
                     "launches_per_pair": {k: v / pairs for k, v in got.items()},
                     "arms": arms,
                     "syncs_per_pair": syncs / pairs, "sync_sites": sites}
        log(f"[sequence] {name} lowering, {n_scans} scans x {n} points on {smi}: {ms:.1f} ms, "
            f"{seq[name]['scans_per_s']:.2f} scans/s, iterations {res.iterations.tolist()}, "
            f"drift RMS {drift}, worst {seq[name]['worst_deg']} deg / "
            f"{seq[name]['worst_trans']}, launches per pair {seq[name]['launches_per_pair']}, "
            f"queries by arm {arms}, "
            f"synchronising calls per pair {syncs / pairs} (by line {sites})")
        check(seq[name]["worst_deg"] < 1.0 and seq[name]["worst_trans"] < 0.15,
              f"sequence ({name}): a pose is off the truth")
        check(got["K2"] > 0 and got["K3"] > 0, f"sequence ({name}) did not launch K2 and K3")
        if name == "scan seeded":
            scanned = res
    out["sequence"] = seq

    # 16. streaming push -------------------------------------------------------------
    streams = {}
    # the structure-free box needs more iterations the denser it is: 38-60
    # a pair at 102,400 points (phase 15), so the 1M stream may run 300
    for label, s_scans, s_poses, reference, s_kw in (
            ("100k", scans, poses, scanned, kw),
            ("1M", *trajectory(rng, sizes["stream_large_scans"], sizes["stream_large"]), None,
             dict(kw, max_iterations=sizes["stream_large_iters"]))):
        stream = tpuslam_torch.sequence_stream(s_scans[0], device=dev, **s_kw)
        push_ms, arm_counts = [], []
        for s in s_scans[1:]:
            nn_hier.ARM_TRACE.clear()
            _, ms = wall(lambda s=s: stream.push(s))
            push_ms.append(ms)
            arm_counts.append("".join(a[0] for a in nn_hier.ARM_TRACE))
        errs = pose_errors(stream.absolute, s_poses)
        probe = tpuslam_torch.sequence_stream(s_scans[0], device=dev, **s_kw)
        _, syncs, sites = count_syncs(lambda: [probe.push(s) for s in s_scans[1:]])
        streams[label] = {"n": len(s_scans[0]), "scans": len(s_scans), "push_ms": push_ms,
                          "median_ms_after_first": float(np.median(push_ms[1:])),
                          "max_ms_after_first": float(max(push_ms[1:])),
                          "worst_deg": max(e[0] for e in errs),
                          "syncs_per_push": syncs / (len(s_scans) - 1), "sync_sites": sites,
                          "queries_per_push": [len(a) for a in arm_counts]}
        log(f"[stream] {len(s_scans)} scans x {len(s_scans[0])} points on {smi}: ms per push "
            f"{[round(m, 3) for m in push_ms]} (median after the first "
            f"{streams[label]['median_ms_after_first']:.3f}, max "
            f"{streams[label]['max_ms_after_first']:.3f}), queries (arms f/c/d) per push "
            f"{arm_counts}, worst pose "
            f"{streams[label]['worst_deg']} deg, synchronising calls per push "
            f"{streams[label]['syncs_per_push']} (by line {sites})")
        check(streams[label]["worst_deg"] < 1.0, f"stream ({label}): a pose is off the truth")
        if reference is not None:
            d = max(float(np.abs(a.rotation - b.rotation).max()) for a, b in
                    zip(stream.absolute, reference.absolute))
            d = max(d, max(float(np.abs(a.translation - b.translation).max()) for a, b in
                           zip(stream.absolute, reference.absolute)))
            streams[label]["vs_scan_lowering"] = d
            log(f"[stream] against the scan lowering: max |d| {d} (tolerance 1e-5)")
            check(d <= 1e-5, "the stream's poses differ from the scan lowering's")
    out["stream"] = streams

    # 17. chunked and checkpointed drivers ---------------------------------------------
    def same_result(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def icp_tuple(res):
        return (res.transform.rotation.cpu().numpy(), res.transform.translation.cpu().numpy(),
                int(res.iterations), float(res.error))

    big_b, big_a = pad_cloud(phase6["before"], device=dev), pad_cloud(phase6["after"], device=dev)
    iters = phase6["max_iterations"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "icp.npz")
        (chunked, ms) = wall(lambda: icp_register_chunked(
            big_b, big_a, max_iterations=iters, chunk=5, use_spatial=True, checkpoint_path=path))
        eq = same_result(icp_tuple(chunked), phase6["result"])
        log(f"[chunked] ICP {len(phase6['before'])} points, chunk 5, checkpointed: "
            f"{chunked.iterations} iterations, {ms:.1f} ms; equal to phase 6's whole run "
            f"{eq} (tolerance 0)")
        check(eq, "chunked ICP differs from the whole run")
        # stopped at 10 iterations (or halfway, should the run end sooner),
        # then resumed from the file in a new process
        stop = min(10, max(1, phase6["result"][2] // 2))
        path = os.path.join(tmp, "resume.npz")
        icp_register_chunked(big_b, big_a, max_iterations=stop, chunk=5, use_spatial=True,
                             checkpoint_path=path)
        data, result = os.path.join(tmp, "clouds.npz"), os.path.join(tmp, "result.npz")
        np.savez(data, before=phase6["before"], after=phase6["after"], iters=iters)
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.resume_child("
                        f"{data!r}, {path!r}, {result!r}, {str(dev)!r})"],
                       cwd=here, check=True, timeout=600)
        child_s = time.perf_counter() - t0
        with np.load(result) as z:
            resumed = (z["rotation"], z["translation"], int(z["iterations"]), float(z["error"]))
        eq = same_result(resumed, phase6["result"])
        log(f"[chunked] stopped at {stop} iterations, resumed in a new process ({child_s:.1f} s): "
            f"{resumed[2]} iterations, equal to the uninterrupted run {eq} (tolerance 0)")
        check(eq, "the resumed run differs from the uninterrupted one")

        # the Hybrid CPD of phase 10, chunked at 5 (slow) and 19 (FGT), with
        # the keywords its registry call took
        config = Configuration(
            computation_method=ComputationMethod.Cpd, approximation_type=ApproximationType.Hybrid,
            cpd_weight=0.1, cpd_const_scale=True, cpd_tolerance=0.0,
            max_iterations=phase10["max_iterations"])
        reset()
        cpd.PHASE_TRACE.clear()
        cb, ca = pad_cloud(phase10["before"], device=dev), pad_cloud(phase10["after"], device=dev)
        c_res, ms = wall(lambda: cpd_register_chunked(
            cb, ca, chunk=5, chunk_fast=19, checkpoint_path=os.path.join(tmp, "cpd.npz"),
            eps=config.convergence_epsilon, weight=config.cpd_weight,
            const_scale=config.cpd_const_scale, max_iterations=config.max_iterations,
            tolerance=config.cpd_tolerance, approximation_type=config.approximation_type,
            ratio_of_far_field=config.ratio_of_far_field,
            order_of_truncation=config.order_of_truncation, use_fgt=config.cpd_use_fgt,
            centroid_init=config.cpd_centroid_init))
        got = ((c_res.transform.scale * c_res.transform.rotation).cpu().numpy(),
               c_res.transform.translation.cpu().numpy(), int(c_res.iterations),
               float(c_res.error))
        eq = same_result(got, phase10["result"])
        phases = "".join(p[0] for p in cpd.PHASE_TRACE)
        log(f"[chunked] CPD Hybrid {len(phase10['before'])} points, chunk 5 / chunk_fast 19, "
            f"checkpointed: {got[2]} iterations ({phases}), {ms:.1f} ms, K5 launches "
            f"{cpd_cand.DENOM_LAUNCHES} / {cpd_cand.MOMENTS_LAUNCHES}; equal to phase 10's "
            f"whole run {eq} (tolerance 0)")
        check(eq, "chunked CPD differs from the whole run")
        check(cpd_cand.DENOM_LAUNCHES > 0 and cpd_cand.MOMENTS_LAUNCHES > 0,
              "chunked CPD's slow phase did not launch K5")

        # register under both checkpoint variables, at 8,192 points
        small_b, small_a = trajectory(rng, 2, sizes["small"], 0.1, 0.5)[0]
        configs = {"ICP": dict(max_iterations=30),
                   "CPD": dict(computation_method=ComputationMethod.Cpd, max_iterations=10,
                               cpd_weight=0.1)}
        for name, cfg in configs.items():
            whole = tpuslam_torch.register(small_b, small_a, device=dev, **cfg)
            var, path = f"TPUSLAM_{name}_CKPT", os.path.join(tmp, f"{name}.npz")
            os.environ[var] = path
            try:
                ck = tpuslam_torch.register(small_b, small_a, device=dev, **cfg)
            finally:
                del os.environ[var]
            eq = same_result(ck, whole)
            log(f"[chunked] register {name} under {var}: {ck[2]} iterations, equal to the run "
                f"without it {eq}, checkpoint written {os.path.exists(path)}")
            check(eq and os.path.exists(path),
                  f"register under {var} differs from the run without it")

    # 18. pair-axis CPD ------------------------------------------------------------------
    k4 = {}
    pair_cpd = {}
    none, hybrid = ApproximationType.NONE, ApproximationType.Hybrid
    # Hybrid runs until its slow phase has truncated for a while (the switch
    # comes at iteration 21 at 2,048 points, later on denser clouds); the
    # truncated E-steps of clouds of batch.CAND_MIN_ROWS rows or more take
    # K5 pair by pair, the others K4's batch form
    h_iters = sizes["batch_hybrid_iters"]
    cases = ((sizes["batch_small"], sizes["batch_pairs"], {none: 20, hybrid: h_iters}),
             (sizes["batch_large"], sizes["batch_pairs"], {none: 20, hybrid: h_iters}),
             (sizes["batch_mid"], sizes["batch_mid_pairs"], {hybrid: h_iters}),
             (sizes["batch_cand"], sizes["batch_cand_pairs"], {hybrid: h_iters}))
    real_estep, real_cand = cpd.cpd_estep_dense_batch, cpd.cpd_estep_cand
    for n_pts, b, modes in cases:
        befores, afters = [], []
        for _ in range(b):
            x = (rng.random((n_pts, 3)) * 10).astype(np.float32)
            r = get_random_rotation_matrix(rng, 0.1)
            y = (x @ r.T + get_random_translation_vector(rng, 0.5)
                 + rng.normal(0, 0.01, x.shape)).astype(np.float32)
            befores.append(x)
            afters.append(y[rng.permutation(n_pts)])
        for mode, iters in modes.items():
            cfg = dict(computation_method=ComputationMethod.Cpd, approximation_type=mode,
                       cpd_use_fgt=False, max_iterations=iters, cpd_weight=0.1,
                       cpd_const_scale=True, cpd_tolerance=0.0, convergence_epsilon=1e-6)
            tpuslam_torch.register_pairs(befores[:2], afters[:2], device=dev,
                                         **dict(cfg, max_iterations=2))
            # the batch form's operands in the run, kept by reference (the
            # loop makes them anew each iteration): its first and last call,
            # and every call's truncation flags, read after the run
            seen = {"flags": []}

            def keep(*args, **kwargs):
                seen.setdefault("first", args)
                seen["last"] = args
                seen["flags"].append(args[6])
                return real_estep(*args, **kwargs)

            def keep_cand(*args, **kwargs):
                seen["cand"] = args
                return real_cand(*args, **kwargs)

            reset()
            cpd.PHASE_TRACE.clear()
            cpd.cpd_estep_dense_batch, cpd.cpd_estep_cand = keep, keep_cand
            try:
                got, ms = wall(lambda: tpuslam_torch.register_pairs(befores, afters, device=dev,
                                                                    **cfg))
            finally:
                cpd.cpd_estep_dense_batch, cpd.cpd_estep_cand = real_estep, real_cand
            launches = dict(cpd_dense.BATCH_LAUNCHES)
            k5_launches = (cpd_cand.DENOM_LAUNCHES, cpd_cand.MOMENTS_LAUNCHES)
            phases = list(cpd.PHASE_TRACE)
            pair_iters = int(got[2].sum())
            batched_iters = int(got[2].max())
            trunc_in_batch = int(sum(int(f.sum()) for f in seen["flags"]))
            bb = batch.stack_clouds(befores, device=dev)
            ba = batch.stack_clouds(afters, device=dev)
            kw_solo = dict(weight=0.1, const_scale=True, max_iterations=iters, tolerance=0.0,
                           eps=1e-6, approximation_type=mode, use_fgt=False)
            solos, solo_ms = wall(lambda: [cpd_register(Cloud(bb.points[p], bb.count[p]),
                                                        Cloud(ba.points[p], ba.count[p]),
                                                        **kw_solo) for p in range(b)])
            solo_reg = [tpuslam_torch.register(x, y, device=dev, **cfg)
                        for x, y in zip(befores, afters)]
            same = all(np.array_equal(got[0][i], s[0]) and np.array_equal(got[1][i], s[1])
                       and int(got[2][i]) == s[2] and float(got[3][i]) == s[3]
                       for i, s in enumerate(solo_reg))
            name = f"{b}x{n_pts} {mode.value}"
            pair_cpd[name] = {"ms": ms, "ms_per_pair_iter": ms / pair_iters,
                              "pair_by_pair_ms": solo_ms,
                              "pair_by_pair_ms_per_pair_iter":
                                  solo_ms / sum(s.iterations for s in solos),
                              "estep_kinds": {k: phases.count(k) for k in ("exact", "trunc")},
                              "truncated_in_batch_form": trunc_in_batch,
                              "k4_launches_by_batch": launches,
                              "k5_launches": k5_launches,
                              # each pass's batch-form (B > 1) launches per
                              # iteration of the loop
                              "launches_per_batched_iter":
                                  sum(v for k, v in launches.items() if k > 1) / 2
                                  / max(batched_iters, 1)}
            log(f"[pairs-cpd] register_pairs CPD {name} on {smi}: iterations "
                f"{got[2].tolist()}, E-steps {pair_cpd[name]['estep_kinds']} (truncated in K4's "
                f"batch form {trunc_in_batch}), {ms:.1f} ms ({ms / pair_iters:.4f} ms per "
                f"pair-iteration); pair by pair (solo cpd_register, the earlier lowering) "
                f"{solo_ms:.1f} ms ({pair_cpd[name]['pair_by_pair_ms_per_pair_iter']:.4f}); K4 "
                f"launches by batch size {launches}, K5 launches {k5_launches}; each pair equal "
                f"to its solo register {same} (tolerance 0)")
            check(same, f"pair-axis CPD ({name}): a pair differs from its solo run")
            check(any(k > 1 and v > 0 for k, v in launches.items()),
                  f"pair-axis CPD ({name}) did not launch K4's batch form with B > 1")
            if mode == hybrid:
                check("trunc" in phases, f"pair-axis CPD ({name}) never reached the slow phase")
                if n_pts >= batch.CAND_MIN_ROWS:
                    check(min(k5_launches) > 0 and trunc_in_batch == 0,
                          f"pair-axis CPD ({name}): the slow phase did not go to K5")
                else:
                    check(trunc_in_batch > 0,
                          f"pair-axis CPD ({name}): no truncated E-step in K4's batch form")
            # the batch form's first and last call of the run against the
            # plain version on the same operands: both passes on the first,
            # middle and last block of each pair, and at 2,048 rows the
            # whole E-step
            for which in ("first", "last"):
                args = seen[which]
                # the batch form computes every pair each iteration, a
                # stopped one frozen (the JAX loop's freeze): a pair whose
                # frozen state went non-finite (its stop) is not an E-step's
                # input, and is left out of the comparison
                finite = torch.isfinite(args[4]) & torch.isfinite(args[5])
                if not bool(finite.all()):
                    log(f"[pairs-cpd] {name}: {int((~finite).sum())} of {len(finite)} pairs "
                        f"of the loop's {which} call hold a non-finite frozen state")
                    args = tuple(a[finite] for a in args)
                scal, ty, tgt, mm, tm = estep_operands(*args)
                errs = k4_batch_against_plain(scal, ty, tgt, None, mm, tm)
                if ty.shape[1] <= 2048:
                    got_e, want_e = real_estep(*args), plain_estep(*args)
                    for f in STATS:
                        g, w = getattr(got_e, f).double(), getattr(want_e, f).double()
                        # a frozen pair's state near its stop can give both
                        # versions the same non-finite value (an infinite
                        # log-likelihood): those must agree, the rest compare
                        finite = torch.isfinite(w)
                        check(torch.equal(torch.isfinite(g), finite),
                              f"pair-axis CPD ({name}): K4's batch form is non-finite where "
                              f"its plain version is not ({f})")
                        g, w = g[finite], w[finite]
                        a = float((g - w).abs().max()) if g.numel() else 0.0
                        # pt1 = 1 - c / denom lies in [0, 1]: the
                        # denominators' 1e-5 relative tolerance bounds its
                        # error by 1e-5 absolute, while against its own
                        # largest value it is ill-conditioned where c
                        # dominates the row sums (the slow phase's c_init)
                        errs[f"E-step {f}"] = (a, a if f == "pt1" else a / max(
                            float(w.abs().max()) if w.numel() else 0.0, 1e-30))
                torch.cuda.synchronize()
                log(f"[pairs-cpd] {name}: K4's batch form on the loop's {which} call (B = "
                    f"{ty.shape[0]}, truncated {int(args[6].sum())}) against the plain version: "
                    + ", ".join(f"{k} {a:.3e}, {e:.3e}" for k, (a, e) in errs.items())
                    + " (max abs, and relative to the largest plain value, absolute for the "
                    "E-step's pt1; tolerance 1e-5)")
                for k, (_, e) in errs.items():
                    check(e <= 1e-5, f"pair-axis CPD ({name}): K4's batch form ({k}) differs "
                                     f"from its plain version on the loop's {which} call")
            if "cand" in seen:
                # the loop's last E-step on K5: equal to K4 bit for bit, and
                # K4 on it against the plain version (first, middle and
                # last block)
                args = seen["cand"]
                cand = real_cand(*args)
                route = cpd_cand.ROUTE_TRACE[-1]
                dense = cpd_dense.cpd_estep_dense(*args)
                # NaN equal to NaN: a frozen pair's state may have gone non-finite
                bad = sum(int(((getattr(dense, f) != getattr(cand, f))
                               & ~(torch.isnan(getattr(dense, f))
                                   & torch.isnan(getattr(cand, f)))).sum()) for f in STATS)
                one = [torch.as_tensor(a, device=dev).reshape(1) for a in args[4:]]
                scal, ty, tgt, mm, tm = estep_operands(*(a[None] for a in args[:4]),
                                                       one[0].float(), one[1].float(), one[2])
                errs = k4_batch_against_plain(scal, ty, tgt, None, mm, tm)
                torch.cuda.synchronize()
                log(f"[pairs-cpd] {name}: the loop's last K5 E-step (route {route}) against K4: "
                    f"{bad} elements differ (tolerance 0); K4 there against the plain version: "
                    + ", ".join(f"{k} {a:.3e}, {e:.3e}" for k, (a, e) in errs.items())
                    + " (max abs, relative; tolerance 1e-5)")
                check(route == "k5" and bad == 0, f"pair-axis CPD ({name}): K5 differs from K4")
                for k, (_, e) in errs.items():
                    check(e <= 1e-5, f"pair-axis CPD ({name}): K4 ({k}) differs from its plain "
                                     f"version on the loop's last K5 E-step")
            del bb, ba, seen
    # K4's passes alone at 16 x 16,384^2 (batch form), then against the plain
    # running totals on the same operands
    b, rows = sizes["batch_pairs"], sizes["batch_large"]
    mov = torch.from_numpy((rng.random((b, rows, 3)) * 10).astype(np.float32)).to(dev)
    tgt = torch.from_numpy((rng.random((b, rows, 3)) * 10).astype(np.float32)).to(dev)
    s2 = torch.full((b,), 2.0, device=dev)
    scal = cpd_dense.estep_scalars(s2, torch.full_like(s2, 0.1),
                                   torch.zeros(b, dtype=torch.bool, device=dev), 1e-3)
    w4 = torch.from_numpy(rng.random((b, rows, 4)).astype(np.float32)).to(dev)
    k4["ms_batch"] = {
        "denom": time_ms(lambda: cpd_dense.denom_pass_batch(scal, mov, tgt), 10),
        "moments": time_ms(lambda: cpd_dense.moments_pass_batch(scal, mov, tgt, w4), 10)}
    errs = k4_batch_against_plain(scal, mov, tgt, w4)
    torch.cuda.synchronize()
    k4["max_abs_err_batch"] = {k: a for k, (a, _) in errs.items()}
    k4["shape"] = f"{b} x {rows}^2"
    k4_pairs, io = float(b) * rows * rows, b * rows * 24 + b * 16
    k4["bound"] = {"denom": bound_of(FLOPS_DENOM * k4_pairs, io + b * rows * 4, k4_pairs),
                   "moments": bound_of(FLOPS_MOMENTS * k4_pairs, io + b * rows * 32, k4_pairs)}
    k4["launches_per_batched_iter"] = {
        name: v["launches_per_batched_iter"] for name, v in pair_cpd.items()}
    log(f"[pairs-cpd] K4's passes at {k4['shape']} (batch form) on {smi}: {k4['ms_batch']} ms, "
        f"bounds {k4['bound']}; against the plain running totals on the first, middle and last "
        f"block of each pair: "
        + ", ".join(f"{k} {a:.3e}, {e:.3e}" for k, (a, e) in errs.items())
        + " (max abs, relative to the largest plain value; tolerance 1e-5)")
    for k, (_, e) in errs.items():
        check(e <= 1e-5, f"K4's batch form ({k}) differs from its plain version at {k4['shape']}")
    out["pair_cpd"] = pair_cpd
    out["k4"] = k4
    return out


FRONT_KERNELS = ("nn_dense (K1)", "bound_pass (K2)", "nn_cand (K3)", "cpd_denom (K4)",
                 "cpd_moments (K4)", "cpd_denom_cand (K5)", "cpd_moments_cand (K5)",
                 "procrustes (P)")


# phase 19(a)'s CLI process: ``python3 -m tpuslam_torch`` run through
# runpy, which then prints the process's own launch counts on stderr
CLI_LAUNCHES = "[chip_smoke] CLI launches "
CLI_CHILD = (
    "import json, runpy, sys\n"
    "sys.argv = ['tpuslam_torch', *sys.argv[1:]]\n"
    "try:\n"
    "    runpy.run_module('tpuslam_torch', run_name='__main__')\n"
    "finally:\n"
    "    from chip_smoke import CLI_LAUNCHES, front_launches\n"
    "    print(CLI_LAUNCHES + json.dumps(front_launches()), file=sys.stderr)\n"
)


def front_launches() -> dict:
    """Each kernel's launch count, by its name in the kernels line."""
    from tpuslam_torch.kernels import launch_counts

    return dict(zip(FRONT_KERNELS, launch_counts().values()))


def reset_launches() -> None:
    from tpuslam_torch.kernels import reset_launch_counts

    reset_launch_counts()


class TestTap:
    """A text sink for the runner's stdout that records the wall clock and
    the kernels' launch counts where each test begins (its ``Running
    test`` line), so that a test-set run through ``main`` can be split by
    test."""

    def __init__(self, fh):
        self.fh, self.marks = fh, []

    def write(self, s: str) -> int:
        if s.startswith("Running test"):
            self.marks.append((time.perf_counter(), front_launches()))
        return self.fh.write(s)

    def flush(self) -> None:
        self.fh.flush()


def config_values(config) -> dict:
    """A ``Configuration``'s fields, numbers as floats and arrays as tuples
    of float32 values, so that a parsed 400.0 equals a table's 400."""
    import dataclasses
    import enum

    def norm(v):
        if v is None or isinstance(v, (bool, str, enum.Enum)):
            return v
        if isinstance(v, (tuple, list)):
            return tuple(norm(x) for x in v)
        if isinstance(v, np.ndarray):
            return tuple(v.astype(np.float32).reshape(-1).tolist())
        return float(v)

    return {f.name: norm(getattr(config, f.name)) for f in dataclasses.fields(config)}


def read_csv(path: str) -> tuple:
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    return lines[0], [ln.split(";") for ln in lines[1:]]


def front_end_phases(dev, smi, kind, sizes) -> dict:
    """Phase 19 (module docstring): the front end's entry points on the
    card.  Returns each kernel's launches in the phase and the figures
    printed."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from tpuslam_torch.algorithms.registry import run_with_configuration
    from tpuslam_torch.config.configuration import ComputationMethod
    from tpuslam_torch.config.parser import ConfigParser
    from tpuslam_torch.data.loader import load_cloud, synthetic_fixture
    from tpuslam_torch.data.synthesis import get_clouds_from_config, transform_cloud
    from tpuslam_torch.harness import cli, noise, testsets
    from tpuslam_torch.harness.runner import CSV_HEADER, TestRunner
    from tpuslam_torch.native import bindings

    root = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(FRONT_KERNELS, 0)
    figures = {}

    def counted(launches: dict) -> dict:
        for k, v in launches.items():
            total[k] += v
        return launches

    def quiet_parse(request: dict):
        with contextlib.redirect_stdout(io.StringIO()):
            parser = ConfigParser.from_dict(request)
        check(parser.is_correct(), f"front: request does not parse: {request}")
        return parser.get_configuration()

    def k45(launches: dict) -> int:
        return sum(launches[k] for k in FRONT_KERNELS[3:7])

    t0 = time.perf_counter()
    native = bindings.available()
    log(f"[front] native OBJ/OFF reader and writer (host c++): available {native}, "
        f"{time.perf_counter() - t0:.3f} s")
    n_icp = sizes["front_icp"]
    icp_request = {
        "method": "icp", "before-path": f"synthetic://{n_icp}",
        "after-path": f"synthetic://{n_icp}", "cloud-spread": 10.0,
        "rotation-range": 0.2, "translation-range": 10.0, "random-seed": 19,
        "max-iterations": 50,
    }
    with tempfile.TemporaryDirectory() as tmp:
        # 19a. one-shot CLI in a subprocess, on the default device ------------------
        out_obj = os.path.join(tmp, "out.obj")
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as fh:
            json.dump({**icp_request, "save-output-path": out_obj}, fh)
        t0 = time.perf_counter()
        start = subprocess.run(
            [sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
             "torch.cuda.synchronize()"], cwd=root, capture_output=True, text=True,
            timeout=300)
        start_s = time.perf_counter() - t0
        check(start.returncode == 0, f"front: torch start-up failed: {start.stderr[-2000:]}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_CHILD, cfg_path], cwd=root,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log(f"[front] CLI stdout tail: {proc.stdout.strip().splitlines()[-8:]}")
        log(f"[front] CLI stderr: {proc.stderr.strip()[-1500:]}")
        check(proc.returncode == 0, f"front: the CLI exited {proc.returncode}")
        check("Results for the icp method" in proc.stdout, "front: no CLI result on stdout")
        check(f"device: cuda:0 ({kind})" in proc.stderr, "front: the CLI did not name the card")
        reported = [ln[len(CLI_LAUNCHES):] for ln in proc.stderr.splitlines()
                    if ln.startswith(CLI_LAUNCHES)]
        check(len(reported) == 1, "front: the CLI process did not report its launches")
        launches = counted(json.loads(reported[0]))
        # the same registration in this process, for the saved cloud and the
        # registration's share of the wall; its launches are not counted
        with contextlib.redirect_stdout(io.StringIO()):
            config = ConfigParser([cfg_path]).get_configuration()
        before, after, (r_true, _) = get_clouds_from_config(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rot, trans, iters, err = run_with_configuration(before, after, config, device=dev)
        reg_s = time.perf_counter() - t0
        saved = load_cloud(out_obj)
        want = transform_cloud(before, rot, trans)
        deg = rotation_error_deg(rot, r_true)
        same = saved.shape == want.shape and bool(np.array_equal(saved, want))
        log(f"[front] (a) python3 -m tpuslam_torch on {n_icp} points, {kind} ({smi}): "
            f"wall {cli_s:.3f} s with process start and kernel load (a bare torch start-up "
            f"with a CUDA context: {start_s:.3f} s); the same registration in this process "
            f"{reg_s * 1e3:.1f} ms ({reg_s / cli_s * 100:.1f} % of the CLI wall), "
            f"{iters} iterations, error {err}, rotation off by {deg:.4f} deg; the saved "
            f"cloud equals transform_cloud(before, R, t) bit for bit: {same}; the CLI "
            f"process's launches {launches}")
        check(same, "front: the CLI's saved cloud differs from the in-process result")
        check(deg < 1.0, f"front: CLI registration off by {deg} deg")
        check(launches["nn_dense (K1)"] > 0 and launches["bound_pass (K2)"] > 0
              and launches["nn_cand (K3)"] > 0, "front: the CLI's ICP did not launch K1-K3")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        refused = subprocess.run([sys.executable, "-m", "tpuslam_torch", "--device", "cuda",
                                  cfg_path], cwd=root, capture_output=True, text=True,
                                 env=env, timeout=300)
        log(f"[front] --device cuda without a visible card: rc {refused.returncode}, "
            f"stderr {refused.stderr.strip()[-300:]!r}")
        check(refused.returncode != 0 and "Results for" not in refused.stdout,
              "front: the CLI ran without a card")
        figures["cli"] = {"wall_s": cli_s, "torch_start_s": start_s,
                          "registration_ms": reg_s * 1e3, "iterations": iters}

        # 19b. --serve in process ---------------------------------------------------
        entry = next(e for e in noise.load_entries() if e["id"] == 38)
        c38 = noise.build_configuration(entry)
        cpd_request = {
            "method": "cpd", "before-path": c38.before_path, "after-path": c38.after_path,
            "approximation-type": c38.approximation_type.value,
            "max-iterations": c38.max_iterations,
            "rotation": c38.transformation[0].reshape(-1).tolist(),
            "translation": c38.transformation[1].tolist(),
            "cloud-spread": c38.cloud_spread, "random-seed": c38.random_seed,
            "max-distance-squared": c38.max_distance_squared,
            "cpd-weight": c38.cpd_weight, "cpd-const-scale": c38.cpd_const_scale,
            "cpd-tolerance": c38.cpd_tolerance,
            "convergence-epsilon": c38.convergence_epsilon,
            "noise-affected-points-before": c38.noise_affected_points_before,
            "noise-affected-points-after": c38.noise_affected_points_after,
            "noise-intensity-before": c38.noise_intensity_before,
            "noise-intensity-after": c38.noise_intensity_after,
            "additional-outliers-before": c38.additional_outliers_before,
            "additional-outliers-after": c38.additional_outliers_after,
            "nicp-batch-size": c38.nicp_batch_size, "nicp-iterations": c38.nicp_iterations,
            "nicp-subcloud-size": c38.nicp_subcloud_size,
        }
        for key, value in (("cloud-before-resize", c38.cloud_before_resize),
                           ("cloud-after-resize", c38.cloud_after_resize)):
            if value is not None:
                cpd_request[key] = value
        check(config_values(quiet_parse(cpd_request)) == config_values(c38),
              "front: the CPD request is not noise config 38")
        n_nicp = sizes["front_nicp"]
        nicp_request = {**icp_request, "method": "nicp", "before-path": f"synthetic://{n_nicp}",
                        "after-path": f"synthetic://{n_nicp}", "random-seed": 5}
        good = [("icp cold", icp_request), ("icp warm", icp_request),
                ("nicp", nicp_request), ("cpd hybrid (noise config 38)", cpd_request)]
        lines = [json.dumps(r) for _, r in good]
        lines += ["not json {", json.dumps({**icp_request, "method": "supericp"})]
        names = [n for n, _ in good] + ["malformed", "unknown method"]

        class Lines:
            """The request stream; it notes the time and the launch counts
            each time the loop asks for the next request."""

            def __init__(self):
                self.marks = []

            def __iter__(self):
                for line in lines:
                    self.marks.append((time.perf_counter(), front_launches()))
                    yield line + "\n"
                self.marks.append((time.perf_counter(), front_launches()))

        reset_launches()
        stream, out = Lines(), io.StringIO()
        torch.cuda.synchronize()
        check(cli.run_serve(iter(stream), out, device=str(dev)) == 0, "front: serve failed")
        serve_launches = counted(front_launches())
        responses = [json.loads(ln) for ln in out.getvalue().splitlines()]
        check(len(responses) == len(lines), f"front: {len(responses)} responses to "
              f"{len(lines)} requests")
        serve_ms = {}
        for i, name in enumerate(names):
            (t_a, c_a), (t_b, c_b) = stream.marks[i], stream.marks[i + 1]
            per = {k: c_b[k] - c_a[k] for k in FRONT_KERNELS}
            serve_ms[name] = (t_b - t_a) * 1e3
            log(f"[front] (b) serve {name}: {serve_ms[name]:.1f} ms, ok "
                f"{responses[i]['ok']}, launches {per}")
            if name.startswith("icp"):
                check(all(per[k] > 0 for k in FRONT_KERNELS[:3]),
                      f"front: serve {name} did not launch K1-K3")
            elif name == "nicp":
                check(per["nn_dense (K1)"] > 0, "front: serve nicp did not launch K1")
            elif name.startswith("cpd"):
                check(k45(per) > 0, "front: serve cpd did not launch K4 or K5")
        check(responses[4]["ok"] is False and responses[5]["ok"] is False,
              "front: a bad request was answered ok")
        for i, (name, request) in enumerate(good):
            config = quiet_parse(request)
            before, after, _ = get_clouds_from_config(config)
            rot, trans, iters, err = run_with_configuration(before, after, config, device=dev)
            resp = responses[i]
            same = (resp["ok"] is True
                    and np.array_equal(np.asarray(resp["rotation"], np.float32), rot)
                    and np.array_equal(np.asarray(resp["translation"], np.float32), trans)
                    and resp["iterations"] == iters and resp["error"] == float(err))
            log(f"[front] (b) serve {name} against run_with_configuration: equal bit for "
                f"bit {same} ({iters} iterations, error {err})")
            check(same, f"front: serve {name} differs from run_with_configuration")
        log(f"[front] (b) serve launches in all: {serve_launches}")
        figures["serve_ms"] = serve_ms

        # 19c. the sizes set through main, in full -----------------------------------
        sizes_dir = os.path.join(tmp, "sizes")
        reset_launches()
        with open(os.path.join(tmp, "sizes.log"), "w") as fh:
            tap = TestTap(fh)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tap):
                rc = cli.main(["--device", str(dev), "--test-set", "sizes", "--methods",
                               "icp,nicp,cpd", "--out", sizes_dir])
            tap.marks.append((time.perf_counter(), front_launches()))
        counted(front_launches())
        sizes_wall = time.perf_counter() - t0
        check(rc == 0, "front: --test-set sizes failed")
        want_rows = {"icp": 25, "nicp": 50, "cpd": 10}
        figures["sizes"], first = {}, 0
        for method, n_rows in want_rows.items():
            header, rows = read_csv(os.path.join(sizes_dir, f"sizes-{method}.csv"))
            check(header + "\n" == CSV_HEADER, f"front: sizes-{method}.csv header {header!r}")
            check(len(rows) == n_rows, f"front: sizes-{method}.csv has {len(rows)} rows")
            errors = [float(r[6]) for r in rows]
            check(all(np.isfinite(errors)), f"front: sizes-{method}: a non-finite error")
            (t_a, c_a), (t_b, c_b) = tap.marks[first], tap.marks[first + len(rows)]
            first += len(rows)
            per = {k: c_b[k] - c_a[k] for k in FRONT_KERNELS}
            ms = [int(r[4]) for r in rows]
            figures["sizes"][method] = {"wall_s": t_b - t_a, "median_ms": float(np.median(ms)),
                                       "rows": len(rows), "launches": per}
            log(f"[front] (c) sizes-{method}: {len(rows)} rows ({rows[0][1]}..{rows[-1][1]} "
                f"points), wall {t_b - t_a:.3f} s, time(ms) median {np.median(ms)} max "
                f"{max(ms)}, iterations median {np.median([int(r[5]) for r in rows])}, "
                f"launches {per}")
            if method == "icp":
                check(all(per[k] > 0 for k in FRONT_KERNELS[:3]),
                      "front: the ICP sizes rows did not launch K1-K3")
            elif method == "nicp":
                check(per["nn_dense (K1)"] > 0, "front: the NICP sizes rows did not launch K1")
            else:
                check(per["cpd_denom (K4)"] > 0 and per["cpd_moments (K4)"] > 0,
                      "front: the CPD sizes rows did not launch K4")
        log(f"[front] (c) the sizes set through main: {sizes_wall:.3f} s")

        # 19d. the performance set's top rungs, with the warm-up ----------------------
        figures["performance"] = {}
        for method in map(ComputationMethod, sizes["front_perf"]):
            cfg = testsets.get_performance_test_set(method)[-1]
            path = os.path.join(tmp, f"performance-{method.value}.csv")
            reset_launches()
            t0 = time.perf_counter()
            with open(os.path.join(tmp, "performance.log"), "a") as fh, \
                    contextlib.redirect_stdout(fh):
                runner = TestRunner(output_file=path, warmup=True, device=dev)
                runner.add_test(cfg)
                runner.run_all()
                runner.close()
            wall = time.perf_counter() - t0
            per = counted(front_launches())
            _, rows = read_csv(path)
            check(len(rows) == 1 and np.isfinite(float(rows[0][6])),
                  f"front: performance {method.value} row {rows}")
            figures["performance"][method.value] = {
                "points": int(rows[0][1]), "time_ms": int(rows[0][4]),
                "iterations": int(rows[0][5])}
            log(f"[front] (d) performance {method.value} at {rows[0][1]} points with the "
                f"warm-up: time(ms) {rows[0][4]}, iterations {rows[0][5]}, error {rows[0][6]}, "
                f"wall with the warm-up and synthesis {wall:.3f} s, launches {per}")
            if method == ComputationMethod.Icp:
                check(per["bound_pass (K2)"] > 0 and per["nn_cand (K3)"] > 0,
                      "front: the 1.3M ICP rung did not launch K2, K3")
            else:
                check(per["nn_dense (K1)"] > 0, "front: the NICP rung did not launch K1")

        # 19e. the noise suite through main, in full -----------------------------------
        os.environ.pop("TPUSLAM_NOISE_CAP", None)
        noise_dir = os.path.join(tmp, "noise")
        reset_launches()
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "noise.log"), "w") as fh, contextlib.redirect_stdout(fh):
            rc = cli.main(["--device", str(dev), "--test-set", "noise", "--methods", "cpd",
                           "--out", noise_dir])
        noise_wall = time.perf_counter() - t0
        per = counted(front_launches())
        check(rc == 0, "front: --test-set noise failed")
        _, rows = read_csv(os.path.join(noise_dir, "noise-cpd.csv"))
        with open(os.path.join(noise_dir, "noise-tiers-cpd.jsonl")) as fh:
            tiers = [json.loads(ln) for ln in fh if ln.strip()]
        for t in tiers:
            log(f"[front] (e) noise config{t['id']:2d} {t['tier']:11s} "
                f"{'ok  ' if t['ok'] else 'FAIL'} n {t['n_before']} gt_mse {t['gt_mse']:.6g} "
                f"identity {t['identity_mse']:.6g} bar {t['bar']} iterations "
                f"{t['iterations']}")
        tier_counts = {}
        for t in tiers:
            key = f"{t['tier']} {'ok' if t['ok'] else 'failed'}"
            tier_counts[key] = tier_counts.get(key, 0) + 1
        ms = [int(r[4]) for r in rows]
        figures["noise"] = {"wall_s": noise_wall, "tiers": tier_counts,
                            "median_ms": float(np.median(ms)), "launches": per}
        log(f"[front] (e) noise suite, {len(rows)} CSV rows, {len(tiers)} tier rows: "
            f"{tier_counts}; wall {noise_wall:.3f} s, time(ms) median {np.median(ms)} max "
            f"{max(ms)}; launches {per}")
        check(len(rows) == 39 and len(tiers) == 39, "front: the noise suite is not 39 configs")
        check(k45(per) > 0, "front: the noise suite launched neither K4 nor K5")
        # the bar: on the fixture of the JAX package's table (its verdicts at
        # full size on the CPU, tests/test_torch_noise_reference.py), parity
        # with the table on every config: the same verdict, and gt_mse within
        # 1e-2 relative or 1e-3 * identity_mse, whichever is larger; on
        # another fixture, every config ok
        fixture = synthetic_fixture()
        with open(os.path.join(os.path.dirname(noise.TABLE), "noise_suite_reference.jsonl")) as fh:
            rows_ref = [json.loads(ln) for ln in fh if ln.strip() and not ln.startswith("#")]
        reference = {r["id"]: r for r in rows_ref if r["fixture"] == fixture}
        figures["noise"]["fixture"] = fixture
        if reference:
            check(sorted(reference) == sorted(t["id"] for t in tiers),
                  f"front: the JAX table on {fixture} does not hold the suite's 39 configs")
            missed = [t["id"] for t in tiers if not t["ok"] and reference[t["id"]]["ok"]]
            beyond = [t["id"] for t in tiers if t["ok"] and not reference[t["id"]]["ok"]]
            worst, apart = 0.0, []
            for t in tiers:
                ref = reference[t["id"]]
                tol = max(1e-2 * ref["gt_mse"], 1e-3 * ref["identity_mse"])
                share = abs(t["gt_mse"] - ref["gt_mse"]) / tol
                worst = max(worst, share)
                if not share <= 1.0:
                    apart.append((t["id"], t["gt_mse"], ref["gt_mse"]))
            figures["noise"]["jax_ok"] = sum(r["ok"] for r in reference.values())
            figures["noise"]["gt_mse_worst_share_of_tolerance"] = worst
            log(f"[front] (e) fixture {fixture}: the JAX package passes "
                f"{figures['noise']['jax_ok']} of the 39 configs on it; missed here but "
                f"passed there: {missed}; passed here but missed there: {beyond}; gt_mse "
                f"against the table's: worst {worst:.4f} of the tolerance, outside it "
                f"{apart}")
            check(not missed and not beyond,
                  f"front: noise verdicts differ from the JAX package's: missed {missed}, "
                  f"passed beyond {beyond}")
            check(not apart, f"front: noise gt_mse outside the tolerance: {apart}")
        else:
            failed = [t["id"] for t in tiers if not t["ok"]]
            log(f"[front] (e) fixture {fixture}: no JAX table; configs that missed: {failed}")
            check(not failed, f"front: noise configs {failed} missed their tier")
    figures["launches"] = total
    log(f"[front] phase 19 launches by kernel: {total}")
    return figures


SHARD_KERNELS = ("K1", "K2", "K3", "K4_denom", "K4_moments", "K5_denom", "K5_moments", "P")


def sharded_phases(dev, smi, kind, sizes, phase6) -> dict:
    """Phase 20 (module docstring): the sharded layer in a one-rank NCCL
    world and a four-rank gloo world on the card, each case against a
    solo run of this process on the same inputs.  Returns each kernel's
    launches on the ranks and the figures printed."""
    import torch

    from tpuslam_torch.algorithms import device_loop
    from tpuslam_torch.algorithms.cpd import cpd_estep_auto, cpd_register
    from tpuslam_torch.algorithms.icp import icp_register
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import pad_cloud, unpad
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.measure import build_headline_pair
    from tpuslam_torch.kernels import cpd_cand, nn_dense
    from tpuslam_torch.ops.fgt import pd_size
    from tpuslam_torch.ops.spatial import morton_permutation
    from tpuslam_torch.parallel import comm_model
    from tpuslam_torch.parallel.launch import run_cases, run_world

    rng = np.random.Generator(np.random.PCG64(2020))
    on_card = dev.type == "cuda"
    timeout = 300.0
    ranks = sizes["shard_ranks"]

    def moved(before, angle, trans, noise=0.0):
        r = get_random_rotation_matrix(rng, angle)
        t = get_random_translation_vector(rng, trans)
        after = before @ r.T + t
        if noise:
            after = after + rng.normal(0, noise, after.shape)
        return after.astype(np.float32)[rng.permutation(len(before))], r, t

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # --- inputs and the solo runs of this process ----------------------------
    n_head = sizes["headline"]
    cb, ca = build_headline_pair(n_head, device=dev)
    head_b, head_a = unpad(cb), unpad(ca)
    dense_kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=50,
                    divergence_guard=False)
    solo_dense = icp_register(cb, ca, use_spatial=False, **dense_kw)
    n_warm = min(8192, n_head)
    warm = [("icp", dict(before=head_b[:n_warm], after=head_b[:n_warm] + 0.01,
                         max_iterations=2)),
            ("cpd", dict(before=head_b[:n_warm // 2], after=head_b[:n_warm // 2] + 0.01,
                         max_iterations=2))]

    pre_b = (rng.random((sizes["prealign"], 3)) * np.array([40.0, 20.0, 10.0])).astype(
        np.float32)
    pre_a, pre_r, _ = moved(pre_b, 2.0, 30.0, noise=0.01)
    nicp_b = (rng.random((sizes["nicp_large"], 3)) * np.array([40.0, 20.0, 10.0])).astype(
        np.float32)
    nicp_a, nicp_r, _ = moved(nicp_b, 2.0, 30.0)

    n_e = sizes["shard_estep"]

    def sorted_box(n):
        p = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(dev)
        return p[morton_permutation(p, torch.ones(n, device=dev)).long()].contiguous()

    e_mov, e_tgt = sorted_box(n_e), sorted_box(n_e)
    e_kw = dict(moving=e_mov.cpu().numpy(), target=e_tgt.cpu().numpy(), sigma2=0.002,
                constant=0.3)

    n_c = sizes["shard_cpd"]
    cpd_b = (rng.random((n_c, 3)) * 10).astype(np.float32)
    cpd_a, cpd_r, _ = moved(cpd_b, 0.1, 0.5, noise=0.01)
    cpd_kw = dict(weight=0.1, const_scale=True, max_iterations=sizes["shard_cpd_iters"],
                  tolerance=0.0, eps=1e-6, approximation_type=ApproximationType.Hybrid)

    n_p = sizes["shard_pair_points"]
    p_befores = [(rng.random((n_p, 3)) * 10).astype(np.float32)
                 for _ in range(sizes["shard_pairs"])]
    p_afters = [moved(b, 0.2, 1.0)[0] for b in p_befores]

    big_b, big_a = phase6["before"], phase6["after"]
    cases = {
        "dense": ("icp", dict(before=head_b, after=head_a, **dense_kw)),
        "dense chunked": ("icp", dict(before=head_b, after=head_a, chunk=5, **dense_kw)),
        "hier": ("icp", dict(before=big_b, after=big_a, max_iterations=phase6["max_iterations"],
                             use_spatial=True, final_nn=True)),
        "prealigned": ("icp", dict(before=pre_b, after=pre_a, prealign=True, max_iterations=60,
                                   max_distance_squared=1e9, eps=1e-6, seed=1)),
        "nicp": ("nicp", dict(before=nicp_b, after=nicp_a, subcloud_size=1000, seed=1)),
        "estep exact": ("estep", dict(trunc=False, **e_kw)),
        "estep truncated": ("estep", dict(trunc=True, **e_kw)),
        "cpd hybrid": ("cpd", dict(before=cpd_b, after=cpd_a, **cpd_kw)),
        "cpd hybrid chunked": ("cpd", dict(before=cpd_b, after=cpd_a, chunk=5, **cpd_kw)),
        "pairs": ("pairs", dict(befores=p_befores, afters=p_afters)),
    }

    def world(name, size, backend, device, names):
        sync()
        t0, epoch0 = time.perf_counter(), time.time()
        _, per_rank = run_world(run_cases, size, backend, device, timeout,
                                warm + [cases[k] for k in names])
        wall = time.perf_counter() - t0
        started = min(r[0]["wall"][0] for r in per_rank) - epoch0
        cases_s = {k: max(r[len(warm) + i]["wall"][1] - r[len(warm) + i]["wall"][0]
                          for r in per_rank) for i, k in enumerate(names)}
        log(f"[sharded] {name}: {size} rank(s) under {backend} on {device or 'the card'}, "
            f"{wall:.3f} s for the world, of which {started:.3f} s before the first case "
            f"(spawn, imports, CUDA start-up, inputs), the cases (set-up included) "
            f"{json.dumps(cases_s)}")
        return {k: [r[len(warm) + i] for r in per_rank] for i, k in enumerate(names)}

    def same_on_ranks(name, recs, keys=("rotation", "translation", "iterations", "error")):
        for rec in recs[1:]:
            for k in keys:
                check(np.array_equal(rec["result"][k], recs[0]["result"][k]),
                      f"{name}: ranks differ in {k}")

    def report(name, recs, steps=None, model=None):
        """ms per iteration, collectives and bytes per iteration against
        the model, host ms inside collectives and launches, per rank;
        ``steps`` None counts an ICP loop's steps by its two ``pmin``s."""
        res = recs[0]["result"]
        colls = recs[0]["collectives"]
        if steps is None:
            steps = sum(c.op == "pmin" for c in colls) // 2
        per_iter = sum(c.nbytes for c in colls) / max(steps, 1)
        host_ms = [sum(c.seconds for c in r["collectives"]) * 1e3 / max(steps, 1) for r in recs]
        fig = {"ms_per_iter": res["seconds"] * 1e3 / max(steps, 1), "steps": steps,
               "collectives_per_iter": len(colls) / max(steps, 1),
               "bytes_per_iter": per_iter, "model_bytes_per_iter": model,
               "host_ms_in_collectives_per_iter": host_ms,
               "launches_per_rank": [r["launches"] for r in recs],
               "routes_per_rank": [sorted(set(r["routes"])) for r in recs]}
        log(f"[sharded] {name} on {smi}: " + json.dumps(fig))
        return fig

    def solo_equal(name, got, solo):
        same = (np.array_equal(got["rotation"], solo.transform.rotation.cpu().numpy())
                and np.array_equal(got["translation"], solo.transform.translation.cpu().numpy())
                and np.array_equal(got["error"], solo.error.cpu().numpy())
                and int(got["iterations"]) == int(solo.iterations))
        log(f"[sharded] {name}: equal to the solo run bit for bit: {same} (tolerance 0)")
        check(same, f"{name}: differs from the solo run")

    figs = {}
    launches = {"nccl_1_rank": dict.fromkeys(SHARD_KERNELS, 0),
                "gloo_4_ranks": dict.fromkeys(SHARD_KERNELS, 0)}

    def add(which, recs):
        for r in recs:
            for k in SHARD_KERNELS:
                launches[which][k] += r["launches"][k]

    # (a) one rank under NCCL: each loop captured (the first run captures,
    # the later ones replay the kept graph; the last counts its host reads)
    # against the eager one-iteration loop of the same world -------------------
    gloo_cases = list(cases)
    solo_cpd = cpd_register(pad_cloud(cpd_b, device=dev), pad_cloud(cpd_a, device=dev), **cpd_kw)
    runs = (("capture", {}), ("replay", {}), ("reads", dict(syncs=True)),
            ("eager", dict(eager=True)))
    captured = ("dense", "hier", "cpd hybrid")
    for k in captured:
        kind, kw = cases[k]
        for run, extra in runs:
            cases[f"{k} {run}"] = (kind, dict(kw, final_nn=False, **extra) if kind == "icp"
                                   else dict(kw, **extra))
    one = world("(a)", 1, "nccl" if on_card else "gloo", None if on_card else str(dev),
                [f"{k} {run}" for k in captured for run, _ in runs])
    for recs in one.values():
        add("nccl_1_rank", recs)
    m_pad = len(pad_cloud(cpd_b, device="cpu").points)
    for k in captured:
        eager = one[f"{k} eager"][0]
        for run, _ in runs[:3]:
            got = one[f"{k} {run}"][0]["result"]
            same = all(np.array_equal(got[f], eager["result"][f])
                       for f in ("rotation", "translation", "scale", "iterations", "error"))
            same = same and one[f"{k} {run}"][0]["phases"] == eager["phases"]
            log(f"[sharded] (a) {k}, {run}: equal to the eager one-iteration loop bit for bit: "
                f"{same} (tolerance 0)")
            check(same, f"(a) {k} {run}: differs from the eager one-iteration loop")
        rec, res = one[f"{k} replay"][0], one[f"{k} replay"][0]["result"]
        its = int(res["iterations"])
        chunk = device_loop.LOOP_CHUNK
        if k == "cpd hybrid":
            # the set-up: the FGT's clusters (an all_gather), sigma^2_0 (3 psums)
            with_fgt = rec["collectives"][0].op == "all_gather"
            per = comm_model.logged_cpd_iterations(rec["collectives"], 3 + with_fgt)
            model = {"fgt": comm_model.cpd_fgt_comm_bytes(min(128, m_pad), pd_size(8))["total"],
                     "exact": comm_model.cpd_comm_bytes(m_pad)["total"]}
            bytes_ok = all(b == model[e] for e, b in per)
            per_bytes = [b for _, b in per]
        else:
            n_rows = len(pad_cloud(head_b if k == "dense" else big_b, device="cpu").points)
            model = comm_model.icp_comm_bytes(n_rows)["total"]
            per_bytes = comm_model.logged_iterations(rec["collectives"], 3)
            bytes_ok = all(b == model for b in per_bytes)
        reads = one[f"{k} reads"][0]["syncs"] or {"count": None, "sites": {}}
        loop_reads = sum(v for site, v in reads["sites"].items()
                         if site.startswith("device_loop.py"))
        inner = [site for site in reads["sites"] if site.startswith(
            ("nn_hier.py", "nn.py", "cpd_cand.py", "cpd_dense.py", "procrustes.py",
             "collectives.py"))]
        t_eager = one[f"{k} eager"][0]["result"]["seconds"]
        fig = {"ms_per_iter": res["seconds"] * 1e3 / max(its, 1),
               "eager_ms_per_iter": t_eager * 1e3 / max(its, 1), "iterations": its,
               "iterations_run": len(per_bytes), "chunk": chunk,
               "host_reads": reads["count"], "host_read_sites": reads["sites"],
               "loop_reads": loop_reads, "chunks_at_most": -(-(its + 1) // chunk),
               "collectives_per_iter": len(rec["collectives"]) / max(len(per_bytes), 1),
               "bytes_per_iter": sorted(set(per_bytes)), "model_bytes_per_iter": model,
               "bytes_equal_model": bytes_ok,
               "launches": rec["launches"], "eager_launches": eager["launches"],
               "routes": sorted(set(rec["routes"]))}
        log(f"[sharded] (a) {k} on the one-rank world, on {smi}: " + json.dumps(fig))
        figs[f"(a) {k}"] = fig
        check(bytes_ok, f"(a) {k}: bytes per iteration differ from comm_model")
        if on_card:
            check(not inner and 1 <= loop_reads <= fig["chunks_at_most"],
                  f"(a) {k}: host reads inside an iteration or more than one a chunk: "
                  f"{reads['sites']}")
    solo_equal("(a) dense ICP", one["dense replay"][0]["result"], solo_dense)
    res = one["hier replay"][0]["result"]
    r6, t6, _, _ = phase6["result"]
    d_r = float(np.abs(res["rotation"] - r6).max())
    d_t = float(np.abs(res["translation"] - t6).max())
    log(f"[sharded] (a) hierarchical ICP: |dR| {d_r}, |dt| {d_t} against the solo "
        f"hierarchical run (tolerance 1e-4)")
    check(d_r <= 1e-4 and d_t <= 1e-4, "(a): the hierarchical run differs from solo")
    res = one["cpd hybrid replay"][0]["result"]
    d_r = float(np.abs(res["rotation"] - solo_cpd.transform.rotation.cpu().numpy()).max())
    log(f"[sharded] (a) Hybrid CPD: |dR| {d_r} against solo cpd_register (tolerance 2e-4)")
    check(d_r <= 2e-4, "(a): the Hybrid run differs from solo")
    na = launches["nccl_1_rank"]
    for k in ("K1", "K2", "K3", "P"):
        check(na[k] > 0, f"(a): {k} was not launched on the rank")
    check(na["K4_denom"] + na["K5_denom"] > 0, "(a): neither K4 nor K5 was launched on the rank")
    model = comm_model.icp_comm_bytes(cb.points.shape[0])["total"]

    # (b) four ranks under gloo, all on one card -----------------------------------
    four = world("(b)", ranks, "gloo", str(dev), gloo_cases)
    for recs in four.values():
        add("gloo_4_ranks", recs)

    recs = four["dense"]
    solo_equal("(b1) dense ICP", recs[0]["result"], solo_dense)
    same_on_ranks("(b1) dense ICP", recs)
    figs["dense"] = report("(b1) dense ICP at headline size", recs, solo_dense.iterations, model)
    check(figs["dense"]["bytes_per_iter"] == model,
          "(b1): bytes per iteration differ from icp_comm_bytes")

    recs = four["hier"]
    res = recs[0]["result"]
    same_on_ranks("(b2) hierarchical ICP", recs)
    r6, t6, it6, _ = phase6["result"]
    d_r = float(np.abs(res["rotation"] - r6).max())
    d_t = float(np.abs(res["translation"] - t6).max())
    valid = res["final_mask"] > 0
    lb = pad_cloud(big_a, device=dev)
    k1_idx, k1_dist = nn_dense.nearest_neighbors_dense(
        torch.from_numpy(res["final_src"]).to(dev), lb.points, lb.count)
    bad = int(((k1_idx.cpu().numpy() != res["final_index"])
               | (k1_dist.cpu().numpy() != res["final_dist"]))[valid].sum())
    log(f"[sharded] (b2) hierarchical ICP at {len(big_b)} points: iterations "
        f"{int(res['iterations'])} (solo {it6}), |dR| {d_r}, |dt| {d_t} against the solo "
        f"hierarchical run (tolerance 1e-4); final-state NN rows differing from K1 on the whole "
        f"cloud {bad} of {int(valid.sum())} (tolerance 0)")
    check(d_r <= 1e-4 and d_t <= 1e-4, "(b2): the hierarchical run differs from solo")
    check(bad == 0, "(b2): the sharded hierarchical NN differs from K1")
    for r in recs:
        check(np.array_equal(r["result"]["final_index"], res["final_index"]),
              "(b2): ranks differ in the final NN")
    figs["hier"] = report("(b2) hierarchical ICP", recs,
                          model=comm_model.icp_comm_bytes(len(res["final_src"]))["total"])

    recs = four["dense chunked"]
    whole = four["dense"][0]["result"]
    same = all(np.array_equal(recs[0]["result"][k], whole[k])
               for k in ("rotation", "translation", "error", "iterations"))
    log(f"[sharded] (b3) chunked dense ICP (chunk 5): equal to the unchunked sharded run bit "
        f"for bit: {same}")
    check(same, "(b3): the chunked run differs from the unchunked one")
    same_on_ranks("(b3) chunked ICP", recs)
    figs["dense chunked"] = report("(b3) chunked dense ICP", recs, solo_dense.iterations, model)

    recs = four["prealigned"]
    ang = rotation_error_deg(recs[0]["result"]["rotation"], pre_r)
    log(f"[sharded] (b3) prealigned ICP at {len(pre_b)} points moved by (2.0 rad, 30): "
        f"{int(recs[0]['result']['iterations'])} iterations, rotation off by {ang} deg "
        f"(bound 1)")
    check(ang < 1.0, f"(b3): prealigned rotation {ang} deg from the truth")
    same_on_ranks("(b3) prealigned ICP", recs)
    figs["prealigned"] = report("(b3) prealigned ICP", recs)

    recs = four["nicp"]
    ang = rotation_error_deg(recs[0]["result"]["rotation"], nicp_r)
    log(f"[sharded] (b4) NICP at {len(nicp_b)} points moved by (2.0 rad, 30), subcloud 1000, "
        f"seed 1: {int(recs[0]['result']['iterations'])} candidates, rotation off by {ang} deg "
        f"(bound 1)")
    check(ang < 1.0, f"(b4): NICP rotation {ang} deg from the truth")
    same_on_ranks("(b4) NICP", recs)
    figs["nicp"] = report("(b4) NICP", recs, 1, comm_model.nicp_comm_bytes(1000)["total"])

    # (b5) the E-step's reduced statistics at n_e^2, exact and truncated
    m1 = torch.ones(n_e, device=dev)
    e_model = comm_model.cpd_comm_bytes(len(four["estep exact"][0]["result"]["p1"]))["total"]
    k5_ranks = 0
    for label, trunc in (("exact", False), ("truncated", True)):
        recs = four[f"estep {label}"]
        cpd_cand.ROUTE_TRACE.clear()
        solo = cpd_estep_auto(e_mov, m1, e_tgt, m1, 0.002, 0.3,
                              torch.tensor(trunc, device=dev) if trunc else False)
        route = list(cpd_cand.ROUTE_TRACE)
        want = {"p1": solo.p1, "px": solo.px, "error": solo.error,
                "t_pt1_a2": torch.sum(solo.pt1 * torch.sum(e_tgt * e_tgt, -1)),
                "s_pt1_a": torch.matmul(solo.pt1, e_tgt)}
        rel = {}
        for k, v in want.items():
            v = v.double().cpu().numpy()
            g = recs[0]["result"][k]
            g = g[:n_e] if k in ("p1", "px") else g  # the moving cloud's padded rows weigh 0
            rel[k] = float(np.abs(g - v).max() / max(np.abs(v).max(), 1e-30))
        shard_routes = [r["routes"] for r in recs]
        log(f"[sharded] (b5) E-step {label} at {n_e}^2, sigma^2 0.002: relative error "
            f"against solo cpd_estep_auto (route {route}) {rel} (tolerance 1e-5); K5 routes "
            f"by shard {shard_routes}")
        check(max(rel.values()) <= 1e-5, f"(b5): {label} statistics differ from solo")
        for k in want:
            for r in recs:
                check(np.array_equal(r["result"][k], recs[0]["result"][k]),
                      f"(b5): ranks differ in {k}")
        if trunc:
            k5_ranks = sum(r["launches"]["K5_denom"] > 0 for r in recs)
            if k5_ranks == 0:
                log("[sharded] (b5) no shard took K5 at sigma^2 0.002 (admission overflow on "
                    "every block); K5 is required of the solo truncated E-step instead")
                check(route == ["k5"], "(b5): the solo truncated E-step did not take K5")
        else:
            check(all(r["launches"]["K4_denom"] > 0 for r in recs),
                  "(b5): K4 was not launched on every rank")
        figs[f"estep {label}"] = report(f"(b5) E-step {label}", recs, 1, e_model)
    figs["k5_shards"] = k5_ranks

    recs = four["cpd hybrid"]
    res = recs[0]["result"]
    solo = solo_cpd
    d_r = float(np.abs(res["rotation"] - solo.transform.rotation.cpu().numpy()).max())
    ang = rotation_error_deg(res["rotation"], cpd_r)
    log(f"[sharded] (b5) Hybrid CPD at {n_c} points moved by (0.1 rad, 0.5): "
        f"{int(res['iterations'])} iterations (solo {int(solo.iterations)}), sigma^2 "
        f"{float(res['error'])} (solo {float(solo.error)}), |dR| against solo {d_r} (tolerance "
        f"2e-4), rotation off by {ang} deg (bound 1); routes {recs[0]['routes'][-3:]}")
    check(d_r <= 2e-4, "(b5): the Hybrid run differs from solo")
    check(ang < 1.0, f"(b5): Hybrid rotation {ang} deg from the truth")
    same_on_ranks("(b5) Hybrid CPD", recs)
    figs["cpd hybrid"] = report("(b5) Hybrid CPD", recs, int(res["iterations"]))

    recs = four["cpd hybrid chunked"]
    same = all(np.array_equal(recs[0]["result"][k], res[k])
               for k in ("rotation", "translation", "error", "iterations"))
    log(f"[sharded] (b5) chunked Hybrid CPD (chunk 5): equal to the unchunked sharded run bit "
        f"for bit: {same}")
    check(same, "(b5): the chunked CPD differs from the unchunked one")
    figs["cpd hybrid chunked"] = report("(b5) chunked Hybrid CPD", recs, int(res["iterations"]))

    recs = four["pairs"]
    res = recs[0]["result"]
    worst = 0
    for i, (b, a) in enumerate(zip(p_befores, p_afters)):
        solo = icp_register(pad_cloud(b, device=dev), pad_cloud(a, device=dev),
                            use_spatial=False)
        same = (np.array_equal(res["rotation"][i], solo.transform.rotation.cpu().numpy())
                and np.array_equal(res["translation"][i],
                                   solo.transform.translation.cpu().numpy())
                and int(res["iterations"][i]) == int(solo.iterations)
                and np.array_equal(res["error"][i], solo.error.cpu().numpy()))
        worst += not same
    log(f"[sharded] (b6) {len(p_befores)} x {n_p} pairs, {len(p_befores) // ranks} a rank: "
        f"pairs differing from their solo runs {worst} (tolerance 0)")
    check(worst == 0, "(b6): a pair differs from its solo run")
    same_on_ranks("(b6) pairs", recs)
    figs["pairs"] = report("(b6) pairs", recs, int(res["iterations"].max()))

    gl = launches["gloo_4_ranks"]
    log(f"[sharded] launches on the ranks of phase 20: {json.dumps(launches)}")
    for k in ("K1", "K2", "K3", "K4_denom", "K4_moments"):
        check(gl[k] > 0, f"phase 20: {k} was not launched on the ranks")
    return {"launches": launches, "figures": figs}


# phase 21: each measurement program of tpuslam_torch/harness/ at its full
# size with the fewest repeats it allows; the headline in a new process
BENCH_ARGS = {
    "bench_report": [],
    "cpd_large": [],
    "cpd_crossover": ["376401"],
    "sweep_hier": ["--triples", "auto"],
    "batch_diag": [],
    "sequence_bench": [],
    "scaling_bench": [],
    "convergence_study": ["--sizes", "icp=20000,nicp=250000,cpd=4000", "--repeats", "1"],
}


def bench_rows(path: str) -> list:
    """The rows a program wrote: a JSON object's ``rows`` or a JSONL file's
    lines."""
    with open(path) as fh:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in fh if line.strip()]
        return json.load(fh)["rows"]


def bench_phases(dev, smi, kind, sizes) -> dict:
    """Phase 21 (module docstring): the measurement programs on the card.
    Returns each program's rows' kernel launches and wall."""
    import importlib
    import os
    import tempfile

    from tpuslam_torch.kernels import KERNELS

    on_card = dev.type == "cuda"
    device_args = [] if on_card else ["--device", str(dev)]
    reps = ["--reps", str(sizes["bench_reps"])]
    t_phase = time.perf_counter()
    launches, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="tpuslam_bench_") as tmp:
        def held(name, path):
            rows = bench_rows(path)
            check(len(rows) > 0, f"phase 21: {name} wrote no row")
            total = dict.fromkeys(KERNELS, 0)
            for row in rows:
                check("failed" not in row, f"phase 21: {name} row {row.get('name')}: "
                      f"{row.get('failed')}")
                check(row.get("device") == (kind if on_card else "cpu"),
                      f"phase 21: {name} row {row.get('name')} names no device")
                check(not on_card or isinstance(row.get("power_limit_w"), float),
                      f"phase 21: {name} row {row.get('name')} has no power limit")
                for k in row.get("expects", []):
                    worked = row["launches"][k] - row["launches"].get(f"{k} skipped", 0)
                    check(worked > 0, f"phase 21: {name} row {row['name']} launched no {k} "
                          "that did its work")
                for k in KERNELS:
                    total[k] += row["launches"].get(k, 0)
            launches[name] = total
            log(f"[bench] {name}: {len(rows)} rows, {walls[name]:.3f} s, launches "
                f"{json.dumps(total)}")
            return rows

        # (a) the headline, as a user runs it: a new process, one JSON line last
        out = os.path.join(tmp, "headline.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpuslam_torch.harness.bench", *device_args, *reps,
             "--n-points", str(sizes["headline"]), "--out", out],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        walls["bench"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 21: the headline exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[bench] headline line: {json.dumps(line)}")
        check(set(line) == {"metric", "value", "unit", "vs_baseline"},
              "phase 21: the headline's last line has other keys")
        check(line["metric"].endswith("_gpu" if on_card else "_cpu") and line["value"] > 0,
              "phase 21: the headline's metric or value")
        held("bench", out)
        # (b) the other programs in this process, each through its main()
        for name, args in BENCH_ARGS.items():
            out = os.path.join(tmp, name + (".jsonl" if name == "convergence_study" else ".json"))
            module = importlib.import_module(f"tpuslam_torch.harness.{name}")
            t0 = time.perf_counter()
            rc = module.main([*args, *device_args, *reps, "--out", out])
            walls[name] = time.perf_counter() - t0
            check(rc == 0, f"phase 21: {name} exited {rc}")
            rows = held(name, out)
            if name == "scaling_bench":
                check(rows[0]["solo_max_abs_diff"] <= 1e-4,
                      "phase 21: the one-rank rung is not the solo run")
    for k in KERNELS:
        check(sum(v[k] for v in launches.values()) > 0,
              f"phase 21: no program launched {k}")
    wall = time.perf_counter() - t_phase
    log(f"[bench] phase 21: {wall:.3f} s on {smi}, by program {json.dumps(walls)}")
    return {"launches": launches, "walls": walls, "wall": wall}


# phase 22: the device-resident ICP loop and kernel P
def device_time_ms(time_ms, on_card: bool):
    """ms a call on the device: on the card by a CUDA graph of the calls
    (``ab_kernels.graph_ms``), else ``time_ms``."""
    import torch

    from tpuslam_torch.harness.ab_kernels import graph_ms

    if on_card:
        return lambda fn, reps: graph_ms(torch, fn, reps)
    return time_ms


def one_iteration_loop(fn):
    """``fn()`` with the ICP loop at one iteration a host read and no CUDA
    graph: the eager loop the device loop is held to."""
    from tpuslam_torch.algorithms import device_loop

    device_loop.CUDA_GRAPHS = False
    try:
        return fn()
    finally:
        device_loop.CUDA_GRAPHS = True


def device_loop_phases(dev, smi, kind, sizes, time_ms) -> dict:
    """Phase 22 (module docstring): kernel P against its plain version and
    timed, the device loop against the eager one-iteration loop bit for
    bit, and the host reads of a warm headline registration.  Returns P's
    entry of the kernels line (launches filled in by the caller)."""
    import torch

    import tpuslam_torch
    from tpuslam_torch.algorithms import device_loop, icp
    from tpuslam_torch.algorithms.batch import icp_register_batch, stack_clouds
    from tpuslam_torch.data.synthesis import get_random_rotation_matrix
    from tpuslam_torch.harness.benchkit import count_syncs
    from tpuslam_torch.harness.measure import build_headline_pair
    from tpuslam_torch.kernels import procrustes
    from tpuslam_torch.ops import nn_hier
    from tpuslam_torch.ops.nn import nearest_neighbors

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    n = sizes["headline"]
    cb, ca = build_headline_pair(n, device=dev)
    # (a) P against its plain version, evaluated in float64 on the same
    # inputs: the rows of one dense query of the headline pair
    idx, dist = nearest_neighbors(cb.points, ca.points, ca.count)
    rows_b, rows_a = cb.points, ca.points.index_select(0, idx)
    w = ((dist < 1e18) & (cb.mask() > 0)).to(torch.float32)
    r, t = procrustes.weighted_procrustes_batch(rows_b[None], rows_a[None], w[None])
    r64, t64 = procrustes.weighted_procrustes_ref(rows_b.double(), rows_a.double(), w.double())
    r32, t32 = procrustes.weighted_procrustes_ref(rows_b, rows_a, w)
    mu_scale = 1.0 + float(rows_a.abs().max()) + float(rows_b.abs().max())
    err_r = float((r[0].double() - r64).abs().max())
    err_t = float((t[0].double() - t64).abs().max())
    err_32 = max(float((r[0] - r32).abs().max()), float((t[0] - t32).abs().max()))
    log(f"[loop] P at {n} rows against its plain version in float64: R {err_r}, t {err_t} "
        f"(tolerance: R 1e-6, t 1e-6 x (1 + |a|max + |b|max) = {1e-6 * mu_scale}: t's "
        f"float32 rounding grows with the means); against the float32 plain version {err_32}")
    check(err_r <= 1e-6 and err_t <= 1e-6 * mu_scale, "P differs from its plain version")
    diff = rows_a - rows_b
    n_corr = w.sum()[None]
    e = procrustes.mean_sq_error_batch(diff[None], w[None], n_corr)
    e64 = procrustes.mean_sq_error_ref(diff.double(), w.double(), n_corr[0].double())
    err_e = abs(float(e[0]) - float(e64)) / max(abs(float(e64)), 1e-30)
    log(f"[loop] P's error entry: {float(e[0])} against {float(e64)}, relative {err_e} "
        f"(tolerance 1e-6)")
    check(err_e <= 1e-6, "P's error entry differs from its plain version")
    rng = np.random.Generator(np.random.PCG64(22))
    pairs, m = sizes["batch_pairs"], sizes["batch_small"]
    pb = torch.from_numpy((rng.random((pairs, m, 3)) * 10).astype(np.float32)).to(dev)
    pa = torch.from_numpy((rng.random((pairs, m, 3)) * 10).astype(np.float32)).to(dev)
    pw = torch.from_numpy((rng.random((pairs, m)) > 0.3).astype(np.float32)).to(dev)
    br, bt = procrustes.weighted_procrustes_batch(pb, pa, pw)
    same = all(torch.equal(x[0], br[p]) and torch.equal(y[0], bt[p]) for p, (x, y) in enumerate(
        procrustes.weighted_procrustes_batch(pb[p:p + 1], pa[p:p + 1], pw[p:p + 1])
        for p in range(pairs)))
    h = torch.from_numpy(rng.standard_normal((pairs, 3, 3)).astype(np.float32)).to(dev)
    sr, ss, sd = procrustes.svd_rotation_det_batch(h)
    svd_err = max(float((sr[p].double() - procrustes.svd_rotation_det_ref(h[p].double())[0])
                        .abs().max()) for p in range(pairs))
    sorted_ok = bool((ss[:, :-1] >= ss[:, 1:]).all() and (ss >= 0).all())
    log(f"[loop] P on {pairs} x {m}: each pair equal to its solo call bit for bit: {same}; "
        f"the SVD entry on {pairs} random 3x3: R against float64 plain {svd_err} (tolerance "
        f"1e-6), singular values descending and non-negative: {sorted_ok}")
    check(same, "P: a pair of the batch differs from its solo call")
    check(svd_err <= 1e-6 and sorted_ok, "P's SVD entry differs from its plain version")
    # (b) P's time at the headline's shape, its plain version's (two
    # cuSOLVER calls that wait), and torch.linalg.svd on the same batch
    h1 = torch.matmul(((rows_a - rows_a.mean(0)) * w[:, None]).T, rows_b - rows_b.mean(0))[None]
    # eager calls back to back (the kernels line's ``ms``, as every slice
    # since P's port has timed it), and the device's time by a CUDA graph
    # of many calls (``ms_device``: the host's Python between calls can
    # exceed a small kernel's time)
    device_ms = device_time_ms(time_ms, on_card)
    p_call = lambda: procrustes.weighted_procrustes_batch(rows_b[None], rows_a[None],  # noqa: E731
                                                          w[None])
    svd_call = lambda: procrustes.svd_rotation_det_batch(h1)  # noqa: E731
    ms, ms_device = time_ms(p_call, 50), device_ms(p_call, 200)
    plain_ms = time_ms(lambda: procrustes.weighted_procrustes_ref(rows_b, rows_a, w), 20)
    library_ms = time_ms(lambda: torch.linalg.svd(h1), 20)
    svd_ms, svd_ms_device = time_ms(svd_call, 50), device_ms(svd_call, 200)
    # before, after and w read once (28 bytes a row); the centred second
    # pass re-reads them from L2 (2.9 MB at 102,400 rows, in the 50 MB)
    p_bound = bound_of(40.0 * n, 28.0 * n)
    log(f"[loop] times on {smi}: P {ms:.4f} ms a call back to back at [1, {n}, 3], the "
        f"host's included ({ms_device:.4f} ms on the device; bound {p_bound}), plain "
        f"{plain_ms:.4f} ms, torch.linalg.svd on the [1, 3, 3] batch {library_ms:.4f} ms, "
        f"P's SVD entry {svd_ms:.4f} ms ({svd_ms_device:.4f} on the device)")
    # (c) the device loop against the eager one-iteration loop at 102,400
    # on both arms, run to the stop (frozen iterations in the last chunk)
    converge = dict(eps=1e-4, max_distance_squared=1e4, max_iterations=100)
    loop = {}
    for arm, use_spatial in (("hier", True), ("dense", False)):
        def reg():
            nn_hier.ARM_TRACE.clear()
            t0 = time.perf_counter()
            res = icp.icp_register(cb, ca, use_spatial=use_spatial, **converge)
            return res, list(nn_hier.ARM_TRACE), time.perf_counter() - t0

        want, want_arms, eager_s = one_iteration_loop(reg)
        with icp.graph_scope({}):
            reg()  # the first call captures the chunk's graph
            got, arms, loop_s = reg()
        equal = (got.iterations == want.iterations and arms == want_arms
                 and torch.equal(got.transform.rotation, want.transform.rotation)
                 and torch.equal(got.transform.translation, want.transform.translation)
                 and torch.equal(got.error, want.error))
        loop[arm] = {"iterations": got.iterations, "eager_ms": eager_s * 1e3,
                     "loop_ms": loop_s * 1e3, "equal": equal}
        log(f"[loop] {arm} arm at {n}: {got.iterations} iterations, the device loop (chunk "
            f"{device_loop.LOOP_CHUNK}{', a replayed graph' if on_card else ''}) "
            f"{loop_s * 1e3:.3f} ms against the eager one-iteration loop "
            f"{eager_s * 1e3:.3f} ms; equal bit for bit (R, t, error, "
            f"iterations, arms {''.join(a[0] for a in arms)}): {equal}")
        check(equal, f"the device loop differs from the eager loop ({arm} arm)")
    # (d) a 5-scan seeded sequence and (e) a 16 x 2,048 batch
    scans, poses = trajectory(np.random.Generator(np.random.PCG64(5)), sizes["loop_scans"], n)
    seq = tpuslam_torch.register_sequence(scans, device=dev)
    seq_ref = one_iteration_loop(lambda: tpuslam_torch.register_sequence(scans, device=dev))
    seq_equal = (np.array_equal(seq.iterations, seq_ref.iterations) and all(
        np.array_equal(x.rotation, y.rotation) and np.array_equal(x.translation, y.translation)
        for x, y in zip(seq.relative, seq_ref.relative)))
    worst = max(pose_errors(seq.absolute, poses))
    log(f"[loop] seeded sequence of {len(scans)} scans at {n}: iterations "
        f"{seq.iterations.tolist()}, equal to the eager loop bit for bit: {seq_equal}, worst "
        f"pose {worst}")
    check(seq_equal, "the sequence on the device loop differs from the eager loop")
    check(worst[0] < 1.0, "the sequence's poses are more than 1 degree off")
    befores = [(rng.random((m, 3)) * 10).astype(np.float32) for _ in range(pairs)]
    afters = [(b @ get_random_rotation_matrix(rng, 0.2).T + 0.3).astype(np.float32)
              for b in befores]
    bb, ba = stack_clouds(befores, device=dev), stack_clouds(afters, device=dev)
    bkw = dict(unroll=False, eps=1e-4, max_distance_squared=1e4, max_iterations=50)
    batch = icp_register_batch(bb, ba, **bkw)
    batch_ref = one_iteration_loop(lambda: icp_register_batch(bb, ba, **bkw))
    batch_equal = (torch.equal(batch.iterations, batch_ref.iterations)
                   and torch.equal(batch.transform.rotation, batch_ref.transform.rotation)
                   and torch.equal(batch.transform.translation, batch_ref.transform.translation)
                   and torch.equal(batch.error, batch_ref.error))
    log(f"[loop] batch of {pairs} x {m}: iterations {batch.iterations.tolist()}, equal to the "
        f"eager loop bit for bit: {batch_equal}")
    check(batch_equal, "the batched device loop differs from the eager loop")
    # (f) host reads of a warm headline registration (measure_icp_100k's
    # protocol: 50 iterations, so ceil(50 / k) chunks) beside the set-up's
    head = dict(eps=0.0, max_distance_squared=1e18, max_iterations=50, divergence_guard=False)
    syncs = sites = setup = None
    with icp.graph_scope({}):
        icp.icp_register(cb, ca, **head)  # captures the graph the next call replays
        if on_card:
            _, setup, setup_sites = count_syncs(lambda: icp.prepare_spatial(cb, ca))
            res, syncs, sites = count_syncs(lambda: icp.icp_register(cb, ca, **head))
    if on_card:
        chunks = -(-int(res.iterations) // device_loop.LOOP_CHUNK)
        log(f"[loop] synchronising calls of a warm headline registration ({res.iterations} "
            f"iterations, chunk {device_loop.LOOP_CHUNK}): {syncs} ({sites}); the loop's reads "
            f"{chunks}, the set-up's {setup} ({setup_sites})")
        check(not any("procrustes.py" in k or "nn_hier.py" in k for k in sites),
              "a warm registration syncs in procrustes.py or nn_hier.py")
        check(syncs <= chunks + setup, "more host reads than one a chunk plus the set-up's")
    wall = time.perf_counter() - t_phase
    log(f"[loop] phase 22: {wall:.3f} s")
    return {
        "entry": {
            "name": "procrustes (P)",
            "route": "cuda",
            "source": "tpuslam_torch/csrc/procrustes.cu",
            "replaces": "tpuslam/ops/procrustes.py:47",
            "max_abs_err": max(err_r, err_t, svd_err),
            "ms": ms,
            "plain_ms": plain_ms,
            **p_bound,
            "library_ms": library_ms,
            "ms_device": ms_device,
            "ms_svd_entry": svd_ms,
            "ms_svd_entry_device": svd_ms_device,
            "max_abs_err_float32_plain": err_32,
        },
        "loop": loop, "syncs": syncs, "sync_sites": sites, "setup_syncs": setup,
        "sequence_iterations": seq.iterations.tolist(), "wall": wall,
    }


# phase 23: the device-resident CPD loop and kernel P's Hopper redesign
def cpd_loop_phases(dev, smi, kind, sizes, time_ms) -> dict:
    """Phase 23 (module docstring): P's entries against their plain
    versions and B-independent, the CPD graph loop against the eager
    one-iteration loop bit for bit (solo exact, solo Hybrid, pair axis),
    the host reads of warm registrations, the launches and skips the
    device counted, and the times.  Returns P's entries of the kernels
    line (but the Procrustes entry, phase 22's) and the phase's record."""
    import torch

    from tpuslam_torch.algorithms import cpd, device_loop, icp
    from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
    from tpuslam_torch.config.configuration import ApproximationType
    from tpuslam_torch.core.types import pad_cloud
    from tpuslam_torch.data.synthesis import get_random_rotation_matrix
    from tpuslam_torch.harness.benchkit import count_syncs
    from tpuslam_torch.kernels import (
        TALLIED,
        cpd_cand,
        launch_counts,
        procrustes,
        reset_launch_counts,
        tally,
    )

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    rng = np.random.Generator(np.random.PCG64(23))

    def rand(*shape, lo=0.0, hi=10.0):
        return torch.from_numpy((lo + rng.random(shape) * (hi - lo)).astype(np.float32)).to(dev)

    # (a) P's moments entry against its float64 plain version, and every
    # entry's bits at B = 1 equal to B = 16
    n, pairs = sizes["cpd_small"], sizes["batch_pairs"]
    p1, mv, px = rand(pairs, n, lo=0.0, hi=1.0), rand(pairs, n, 3), rand(pairs, n, 3, lo=-1.0)
    pt1, tg = rand(pairs, n, lo=0.0, hi=1.0), rand(pairs, n, 3)
    sums = procrustes.mstep_moments_batch(p1, mv, px, pt1, tg)
    ref = torch.stack([procrustes.mstep_moments_ref(p1[p], mv[p], px[p], pt1[p], tg[p])
                       for p in range(pairs)])
    mom_err = float(((sums - ref).abs() / ref.abs().clamp_min(1e-300)).max())
    solo = [procrustes.mstep_moments_batch(p1[p:p + 1], mv[p:p + 1], px[p:p + 1],
                                           pt1[p:p + 1], tg[p:p + 1])[0] for p in range(pairs)]
    mom_same = all(torch.equal(sums[p], solo[p]) for p in range(pairs))
    diff, w = rand(pairs, n, 3, lo=-1.0, hi=1.0), (rand(pairs, n, hi=1.0) > 0.3).float()
    nc = w.sum(1)
    err_b = procrustes.mean_sq_error_batch(diff, w, nc)
    err_err = max(abs(float(err_b[p]) - float(procrustes.mean_sq_error_ref(
        diff[p].double(), w[p].double(), nc[p].double()))) / float(err_b[p])
        for p in range(pairs))
    err_same = all(torch.equal(err_b[p:p + 1], procrustes.mean_sq_error_batch(
        diff[p:p + 1], w[p:p + 1], nc[p:p + 1])) for p in range(pairs))
    h = rand(pairs, 3, 3, lo=-1.0, hi=1.0)
    svd_b = procrustes.svd_rotation_det_batch(h)
    svd_same = all(all(torch.equal(x[p:p + 1], y) for x, y in zip(
        svd_b, procrustes.svd_rotation_det_batch(h[p:p + 1]))) for p in range(pairs))
    # rank 2 and rank 1 cross-covariances, and a non-finite one
    u = rand(2, 3, lo=-1.0, hi=1.0)
    h_rank = torch.stack([u[0][:, None] * u[1][None, :] + u[1][:, None] * u[0][None, :],
                          u[0][:, None] * u[1][None, :]])
    h_bad = torch.full((1, 3, 3), float("nan"), device=dev)
    r_rank = procrustes.svd_rotation_det_batch(h_rank)[0]
    rank_err = max(float((r_rank[p].double() - procrustes.svd_rotation_det_ref(
        h_rank[p].double())[0]).abs().max()) for p in range(1))
    svd_err = max(float((svd_b[0][p].double() - procrustes.svd_rotation_det_ref(
        h[p].double())[0]).abs().max()) for p in range(pairs))
    nan_ok = bool(torch.isnan(procrustes.svd_rotation_det_batch(h_bad)[0]).all())
    log(f"[cpd-loop] P's moments entry on {pairs} x {n}: relative error against its float64 "
        f"plain version {mom_err:.3e} (tolerance 1e-12); a pair's bits at B = 1 equal B = "
        f"{pairs}: moments {mom_same}, error {err_same}, SVD {svd_same}; the error entry "
        f"against its float64 plain version {err_err:.3e} relative (tolerance 1e-6); the SVD "
        f"on {pairs} random H {svd_err:.3e} and on a rank-2 H {rank_err:.3e} in R against "
        f"float64 plain (tolerance 1e-6); NaN H gives NaN R: {nan_ok}")
    check(mom_err <= 1e-12, "P's moments entry differs from its plain version")
    check(err_err <= 1e-6, "P's error entry differs from its plain version")
    check(mom_same and err_same and svd_same, "P: a pair of the batch differs from its solo call")
    check(max(svd_err, rank_err) <= 1e-6 and nan_ok, "P's SVD entry differs from its plain "
          "version (random, rank 2 or non-finite H)")
    # P's entries timed at the CPD and ICP shapes, as phase 22 times the
    # Procrustes entry: eager calls back to back, and on the device by a
    # CUDA graph of 200 calls (``_device``); each with its bound (each
    # input read once, each output written once)
    n_head = sizes["headline"]
    d1, w1 = rand(1, n_head, 3, lo=-1.0, hi=1.0), (rand(1, n_head, hi=1.0) > 0.3).float()
    device_ms = device_time_ms(time_ms, on_card)
    calls = {
        "error": lambda: procrustes.mean_sq_error_batch(d1, w1, w1.sum(1)),
        "moments": lambda: procrustes.mstep_moments_batch(p1[:1], mv[:1], px[:1], pt1[:1],
                                                          tg[:1]),
        "svd": lambda: procrustes.svd_rotation_det_batch(h[:1]),
    }
    times = {
        "error_plain": time_ms(lambda: procrustes.mean_sq_error_ref(d1[0], w1[0], w1[0].sum()),
                               50),
        "moments_plain": time_ms(lambda: procrustes.mstep_moments_ref(
            p1[0], mv[0], px[0], pt1[0], tg[0]), 20),
        "svd_plain": time_ms(lambda: procrustes.svd_rotation_det_ref(h[0]), 20),
        "svd_library": time_ms(lambda: torch.linalg.svd(h[:1]), 20),
    }
    for key, call in calls.items():
        times[key], times[f"{key}_device"] = time_ms(call, 50), device_ms(call, 200)
    bounds = {
        # diff and w read, the error written; 6 float32 operations a row
        "error": bound_of(6.0 * n_head, 16.0 * n_head + 4),
        # p1, y, px a moving row and pt1, x a target row; 18 and 5 float64
        # FMAs (36 and 10 operations)
        "moments": bound_of(0.0, 44.0 * n + 144, flops64=46.0 * n),
        "svd": bound_of(0.0, 36.0 + 52.0, flops64=2000.0),
    }
    log(f"[cpd-loop] P's entries on {smi}, ms a call back to back (on the device, a CUDA "
        f"graph of 200 calls): error at [1, {n_head}, 3] {times['error']:.4f} "
        f"({times['error_device']:.4f}; plain {times['error_plain']:.4f}, bound "
        f"{bounds['error']}), moments at [1, {n}] x [1, {n}] {times['moments']:.4f} "
        f"({times['moments_device']:.4f}; plain {times['moments_plain']:.4f}, bound "
        f"{bounds['moments']}), SVD on [1, 3, 3] {times['svd']:.4f} ({times['svd_device']:.4f}; "
        f"plain {times['svd_plain']:.4f}, torch.linalg.svd {times['svd_library']:.4f})")

    # (b) the graph loop against the eager one-iteration loop, bit for bit
    def box_pair(m, angle, trans=0.3, scale=10.0):
        b = (rng.random((m, 3)) * scale).astype(np.float32)
        r = get_random_rotation_matrix(rng, angle)
        a = (b @ r.T + trans).astype(np.float32)[rng.permutation(m)]
        return b, a

    def traced(fn):
        cpd.PHASE_TRACE.clear()
        cpd_cand.ROUTE_TRACE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, list(cpd.PHASE_TRACE), list(cpd_cand.ROUTE_TRACE), time.perf_counter() - t0

    def same(x, y):
        return (torch.equal(torch.as_tensor(x.iterations), torch.as_tensor(y.iterations))
                and all(torch.equal(getattr(x.transform, f), getattr(y.transform, f))
                        for f in ("rotation", "translation", "scale"))
                and torch.equal(x.error, y.error))

    runs = {}
    cases = (
        ("exact", sizes["cpd_small"], 0.2,
         dict(approximation_type=ApproximationType.NONE, weight=0.1, tolerance=1e-5,
              max_iterations=100)),
        # phase 10's protocol at the headline's size: the FGT fast phase,
        # then the slow phase's K4 route (the admission overflows) and K5's
        ("hybrid", sizes["headline"], 0.1,
         dict(approximation_type=ApproximationType.Hybrid, weight=0.1, tolerance=0.0,
              const_scale=True, max_iterations=sizes["cpd_loop_iters"])),
    )
    reset_launch_counts()
    for name, m, angle, kw in cases:
        bc, ac = (pad_cloud(x, device=dev) for x in box_pair(m, angle, 0.5))

        def reg():
            return cpd.cpd_register(bc, ac, **kw)

        want, want_ph, want_rt, eager_s = one_iteration_loop(lambda: traced(reg))
        with icp.graph_scope({}):
            traced(reg)  # the first call runs the warm-up chunks and captures
            got, ph, rt, loop_s = traced(reg)
            syncs = sites = setup = loop_sites = None
            if on_card:
                # the set-up's reads (Morton order, FGT clusterings) counted
                # alone; the rest are the loop's
                _, setup, setup_sites = count_syncs(lambda: cpd._EM(
                    bc, ac, kw.get("eps", 1e-3), kw["weight"], kw["tolerance"],
                    kw["approximation_type"], 10.0, 8, None, 128, None, False, False,
                    kw.get("const_scale", False)).initial(None))
                _, syncs, sites = count_syncs(reg)
                loop_sites = {k: v - setup_sites.get(k, 0) for k, v in sites.items()
                              if v > setup_sites.get(k, 0)}
        equal = same(got, want) and ph == want_ph and rt == want_rt
        iters = int(got.iterations)
        chunks = -(-iters // device_loop.LOOP_CHUNK) + sum(a != b for a, b in zip(ph, ph[1:]))
        runs[name] = {"rows": m, "iterations": iters, "eager_ms_per_iter": eager_s * 1e3 / iters,
                      "loop_ms_per_iter": loop_s * 1e3 / iters, "equal": equal,
                      "phases": {k: ph.count(k) for k in cpd.PHASES},
                      "routes": {k: rt.count(k) for k in cpd_cand.ROUTES},
                      "syncs": syncs, "sync_sites": sites, "setup_syncs": setup,
                      "loop_sync_sites": loop_sites, "chunk_reads_at_most": chunks + 1}
        log(f"[cpd-loop] {name} at {m} rows: {iters} iterations, E-steps "
            f"{''.join(p[0] for p in ph)}, K5 routes {''.join(r[1] for r in rt)}; the graph "
            f"loop (chunk {device_loop.LOOP_CHUNK}) {loop_s * 1e3 / iters:.4f} ms/iter against the "
            f"eager one-iteration loop {eager_s * 1e3 / iters:.4f} ms/iter on {smi}; equal bit "
            f"for bit (R, t, scale, sigma^2, iterations, E-steps, routes): {equal}; "
            f"synchronising calls of a warm registration {syncs} ({sites}), of its set-up "
            f"{setup}, so the loop's {loop_sites} (at most one a chunk and the first phase's "
            f"read: {chunks + 1})")
        check(equal, f"the CPD graph loop differs from the eager loop ({name})")
        if on_card:
            # the loop reads only its status, once a chunk (the read in
            # device_loop.py), and each problem's state
            # once before the first chunk (cpd.py)
            check(all(k.startswith(("device_loop.py", "cpd.py")) for k in loop_sites),
                  f"a warm CPD registration syncs inside an iteration ({name})")
            check(syncs <= setup + runs[name]["chunk_reads_at_most"],
                  f"more host reads than one a chunk plus the set-up's ({name})")
    hy = runs["hybrid"]
    check(hy["phases"]["fgt"] > 0 and hy["phases"]["trunc"] > 0,
          "the Hybrid run must take both phases")
    check(hy["routes"]["k5"] > 0 and hy["routes"]["k4"] > 0,
          "the Hybrid slow phase must take both K5's route and K4's")
    counted = launch_counts()
    on_device = dict(zip(TALLIED, tally(dev)[:, 0].tolist())) if on_card else {}
    log(f"[cpd-loop] launches of the solo runs (the wrappers' counts, each replay booked from "
        f"the device): {json.dumps(counted)}; counted on the device {json.dumps(on_device)}")
    for key in ("K4_denom", "K4_moments", "K5_denom", "K5_moments", "P svd", "P moments"):
        check(counted[key] > 0, f"phase 23 did not launch {key}")
        if on_card:
            check(counted[key] == on_device[key], f"{key}: the wrappers counted "
                  f"{counted[key]}, the device {on_device[key]}")
    check(counted["K5_denom skipped"] > 0 and counted["K4_denom skipped"] > 0,
          "no predicated K4 or K5 launch was skipped")

    # (c) the pair axis: 16 x 2,048 Hybrid pairs that switch and stop at
    # different iterations, graph loop against eager, each pair its solo bits
    pairs_m = sizes["batch_small"]
    clouds = [box_pair(pairs_m, 0.05 + 0.02 * i, 0.1 * i, 6.0) for i in range(pairs)]
    bb = stack_clouds([x[0] for x in clouds], device=dev)
    ba = stack_clouds([x[1] for x in clouds], device=dev)
    bkw = dict(approximation_type=ApproximationType.Hybrid, weight=0.1, tolerance=1e-5,
               max_iterations=60)
    want, _, _, eager_s = one_iteration_loop(lambda: traced(
        lambda: cpd_register_batch(bb, ba, **bkw)))
    with icp.graph_scope({}):
        traced(lambda: cpd_register_batch(bb, ba, **bkw))
        got, ph, _, loop_s = traced(lambda: cpd_register_batch(bb, ba, **bkw))
        solos = [cpd.cpd_register(pad_cloud(clouds[p][0], device=dev),
                                  pad_cloud(clouds[p][1], device=dev), **bkw)
                 for p in range(pairs)]
    pair_equal = same(got, want)
    solo_equal = all(
        int(got.iterations[p]) == int(s.iterations) and torch.equal(got.error[p], s.error)
        and all(torch.equal(getattr(got.transform, f)[p], getattr(s.transform, f))
                for f in ("rotation", "translation", "scale"))
        for p, s in enumerate(solos))
    its = got.iterations.tolist()
    pair_iters = sum(its)
    log(f"[cpd-loop] pair axis {pairs} x {pairs_m} Hybrid: iterations {its}, the graph loop "
        f"{loop_s * 1e3 / pair_iters:.4f} ms a pair-iteration against the eager one-iteration "
        f"loop {eager_s * 1e3 / pair_iters:.4f}; equal to the eager loop bit for bit: "
        f"{pair_equal}; each pair equal to its solo run: {solo_equal}")
    check(len(set(its)) > 1, "the pairs must stop at different iterations")
    check(pair_equal, "the pair-axis graph loop differs from the eager loop")
    check(solo_equal, "a pair of the pair-axis loop differs from its solo run")
    wall = time.perf_counter() - t_phase
    log(f"[cpd-loop] phase 23: {wall:.3f} s")

    def entry(name, replaces, err, key, plain_key, library=None):
        return {"name": name, "route": "cuda", "source": "tpuslam_torch/csrc/procrustes.cu",
                "replaces": replaces, "launches": counted[f"P {key}"], "max_abs_err": err,
                "ms": times[key], "ms_device": times[f"{key}_device"],
                "plain_ms": times[plain_key], **bounds[key], "library_ms": library}

    return {
        "entries": [
            entry("procrustes svd (P)", "tpuslam/algorithms/cpd.py:408",
                  max(svd_err, rank_err), "svd", "svd_plain", times["svd_library"]),
            entry("procrustes error (P)", "tpuslam/algorithms/icp.py:180", err_err, "error",
                  "error_plain"),
            entry("procrustes moments (P)", "tpuslam/algorithms/cpd.py:408", mom_err,
                  "moments", "moments_plain"),
        ],
        "runs": runs, "pair_axis": {"iterations": its, "equal": pair_equal,
                                    "solo_equal": solo_equal,
                                    "eager_ms_per_pair_iter": eager_s * 1e3 / pair_iters,
                                    "loop_ms_per_pair_iter": loop_s * 1e3 / pair_iters},
        "launches": counted, "wall": wall,
    }


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
    from tpuslam_torch.kernels import (
        P_ENTRIES,
        TALLIED,
        bound,
        build,
        launch_counts,
        nn_cand,
        nn_dense,
        reset_launch_counts,
        tally,
    )
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
    reset_launch_counts()
    nn_hier.ARM_TRACE.clear()
    t0 = time.perf_counter()
    rot, trans, iters, err = tpuslam_torch.register(
        before, after, device=dev, max_iterations=100
    )
    wall = time.perf_counter() - t0
    counted = launch_counts()
    launches = {k: counted[k] for k in ("K1", "K2", "K3", "P", "K1 skipped", "K3 skipped",
                                        "P procrustes", "P error")}
    on_device = dict(zip(TALLIED, tally(dev)[:, 0].tolist()))
    on_device["P"] = sum(on_device[k] for k in P_ENTRIES)
    arms = list(nn_hier.ARM_TRACE)
    cos = (np.trace(rot.astype(np.float64).T @ r_true.astype(np.float64)) - 1) / 2
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    log(f"[slice] register {n_head}-point uniform box on {kind}: {iters} "
        f"iterations, error {err}, rotation off by {angle} deg, translation "
        f"off by {float(np.abs(trans - t_true).max())}, launches {launches}, "
        f"arms fine {arms.count('fine')} / coarse {arms.count('coarse')} / "
        f"dense {arms.count('dense')} ({''.join(a[0] for a in arms)}), "
        f"{wall:.3f} s")
    log(f"[slice] launches the kernels counted on the device {on_device} (each must equal "
        f"the wrappers' count, a replay's booked from it)")
    for name in ("K1", "K2", "K3", "P", "P procrustes", "P error"):
        check(launches[name] > 0, f"the registration did not launch {name}")
        check(launches[name] == on_device[name],
              f"{name}: the wrappers counted {launches[name]} launches, the device "
              f"{on_device[name]}")
    check(launches["K3"] > launches["K3 skipped"], "K3 did no work in the registration")
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
    phase6 = {"before": big_before, "after": big_after, "max_iterations": sizes["large_iters"],
              "result": (big.transform.rotation.cpu().numpy(),
                         big.transform.translation.cpu().numpy(), int(big.iterations),
                         float(big.error))}
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
        h = measure_icp_100k(n_points=n_pts, device=dev, use_spatial=arm)
        h["nvidia_smi"] = smi
        # the timed calls, each of iters_per_call (the untimed first call
        # captures the graph they replay)
        h["launches_per_call"] = {
            k: h["launches"][k] / h["reps"]
            for k in ("K1", "K2", "K3", "P", "K1 skipped", "K3 skipped")}
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

    cpd_kernels, plan_entry, fgt_entries, phase10 = cpd_phases(dev, smi, kind, sizes, time_ms)
    slice7 = nicp_batch_phases(dev, smi, kind, sizes, time_ms)
    log(f"[nicp] summary: {json.dumps(slice7)}")
    slice8 = drivers_phases(dev, smi, kind, sizes, time_ms, phase6, phase10)
    log(f"[drivers] summary: {json.dumps(slice8)}")
    front = front_end_phases(dev, smi, kind, sizes)
    log(f"[front] summary: {json.dumps(front)}")
    sharded = sharded_phases(dev, smi, kind, sizes, phase6)
    log(f"[sharded] summary: {json.dumps(sharded)}")
    benches = bench_phases(dev, smi, kind, sizes)
    log(f"[bench] summary: {json.dumps(benches)}")
    phase22 = device_loop_phases(dev, smi, kind, sizes, time_ms)
    log(f"[loop] summary: {json.dumps({k: v for k, v in phase22.items() if k != 'entry'})}")
    phase23 = cpd_loop_phases(dev, smi, kind, sizes, time_ms)
    log(f"[cpd-loop] summary: {json.dumps({k: v for k, v in phase23.items() if k != 'entries'})}")
    # K4's and K5's launches on the CPD device loop's runs, and those of
    # them that did no work (an unselected route, no fat block)
    for entry, key in zip(cpd_kernels, ("K4_denom", "K4_moments", "K5_denom", "K5_moments")):
        entry["launches_device_loop"] = phase23["launches"][key]
        entry["launches_skipped_device_loop"] = phase23["launches"][f"{key} skipped"]
    per_pair = slice8["sequence"]["scan seeded"]["launches_per_pair"]
    for entry, name in zip(cpd_kernels[:2], ("denom", "moments")):
        entry["launches_per_batched_iter"] = slice8["k4"]["launches_per_batched_iter"]
        entry["ms_batch_form"] = slice8["k4"]["ms_batch"][name]
        entry["bound_ms_batch_form"] = slice8["k4"]["bound"][name]["bound_ms"]
        entry["batch_form_shape"] = slice8["k4"]["shape"]
        entry["max_abs_err_batch_form"] = slice8["k4"]["max_abs_err_batch"][name]
    # K5 on the pair-axis loop: the slow phase of clouds of CAND_MIN_ROWS rows or more
    for entry, k in zip(cpd_kernels[2:4], range(2)):
        entry["launches_pair_axis"] = {
            name: v["k5_launches"][k] for name, v in slice8["pair_cpd"].items()}

    kernels = [
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
            "launches_skipped": launches["K1 skipped"],
            "launches_skipped_per_iter": per_iter["K1 skipped"],
            "launches_per_sequence_pair": per_pair["K1"],
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
            "launches_per_sequence_pair": per_pair["K2"],
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
            "launches_skipped": launches["K3 skipped"],
            "launches_skipped_per_iter": per_iter["K3 skipped"],
            "launches_per_sequence_pair": per_pair["K3"],
        },
        *cpd_kernels,
        {**phase22["entry"], "launches": launches["P"],
         "launches_per_iter": per_iter["P"], "launches_per_sequence_pair": per_pair["P"]},
        # the error entry's main path is the ICP registration of phase 5
        *({**e, "launches": launches["P error"]} if e["name"] == "procrustes error (P)" else e
          for e in phase23["entries"]),
        plan_entry,
        *fgt_entries,
    ]
    for entry, key in zip(kernels, SHARD_KERNELS):
        entry["front_end_launches"] = front["launches"][entry["name"]]
        entry["launches_sharded"] = {world: counts[key]
                                     for world, counts in sharded["launches"].items()}
        entry["launches_bench"] = {name: counts[key]
                                   for name, counts in benches["launches"].items()}
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
