#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpuslam_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed as it ends; the first failure raises and the script
exits non-zero without printing a result:

1. device — the card's name and power limit (nvidia-smi) and torch's view;
2. build — kernel K1 (``tpuslam_torch/csrc/nn_dense.cu``) from source;
3. K1 against its plain PyTorch version on the card, bit for bit (idx and
   dist equal; tolerance 0): the 102,400 x 102,400 headline pair, a
   ragged count, planted ties, count 0 and a batch of two; then K1's and
   the plain version's times at 102,400 x 102,400;
4. the slice — ``tpuslam_torch.register`` on a 102,400-point uniform box
   moved by a known motion (0.1 rad, 0.5); K1 must have been launched,
   the error must be finite and the rotation within 1 degree of the
   truth; then one 8,192-point registration on the CPU (plain version)
   and on the card (K1), whose R and t must agree within 1e-4;
5. headline — ``measure_icp_100k()`` on the 100k protocol.

The last lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import tpuslam_torch
    from tpuslam_torch.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )
    from tpuslam_torch.harness.measure import build_headline_pair, measure_icp_100k
    from tpuslam_torch.kernels import build, nn_dense

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind}, {torch.cuda.device_count()} device(s)")

    # 2. build ----------------------------------------------------------------
    build.build(force=True)
    log(f"[build] K1 built by nvcc in {build.last_build['seconds']:.3f} s "
        f"-> {build.last_build['path']}")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    build.load_library()

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

    cb, ca = build_headline_pair(device=dev)
    src, tgt, count = cb.points[None], ca.points[None], ca.count.reshape(1)
    errs = [compare("headline 102400", src, tgt, count)[2]]
    ragged = torch.tensor([77_777], dtype=torch.int32, device=dev)
    errs.append(compare("ragged count 77777", src, tgt, ragged)[2])
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

    plain_ms = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_ref(src, tgt, count), 3)
    k1_ms = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, count), 20)
    plain_ms_2 = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_ref(src, tgt, count), 3)
    k1_ms_2 = time_ms(
        lambda: nn_dense.nearest_neighbors_dense_batch(src, tgt, count), 20)
    log(f"[k1] time at 102400 x 102400 on {smi}: K1 {k1_ms:.4f} / "
        f"{k1_ms_2:.4f} ms, plain {plain_ms:.3f} / {plain_ms_2:.3f} ms")

    # 4. the slice --------------------------------------------------------------
    n = 102_400
    rng = np.random.Generator(np.random.PCG64(2024))
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.1)
    t_true = get_random_translation_vector(rng, 0.5)
    after = (before @ r_true.T + t_true).astype(np.float32)[rng.permutation(n)]
    nn_dense.LAUNCHES = 0
    t0 = time.perf_counter()
    rot, trans, iters, err = tpuslam_torch.register(
        before, after, device=dev, max_iterations=100
    )
    wall = time.perf_counter() - t0
    launches = nn_dense.LAUNCHES
    cos = (np.trace(rot.astype(np.float64).T @ r_true.astype(np.float64)) - 1) / 2
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    log(f"[slice] register 102400-point uniform box on {kind}: {iters} "
        f"iterations, error {err}, rotation off by {angle} deg, translation "
        f"off by {float(np.abs(trans - t_true).max())}, K1 launches {launches}, "
        f"{wall:.3f} s")
    check(launches > 0, "the registration did not launch K1")
    check(rot.shape == (3, 3) and trans.shape == (3,), "result shapes")
    check(bool(np.isfinite(rot).all() and np.isfinite(trans).all()),
          "non-finite transform")
    check(bool(np.isfinite(err)), "non-finite error")
    check(angle < 1.0, f"rotation {angle} deg from the truth")

    n_small = 8192
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
    log(f"[slice] 8192 points, CPU (plain) vs card (K1): iterations "
        f"{on_cpu[2]} / {on_card[2]}, |dR| {d_rot}, |dt| {d_trans}, "
        f"error {on_cpu[3]} / {on_card[3]}")
    check(d_rot <= 1e-4 and d_trans <= 1e-4, "CPU and card disagree")

    # 5. headline -----------------------------------------------------------------
    headline = measure_icp_100k(device=dev)
    headline["nvidia_smi"] = smi
    log(f"[headline] {json.dumps(headline)}")
    check(headline["iterations_run"] == headline["iters_per_call"],
          "the headline run stopped early")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "nn_dense (K1)",
        "route": "cuda",
        "source": "tpuslam_torch/csrc/nn_dense.cu",
        "replaces": "tpuslam/kernels/pallas_nn.py:116",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
