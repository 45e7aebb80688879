"""The port's Fast Gauss Transform path against the benchmark's plain
reference (``regbench/reference/cpd.py``: exact E-steps, plain torch, no
JAX), on pairs made by the benchmark's own generator (``regbench/pool.py``)
with the ``cpd-conv`` configuration's settings, on the CPU.

Two comparisons, each with the bfloat16 reference held to the same
tolerances as a control that must fail them:

* one E-step, ``cpd_estep_fgt`` on clusterings made as a registration
  makes them (``k_center_ordered`` on the untransformed clouds, the
  moving centres moved with the pose), against the exact E-step with the
  FGT-mode constant, at three fast-phase sigma^2;
* whole Hybrid registrations through ``tpuslam_torch.register`` with the
  FGT forced on, against the reference's registration, by the numbers
  that decide a benchmark run's ``correct`` (``regbench/compare.py``).
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.algorithms.cpd import cpd_estep_fgt
from tpuslam_torch.config.configuration import Configuration
from tpuslam_torch.ops.fgt import k_center_ordered
from tpuslam_torch.ops.geometry import transform_points

# regbench/ on sys.path for its own imports, as regbench/tests/conftest.py
# puts it, and off again: left there, its tests/ would shadow this
# directory's for every test module imported after this one
BENCH = Path(__file__).resolve().parents[1] / "regbench"
sys.path.insert(0, str(BENCH))
try:
    import compare
    import harness
    import pool as pools
    from reference import cpd as ref_cpd
finally:
    sys.path.remove(str(BENCH))

CONFIG = json.loads((BENCH / "configs" / "cpd-conv.json").read_text())
CPU = torch.device("cpu")
SEED = 2**31 + 77
FGT_K = 128  # cpd_register's default number of centres
# the configuration leaves the FGT's order and far-field ratio at their
# defaults, 8 and 10
ORDER, RATIO = Configuration().order_of_truncation, Configuration().ratio_of_far_field

# One tolerance a sigma^2 (a fraction of sigma^2_0) for p1, pt1, px (the
# largest gap over the largest value) and L (relative).  The FGT's error
# grows as h = sqrt(2 sigma^2) shrinks against the clusters' radius: on
# three seeds at sigma^2_0 it is float32 rounding (<= 4.4e-7), at 0.2 and
# 0.05 the order-8 truncation (<= 3.4e-5 and <= 1.14e-3); each tolerance is
# 3.5 to 6 times that.  The bfloat16 reference reads >= 7.8e-3, >= 8.1e-3
# and >= 1.95e-2 at these points.  Nearer the Hybrid switch (0.015) the
# FGT's own gap (<= 1.4e-2 at 0.016) approaches bfloat16's (>= 1.5e-2), so
# no tolerance there would tell the two apart.
ESTEP_TOL = {1.0: 2e-6, 0.2: 2e-4, 0.05: 4e-3}

# Whole registrations, the numbers of regbench/compare.py.  CPD's end state
# swings by nature as sigma^2 collapses toward eps (PERF.md §2): on six
# pairs of 1,000 and 2,000 points the port read at most rot 0.17 deg, trans
# 5.4e-3, error_rel 1.63, iters 3; the bfloat16 reference at least 1.06
# deg, 0.108, 700 and 7.  Each limit lies between, with room on both sides.
REG_LIMITS = {"rot_deg": 1.0, "trans": 0.05, "error_rel": 30.0, "iters": 5}


def _pair(n: int, seed: int):
    return pools.pair(pools.make_pool(seed, n, 1, CONFIG["protocol"], CPU), seed, 0)


def _sigma2_0(y: torch.Tensor, x: torch.Tensor) -> float:
    y64, x64 = y.double(), x.double()
    m, n = len(y), len(x)
    return float((n * (y64 * y64).sum() + m * (x64 * x64).sum()
                  - 2.0 * y64.sum(0) @ x64.sum(0)) / (3.0 * m * n))


def _estep_gaps(p, frac: float, dtype) -> dict:
    """Each quantity's gap between the port's FGT E-step and the exact
    reference in float32 (``dtype`` None), or between the reference in
    ``dtype`` and in float32."""
    reg = CONFIG["registration"]
    y, x = torch.from_numpy(p.before), torch.from_numpy(p.after)
    m, n = len(y), len(x)
    # halfway along the true motion: the clusters' centres move with the pose
    r = torch.from_numpy(np.asarray(p.rotation, np.float32))
    t = torch.from_numpy(np.asarray(p.translation, np.float32)) * 0.5
    moved = transform_points(y, r, t)
    s0 = _sigma2_0(y, x)
    sigma2 = s0 * frac
    weight = reg["cpd_weight"]
    c = ref_cpd._constant(sigma2, weight, m, n)  # the FGT-mode constant
    want = ref_cpd.estep(moved, x, sigma2, c, truncate=False)
    if dtype is None:
        mask_y, mask_x = torch.ones(m), torch.ones(n)
        cy, iy, oy = k_center_ordered(y, mask_y, FGT_K)
        cx, ix, ox = k_center_ordered(x, mask_x, FGT_K)
        st = cpd_estep_fgt(
            moved, mask_y, x, mask_x, torch.tensor(sigma2), torch.tensor(weight),
            torch.tensor(float(m)), torch.tensor(float(n)), FGT_K, ORDER, RATIO,
            sigma2_init=torch.tensor(s0), clusters=(transform_points(cy, r, t), iy, cx, ix),
            orders=(oy, ox))
        got = (st.p1, st.pt1, st.px, float(st.error))
    else:
        got = ref_cpd.estep(moved.to(dtype), x.to(dtype), sigma2, c, truncate=False)

    def gap(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    return {"p1": gap(got[0], want[0]), "pt1": gap(got[1], want[1]),
            "px": gap(got[2], want[2]),
            "L": abs(float(got[3]) - want[3]) / abs(want[3])}


@pytest.fixture(scope="module")
def estep_pair():
    return _pair(2000, SEED)


@pytest.mark.parametrize("frac", list(ESTEP_TOL))
def test_fgt_estep_matches_the_exact_reference(estep_pair, frac):
    gaps = _estep_gaps(estep_pair, frac, None)
    assert max(gaps.values()) <= ESTEP_TOL[frac], gaps


@pytest.mark.parametrize("frac", list(ESTEP_TOL))
def test_the_bfloat16_reference_fails_the_estep_tolerance(estep_pair, frac):
    gaps = _estep_gaps(estep_pair, frac, torch.bfloat16)
    assert max(gaps.values()) > ESTEP_TOL[frac], gaps


def _fails(numbers: dict) -> list:
    return [k for k, lim in REG_LIMITS.items() if not numbers[k] <= lim]


@pytest.mark.parametrize("n,seed", [(1000, SEED), (2000, 3)])
def test_a_hybrid_registration_on_the_fgt_matches_the_reference(n, seed):
    p = _pair(n, seed)
    settings = dict(CONFIG["registration"], cpd_use_fgt=True)
    mine = harness.System(settings, CPU)(p.before, p.after)
    want = harness.reference(CONFIG, p.before, p.after, torch.float32, CPU)
    got = compare.numbers(mine, want)
    assert not _fails(got), got
    assert all(math.isfinite(v) for v in got.values())
    # the bfloat16 reference fails at least one limit on the same pair
    low = compare.numbers(
        harness.reference(CONFIG, p.before, p.after, torch.bfloat16, CPU), want)
    assert _fails(low), low
