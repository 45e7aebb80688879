"""The sharded loops' chunks on the CPU: the device-resident sharded ICP
and CPD loops (``tpuslam_torch.parallel.icp`` and ``.cpd`` on
``algorithms/device_loop.py``) at ``LOOP_CHUNK`` = 2 against the same
loops at one iteration a chunk (``run_cases``' ``eager``), in gloo worlds
of 2 and 4 spawned CPU ranks.

On the CPU a chunk runs eagerly, frozen past the stop, with its
collectives; the card captures the same chunk as a CUDA graph (the card
tests in ``tests/test_torch_cuda.py``).  Every stop condition is met
inside a chunk where it can be: ICP's ``eps`` and its divergence guard
at the chunk's first iteration, an odd ``max_iterations``, none at all;
CPD's tolerance, ``sigma^2 <= eps`` and the Hybrid switch after an odd
count, ``max_iterations < 0``.  Tolerance: bit for bit, on every rank;
the sharded dense ICP equals the solo dense run bit for bit as well.
Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest

from tpuslam_torch.algorithms import device_loop
from tpuslam_torch.algorithms.icp import icp_register
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.data.synthesis import (
    get_random_rotation_matrix,
    get_random_translation_vector,
)
from tpuslam_torch.parallel.launch import run_cases, run_world

CPU = "cpu"
TIMEOUT = 60.0
WORLDS = (2, 4)
MAX_ICP = 50


def _moved(rng, n, angle, trans, noise=0.0, spread=10.0):
    before = (rng.random((n, 3)) * spread).astype(np.float32)
    after = before @ get_random_rotation_matrix(rng, angle).T + get_random_translation_vector(
        rng, trans)
    if noise:
        after = after + rng.normal(0.0, noise, after.shape)
    return before, after.astype(np.float32)[rng.permutation(n)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.Generator(np.random.PCG64(14))
    return {
        "icp_copy": _moved(rng, 400, 0.2, 1.0),
        "icp_noisy": _moved(rng, 400, 0.2, 1.0, noise=0.05),
        "cpd_copy": _moved(rng, 300, 0.2, 0.4, spread=5.0),
        "cpd_noisy": _moved(rng, 300, 0.2, 0.4, noise=0.02, spread=5.0),
        "icp_fine": _moved(rng, 400, 0.2, 1.0, noise=0.002),
    }


# name -> (cloud pair, loop settings)
ICP_STOPS = {
    # converges at the 5th iteration, the first of the third chunk
    "eps": ("icp_fine", dict(eps=1e-2, max_iterations=MAX_ICP)),
    "odd_cap": ("icp_copy", dict(eps=0.0, divergence_guard=False, max_iterations=5)),
    "guard": ("icp_noisy", dict(eps=1e-9, max_iterations=MAX_ICP)),
    "zero": ("icp_copy", dict(max_iterations=0)),
}
CPD_STOPS = {
    "tolerance": ("cpd_noisy", dict(weight=0.1, tolerance=3e-3, eps=1e-9, max_iterations=100)),
    "sigma2_eps": ("cpd_copy", dict(weight=0.1, tolerance=0.0, eps=1e-3, max_iterations=100)),
    "hybrid_fgt": ("cpd_copy", dict(weight=0.1, tolerance=1e-6, max_iterations=60,
                                    const_scale=True, use_fgt=True,
                                    approximation_type=ApproximationType.Hybrid)),
    "hybrid_exact": ("cpd_copy", dict(weight=0.1, tolerance=1e-6, max_iterations=60,
                                      const_scale=True, use_fgt=False,
                                      approximation_type=ApproximationType.Hybrid)),
    "negative": ("cpd_copy", dict(weight=0.1, max_iterations=-1)),
}


def _cases(d):
    """name -> (kind, kwargs): each stop as chunked and as eager."""
    cases = {}
    for arm in ("dense", "hier"):
        for stop, (pair, kw) in ICP_STOPS.items():
            b, a = d[pair]
            for eager in (False, True):
                cases[("icp", arm, stop, eager)] = (
                    "icp", dict(before=b, after=a, use_spatial=arm == "hier", eager=eager, **kw))
    for stop, (pair, kw) in CPD_STOPS.items():
        b, a = d[pair]
        for eager in (False, True):
            cases[("cpd", stop, eager)] = ("cpd", dict(before=b, after=a, eager=eager, **kw))
    return cases


@pytest.fixture(scope="module")
def worlds(data):
    """world size -> case name -> every rank's case record."""
    cases = _cases(data)
    out = {}
    for size in WORLDS:
        _, ranks = run_world(run_cases, size, "gloo", CPU, TIMEOUT, list(cases.values()))
        out[size] = {name: [r[i] for r in ranks] for i, name in enumerate(cases)}
    return out


KEYS = ("rotation", "translation", "scale", "iterations", "error")


def _equal(got: dict, want: dict, keys=KEYS) -> None:
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_on_ranks(recs) -> None:
    for rec in recs[1:]:
        _equal(rec["result"], recs[0]["result"])


@pytest.mark.parametrize("stop", list(ICP_STOPS))
@pytest.mark.parametrize("arm", ["dense", "hier"])
@pytest.mark.parametrize("size", WORLDS)
def test_sharded_icp_chunks_equal_one_iteration_loop(worlds, data, size, arm, stop):
    """Chunks of 2 against one iteration a chunk, bit for bit on every
    rank; each stop where the case puts it; the dense arm equal to the
    solo dense run."""
    chunked = worlds[size][("icp", arm, stop, False)]
    eager = worlds[size][("icp", arm, stop, True)]
    got, want = chunked[0]["result"], eager[0]["result"]
    _equal(got, want)
    _same_on_ranks(chunked)
    _same_on_ranks(eager)
    its, err = int(got["iterations"]), float(got["error"])
    kw = ICP_STOPS[stop][1]
    if stop == "eps":
        # converged at an odd iteration: the chunk's first, its second frozen
        assert err < kw["eps"] and its % device_loop.LOOP_CHUNK == 0 and its < MAX_ICP
    elif stop == "odd_cap":
        assert its == 5
    elif stop == "guard":
        assert err > kw["eps"] and its < MAX_ICP
    else:
        assert its == 0
    if arm == "dense":
        b, a = data[ICP_STOPS[stop][0]]
        solo = icp_register(pad_cloud(b, device=CPU), pad_cloud(a, device=CPU),
                            use_spatial=False, **kw)
        _equal(got, {"rotation": solo.transform.rotation.numpy(),
                     "translation": solo.transform.translation.numpy(),
                     "iterations": int(solo.iterations), "error": solo.error.numpy()},
               ("rotation", "translation", "iterations", "error"))


@pytest.mark.parametrize("stop", list(CPD_STOPS))
@pytest.mark.parametrize("size", WORLDS)
def test_sharded_cpd_chunks_equal_one_iteration_loop(worlds, size, stop):
    """Chunks of 2 against one iteration a chunk, bit for bit on every rank
    (the whole EM state and each iteration's E-step), each stop after an
    odd count of iterations (the Hybrid switch after an odd count of fast
    ones) where the case can put it."""
    chunked = worlds[size][("cpd", stop, False)]
    eager = worlds[size][("cpd", stop, True)]
    got, want = chunked[0]["result"], eager[0]["result"]
    _equal(got, want)
    for k in want["em"] if "em" in want else ():
        np.testing.assert_array_equal(got["em"][k], want["em"][k], err_msg=k)
    assert chunked[0]["phases"] == eager[0]["phases"]
    _same_on_ranks(chunked)
    _same_on_ranks(eager)
    its, phases = int(got["iterations"]), chunked[0]["phases"]
    kw = CPD_STOPS[stop][1]
    if stop == "negative":
        assert its == 0 and phases == []
        return
    assert its % device_loop.LOOP_CHUNK == 1 and its < kw["max_iterations"]
    if stop == "tolerance":
        assert float(got["em"]["ntol"]) <= kw["tolerance"]
    elif stop == "sigma2_eps":
        assert float(got["error"]) <= kw["eps"]
    else:
        fast = phases.count("fgt" if stop == "hybrid_fgt" else "exact")
        assert fast % device_loop.LOOP_CHUNK == 1 and phases.count("trunc") > 0
        assert phases == [phases[0]] * fast + ["trunc"] * (its - fast)
