"""ICP of the PyTorch port (``tpuslam_torch.algorithms.icp``) against
the JAX package's dense arm (``icp_register(use_spatial=False)``) on the
same clouds, one case per stop condition; and the hierarchical arm
(``use_spatial=True``) against the JAX package's, whose Morton order
both packages share, so Procrustes sums in the same order.

Tolerances, with their reasons: equal ``iterations``; R and t within
1e-4 — float32 sums in another order and torch's unfused transform
against XLA's contracted one (about 1e-6 per coordinate); the error
within 1e-4 relative, and 1e-9 absolute for runs whose error has fallen
to the float32 round-off of an exact alignment (about 1e-11), where only
the absolute bound means anything.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import make_cloud, random_rigid
from tpuslam.algorithms.icp import ICPResume as JaxResume
from tpuslam.algorithms.icp import icp_register as jax_icp_register
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms.icp import icp_register, resolve_use_spatial
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.interop import from_numpy_state, to_numpy_state

N = 2048


def _run_both(before, after, resume=None, **kw):
    jax_res = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=False,
        resume=resume, **kw
    )
    port_resume = None
    if resume is not None:
        port_resume = from_numpy_state(to_numpy_state(resume), "cpu")
    port_res = icp_register(
        pad_cloud(before), pad_cloud(after), resume=port_resume, **kw
    )
    return jax_res, port_res


def _assert_agree(jax_res, port_res):
    assert port_res.iterations == int(jax_res.iterations)
    np.testing.assert_allclose(
        port_res.transform.rotation.numpy(),
        np.asarray(jax_res.transform.rotation), rtol=0, atol=1e-4,
    )
    np.testing.assert_allclose(
        port_res.transform.translation.numpy(),
        np.asarray(jax_res.transform.translation), rtol=0, atol=1e-4,
    )
    np.testing.assert_allclose(
        float(port_res.error), float(jax_res.error), rtol=1e-4, atol=1e-9
    )


def _pair(rng, angle, trans, n=N, permute=True):
    before = make_cloud(rng, n)
    r, t = random_rigid(rng, angle, trans)
    after = (before @ r.T + t).astype(np.float32)
    if permute:
        after = after[rng.permutation(n)]
    return before, after, r, t


def test_recovers_small_transform(rng):
    before, after, r, t = _pair(rng, 0.2, 1.0)
    jax_res, port_res = _run_both(
        before, after, eps=1e-5, max_distance_squared=1e4, max_iterations=50
    )
    _assert_agree(jax_res, port_res)
    assert float(port_res.error) < 1e-5
    np.testing.assert_allclose(port_res.transform.rotation.numpy(), r, atol=1e-3)
    np.testing.assert_allclose(port_res.transform.translation.numpy(), t, atol=1e-3)


def test_identity_converges_immediately(rng):
    cloud = make_cloud(rng, N)
    jax_res, port_res = _run_both(cloud, cloud.copy(), eps=1e-4)
    _assert_agree(jax_res, port_res)
    assert port_res.iterations == 0  # error 0 < eps on the first step
    np.testing.assert_allclose(
        port_res.transform.rotation.numpy(), np.eye(3), rtol=0, atol=1e-5
    )


def test_respects_max_iterations(rng):
    before, after, _, _ = _pair(rng, 1.2, 8.0)  # far from converged in 3
    jax_res, port_res = _run_both(
        before, after, eps=1e-12, max_iterations=3, divergence_guard=False
    )
    _assert_agree(jax_res, port_res)
    assert port_res.iterations == 3


def test_unbounded_iterations_run_to_eps(rng):
    before, after, _, _ = _pair(rng, 0.2, 1.0)
    jax_res, port_res = _run_both(
        before, after, eps=1e-5, max_distance_squared=1e4, max_iterations=-1
    )
    _assert_agree(jax_res, port_res)
    assert 0 < port_res.iterations < 50


def test_zero_correspondences_stops(rng):
    cloud = make_cloud(rng, N)
    jax_res, port_res = _run_both(
        cloud, cloud + 1000.0, eps=1e-6, max_distance_squared=1.0,
        max_iterations=10,
    )
    _assert_agree(jax_res, port_res)
    assert port_res.iterations == 0
    assert float(port_res.error) == pytest.approx(1e5)  # initial sentinel
    np.testing.assert_array_equal(port_res.transform.rotation.numpy(), np.eye(3))


def test_divergence_guard_reverts(rng):
    # gated correspondences: as more points come within the gate the mean
    # error rises, the guard stops the loop and keeps the last accepted
    # transform — the one a run capped at that many iterations ends with
    before, after, _, _ = _pair(rng, 0.8, 3.0)
    kw = dict(eps=1e-12, max_distance_squared=1.0)
    jax_res, port_res = _run_both(before, after, max_iterations=40, **kw)
    _assert_agree(jax_res, port_res)
    assert 0 < port_res.iterations < 40  # stopped by the guard, not the cap
    capped = icp_register(
        pad_cloud(before), pad_cloud(after),
        max_iterations=port_res.iterations, **kw
    )
    assert torch.equal(capped.transform.rotation, port_res.transform.rotation)
    assert torch.equal(capped.error, port_res.error)
    unguarded = icp_register(
        pad_cloud(before), pad_cloud(after), max_iterations=40,
        divergence_guard=False, **kw
    )
    assert unguarded.iterations == 40


def test_nan_input_terminates(rng):
    before = np.full((100, 3), np.nan, dtype=np.float32)
    after = make_cloud(rng, 100)
    jax_res, port_res = _run_both(before, after, max_iterations=-1)
    assert port_res.iterations == int(jax_res.iterations) == 0
    assert float(port_res.error) == float(jax_res.error) == 1e5
    np.testing.assert_array_equal(port_res.transform.rotation.numpy(), np.eye(3))


def test_non_finite_error_reverts_to_last_accepted(rng):
    pts = make_cloud(rng, 100)
    pts[3] = np.nan
    jax_res, port_res = _run_both(
        pts, make_cloud(rng, 100), eps=0.0, max_distance_squared=1e18,
        max_iterations=5, divergence_guard=False,
    )
    _assert_agree(jax_res, port_res)
    assert port_res.iterations == 0
    assert np.isfinite(float(port_res.error))


def test_patience_best_so_far(rng):
    # guard off, eps 0, gated correspondences: the error rises as points
    # enter the gate, and the loop stops after 4 steps in a row that do not
    # beat the best error, returning the best state.  (Near an exact
    # alignment the same stop would be decided by float32 round-off.)
    before, after, _, _ = _pair(rng, 0.8, 3.0)
    jax_res, port_res = _run_both(
        before, after, eps=0.0, max_distance_squared=1.0, max_iterations=60,
        divergence_guard=False, patience=4,
    )
    _assert_agree(jax_res, port_res)
    assert 4 <= port_res.iterations < 60


def test_patience_zero_iterations_reports_carried_error(rng):
    before, after, _, _ = _pair(rng, 0.3, 2.0, n=256)
    jax_res, port_res = _run_both(
        before, after, max_iterations=0, divergence_guard=False, patience=4,
    )
    _assert_agree(jax_res, port_res)
    assert float(port_res.error) == 1e5


def test_resume_from_jax_mid_run_state(rng):
    before, after, _, _ = _pair(rng, 0.4, 3.0)
    kw = dict(eps=1e-7, max_distance_squared=1e4)
    first = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=False,
        max_iterations=3, **kw,
    )
    assert int(first.iterations) == 3
    resume = JaxResume(
        rotation=first.transform.rotation,
        translation=first.transform.translation,
        error=first.error,
        done_before=jnp.int32(3),
    )
    jax_res, port_res = _run_both(
        before, after, resume=resume, max_iterations=47, **kw
    )
    _assert_agree(jax_res, port_res)
    whole = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=False,
        max_iterations=50, **kw,
    )
    assert port_res.iterations + 3 == int(whole.iterations)


def test_verbose_prints_each_iteration(rng, capsys):
    before, after, _, _ = _pair(rng, 0.1, 0.5, n=256)
    res = icp_register(
        pad_cloud(before), pad_cloud(after), max_iterations=3,
        eps=0.0, divergence_guard=False, verbose=True,
    )
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == [
        "loop_nr 1", "loop_nr 2", "loop_nr 3"
    ]
    assert res.iterations == 3


def test_clouds_on_two_devices_raise(rng):
    cloud = pad_cloud(make_cloud(rng, 128))
    other = cloud._replace(points=cloud.points.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        icp_register(cloud, other)


@pytest.mark.parametrize("n", [1500, 1900])
def test_spatial_arm_matches_jax_spatial_arm(rng, n):
    """n = 1500 pads to 1536 and n = 1900 to 1920, neither a multiple of
    the 1,024-row source groups: both packages re-pad internally."""
    before, after, _, _ = _pair(rng, 0.2, 1.0, n=n)
    kw = dict(max_iterations=25)
    jax_res = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=True, **kw)
    port_res = icp_register(pad_cloud(before), pad_cloud(after), use_spatial=True, **kw)
    _assert_agree(jax_res, port_res)
    assert port_res.nn is not None and bool(port_res.nn.warm)
    assert port_res.nn.prev_target.shape == (2048, 3)
    dense = icp_register(pad_cloud(before), pad_cloud(after), use_spatial=False, **kw)
    assert dense.nn is None
    assert abs(dense.iterations - port_res.iterations) <= 2


def test_spatial_resume_from_jax_mid_run_state(rng):
    """A JAX spatial run stopped after 3 iterations, resumed in both
    packages from its warm state, carried across by ``interop``."""
    before, after, _, _ = _pair(rng, 0.3, 2.0, n=1900)
    kw = dict(eps=1e-7, max_distance_squared=1e4)
    first = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=True,
        max_iterations=3, **kw)
    assert int(first.iterations) == 3 and first.nn is not None
    resume = JaxResume(
        rotation=first.transform.rotation,
        translation=first.transform.translation,
        error=first.error, nn=first.nn, done_before=3,
    )
    state = to_numpy_state(resume)
    assert set(state["nn"]) == {"prev_target", "warm", "sparse"}
    port_resume = from_numpy_state(state, "cpu")
    np.testing.assert_array_equal(
        port_resume.nn.prev_target.numpy(), np.asarray(first.nn.prev_target))
    assert bool(port_resume.nn.warm) and port_resume.done_before == 3
    jax_res = jax_icp_register(
        jax_pad_cloud(before), jax_pad_cloud(after), use_spatial=True,
        resume=resume, max_iterations=30, **kw)
    port_res = icp_register(
        pad_cloud(before), pad_cloud(after), use_spatial=True,
        resume=port_resume, max_iterations=30, **kw)
    _assert_agree(jax_res, port_res)


def test_hier_state_round_trip(rng):
    from tpuslam_torch.ops.nn_hier import HierState

    state = HierState(
        prev_target=torch.from_numpy(make_cloud(rng, 256)),
        warm=torch.tensor(True), sparse=torch.tensor(False),
    )
    back = from_numpy_state(to_numpy_state(state), "cpu")
    assert isinstance(back, HierState)
    assert torch.equal(back.prev_target, state.prev_target)
    assert bool(back.warm) and not bool(back.sparse)


@pytest.mark.parametrize("use_spatial,rows,device,expected", [
    (None, 102_400, "cpu", False),  # the CPU is the dense arm, as in JAX
    (None, 8191, "cuda", False),  # below the crossover
    (None, 8192, "cuda", True),
    (None, 102_400, "cuda:0", True),
    (None, 2**24 - 256, "cuda", True),  # the float32 index limit
    (None, 2**24 - 255, "cuda", False),
    (True, 128, "cpu", True),  # an explicit choice stands
    (False, 102_400, "cuda", False),
])
def test_resolve_use_spatial_gate(use_spatial, rows, device, expected):
    assert resolve_use_spatial(use_spatial, rows, torch.device(device)) is expected


def test_spatial_arm_refuses_2_24_target_rows():
    big = pad_cloud(np.zeros((2**24, 3), np.float32))
    small = pad_cloud(np.zeros((1024, 3), np.float32))
    with pytest.raises(ValueError, match="2\\^24"):
        icp_register(small, big, use_spatial=True)


@pytest.mark.parametrize("use_spatial,arm", [(None, "dense"), (True, "hier"), (False, "dense")])
def test_measure_icp_use_spatial(use_spatial, arm):
    from tpuslam_torch.harness.measure import measure_icp_100k

    res = measure_icp_100k(n_points=1024, iters=2, reps=1, device="cpu",
                           use_spatial=use_spatial)
    assert res["nn_arm"] == arm
    assert res["iterations_run"] == 2 and res["n_points"] == 1024
    assert res["ms_per_iter"] > 0 and res["device"] == "cpu"
