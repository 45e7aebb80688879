"""CPD of the PyTorch port (``tpuslam_torch.algorithms.cpd``) against the
JAX package's ``tpuslam.algorithms.cpd`` on the same inputs: its pieces
(sigma^2 init, uniform constant, E-step oracle, M-step, Hybrid switch),
whole registrations in the None, Full and Hybrid modes on the default
CPU path and on the kernel path (``use_kernels=True``, the plain versions
of K4 and K5, against ``use_pallas=True`` in interpret mode), and the
entry point ``register(..., computation_method=Cpd)``.

Tolerances, with their reasons: pieces within 1e-5 relative (float32 sums
in another order); registrations with equal iterations, R and t within
1e-4 (as ICP's parity tests), and the final sigma^2 within 1e-6 of
sigma^2_0: near convergence sigma^2 is a difference of nearly equal
sums, so its relative error is large while R and t agree to ~1e-7;
FGT runs stopped mid-way add 1e-3 relative on sigma^2 (the expansions
round differently, and 40 iterations compound it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuslam
import tpuslam_torch
from tests.conftest import random_rigid
from tpuslam.algorithms import cpd as jcpd
from tpuslam.config.configuration import ApproximationType as JaxApprox
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms import cpd
from tpuslam_torch.config.configuration import ApproximationType, ComputationMethod
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.interop import from_numpy_state, to_numpy_state
from tpuslam_torch.kernels import cpd_cand

MODES = {"none": (ApproximationType.NONE, JaxApprox.NONE),
         "full": (ApproximationType.Full, JaxApprox.Full),
         "hybrid": (ApproximationType.Hybrid, JaxApprox.Hybrid)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(rng, n=300, angle=0.25, trans=0.5, spread=6.0):
    before = (rng.random((n, 3)) * spread - spread / 2).astype(np.float32)
    r, t = random_rigid(rng, angle=angle, trans=trans)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    return before, after, r, t


def _sigma2_0(before, after):
    cb, ca = jax_pad_cloud(before), jax_pad_cloud(after)
    return float(jcpd.sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask()))


def _assert_agree(port, ref, sigma2_0, sigma2_rtol=0.0, t_atol=1e-4):
    assert port.iterations == int(ref.iterations)
    np.testing.assert_allclose(port.transform.rotation.numpy(),
                               np.asarray(ref.transform.rotation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.transform.translation.numpy(),
                               np.asarray(ref.transform.translation), rtol=0, atol=t_atol)
    np.testing.assert_allclose(float(port.transform.scale),
                               float(ref.transform.scale), rtol=0, atol=1e-4)
    assert (abs(float(port.error) - float(ref.error))
            <= 1e-6 * sigma2_0 + sigma2_rtol * abs(float(ref.error)))


def _run_both(before, after, mode, use_kernels=None, multiple=128, resume=None, **kw):
    approx, japprox = MODES[mode]
    ref = jcpd.cpd_register(
        jax_pad_cloud(before, multiple=multiple), jax_pad_cloud(after, multiple=multiple),
        approximation_type=japprox, use_pallas=use_kernels, resume=resume, **kw)
    port_resume = None if resume is None else from_numpy_state(to_numpy_state(resume), "cpu")
    port = cpd.cpd_register(
        pad_cloud(before, multiple=multiple), pad_cloud(after, multiple=multiple),
        approximation_type=approx, use_kernels=use_kernels, resume=port_resume, **kw)
    return port, ref


def test_sigma2_init_and_uniform_constant_match_jax(rng):
    before, after, _, _ = _pair(rng, n=200)
    cb, ca = jax_pad_cloud(before[:150]), jax_pad_cloud(after)
    want = jcpd.sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask())
    got = cpd.sigma_squared_init(_t(cb.points), _t(cb.mask()), _t(ca.points), _t(ca.mask()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    c_j = jcpd.uniform_constant(want, jnp.float32(0.1), jnp.float32(150), jnp.float32(200))
    c = cpd.uniform_constant(got, torch.tensor(0.1), torch.tensor(150.0), torch.tensor(200.0))
    np.testing.assert_allclose(float(c), float(c_j), rtol=1e-5)


@pytest.mark.parametrize("truncate", [False, True])
def test_estep_oracle_matches_jax(rng, truncate):
    before, after, _, _ = _pair(rng, n=96)
    cb, ca = jax_pad_cloud(before), jax_pad_cloud(after[:80])
    s2 = jcpd.sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask()) * 0.05
    c = jcpd.uniform_constant(s2, jnp.float32(0.3), jnp.float32(96), jnp.float32(80))
    args = (cb.points, cb.mask(), ca.points, ca.mask(), s2, c, jnp.asarray(truncate))
    want = jcpd.cpd_estep(*args)
    got = cpd.cpd_estep(*(_t(a) for a in args))
    for f in ("p1", "pt1", "px"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-5)
    auto = cpd.cpd_estep_auto(*(_t(a) for a in args))  # the oracle on the CPU
    assert torch.equal(auto.px, got.px)


@pytest.mark.parametrize("const_scale", [False, True])
def test_mstep_matches_jax(rng, const_scale):
    before, after, _, _ = _pair(rng, n=128)
    cb, ca = jax_pad_cloud(before), jax_pad_cloud(after)
    s2 = jcpd.sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask())
    c = jcpd.uniform_constant(s2, jnp.float32(0.1), jnp.float32(128), jnp.float32(128))
    stats = jcpd.cpd_estep(cb.points, cb.mask(), ca.points, ca.mask(), s2 * 0.1, c,
                           jnp.asarray(False))
    want = jcpd.cpd_mstep(cb.points, ca.points, stats, const_scale, jnp.float32(1.0))
    port_stats = from_numpy_state(to_numpy_state(stats), "cpu")
    got = cpd.cpd_mstep(_t(cb.points), _t(ca.points), port_stats, const_scale,
                        torch.tensor(1.0))
    for f in ("rotation", "translation", "scale", "sigma2"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("centroid_init", [False, True])
def test_hybrid_fast_threshold_matches_jax(rng, centroid_init):
    before = (rng.random((300, 3)) * 6.0).astype(np.float32)
    after = (before[rng.permutation(300)] + 0.5).astype(np.float32)
    want = jcpd.hybrid_fast_threshold(jax_pad_cloud(before), jax_pad_cloud(after),
                                      centroid_init=centroid_init)
    got = cpd.hybrid_fast_threshold(pad_cloud(before), pad_cloud(after),
                                    centroid_init=centroid_init)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("mode,use_fgt", [
    ("none", None), ("full", None), ("hybrid", None), ("full", True), ("hybrid", True),
])
def test_register_default_path_matches_jax(rng, mode, use_fgt):
    """The CPU default: the blocked oracle, and the FGT where asked."""
    before, after, r, t = _pair(rng)
    kw = dict(weight=0.1, max_iterations=40 if use_fgt else 150, tolerance=1e-6,
              use_fgt=use_fgt, fgt_k=64)
    port, ref = _run_both(before, after, mode, **kw)
    _assert_agree(port, ref, _sigma2_0(before, after), 1e-3 if use_fgt else 0.0)
    if mode != "full":  # Full floors sigma^2 at 0.05 and stops short of the optimum
        np.testing.assert_allclose(port.transform.rotation.numpy(), r, atol=2e-3)


@pytest.mark.parametrize("mode", ["none", "hybrid"])
def test_register_kernel_path_matches_jax_pallas(rng, mode):
    """``use_kernels=True`` (Morton-sorted clouds, K5 routing to K4, their
    plain versions) against ``use_pallas=True`` (interpret mode), resumed
    near the truth with a sigma^2 below the Hybrid switch, so the Hybrid
    run's slow phase runs truncated through K5; the exact mode goes
    straight to K4 (no admission, route "k4")."""
    before, after, r, t = _pair(rng, n=2500, spread=10.0)
    assert 0.02 < 0.015 * _sigma2_0(before, after)
    resume = jcpd.CPDResume(jnp.asarray(r, jnp.float32), jnp.asarray(t + 0.01, jnp.float32),
                            jnp.float32(1.0), jnp.float32(0.02), jnp.float32(0.0),
                            jnp.float32(11.0), done_before=0)
    kw = dict(weight=0.1, max_iterations=3, tolerance=1e-9, use_fgt=False)
    launches, calls = cpd_cand.DENOM_LAUNCHES, len(_CAND_CALLS)
    cpd_cand.ROUTE_TRACE.clear()
    port, ref = _run_both(before, after, mode, use_kernels=True, resume=resume, **kw)
    _assert_agree(port, ref, _sigma2_0(before, after))
    assert cpd_cand.DENOM_LAUNCHES == launches  # the CPU launches nothing
    if mode == "hybrid":
        assert len(_CAND_CALLS) > calls  # K5's plain version ran
        assert "k5" in cpd_cand.ROUTE_TRACE
    else:
        assert len(_CAND_CALLS) == calls and set(cpd_cand.ROUTE_TRACE) == {"k4"}


_CAND_CALLS = []


@pytest.fixture(autouse=True)
def _spy_cand_ref(monkeypatch):
    orig = cpd_cand.denom_cand_ref

    def spy(*args):
        _CAND_CALLS.append(1)
        return orig(*args)

    monkeypatch.setattr(cpd_cand, "denom_cand_ref", spy)


def test_register_kernel_path_full_run(rng):
    """A whole short Hybrid run on the kernel path against the JAX
    package's Pallas path, both from the identity (fast phase only)."""
    before, after, _, _ = _pair(rng, n=2100, spread=10.0)
    port, ref = _run_both(before, after, "hybrid", use_kernels=True, weight=0.1,
                          max_iterations=4, tolerance=1e-9, use_fgt=False)
    _assert_agree(port, ref, _sigma2_0(before, after))


def test_zero_iterations_for_minus_one(rng):
    before, after, _, _ = _pair(rng, n=100)
    port, ref = _run_both(before, after, "none", max_iterations=-1)
    assert port.iterations == 0 == int(ref.iterations)
    assert torch.equal(port.transform.rotation, torch.eye(3))
    assert torch.equal(port.transform.translation, torch.zeros(3))
    assert float(port.error) == pytest.approx(float(ref.error), rel=1e-6)


def test_const_scale_matches_jax(rng):
    before, after, _, _ = _pair(rng, n=200)
    port, ref = _run_both(before, after, "none", weight=0.1, const_scale=True,
                          max_iterations=50)
    assert float(port.transform.scale) == 1.0
    _assert_agree(port, ref, _sigma2_0(before, after))


def test_centroid_init_matches_jax(rng):
    """Free scale at a large translation: the identity start collapses the
    scale (both packages), the centroid start recovers the motion."""
    before = (rng.random((300, 3)) * 10.0).astype(np.float32)
    r, _ = random_rigid(rng, angle=0.3, trans=0.0)
    t = np.array([30.0, -18.0, 22.0], np.float32)
    after = (before @ r.T + t).astype(np.float32)
    kw = dict(weight=0.1, max_iterations=150, tolerance=1e-5)
    collapsed, ref_c = _run_both(before, after, "none", **kw)
    # a degenerate optimum: the rotation is ill-conditioned there
    assert float(collapsed.transform.scale) < 0.1 and float(ref_c.transform.scale) < 0.1
    # a fixed count of iterations: the rescued run ends where sigma^2
    # crosses eps, and the iteration that crosses it is too close to call
    kw.update(eps=0.0, tolerance=0.0, max_iterations=60)
    rescued, ref_r = _run_both(before, after, "none", centroid_init=True, **kw)
    assert float(rescued.transform.scale) == pytest.approx(1.0, abs=0.01)
    np.testing.assert_allclose(rescued.transform.rotation.numpy(), r, atol=0.02)
    # t near (30, -18, 22) after sigma^2 reaches float32 noise: 1e-3, ~2e-5
    # relative to |t|
    _assert_agree(rescued, ref_r, _sigma2_0(before, after), t_atol=1e-3)


def test_padding_invariance(rng):
    before, after, _, _ = _pair(rng, n=150)
    a = cpd.cpd_register(pad_cloud(before, multiple=128), pad_cloud(after, multiple=128),
                         weight=0.1, max_iterations=30)
    b = cpd.cpd_register(pad_cloud(before, multiple=512), pad_cloud(after, multiple=512),
                         weight=0.1, max_iterations=30)
    assert a.iterations == b.iterations
    np.testing.assert_allclose(a.transform.rotation.numpy(), b.transform.rotation.numpy(),
                               atol=1e-4)


def test_history_ring_matches_jax(rng):
    """The history is a true ring: iteration i lands in slot i % length, so
    a run longer than the ring keeps its latest iterations; the rows agree
    with the JAX package's."""
    before, after, _, _ = _pair(rng, n=150)
    kw = dict(weight=0.1, max_iterations=12, tolerance=0.0, record_history=True)
    full, ref = _run_both(before, after, "none", history_length=64, **kw)
    ring = cpd.cpd_register(pad_cloud(before), pad_cloud(after), approximation_type=
                            ApproximationType.NONE, history_length=8, **kw)
    assert full.iterations == ring.iterations == 12
    assert full.history.shape == (64, 4)
    assert torch.all(torch.isnan(full.history[12:]))
    for i in range(4, 12):
        assert torch.equal(ring.history[i % 8], full.history[i])
    assert float(full.history[11, 0]) == float(full.error)
    np.testing.assert_allclose(full.history[:12, 3].numpy(), np.asarray(ref.history)[:12, 3],
                               atol=1e-5)
    np.testing.assert_allclose(full.history[:12, 0].numpy(), np.asarray(ref.history)[:12, 0],
                               rtol=1e-4, atol=1e-6 * _sigma2_0(before, after))


def test_resume_from_jax_state_matches_jax(rng):
    """Both packages continue from the JAX package's mid-run EM state."""
    before, after, _, _ = _pair(rng)
    first = jcpd.cpd_register(jax_pad_cloud(before), jax_pad_cloud(after), weight=0.1,
                              max_iterations=5, tolerance=1e-6)
    s = first.em
    resume = jcpd.CPDResume(s.rotation, s.translation, s.scale, s.sigma2,
                            s.log_likelihood, s.ntol, done_before=5)
    port, ref = _run_both(before, after, "none", resume=resume, weight=0.1,
                          max_iterations=30, tolerance=1e-6)
    _assert_agree(port, ref, _sigma2_0(before, after))


def test_verbose_prints_reference_trace(rng, capsys):
    before, after, _, _ = _pair(rng, n=100)
    resume = cpd.CPDResume(torch.eye(3), torch.zeros(3), torch.tensor(1.0),
                           torch.tensor(1.0), torch.tensor(0.0), torch.tensor(11.0),
                           done_before=7)
    cpd.cpd_register(pad_cloud(before), pad_cloud(after), max_iterations=3,
                     tolerance=0.0, verbose=True, resume=resume)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == ["loop_nr 8", "loop_nr 9", "loop_nr 10"]
    assert all(ln.split(", error: ")[1] for ln in lines)


def test_register_entry_point_matches_jax(rng):
    before, after, r, _ = _pair(rng, n=400)
    kw = dict(computation_method=ComputationMethod.Cpd, max_iterations=100,
              cpd_weight=0.1, cpd_tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid)
    ours = tpuslam_torch.register(before, after, device="cpu", **kw)
    jkw = dict(kw, computation_method=tpuslam.ComputationMethod.Cpd,
               approximation_type=JaxApprox.Hybrid)
    ref = tpuslam.register(before, after, **jkw)
    rot, trans, iters, err = ours
    assert iters == int(ref[2])
    np.testing.assert_allclose(rot, np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(ref[1]), rtol=0, atol=1e-4)
    assert abs(err - float(ref[3])) <= 1e-6 * _sigma2_0(before, after)
    assert rot.dtype == trans.dtype == np.float32
    np.testing.assert_allclose(rot, r, atol=2e-3)
    # a missing max-iterations runs zero iterations: identity
    none = tpuslam_torch.register(before, after, device="cpu", computation_method=
                                  ComputationMethod.Cpd)
    assert none[2] == 0 and np.array_equal(none[0], np.eye(3, dtype=np.float32))


def test_checkpointing_raises(rng, monkeypatch, tmp_path):
    monkeypatch.setenv("TPUSLAM_CPD_CKPT", str(tmp_path / "ckpt"))
    before, _, _, _ = _pair(rng, n=64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tpuslam_torch.register(before, before, device="cpu",
                               computation_method=ComputationMethod.Cpd, max_iterations=5)


def test_interop_round_trips(rng):
    before, after, _, _ = _pair(rng, n=100)
    res = jcpd.cpd_register(jax_pad_cloud(before), jax_pad_cloud(after), weight=0.1,
                            max_iterations=4)
    state = from_numpy_state(to_numpy_state(res.em), "cpu")
    assert isinstance(state, cpd.CPDState) and state.iterations == 4
    again = to_numpy_state(state)
    for k, v in to_numpy_state(res.em).items():
        np.testing.assert_array_equal(again[k], v)
    resume = from_numpy_state(to_numpy_state(jcpd.CPDResume(*res.em[:6], done_before=4)))
    assert isinstance(resume, cpd.CPDResume) and resume.done_before == 4
    from tpuslam.ops.fgt import compute_fgt_model

    model = compute_fgt_model(jnp.asarray(before), jnp.ones(100), jnp.float32(1.0), 8, 4)
    port_model = from_numpy_state(to_numpy_state(model))
    assert type(port_model).__name__ == "FGTModel"
    np.testing.assert_array_equal(port_model.ak.numpy(), np.asarray(model.ak))
    stats = from_numpy_state(to_numpy_state(jcpd.Sufficient(
        p1=jnp.ones(3), pt1=jnp.ones(2), px=jnp.ones((3, 3)), error=jnp.float32(2.0))))
    assert isinstance(stats, cpd.Sufficient) and float(stats.error) == 2.0
