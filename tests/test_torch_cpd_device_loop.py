"""The device-resident CPD loop of the PyTorch port
(``tpuslam_torch.algorithms.cpd._em_loop``) on the CPU.

The loop runs ``k`` EM iterations between host reads, freezing a
registration once it has stopped or, in Hybrid with the FGT, while its
phase is not the chunk's (the JAX ``while_loop``s' freeze).  Whatever
``k``, its result must be the one-iteration loop's bit for bit: equal
``iterations``, R, t, scale, sigma^2 and history ring (``torch.equal``,
tolerance 0, NaN equal to NaN in the ring) and equal ``PHASE_TRACE`` and
``ROUTE_TRACE`` (a frozen iteration's E-step is not booked).  Every mode
is covered (None, Full with and without the FGT, Hybrid with the FGT's
fast phase and with the exact kernel's), with the history ring, a
resumed run, a cap inside a chunk and a non-finite stop; the pair axis
gives each pair its solo bits; and chunked runs stay within the JAX
package's tolerances of ``test_torch_cpd.py`` (equal iterations, R and t
within 1e-4, sigma^2 within 1e-6 sigma^2_0).  The CUDA graph of a chunk
is a card matter (``test_torch_cuda.py``); here the same chunks run
eagerly, K5 reading its route on the host.

Cloud sizes stay at or below 2,048 rows (two of K4's 1,024-row blocks,
the least K5 can skip in), as the kernels' plain versions are slow.
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from tests.conftest import random_rigid
from tpuslam.algorithms import cpd as jcpd
from tpuslam.config.configuration import ApproximationType as JaxApprox
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms import cpd, device_loop
from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core import choices
from tpuslam_torch.core.types import Cloud, pad_cloud
from tpuslam_torch.kernels import cpd_cand

# the port runs on the card unless asked for the CPU; these tests ask
CPU = "cpu"
CHUNKS = (1, 2, 3, 5)
NONE, FULL, HYBRID = ApproximationType.NONE, ApproximationType.Full, ApproximationType.Hybrid


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextmanager
def _loop_chunk(k):
    saved = device_loop.LOOP_CHUNK
    device_loop.LOOP_CHUNK = k
    try:
        yield
    finally:
        device_loop.LOOP_CHUNK = saved


def _box(n, angle=0.25, trans=0.5, seed=0, spread=6.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    before = (rng.random((n, 3)) * spread - spread / 2).astype(np.float32)
    r, t = random_rigid(rng, angle=angle, trans=trans)
    return before, (before @ r.T + t)[rng.permutation(n)].astype(np.float32)


def _clusters(seed=0):
    """Two cubes of 1,024 points, the second 7 along every axis from the
    first, moved a little: each fills one of K4's blocks after the Morton
    sort, so K5's admission shrinks from both blocks (K4's route, early
    in the slow phase) to one (K5's) as sigma^2 falls."""
    rng = np.random.Generator(np.random.PCG64(seed))
    before = np.concatenate([rng.random((1024, 3)) * 4.0,
                             rng.random((1024, 3)) * 4.0 + 7.0]).astype(np.float32)
    r, t = random_rigid(rng, angle=0.05, trans=0.2)
    return before, (before @ r.T + t)[rng.permutation(2048)].astype(np.float32)


def _run(before, after, k, **kw):
    cpd.PHASE_TRACE.clear()
    cpd_cand.ROUTE_TRACE.clear()
    with _loop_chunk(k):
        res = cpd.cpd_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU), **kw)
    return res, list(cpd.PHASE_TRACE), list(cpd_cand.ROUTE_TRACE)


def _same(a, b):
    """Equal bits, NaN equal to NaN (a non-finite stop keeps NaN)."""
    assert int(a.iterations) == int(b.iterations)
    for x, y in ((a.transform.rotation, b.transform.rotation),
                 (a.transform.translation, b.transform.translation),
                 (a.transform.scale, b.transform.scale), (a.error, b.error),
                 (a.history, b.history)):
        if x is not None or y is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


CASES = {
    "none": (lambda: _box(300), dict(approximation_type=NONE, weight=0.1, tolerance=1e-6,
                                     max_iterations=40)),
    "none_kernels": (lambda: _box(300), dict(approximation_type=NONE, weight=0.1,
                                             max_iterations=6, use_kernels=True)),
    "full_fgt": (lambda: _box(200), dict(approximation_type=FULL, weight=0.1, use_fgt=True,
                                         fgt_k=16, max_iterations=8)),
    "full_exact": (lambda: _box(300), dict(approximation_type=FULL, weight=0.1, use_fgt=False,
                                           tolerance=1e-6, max_iterations=20)),
    "hybrid_fgt": (_clusters, dict(approximation_type=HYBRID, weight=0.1, use_fgt=True,
                                   fgt_k=16, use_kernels=True, tolerance=0.0, const_scale=True,
                                   max_iterations=6)),
    "hybrid_exact_kernel": (_clusters, dict(approximation_type=HYBRID, weight=0.1,
                                            use_fgt=False, use_kernels=True, tolerance=0.0,
                                            const_scale=True, max_iterations=6)),
    "history": (lambda: _box(250), dict(approximation_type=NONE, weight=0.1, tolerance=0.0,
                                        max_iterations=12, record_history=True,
                                        history_length=5)),
    "cap_inside_a_chunk": (lambda: _box(250), dict(approximation_type=HYBRID, weight=0.1,
                                                   tolerance=0.0, max_iterations=7)),
    # identical clouds: sigma^2 falls to 0 and the log-likelihood turns
    # NaN (eps and tolerance below any value, so only that stops it)
    "non_finite": (lambda: (_box(200)[0],) * 2, dict(approximation_type=NONE, weight=0.1,
                                                     eps=-1.0, tolerance=-1.0,
                                                     max_iterations=300)),
}
_REFERENCE = {}


@pytest.fixture
def _routes(monkeypatch):
    """K5's table one slot wide and one fat block served before the whole
    E-step routes to K4, so that two 1,024-row blocks show all three
    routes: K4 (both blocks fat), K5 with a fat block, K5 alone; and
    Hybrid's switch at half sigma^2_0, so that the slow phase comes
    within a few iterations."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 1)
    monkeypatch.setattr(cpd_cand, "FAT_MAX", 1)
    monkeypatch.setattr(cpd, "HYBRID_SWITCH", 0.5)


def _reference(case):
    if case not in _REFERENCE:
        make, kw = CASES[case]
        _REFERENCE[case] = _run(*make(), 1, **kw)
    return _REFERENCE[case]


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_cpd_loop_equals_one_iteration_loop(case, k, _routes):
    want, want_phases, want_routes = _reference(case)
    make, kw = CASES[case]
    got, phases, routes = _run(*make(), k, **kw)
    _same(got, want)
    assert phases == want_phases and routes == want_routes
    if case == "hybrid_fgt":
        assert "fgt" in phases and "trunc" in phases, phases
        assert "k4" in routes and "k5" in routes, routes
    if case == "hybrid_exact_kernel":
        assert "exact" in phases and "trunc" in phases, phases
    if case == "non_finite":
        assert int(got.iterations) < kw["max_iterations"]
        assert not torch.isfinite(got.em.log_likelihood)


@pytest.mark.parametrize("k", (2, 3))
def test_resumed_chunked_cpd_loop_equals_one_iteration_loop(k):
    before, after = _box(300, seed=3)
    kw = dict(approximation_type=HYBRID, weight=0.1, tolerance=0.0, max_iterations=5)
    first, _, _ = _run(before, after, 1, **kw)
    s = first.em
    resume = cpd.CPDResume(s.rotation, s.translation, s.scale, s.sigma2, s.log_likelihood,
                           s.ntol, done_before=5)
    kw.update(max_iterations=9, resume=resume, record_history=True, history_length=4)
    want, want_phases, _ = _run(before, after, 1, **kw)
    got, phases, _ = _run(before, after, k, **kw)
    _same(got, want)
    assert phases == want_phases
    # the ring numbers the resumed iterations from done_before
    assert torch.equal(got.history[5 % 4], want.history[5 % 4])


@pytest.mark.parametrize("k", (2, 5))
def test_chunked_driver_equals_whole_run(k):
    """``cpd_register_chunked`` through the same loop: each call's chunks
    carried across the driver's boundaries give the whole run's bits."""
    before, after = _box(300, seed=4)
    kw = dict(approximation_type=NONE, weight=0.1, tolerance=1e-6)
    whole, _, _ = _run(before, after, 1, max_iterations=30, **kw)
    with _loop_chunk(k):
        chunked = cpd.cpd_register_chunked(pad_cloud(before, device=CPU),
                                           pad_cloud(after, device=CPU), max_iterations=30,
                                           chunk=7, **kw)
    assert chunked.iterations == whole.iterations
    assert torch.equal(chunked.transform.rotation, whole.transform.rotation)
    assert torch.equal(chunked.error, whole.error)


def _pairs():
    """Three pairs moved by different amounts, so that they switch phase
    and stop at different iterations."""
    clouds = [_box(200 + 30 * i, angle=0.05 + 0.15 * i, trans=0.1 + 0.3 * i, seed=10 + i)
              for i in range(3)]
    bb = stack_clouds([c[0] for c in clouds], device=CPU)
    ba = stack_clouds([c[1] for c in clouds], device=CPU)
    return bb, ba


@pytest.mark.parametrize("use_fgt", (False, True))
@pytest.mark.parametrize("k", (1, 3))
def test_pair_axis_gives_each_pair_its_solo_bits(use_fgt, k):
    bb, ba = _pairs()
    kw = dict(approximation_type=HYBRID, weight=0.1, tolerance=1e-5, use_fgt=use_fgt,
              fgt_k=16, max_iterations=40)
    cpd.PHASE_TRACE.clear()
    with _loop_chunk(k):
        batch = cpd_register_batch(bb, ba, **kw)
    phases = list(cpd.PHASE_TRACE)
    its = batch.iterations.tolist()
    assert len(set(its)) > 1, its
    switches = []
    for p in range(3):
        # the solo run on the pair's rows padded as the batch pads them
        cpd.PHASE_TRACE.clear()
        solo = cpd.cpd_register(Cloud(bb.points[p], bb.count[p]),
                                Cloud(ba.points[p], ba.count[p]), **kw)
        solo_phases = list(cpd.PHASE_TRACE)
        assert int(batch.iterations[p]) == int(solo.iterations)
        for f in ("rotation", "translation", "scale"):
            assert torch.equal(getattr(batch.transform, f)[p], getattr(solo.transform, f))
        assert torch.equal(batch.error[p], solo.error)
        switches.append(solo_phases.index("trunc") if "trunc" in solo_phases else None)
    assert len(set(switches)) > 1, switches
    assert len(phases) == sum(its)


@pytest.mark.parametrize("k", (1, 3))
def test_pair_axis_runs_pair_by_pair_only_the_pairs_of_its_phase(monkeypatch, k):
    """Where the pair-axis E-step runs pair by pair (the FGT's fast phase
    here), a chunk runs the E-step of the pairs that were running in its
    phase when it began and of no other pair: one that has stopped, or
    waits in the other phase, is frozen through the chunk.  At one
    iteration a chunk that is exactly one FGT E-step an FGT iteration."""
    bb, ba = _pairs()
    kw = dict(approximation_type=HYBRID, weight=0.1, tolerance=1e-5, use_fgt=True,
              fgt_k=16, max_iterations=40)
    fgt_calls, chunks = [], []
    real_fgt, real_chunk = cpd._fgt_estep, cpd._em_chunk

    def fgt_estep(*args):
        fgt_calls.append(1)
        return real_fgt(*args)

    def chunk(cfg, kk, phase, eligible, *args):
        before = len(fgt_calls)
        out = real_chunk(cfg, kk, phase, eligible, *args)
        chunks.append((phase, eligible, len(fgt_calls) - before))
        return out

    monkeypatch.setattr(cpd, "_fgt_estep", fgt_estep)
    monkeypatch.setattr(cpd, "_em_chunk", chunk)
    cpd.PHASE_TRACE.clear()
    with _loop_chunk(k):
        cpd_register_batch(bb, ba, **kw)
    phases = list(cpd.PHASE_TRACE)
    fast = [c for c in chunks if c[0] == "fast"]
    assert fast and all(eligible for _, eligible, _ in fast), chunks
    assert all(n == k * len(eligible) for _, eligible, n in fast), chunks
    assert all(n == 0 for phase, _, n in chunks if phase == "slow"), chunks
    # the pairs left the fast phase at different chunks
    assert any(len(eligible) < 3 for _, eligible, _ in fast), chunks
    if k == 1:
        assert len(fgt_calls) == phases.count("fgt")
    else:
        assert len(fgt_calls) >= phases.count("fgt")


@pytest.mark.parametrize("mode", ["none", "hybrid"])
def test_chunked_solo_and_pair_axis_match_jax(mode):
    """Against the JAX package's ``cpd_register`` (the oracle E-step, as
    its tests run it on the CPU), the tolerances of ``test_torch_cpd.py``."""
    approx = {"none": (NONE, JaxApprox.NONE), "hybrid": (HYBRID, JaxApprox.Hybrid)}[mode]
    kw = dict(weight=0.1, max_iterations=150, tolerance=1e-6)
    clouds = [_box(n, angle=0.25, seed=20 + n) for n in (300, 260)]
    bb = stack_clouds([c[0] for c in clouds], device=CPU)
    ba = stack_clouds([c[1] for c in clouds], device=CPU)
    with _loop_chunk(3):
        batch = cpd_register_batch(bb, ba, approximation_type=approx[0], **kw)
    for p, (before, after) in enumerate(clouds):
        ref = jcpd.cpd_register(jax_pad_cloud(before), jax_pad_cloud(after),
                                approximation_type=approx[1], **kw)
        solo, _, _ = _run(before, after, 3, approximation_type=approx[0], **kw)
        cb, ca = jax_pad_cloud(before), jax_pad_cloud(after)
        sigma2_0 = float(jcpd.sigma_squared_init(cb.points, cb.mask(), ca.points, ca.mask()))
        for iters, rot, trans, err in (
                (solo.iterations, solo.transform.rotation, solo.transform.translation,
                 solo.error),
                (int(batch.iterations[p]), batch.transform.rotation[p],
                 batch.transform.translation[p], batch.error[p])):
            assert int(iters) == int(ref.iterations)
            np.testing.assert_allclose(rot.numpy(), np.asarray(ref.transform.rotation),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(trans.numpy(), np.asarray(ref.transform.translation),
                                       rtol=0, atol=1e-4)
            assert abs(float(err) - float(ref.error)) <= 1e-6 * sigma2_0


def test_fgt_tables_equal_the_host_tables(monkeypatch):
    """``fgt_tables`` puts the host tables on a device bit for bit, once:
    a later call returns the same tensors, and models and predictions
    build no table again (no host-to-device copy inside an E-step)."""
    from tpuslam_torch.ops import fgt

    rng = np.random.Generator(np.random.PCG64(5))
    for p in (1, 2, 5, 8):
        t = fgt.fgt_tables(p, CPU)
        assert torch.equal(t.alpha, torch.from_numpy(fgt._alpha_table(p).astype(np.int64)))
        assert torch.equal(t.coeff, torch.from_numpy(fgt._c_coefficients(p)))
        assert fgt.max_pow(p) == int(fgt._alpha_table(p).max())
        again = fgt.fgt_tables(p, CPU)
        assert again.alpha is t.alpha and again.coeff is t.coeff

    def built_again(p):
        raise AssertionError(f"a table of order {p} was built again")

    pts = torch.from_numpy((rng.random((300, 3)) * 4).astype(np.float32))
    w = torch.from_numpy(rng.random((300, 4)).astype(np.float32))
    mask = torch.ones(300)
    sigma = torch.tensor(1.5)
    tg = torch.from_numpy((rng.random((100, 3)) * 4).astype(np.float32))
    a = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 16, 8)
    want = fgt.fgt_predict_multi(tg, a, sigma, 10.0, 8)
    monkeypatch.setattr(fgt, "_alpha_table", built_again)
    monkeypatch.setattr(fgt, "_c_coefficients", built_again)
    b = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 16, 8)
    assert torch.equal(a.ak, b.ak) and torch.equal(a.centers, b.centers)
    assert torch.equal(fgt.fgt_predict_multi(tg, b, sigma, 10.0, 8), want)


def _estep_operands(sigma2_scale):
    """K5's operands on the Morton-sorted two-cluster clouds at ``sigma2``
    = ``sigma2_scale`` x sigma^2_0, truncated."""
    from tpuslam_torch.ops.spatial import morton_permutation

    before, after = _clusters(seed=7)
    mov, tgt = pad_cloud(before, device=CPU), pad_cloud(after, device=CPU)
    m = mov.points[morton_permutation(mov.points, mov.mask()).long()].contiguous()
    t = tgt.points[morton_permutation(tgt.points, tgt.mask()).long()].contiguous()
    ones = torch.ones(len(m))
    s2 = cpd.sigma_squared_init(m, ones, t, ones) * sigma2_scale
    return m, ones, t, ones, s2, torch.tensor(0.01), torch.tensor(True)


@pytest.mark.parametrize("sigma2_scale,route", [(0.5, "k4"), (0.05, "k5"), (0.002, "k5")])
def test_predicated_estep_equals_the_host_route(_routes, sigma2_scale, route):
    """The E-step with its route chosen on the device (every pass
    launched, each predicated; the fat subsets at their fixed capacity
    with a device count, masked back) gives the host route's statistics
    bit for bit, and the same route code."""
    args = _estep_operands(sigma2_scale)
    cpd_cand.ROUTE_TRACE.clear()
    host = cpd_cand.cpd_estep_cand(*args)
    with choices.recording() as rec:
        dev = cpd_cand.cpd_estep_cand(*args, predicated=True)
    assert list(cpd_cand.ROUTE_TRACE) == [route]
    assert [int(c) for _, _, c in rec.booked] == [cpd_cand.ROUTES.index(route)]
    assert all(trace is cpd_cand.ROUTE_TRACE for trace, _, _ in rec.booked)
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(dev, f), getattr(host, f)), f


def test_predicated_k4_and_k5_wrappers_write_only_when_selected_on_the_cpu():
    """The predicated passes of K4 and K5 write ``out`` where the route
    code equals their value and leave it alone otherwise; K4 given a live
    row count writes only those rows."""
    from tpuslam_torch.kernels import cpd_dense

    m, _, t, _, s2, c, tr = _estep_operands(0.05)
    scal = cpd_dense.estep_scalars(s2.reshape(1), c.reshape(1), tr.reshape(1), 1e-3)
    ty, tg = m[None], t[None]
    want = cpd_dense.denom_pass_batch(scal, ty, tg)
    for code, value in ((0, 0), (1, 0), (1, 1)):
        route = torch.tensor([code], dtype=torch.int32)
        out = torch.full_like(want, -7.0)
        cpd_dense.denom_pass_batch(scal, ty, tg, pred=route, pred_value=value, out=out)
        assert torch.equal(out, want) if code == value else bool((out == -7.0).all())
    out = torch.full_like(want, -7.0)
    cpd_dense.denom_pass_batch(scal, ty, tg, pred=torch.tensor([0], dtype=torch.int32),
                               live=torch.tensor([1024], dtype=torch.int32), out=out)
    assert torch.equal(out[..., :1024], want[..., :1024]) and bool((out[..., 1024:] == -7.0).all())
    w4 = torch.rand(1, t.shape[0], 4)
    want_m = cpd_dense.moments_pass_batch(scal, ty, tg, w4)
    out = torch.full_like(want_m, -7.0)
    cpd_dense.moments_pass_batch(scal, ty, tg, w4, pred=torch.tensor([1], dtype=torch.int32),
                                 pred_value=0, out=out)
    assert bool((out == -7.0).all())
    a = cpd_cand.block_admission(m, torch.ones(len(m)), t, torch.ones(len(t)), s2, tr)
    table, counts = cpd_cand.cta_tables(a.sub_adm, a.f_sub,
                                        cpd_dense.cpd_geometry(len(t)).cta_rows,
                                        torch.ones(len(t) // 1024, dtype=torch.bool), 2)
    want_c = cpd_cand.denom_cand(scal[0], m, t, table, counts)
    for code in (0, 1):
        out = torch.full_like(want_c, -7.0)
        cpd_cand.denom_cand(scal[0], m, t, table, counts,
                            pred=torch.tensor([code], dtype=torch.int32), out=out)
        assert torch.equal(out, want_c) if code == 0 else bool((out == -7.0).all())
    with pytest.raises(ValueError):
        cpd_dense.denom_pass_batch(scal, ty, tg, pred=torch.tensor([0], dtype=torch.int32))
