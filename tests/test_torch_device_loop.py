"""The device-resident ICP loop of the PyTorch port
(``tpuslam_torch.algorithms.icp._icp_loop``) on the CPU.

The loop runs ``k`` iterations between host reads, freezing a problem
once it has stopped (the JAX ``while_loop``'s ``cond``).  Whatever ``k``,
its result must be the one-iteration loop's bit for bit: equal
``iterations``, R, t and error (``torch.equal``, tolerance 0) and an equal
``ARM_TRACE`` (a frozen iteration's query is not booked).  Every stop
condition is covered, solo and batched, and the chunked runs are held to
the JAX package at the tolerances of ``test_torch_icp.py`` (equal
iterations, R and t within 1e-4, the error within 1e-4 relative and 1e-9
absolute) and ``test_torch_batch.py`` (R within 1e-4, t within 1e-3).
The CUDA graph of a chunk is a card matter (``test_torch_cuda.py``); here
the same chunks run eagerly.
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import tpuslam
import tpuslam_torch
from tests.conftest import make_cloud, random_rigid
from tpuslam.algorithms import batch as jbatch
from tpuslam.algorithms.icp import icp_register as jax_icp_register
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam_torch.algorithms import cpd, device_loop, icp
from tpuslam_torch.algorithms.batch import _icp_batched_loop, stack_clouds
from tpuslam_torch.algorithms.icp import ICPResume, icp_register, icp_register_chunked
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.core import choices
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.ops import nn_hier

# the port runs on the card unless asked for the CPU; these tests ask
CPU = "cpu"
CHUNKS = (1, 3, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes, and torch's default of a thread per core in each of them
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(rng, angle, trans, n=512, permute=True):
    before = make_cloud(rng, n)
    r, t = random_rigid(rng, angle, trans)
    after = (before @ r.T + t).astype(np.float32)
    if permute:
        after = after[rng.permutation(n)]
    return before, after


@contextmanager
def _loop_chunk(k):
    """The loop at ``k`` iterations a host read (``device_loop.LOOP_CHUNK``)."""
    saved = device_loop.LOOP_CHUNK
    device_loop.LOOP_CHUNK = k
    try:
        yield
    finally:
        device_loop.LOOP_CHUNK = saved


def _run(before, after, k, **kw):
    nn_hier.ARM_TRACE.clear()
    with _loop_chunk(k):
        res = icp_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU), **kw)
    return res, list(nn_hier.ARM_TRACE)


# the one-iteration runs, by case: every test draws its clouds from the
# same seed, so the reference is computed once a module
_REFERENCE = {}


def _reference(key, before, after, **kw):
    if key not in _REFERENCE:
        _REFERENCE[key] = _run(before, after, 1, **kw)
    return _REFERENCE[key]


def _assert_equal(got, want):
    (res, arms), (ref, ref_arms) = got, want
    assert res.iterations == ref.iterations
    assert torch.equal(res.transform.rotation, ref.transform.rotation)
    assert torch.equal(res.transform.translation, ref.transform.translation)
    assert torch.equal(res.error, ref.error) or (
        torch.isnan(res.error).all() and torch.isnan(ref.error).all())
    assert arms == ref_arms


def _stop_case(rng, case):
    """Clouds and settings that end the loop by ``case``."""
    if case == "converged":
        return _pair(rng, 0.2, 1.0), dict(eps=1e-5, max_distance_squared=1e4, max_iterations=50)
    if case == "identity":  # converged on the first step
        cloud = make_cloud(rng, 512)
        return (cloud, cloud.copy()), dict(eps=1e-4)
    if case == "diverged":  # the guard stops a gated run (test_torch_icp.py)
        return _pair(rng, 0.8, 3.0, n=1024), dict(eps=1e-12, max_distance_squared=1.0,
                                                  max_iterations=40)
    if case == "no_correspondences":
        cloud = make_cloud(rng, 512)
        return (cloud, cloud + 1000.0), dict(eps=1e-6, max_distance_squared=1.0,
                                             max_iterations=10)
    if case == "non_finite":
        pts = make_cloud(rng, 128)
        pts[3] = np.nan
        return (pts, make_cloud(rng, 128)), dict(eps=0.0, max_distance_squared=1e18,
                                                 max_iterations=5, divergence_guard=False)
    if case == "max_iterations":
        return _pair(rng, 1.2, 8.0), dict(eps=1e-12, max_iterations=7, divergence_guard=False)
    if case == "unbounded":
        return _pair(rng, 0.2, 1.0), dict(eps=1e-5, max_distance_squared=1e4,
                                          max_iterations=-1)
    if case == "zero_iterations":
        return _pair(rng, 0.3, 2.0, n=256), dict(max_iterations=0)
    assert case == "patience"  # the best-so-far loop with the guard off
    return _pair(rng, 0.8, 3.0, n=1024), dict(eps=0.0, max_distance_squared=1.0,
                                              max_iterations=60, divergence_guard=False,
                                              patience=4)


STOPS = ("converged", "identity", "diverged", "no_correspondences", "non_finite",
         "max_iterations", "unbounded", "zero_iterations", "patience")


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("case", STOPS)
def test_chunked_loop_equals_one_iteration_loop(rng, case, k):
    (before, after), kw = _stop_case(rng, case)
    want = _reference((case, False), before, after, **kw)
    _assert_equal(_run(before, after, k, **kw), want)
    # the stop really is the case's
    res = want[0]
    if case in ("identity", "no_correspondences", "non_finite"):
        assert res.iterations == 0
    elif case in ("diverged", "converged"):
        assert 0 < res.iterations < kw["max_iterations"]
    elif case == "max_iterations":
        assert res.iterations == kw["max_iterations"]
    elif case == "patience":
        assert 4 <= res.iterations < 60


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("case", ["converged", "max_iterations", "patience"])
def test_hier_arm_chunked_equals_one_iteration_loop(rng, case, k):
    """The hierarchical arm (K2, K3, K1 plain versions on the CPU): the
    arm of every iteration that ran is booked once, a frozen one's never."""
    (before, after), kw = _stop_case(rng, case)
    want = _reference((case, True), before, after, use_spatial=True, **kw)
    assert len(want[1]) == want[0].iterations + (case == "converged")
    _assert_equal(_run(before, after, k, use_spatial=True, **kw), want)


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("use_spatial", [False, True])
def test_resume_chunked_equals_one_iteration_loop(rng, k, use_spatial):
    before, after = _pair(rng, 0.4, 3.0)
    b, a = pad_cloud(before, device=CPU), pad_cloud(after, device=CPU)
    kw = dict(eps=1e-7, max_distance_squared=1e4, use_spatial=use_spatial)
    with _loop_chunk(1):
        first = icp_register(b, a, max_iterations=3, **kw)
    resume = ICPResume(first.transform.rotation, first.transform.translation, first.error,
                       done_before=3, nn=first.nn)
    nn_hier.ARM_TRACE.clear()
    with _loop_chunk(1):
        want = icp_register(b, a, max_iterations=20, resume=resume, **kw)
    want_arms = list(nn_hier.ARM_TRACE)
    nn_hier.ARM_TRACE.clear()
    with _loop_chunk(k):
        got = icp_register(b, a, max_iterations=20, resume=resume, **kw)
    _assert_equal((got, list(nn_hier.ARM_TRACE)), (want, want_arms))


@pytest.mark.parametrize("k", CHUNKS)
def test_chunked_driver_equals_whole_run(rng, monkeypatch, k, tmp_path):
    """``icp_register_chunked`` (chunks of 5, checkpointed) over a loop of
    ``k`` iterations a host read: the whole one-iteration run, bit for bit."""
    before, after = _pair(rng, 0.4, 3.0)
    b, a = pad_cloud(before, device=CPU), pad_cloud(after, device=CPU)
    kw = dict(eps=1e-7, max_distance_squared=1e4, max_iterations=23)
    with _loop_chunk(1):
        whole = icp_register(b, a, **kw)
    monkeypatch.setattr(device_loop, "LOOP_CHUNK", k)
    chunked = icp_register_chunked(b, a, chunk=5, checkpoint_path=str(tmp_path / "c.npz"),
                                   **kw)
    assert chunked.iterations == whole.iterations
    assert torch.equal(chunked.transform.rotation, whole.transform.rotation)
    assert torch.equal(chunked.transform.translation, whole.transform.translation)
    assert torch.equal(chunked.error, whole.error)


def _batch_problem(rng, n=512):
    """Four pairs: one converges at once (identity), one has no
    correspondence, one stops early, one runs on (a wide rotation)."""
    moving = make_cloud(rng, n)
    r, t = random_rigid(rng, 0.3, 1.0)
    r2, t2 = random_rigid(rng, 0.9, 3.0)
    other = make_cloud(rng, n)
    befores = [moving, moving, moving, other]
    afters = [(moving @ r.T + t).astype(np.float32), moving.copy(), moving + 1000.0,
              (other @ r2.T + t2).astype(np.float32)]
    return (stack_clouds(befores, device=CPU), stack_clouds(afters, device=CPU),
            befores, afters)


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("use_spatial", [False, True])
def test_batched_loop_chunked_equals_one_iteration_loop(rng, k, use_spatial):
    bb, ba, _, _ = _batch_problem(rng)
    kw = dict(eps=1e-4, max_distance_squared=50.0, max_iterations=25,
              divergence_guard=True, use_spatial=use_spatial)
    nn_hier.ARM_TRACE.clear()
    with _loop_chunk(1):
        want = _icp_batched_loop(bb, ba, **kw)
    want_arms = list(nn_hier.ARM_TRACE)
    nn_hier.ARM_TRACE.clear()
    with _loop_chunk(k):
        got = _icp_batched_loop(bb, ba, **kw)
    iters = want.iterations.tolist()
    assert iters[1] == 0 and iters[2] == 0 and iters[0] < max(iters)  # one stops early
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.transform.rotation, want.transform.rotation)
    assert torch.equal(got.transform.translation, want.transform.translation)
    assert torch.equal(got.error, want.error)
    assert list(nn_hier.ARM_TRACE) == want_arms
    if use_spatial:  # one query an iteration until the last pair stops or hits the cap
        assert len(want_arms) == max(iters) + (max(iters) < kw["max_iterations"])
        assert all(torch.equal(x, y) for x, y in zip(got.nn, want.nn))


@pytest.mark.parametrize("k", (3, 8))
@pytest.mark.parametrize("use_spatial", [False, True])
def test_chunked_solo_matches_jax(rng, k, use_spatial):
    before, after = _pair(rng, 0.2, 1.0, n=1500)
    kw = dict(eps=1e-5, max_distance_squared=1e4, max_iterations=50)
    ref = jax_icp_register(jax_pad_cloud(before), jax_pad_cloud(after),
                           use_spatial=use_spatial, **kw)
    res, _ = _run(before, after, k, use_spatial=use_spatial, **kw)
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.transform.rotation.numpy(),
                               np.asarray(ref.transform.rotation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.transform.translation.numpy(),
                               np.asarray(ref.transform.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(res.error), float(ref.error), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("k", (3, 8))
def test_chunked_batch_matches_jax(rng, k):
    _, _, befores, afters = _batch_problem(rng, n=300)
    bb, ba = stack_clouds(befores, device=CPU), stack_clouds(afters, device=CPU)
    kw = dict(eps=1e-4, max_distance_squared=50.0, max_iterations=25)
    with _loop_chunk(k):
        got = _icp_batched_loop(bb, ba, divergence_guard=True, use_spatial=False, **kw)
    want = jbatch.icp_register_batch(jbatch.stack_clouds(befores), jbatch.stack_clouds(afters),
                                     unroll=False, **kw)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation), rtol=0, atol=1e-3)


@pytest.mark.parametrize("k", (3, 8))
def test_chunked_registration_matches_jax(rng, monkeypatch, k):
    """The whole registration (``tpuslam_torch.register``) with the loop at
    ``k`` iterations a host read, against ``tpuslam.register``."""
    before, after = _pair(rng, 0.2, 1.0, n=2048)
    kw = dict(max_iterations=50, max_distance_squared=1e4, convergence_epsilon=1e-5)
    monkeypatch.setattr(device_loop, "LOOP_CHUNK", k)
    rot, trans, iters, err = tpuslam_torch.register(before, after, device=CPU, **kw)
    ref = tpuslam.register(before, after, **kw)
    assert iters == int(ref[2])
    np.testing.assert_allclose(rot, np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(ref[1]), rtol=0, atol=1e-4)
    assert err == pytest.approx(float(ref[3]), rel=1e-4, abs=1e-9)


@pytest.mark.parametrize("overflow,overflow2,arm", [
    (False, False, "fine"), (False, True, "fine"), (False, None, "fine"),
    (True, False, "coarse"), (True, True, "dense"), (True, None, "dense"),
])
def test_arm_code_every_case_of_the_host_branch(overflow, overflow2, arm):
    """``arm_code`` against the host branch's order (``lax.cond`` in the
    JAX package): fine unless the fine arm overflows, then coarse unless
    the coarse arm overflows or does not exist (None), then dense."""
    flag2 = None if overflow2 is None else torch.tensor(overflow2)
    code = nn_hier.arm_code(torch.tensor(overflow), flag2)
    assert code.dtype == torch.int32 and code.shape == (1,)
    assert nn_hier.ARMS[int(code)] == arm


def test_read_status_books_trace_of_running_queries():
    """A chunk's report, built by ``device_loop._reporting`` and read once
    (``device_loop.read_report``): the device's launch counts, the loop's
    own status (stopped, the iteration counts) handed back, then each
    query's arm code, ``choices.FROZEN`` for a query of a frozen
    iteration, which ``ARM_TRACE`` does not get."""
    def chunk(inputs, carry):
        for arm, ran in ((1, True), (2, False), (0, True)):
            choices.book(nn_hier.ARM_TRACE, nn_hier.ARMS,
                         torch.tensor([arm], dtype=torch.int32))
            choices.ran(torch.tensor(ran))
        return carry, [torch.tensor([1, 5, 7], dtype=torch.int32)], None

    nn_hier.ARM_TRACE.clear()
    _, report, _, layout = device_loop._reporting(chunk, False)((torch.zeros(1),), None)
    assert report.tolist()[-3:] == [1, choices.FROZEN, 0]
    assert device_loop.read_report(report.tolist(), layout) == [1, 5, 7]
    assert list(nn_hier.ARM_TRACE) == ["coarse", "fine"]


@pytest.mark.parametrize("loop,kw,bound", [
    ("icp", dict(use_spatial=False), 546),
    ("icp", dict(use_spatial=True), 982),
    ("cpd", dict(), 607),
    ("cpd", dict(approximation_type=ApproximationType.Hybrid, use_kernels=True), 877),
])
def test_one_chunk_dispatches_no_more_torch_ops(monkeypatch, loop, kw, bound):
    """The torch ops that one chunk of two iterations dispatches on the
    CPU (``TorchDispatchMode``), its report and its choices' bookkeeping
    included, on 256 points: at most the pinned bound, the count of the
    loop whose chunk built and parsed its own status.  A chunk replayed
    as a CUDA graph holds these ops' kernels, so an op added to the
    loop's bookkeeping, the report or the choices fails here."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    mod = icp if loop == "icp" else cpd
    real, counts = mod.run_chunks, []

    def counted(*args, **kwargs):
        Count.ops = 0
        with Count():
            out = real(*args, **kwargs)
        counts.append(Count.ops)
        return out

    monkeypatch.setattr(mod, "run_chunks", counted)
    monkeypatch.setattr(device_loop, "LOOP_CHUNK", 2)
    rng = np.random.default_rng(0)
    before = (rng.random((256, 3)) * 4).astype(np.float32)
    r, t = random_rigid(rng, 0.2, 0.3)
    after = (before @ r.T + t).astype(np.float32)
    b, a = pad_cloud(before, device=CPU), pad_cloud(after, device=CPU)
    if loop == "icp":
        icp_register(b, a, max_iterations=2, eps=0.0, **kw)
    else:
        cpd.cpd_register(b, a, max_iterations=2, tolerance=0.0, **kw)
    assert len(counts) == 1 and counts[0] <= bound, counts


def test_chunk_must_be_positive(rng):
    before, after = _pair(rng, 0.1, 0.5, n=128)
    with pytest.raises(ValueError, match="chunk"), _loop_chunk(0):
        icp_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU))


def test_graph_scope_nests_and_restores():
    """``graph_scope``: an inner scope without a dict shares the open one,
    one with a dict holds that dict, and each restores what was open; on
    the CPU the loop captures nothing into it."""
    assert device_loop._SCOPE is None
    with icp.graph_scope() as outer:
        with icp.graph_scope() as inner:
            assert inner is outer
        own = {}
        with icp.graph_scope(own) as held:
            assert held is own and device_loop._SCOPE is own
        assert device_loop._SCOPE is outer
    assert device_loop._SCOPE is None
    rng = np.random.default_rng(3)
    before, after = _pair(rng, 0.1, 0.5, n=128)
    with icp.graph_scope() as graphs:
        icp_register(pad_cloud(before, device=CPU), pad_cloud(after, device=CPU))
    assert graphs == {}


@pytest.mark.parametrize("use_spatial", [False, True])
def test_sharded_style_arm_runs_one_iteration_a_chunk(rng, use_spatial):
    """An arm without a graph key (the sharded ranks' arm) takes the same
    path as a keyed one, bit for bit: the key only decides the capture."""
    before, after = _pair(rng, 0.2, 1.0, n=512)
    b, a = pad_cloud(before, device=CPU), pad_cloud(after, device=CPU)
    kw = dict(eps=1e-5, max_distance_squared=1e4, max_iterations=30, use_spatial=use_spatial)
    want = _run(before, after, 1, **kw)
    real = icp._icp_loop

    def keyless(src, mask, arm, *args, **kwargs):
        return real(src, mask, arm._replace(key=None), *args, **kwargs)

    icp._icp_loop = keyless
    try:
        nn_hier.ARM_TRACE.clear()
        got = icp_register(b, a, **kw), list(nn_hier.ARM_TRACE)
    finally:
        icp._icp_loop = real
    _assert_equal(got, want)


def test_loop_chunk_program_on_the_cpu(tmp_path):
    """``harness/loop_chunk.py`` at a tiny size on the CPU: a row per size,
    arm and chunk, each chunk's registration taking the same iterations,
    no sync count off the card, the module's chunk restored."""
    import json

    from tpuslam_torch.harness import loop_chunk

    out = tmp_path / "lc.json"
    before = device_loop.LOOP_CHUNK
    assert loop_chunk.main(["--device", "cpu", "--sizes", "512", "--chunks", "1:3",
                            "--reps", "1", "--out", str(out)]) == 0
    assert device_loop.LOOP_CHUNK == before and device_loop.CUDA_GRAPHS
    got = json.load(open(out))
    # per arm: fixed and converge rows for each setting, a miss row for k1, k3
    assert got["device"] == "cpu" and len(got["rows"]) == 2 * (2 * 3 + 2)
    summary = got["summary"]
    for arm in ("hier", "dense"):
        iters = {summary[f"512_{arm}_{k}"]["converge_iterations"] for k in ("eager", "k1", "k3")}
        assert len(iters) == 1
        assert all(summary[f"512_{arm}_{k}"]["miss_ms"] > 0 for k in ("k1", "k3"))
        assert all(summary[f"512_{arm}_{k}"]["converge_syncs"] is None
                   for k in ("eager", "k1", "k3"))


def test_predicated_wrappers_write_only_when_selected_on_the_cpu(rng):
    """K1's and K3's wrappers with an arm code, on the CPU (their plain
    versions read the code): ``out`` keeps its sentinel unless the code is
    the launch's value, and then holds the unpredicated result; an arm
    code without ``out`` is refused."""
    from tpuslam_torch.kernels import nn_cand, nn_dense

    n, m = 256, 512
    src = torch.from_numpy(make_cloud(rng, n))[None]
    tgt = torch.from_numpy(make_cloud(rng, m))[None]
    count = torch.tensor([m], dtype=torch.int32)
    packed = torch.cat([tgt, torch.arange(m, dtype=torch.float32)[None, :, None]], dim=2)
    cand = torch.arange(4, dtype=torch.int32).repeat(1, 1, 1)
    counts = torch.full((1, 1), 4, dtype=torch.int32)
    runs = {
        2: (lambda **kw: nn_dense.nearest_neighbors_dense_batch(src, tgt, count, **kw)),
        0: (lambda **kw: nn_cand.nearest_neighbors_cand_batch(src, packed, cand, counts,
                                                              g=128, gsrc=n, **kw)),
    }
    for value, run in runs.items():
        want = run()
        for code in (0, 1, 2):
            out = (torch.full((1, n), -7, dtype=torch.int32), torch.full((1, n), -1.0))
            got = run(arm=torch.tensor([code], dtype=torch.int32), arm_value=value, out=out)
            assert got[0] is out[0] and got[1] is out[1]
            if code == value:
                assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
            else:
                assert bool((out[0] == -7).all()) and bool((out[1] == -1.0).all())
        with pytest.raises(ValueError, match="out="):
            run(arm=torch.tensor([value], dtype=torch.int32), arm_value=value)
