"""Chunked and checkpointed ICP and CPD of the PyTorch port
(``tpuslam_torch.harness.checkpoint``, ``icp.icp_register_chunked``,
``icp.icp_register_prealigned(chunk=, checkpoint_path=)``,
``cpd.cpd_register_chunked`` and the ``TPUSLAM_{ICP,CPD}_{CHUNK,CKPT}``
contract of ``algorithms/registry.py``): the cases of ``tests/test_icp.py``
and ``tests/test_cpd.py`` about chunks and checkpoints on the port, the
checkpoint format against the JAX package's in both directions, and the
fingerprint against the JAX package's.

Tolerances, with their reasons:

* chunked against whole, resumed against uninterrupted, re-run against
  first run: bit for bit (the boundary is the loop's own state);
* ``cloud_fingerprint`` against JAX's: 1e-6 relative (float32 sums that
  XLA and torch add in different orders);
* arrays saved by one package and loaded by the other: equal;
* the chunked run against the JAX package's chunked run: R and t within
  1e-4, equal iterations (whole registrations, ``tests/test_torch_icp.py``).
"""

import os

import numpy as np
import pytest
import torch

import tpuslam_torch
from tests.conftest import make_cloud, random_rigid
from tests.test_icp import _anisotropic_pair
from tpuslam.algorithms import icp as jicp
from tpuslam.algorithms import registry as jregistry
from tpuslam.core.types import pad_cloud as jax_pad_cloud
from tpuslam.harness import checkpoint as jckpt
from tpuslam_torch.algorithms import nicp as nicp_mod
from tpuslam_torch.algorithms.cpd import CPDResume, cpd_register, cpd_register_chunked
from tpuslam_torch.algorithms.icp import (
    ICPResume,
    icp_register,
    icp_register_chunked,
    icp_register_prealigned,
)
from tpuslam_torch.algorithms.registry import (
    cpd_chunk_size,
    icp_chunk_size,
    run_with_configuration,
)
from tpuslam_torch.config.configuration import (
    ApproximationType,
    ComputationMethod,
    Configuration,
)
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.harness import checkpoint as ckpt
from tpuslam_torch.ops.nn_hier import HierState


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes (see ``tests/test_torch_batch.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pc(points):
    return pad_cloud(points, device="cpu")


def register(before, after, **kw):
    return icp_register(pc(before), pc(after), **kw)


def _same(a, b):
    assert int(a.iterations) == int(b.iterations)
    assert torch.equal(a.transform.rotation, b.transform.rotation)
    assert torch.equal(a.transform.translation, b.transform.translation)
    assert torch.equal(a.error, b.error)


def _pair(rng, n=300, angle=0.3, trans=2.0, permute=False):
    cloud = make_cloud(rng, n)
    r_true, t_true = random_rigid(rng, angle, trans)
    after = (cloud @ r_true.T + t_true).astype(np.float32)
    if permute:
        after = after[rng.permutation(n)]
    return cloud, after


def _cpd_pair(rng, n=300, angle=0.25, trans=0.5):
    before = (rng.random((n, 3)) * 6.0 - 3.0).astype(np.float32)
    r, t = random_rigid(rng, angle=angle, trans=trans)
    after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
    return before, after


# the format and the fingerprint against the JAX package --------------------------


def test_cloud_fingerprint_matches_jax(rng):
    pts = make_cloud(rng, 1000)
    pts -= pts.mean(axis=0)
    got = ckpt.cloud_fingerprint(pc(pts).points, pc(pts).mask())
    jc = jax_pad_cloud(pts)
    want = jckpt.cloud_fingerprint(jc.points, jc.mask())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(map(abs, want)))


def test_cloud_fingerprint_discriminates(rng):
    pts = make_cloud(rng, 500)
    pts -= pts.mean(axis=0)
    c = pc(pts)
    fp = ckpt.cloud_fingerprint(c.points, c.mask())
    perm = pc(pts[rng.permutation(len(pts))])
    assert fp != ckpt.cloud_fingerprint(perm.points, perm.mask())
    r, _ = random_rigid(rng, 0.7, 0.0)
    rot = pc((pts @ r.T).astype(np.float32))
    assert fp != ckpt.cloud_fingerprint(rot.points, rot.mask())


def _icp_resume(rng, with_nn):
    nn = None
    if with_nn:
        nn = HierState(prev_target=torch.from_numpy(make_cloud(rng, 64)),
                       warm=torch.tensor(True), sparse=torch.tensor(False))
    r, t = random_rigid(rng, 0.4, 2.0)
    return ICPResume(rotation=torch.from_numpy(r), translation=torch.from_numpy(t),
                     error=torch.tensor(0.25), done_before=7,
                     prev_error=torch.tensor(0.5), nn=nn)


@pytest.mark.parametrize("with_nn", [False, True])
def test_icp_format_round_trips_between_packages(rng, tmp_path, with_nn):
    resume = _icp_resume(rng, with_nn)
    meta = {"eps": 1e-3, "fp_before": [1.0, 2.0, 3.0, 4.0, 5.0]}
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_icp_checkpoint(ours, resume, meta)
    jres, jmeta = jckpt.load_icp_checkpoint(ours, expect_meta=None)
    assert jmeta == meta and int(jres.done_before) == 7
    for f in ("rotation", "translation", "error", "prev_error"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(resume, f).numpy())
    assert (jres.nn is None) == (not with_nn)
    # and back: the JAX package's file through the port's loader
    jckpt.save_icp_checkpoint(theirs, jres, jmeta)
    back, bmeta = ckpt.load_icp_checkpoint(theirs, expect_meta=None)
    assert bmeta == meta and back.done_before == 7
    for f in ("rotation", "translation", "error", "prev_error"):
        assert torch.equal(getattr(back, f), getattr(resume, f))
    if with_nn:
        for f in HierState._fields:
            assert torch.equal(getattr(back.nn, f), getattr(resume.nn, f))
    else:
        assert back.nn is None


def test_cpd_format_round_trips_between_packages(rng, tmp_path):
    r, t = random_rigid(rng, 0.4, 2.0)
    resume = CPDResume(torch.from_numpy(r), torch.from_numpy(t), torch.tensor(0.9),
                       torch.tensor(0.01), torch.tensor(-123.5), torch.tensor(1e-4),
                       done_before=12)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_cpd_checkpoint(ours, resume, {"weight": 0.1})
    jres, jmeta = jckpt.load_cpd_checkpoint(ours)
    assert jmeta == {"weight": 0.1} and int(jres.done_before) == 12
    jckpt.save_cpd_checkpoint(theirs, jres, jmeta)
    back, _ = ckpt.load_cpd_checkpoint(theirs)
    assert back.done_before == 12
    for f in CPDResume._fields[:-1]:
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(resume, f).numpy())
        assert torch.equal(getattr(back, f), getattr(resume, f))
    # the kind guards the loaders both ways
    with pytest.raises(ValueError, match="kind"):
        ckpt.load_icp_checkpoint(theirs)
    with pytest.raises(ValueError, match="kind"):
        jckpt.load_icp_checkpoint(ours)


def test_foreign_fingerprints_start_fresh(rng, tmp_path, capsys):
    """A file the JAX package's chunked driver wrote loads through the
    port's loader; its fingerprints come from XLA's sums, so the port's
    driver resumes it only when they match its own, and otherwise starts
    fresh with the notice, landing on its uninterrupted result."""
    cloud, after = _pair(rng)
    kw = dict(eps=0.0, max_distance_squared=1e4, chunk=3)
    path = str(tmp_path / "jax.npz")
    jicp.icp_register_chunked(jax_pad_cloud(cloud), jax_pad_cloud(after), max_iterations=6,
                              checkpoint_path=path, **kw)
    resume, meta = ckpt.load_icp_checkpoint(path)
    assert resume.done_before == 6 and meta["prealign"] is False
    ours = ckpt.cloud_fingerprint(pc(cloud).points, pc(cloud).mask())
    whole = icp_register_chunked(pc(cloud), pc(after), max_iterations=9, **kw)
    got = icp_register_chunked(pc(cloud), pc(after), max_iterations=9, checkpoint_path=path,
                               **kw)
    if ours != meta["fp_before"]:
        assert "ignoring checkpoint" in capsys.readouterr().out
        _same(got, whole)
    else:
        np.testing.assert_allclose(got.transform.rotation.numpy(),
                                   whole.transform.rotation.numpy(), atol=1e-4)


def test_load_errors_are_the_jax_ones():
    assert ckpt.LOAD_ERRORS == jckpt.LOAD_ERRORS


# the environment contract --------------------------------------------------------


@pytest.mark.parametrize("env", [None, "7", "0", "-3", "junk", " 12 "])
def test_chunk_gates_match_jax_off_the_tpu(env, capsys):
    assert icp_chunk_size(env) == jregistry.icp_chunk_size(10**6, 50, "cpu", env)
    assert cpd_chunk_size(env) == jregistry.cpd_chunk_size(376_401, 376_401, 15, "cpu", env)
    out = capsys.readouterr().out
    if env == "junk":
        assert "ignoring malformed TPUSLAM_ICP_CHUNK='junk'" in out
        assert "ignoring malformed TPUSLAM_CPD_CHUNK='junk'" in out


# ICP: the cases of tests/test_icp.py ----------------------------------------------


def test_icp_registry_chunk_env_matches_whole(rng, monkeypatch):
    cloud, after = _pair(rng, angle=0.3, trans=2.0)
    config = Configuration(max_iterations=50, max_distance_squared=1e4,
                           convergence_epsilon=1e-7)
    whole = run_with_configuration(cloud, after, config, device="cpu")
    monkeypatch.setenv("TPUSLAM_ICP_CHUNK", "6")
    parts = run_with_configuration(cloud, after, config, device="cpu")
    np.testing.assert_array_equal(parts[0], whole[0])
    np.testing.assert_array_equal(parts[1], whole[1])
    assert parts[2] == whole[2] and parts[3] == whole[3]


def test_icp_chunked_matches_unchunked(rng):
    cloud, after = _pair(rng, n=400, angle=0.6, trans=4.0)
    kw = dict(eps=1e-7, max_distance_squared=1e4, max_iterations=50)
    whole = register(cloud, after, **kw)
    for chunk in (1, 3, 10, 64):
        _same(icp_register_chunked(pc(cloud), pc(after), chunk=chunk, **kw), whole)
    want = jicp.icp_register_chunked(jax_pad_cloud(cloud), jax_pad_cloud(after), chunk=3, **kw)
    assert int(want.iterations) == whole.iterations
    np.testing.assert_allclose(whole.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(whole.transform.translation.numpy(),
                               np.asarray(want.transform.translation), rtol=0, atol=1e-4)


def test_icp_chunked_matches_unchunked_run_to_eps(rng):
    cloud, after = _pair(rng, angle=0.2, trans=1.0)
    kw = dict(eps=1e-5, max_distance_squared=1e4, max_iterations=-1)
    _same(icp_register_chunked(pc(cloud), pc(after), chunk=4, **kw), register(cloud, after, **kw))


def test_icp_chunked_divergence_guard(rng):
    cloud, after = _pair(rng, angle=2.8, trans=20.0)
    kw = dict(eps=1e-12, max_distance_squared=1e6, max_iterations=40)
    _same(icp_register_chunked(pc(cloud), pc(after), chunk=7, **kw),
          register(cloud, after, **kw))


def test_icp_chunked_matches_unchunked_spatial(rng):
    """The hierarchical arm's warm state crosses every boundary."""
    cloud, after = _pair(rng, angle=0.3, trans=2.0)
    kw = dict(eps=1e-7, max_distance_squared=1e4, max_iterations=12, use_spatial=True)
    _same(icp_register_chunked(pc(cloud), pc(after), chunk=5, **kw),
          register(cloud, after, **kw))


def test_icp_prealign_chunked_matches_unchunked(rng):
    before, after, _, _ = _anisotropic_pair(rng, 1.0, 10.0, n=600, keep=500)
    kw = dict(eps=1e-7, max_distance_squared=1e9, max_iterations=40)
    whole = icp_register_prealigned(pc(before), pc(after), **kw)
    _same(icp_register_prealigned(pc(before), pc(after), chunk=7, **kw), whole)


def test_icp_checkpoint_resume_matches_uninterrupted(rng, tmp_path):
    cloud, after = _pair(rng, n=400, angle=0.4, trans=3.0, permute=True)
    kw = dict(eps=1e-7, max_distance_squared=1e4, chunk=5)
    whole = icp_register_chunked(pc(cloud), pc(after), max_iterations=30, **kw)
    path = str(tmp_path / "icp.ckpt.npz")
    part = icp_register_chunked(pc(cloud), pc(after), max_iterations=10,
                                checkpoint_path=path, **kw)
    assert part.iterations == 10
    _same(icp_register_chunked(pc(cloud), pc(after), max_iterations=30, checkpoint_path=path,
                               **kw), whole)


def test_icp_checkpoint_resume_spatial(rng, tmp_path):
    """The warm state of the hierarchical arm goes through the file."""
    cloud, after = _pair(rng, n=400, angle=0.3, trans=2.0, permute=True)
    kw = dict(eps=0.0, max_distance_squared=1e4, chunk=3, use_spatial=True)
    whole = icp_register_chunked(pc(cloud), pc(after), max_iterations=8, **kw)
    path = str(tmp_path / "icp.ckpt.npz")
    icp_register_chunked(pc(cloud), pc(after), max_iterations=3, checkpoint_path=path, **kw)
    resume, _ = ckpt.load_icp_checkpoint(path)
    assert resume.nn is not None and bool(resume.nn.warm)
    _same(icp_register_chunked(pc(cloud), pc(after), max_iterations=8, checkpoint_path=path,
                               **kw), whole)


def test_icp_checkpoint_mismatch_starts_fresh(rng, tmp_path, capsys):
    cloud, after = _pair(rng, angle=0.2, trans=1.0)
    r_true, t_true = random_rigid(rng, 0.2, 1.0)
    path = str(tmp_path / "icp.ckpt.npz")
    kw = dict(max_iterations=6, chunk=3, eps=0.0, checkpoint_path=path)
    icp_register_chunked(pc(cloud), pc(after), **kw)
    assert os.path.exists(path)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_icp_checkpoint(path, expect_meta={"eps": 1e-5})
    other = (cloud * (1.0 + 1e-4)).astype(np.float32)
    other_after = (other @ r_true.T + t_true).astype(np.float32)
    clean = icp_register_chunked(pc(other), pc(other_after), max_iterations=6, chunk=3, eps=0.0)
    resumed = icp_register_chunked(pc(other), pc(other_after), **kw)
    assert "ignoring checkpoint" in capsys.readouterr().out
    _same(resumed, clean)


def test_icp_checkpoint_idempotent_rerun(rng, tmp_path, capsys):
    cloud, after = _pair(rng, angle=0.2, trans=1.0)
    path = str(tmp_path / "icp.ckpt.npz")
    kw = dict(chunk=3, eps=0.0, checkpoint_path=path)
    first = icp_register_chunked(pc(cloud), pc(after), max_iterations=6, **kw)
    _same(icp_register_chunked(pc(cloud), pc(after), max_iterations=6, **kw), first)
    # a request for fewer iterations than the file holds returns its state
    assert first.iterations > 1
    fewer = icp_register_chunked(pc(cloud), pc(after), max_iterations=first.iterations - 1,
                                 **kw)
    assert f"already holds {first.iterations} iterations" in capsys.readouterr().out
    _same(fewer, first)


def test_icp_registry_checkpoint_env(rng, monkeypatch, tmp_path):
    cloud, after = _pair(rng, angle=0.3, trans=2.0)
    config = Configuration(max_iterations=20, max_distance_squared=1e4,
                           convergence_epsilon=0.0)
    monkeypatch.setenv("TPUSLAM_ICP_CHUNK", "4")
    whole = run_with_configuration(cloud, after, config, device="cpu")
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", str(tmp_path / "cli.ckpt.npz"))
    run_with_configuration(cloud, after, Configuration(
        max_iterations=8, max_distance_squared=1e4, convergence_epsilon=0.0), device="cpu")
    cont = run_with_configuration(cloud, after, config, device="cpu")
    np.testing.assert_array_equal(cont[0], whole[0])
    np.testing.assert_array_equal(cont[1], whole[1])
    assert cont[2] == whole[2] and cont[3] == whole[3]


def test_icp_checkpoint_corrupt_file_starts_fresh(rng, tmp_path, capsys):
    cloud, after = _pair(rng, angle=0.2, trans=1.0)
    kw = dict(max_iterations=6, chunk=3, eps=0.0)
    clean = icp_register_chunked(pc(cloud), pc(after), **kw)
    path = str(tmp_path / "icp.ckpt.npz")
    icp_register_chunked(pc(cloud), pc(after), checkpoint_path=path, **kw)
    blob = open(path, "rb").read()
    for corrupt in (b"", blob[: len(blob) // 2]):
        with open(path, "wb") as fh:
            fh.write(corrupt)
        res = icp_register_chunked(pc(cloud), pc(after), checkpoint_path=path, **kw)
        assert "ignoring checkpoint" in capsys.readouterr().out
        _same(res, clean)
        ckpt.load_icp_checkpoint(path)  # overwritten with a valid boundary


def test_icp_checkpoint_prealign_and_cold_not_interchangeable(rng, tmp_path):
    cloud, after = _pair(rng, n=400, angle=1.2, trans=6.0, permute=True)
    kw = dict(max_iterations=8, eps=0.0, max_distance_squared=1e6)
    path = str(tmp_path / "icp.ckpt.npz")
    cold = icp_register_chunked(pc(cloud), pc(after), chunk=4, checkpoint_path=path, **kw)
    pre_fresh = icp_register_prealigned(pc(cloud), pc(after), chunk=4, **kw)
    assert not np.allclose(cold.transform.rotation.numpy(),
                           pre_fresh.transform.rotation.numpy(), atol=1e-3)
    _same(icp_register_prealigned(pc(cloud), pc(after), chunk=4, checkpoint_path=path, **kw),
          pre_fresh)
    _same(icp_register_chunked(pc(cloud), pc(after), chunk=4, checkpoint_path=path, **kw),
          cold)


def test_icp_prealign_resume_skips_seed_computation(rng, tmp_path, monkeypatch):
    cloud, after = _pair(rng, angle=0.8, trans=4.0)
    kw = dict(max_iterations=6, eps=0.0, max_distance_squared=1e6)
    path = str(tmp_path / "pre.ckpt.npz")
    calls = []
    real = nicp_mod.nicp_register

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nicp_mod, "nicp_register", counting)
    first = icp_register_prealigned(pc(cloud), pc(after), chunk=3, checkpoint_path=path, **kw)
    assert len(calls) == 1
    again = icp_register_prealigned(pc(cloud), pc(after), chunk=3, checkpoint_path=path, **kw)
    assert len(calls) == 1  # the boundary on disk supersedes the seed
    _same(again, first)
    _, meta = ckpt.load_icp_checkpoint(path)
    assert (meta["prealign"], meta["prealign_subcloud"], meta["prealign_seed"]) == (True, 1000, 0)


def test_icp_registry_ckpt_env_alone_forces_chunked(rng, monkeypatch, tmp_path):
    cloud, after = _pair(rng, angle=0.3, trans=2.0)
    config = Configuration(max_iterations=12, max_distance_squared=1e4,
                           convergence_epsilon=0.0)
    monkeypatch.delenv("TPUSLAM_ICP_CHUNK", raising=False)
    whole = run_with_configuration(cloud, after, config, device="cpu")
    path = str(tmp_path / "forced.ckpt.npz")
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", path)
    run_with_configuration(cloud, after, Configuration(
        max_iterations=5, max_distance_squared=1e4, convergence_epsilon=0.0), device="cpu")
    assert os.path.exists(path)
    cont = run_with_configuration(cloud, after, config, device="cpu")
    np.testing.assert_array_equal(cont[0], whole[0])
    assert cont[2] == whole[2] and cont[3] == whole[3]


def test_icp_registry_prealign_ckpt_env(rng, monkeypatch, tmp_path):
    before, after, _, _ = _anisotropic_pair(rng, 1.0, 10.0, n=600, keep=500)
    config = Configuration(max_iterations=12, max_distance_squared=1e9,
                           convergence_epsilon=0.0, icp_prealign=True)
    whole = run_with_configuration(before, after, config, device="cpu")
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", str(tmp_path / "pre.npz"))
    got = run_with_configuration(before, after, config, device="cpu")
    np.testing.assert_array_equal(got[0], whole[0])
    assert got[2] == whole[2] and got[3] == whole[3]


# CPD: the cases of tests/test_cpd.py ----------------------------------------------


def test_cpd_chunked_presorted_matches_unchunked(rng):
    """With the kernels the driver sorts once and runs its chunks on the
    sorted clouds; whole runs sort inside."""
    before = (rng.random((300, 3)) * 6.0 - 3.0).astype(np.float32)
    after = before[rng.permutation(300)].astype(np.float32) + 0.1
    kw = dict(weight=0.1, max_iterations=8, tolerance=1e-6, use_kernels=True)
    whole = cpd_register(pc(before), pc(after), **kw)
    _same(cpd_register_chunked(pc(before), pc(after), chunk=3, **kw), whole)


def test_cpd_chunked_phase_split_matches_unchunked(rng):
    before, after = _cpd_pair(rng)
    kw = dict(weight=0.1, max_iterations=60, tolerance=1e-6,
              approximation_type=ApproximationType.Hybrid, use_fgt=True)
    whole = cpd_register(pc(before), pc(after), **kw)
    for chunk, chunk_fast in ((1, 9), (3, 17)):
        _same(cpd_register_chunked(pc(before), pc(after), chunk=chunk, chunk_fast=chunk_fast,
                                   **kw), whole)


@pytest.mark.parametrize(
    "mode", [ApproximationType.NONE, ApproximationType.Hybrid, ApproximationType.Full])
def test_cpd_chunked_matches_unchunked(rng, mode):
    before, after = _cpd_pair(rng)
    kw = dict(weight=0.1, max_iterations=60, tolerance=1e-6, approximation_type=mode)
    whole = cpd_register(pc(before), pc(after), **kw)
    for chunk in (1, 7, 64):
        _same(cpd_register_chunked(pc(before), pc(after), chunk=chunk, **kw), whole)


def test_cpd_chunked_minus_one_runs_zero_iterations(rng):
    before = (rng.random((200, 3)) * 2.0).astype(np.float32)
    after = (rng.random((200, 3)) * 2.0).astype(np.float32)
    res = cpd_register_chunked(pc(before), pc(after), max_iterations=-1, chunk=4, weight=0.1)
    assert res.iterations == 0
    assert torch.equal(res.transform.rotation, torch.eye(3))


def test_cpd_chunked_record_history_raises(rng):
    before, after = _cpd_pair(rng, n=64)
    with pytest.raises(ValueError, match="record_history"):
        cpd_register_chunked(pc(before), pc(after), max_iterations=4, record_history=True)


def test_cpd_checkpoint_resume_matches_uninterrupted(rng, tmp_path):
    before, after = _cpd_pair(rng)
    kw = dict(weight=0.1, tolerance=1e-9, chunk=4)
    whole = cpd_register_chunked(pc(before), pc(after), max_iterations=30, **kw)
    path = str(tmp_path / "cpd.ckpt.npz")
    part = cpd_register_chunked(pc(before), pc(after), max_iterations=12, checkpoint_path=path,
                                **kw)
    assert part.iterations == 12
    _same(cpd_register_chunked(pc(before), pc(after), max_iterations=30, checkpoint_path=path,
                               **kw), whole)
    # an ICP checkpoint must be rejected by the CPD loader (kind guard)
    ick = str(tmp_path / "icp.ckpt.npz")
    ckpt.save_icp_checkpoint(ick, ICPResume(torch.eye(3), torch.zeros(3), torch.tensor(1.0)))
    with pytest.raises(ValueError, match="kind"):
        ckpt.load_cpd_checkpoint(ick)


def test_cpd_registry_chunk_env_matches_whole(rng, monkeypatch):
    before, after = _cpd_pair(rng, n=250, angle=0.2, trans=0.4)
    config = Configuration(computation_method=ComputationMethod.Cpd, max_iterations=40,
                           cpd_weight=0.1, cpd_tolerance=1e-7)
    whole = run_with_configuration(before, after, config, device="cpu")
    monkeypatch.setenv("TPUSLAM_CPD_CHUNK", "6")
    parts = run_with_configuration(before, after, config, device="cpu")
    np.testing.assert_array_equal(parts[0], whole[0])
    np.testing.assert_array_equal(parts[1], whole[1])
    assert parts[2] == whole[2] and parts[3] == whole[3]


def test_cpd_registry_checkpoint_env(rng, monkeypatch, tmp_path):
    before, after = _cpd_pair(rng, n=250, angle=0.2, trans=0.4)
    config = Configuration(computation_method=ComputationMethod.Cpd, max_iterations=20,
                           cpd_weight=0.1, cpd_tolerance=1e-9)
    whole = run_with_configuration(before, after, config, device="cpu")
    path = str(tmp_path / "cpd.npz")
    monkeypatch.setenv("TPUSLAM_CPD_CKPT", path)
    run_with_configuration(before, after, Configuration(
        computation_method=ComputationMethod.Cpd, max_iterations=8, cpd_weight=0.1,
        cpd_tolerance=1e-9), device="cpu")
    assert ckpt.load_cpd_checkpoint(path)[0].done_before == 8
    cont = run_with_configuration(before, after, config, device="cpu")
    np.testing.assert_array_equal(cont[0], whole[0])
    np.testing.assert_array_equal(cont[1], whole[1])
    assert cont[2] == whole[2] and cont[3] == whole[3]


def test_cpd_checkpoint_mismatch_starts_fresh(rng, tmp_path, capsys):
    before, after = _cpd_pair(rng, n=200, angle=0.2, trans=0.4)
    path = str(tmp_path / "cpd.ckpt.npz")
    kw = dict(max_iterations=8, chunk=3, tolerance=1e-9)
    cpd_register_chunked(pc(before), pc(after), weight=0.1, checkpoint_path=path, **kw)
    clean = cpd_register_chunked(pc(before), pc(after), weight=0.5, **kw)
    resumed = cpd_register_chunked(pc(before), pc(after), weight=0.5, checkpoint_path=path,
                                   **kw)
    assert "ignoring checkpoint" in capsys.readouterr().out
    _same(resumed, clean)


def test_cpd_checkpoint_corrupt_file_starts_fresh(rng, tmp_path, capsys):
    before, after = _cpd_pair(rng, n=200, angle=0.2, trans=0.5)
    kw = dict(max_iterations=6, chunk=3, weight=0.1)
    clean = cpd_register_chunked(pc(before), pc(after), **kw)
    path = str(tmp_path / "cpd.ckpt.npz")
    cpd_register_chunked(pc(before), pc(after), checkpoint_path=path, **kw)
    blob = open(path, "rb").read()
    for corrupt in (b"", blob[: len(blob) // 2]):
        with open(path, "wb") as fh:
            fh.write(corrupt)
        res = cpd_register_chunked(pc(before), pc(after), checkpoint_path=path, **kw)
        assert "ignoring checkpoint" in capsys.readouterr().out
        _same(res, clean)
        ckpt.load_cpd_checkpoint(path)


def test_register_entry_point_runs_chunked_on_both_methods(rng, monkeypatch, tmp_path):
    """``tpuslam_torch.register`` under both checkpoint variables runs the
    chunked drivers and lands on the whole runs."""
    cloud, after = _pair(rng, n=200, angle=0.2, trans=1.0)
    icp_kw = dict(max_iterations=10, convergence_epsilon=0.0, max_distance_squared=1e4)
    cpd_kw = dict(computation_method=ComputationMethod.Cpd, max_iterations=6, cpd_weight=0.1)
    whole = [tpuslam_torch.register(cloud, after, device="cpu", **kw) for kw in (icp_kw, cpd_kw)]
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", str(tmp_path / "icp.npz"))
    monkeypatch.setenv("TPUSLAM_CPD_CKPT", str(tmp_path / "cpd.npz"))
    got = [tpuslam_torch.register(cloud, after, device="cpu", **kw) for kw in (icp_kw, cpd_kw)]
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[2] == w[2] and g[3] == w[3]
    assert os.path.exists(tmp_path / "icp.npz") and os.path.exists(tmp_path / "cpd.npz")
