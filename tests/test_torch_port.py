"""The PyTorch port's entry points — ``tpuslam_torch.register``,
``run_with_configuration``, the headline measurement — against the JAX
package, plus the package's import boundary and its kernel build.

Whole-registration tolerances are those of ``test_torch_icp.py``: equal
iterations, R and t within 1e-4, the error within 1e-4 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import tpuslam
import tpuslam_torch
from tests.conftest import make_cloud, random_rigid
from tpuslam.harness import measure as jax_measure
from tpuslam_torch.algorithms.registry import run_with_configuration
from tpuslam_torch.config.configuration import ComputationMethod, Configuration
from tpuslam_torch.harness import measure
from tpuslam_torch.kernels import build

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_result(ours, ref):
    rot, trans, iters, err = ours
    assert iters == int(ref[2])
    np.testing.assert_allclose(rot, np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(ref[1]), rtol=0, atol=1e-4)
    assert err == pytest.approx(float(ref[3]), rel=1e-4, abs=1e-9)
    assert rot.dtype == trans.dtype == np.float32
    assert isinstance(iters, int) and isinstance(err, float)


def _pair(rng, n=2048):
    before = make_cloud(rng, n)
    r, t = random_rigid(rng, 0.2, 1.0)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    return before, after, r, t


def test_register_matches_jax(rng):
    before, after, r, _ = _pair(rng)
    kw = dict(max_iterations=50, max_distance_squared=1e4,
              convergence_epsilon=1e-5)
    ours = tpuslam_torch.register(before, after, device="cpu", **kw)
    _assert_same_result(ours, tpuslam.register(before, after, **kw))
    np.testing.assert_allclose(ours[0], r, atol=1e-3)


def test_run_with_configuration_defaults_match_jax(rng):
    # the default Configuration: max_iterations unset (-1, run to eps
    # 1e-3), max_distance_squared 1000, the divergence guard on
    before, after, _, _ = _pair(rng, n=1024)
    ours = run_with_configuration(before, after, Configuration(), device="cpu")
    from tpuslam.algorithms.registry import (
        run_with_configuration as jax_run_with_configuration,
    )
    from tpuslam.config.configuration import Configuration as JaxConfiguration

    _assert_same_result(
        ours, jax_run_with_configuration(before, after, JaxConfiguration())
    )


@pytest.mark.parametrize("what,match", [
    (dict(computation_method=ComputationMethod.NoniterativeIcp), "NICP"),
    (dict(computation_method=ComputationMethod.Cpd), "CPD"),
    (dict(icp_prealign=True), "NICP"),
])
def test_unported_methods_raise(rng, monkeypatch, tmp_path, what, match):
    # ICP (cold and NICP-prealigned) and CPD are ported; their checkpointed,
    # chunked forms are not (ROADMAP Queue 1 item 2).  NICP, which the JAX
    # package never chunks, is ported and runs with both set.
    monkeypatch.setenv("TPUSLAM_CPD_CKPT", str(tmp_path / "cpd.ckpt"))
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", str(tmp_path / "icp.ckpt"))
    cloud = make_cloud(rng, 64)
    if what.get("computation_method") == ComputationMethod.NoniterativeIcp:
        rot, _, iters, _ = tpuslam_torch.register(cloud, cloud, device="cpu", **what)
        assert iters == 4 and np.isfinite(rot).all()
        return
    with pytest.raises(NotImplementedError, match=f"{match}.*Queue 1 item 2"):
        tpuslam_torch.register(cloud, cloud, device="cpu", **what)


def test_headline_pair_matches_jax():
    ours = measure.build_headline_pair(2048, device="cpu")
    ref = jax_measure.build_headline_pair(2048)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.points.numpy(), np.asarray(r.points))
        assert int(o.count) == int(r.count) == 2048


def test_measure_icp_100k_runs_on_cpu():
    result = measure.measure_icp_100k(n_points=2048, iters=2, reps=1, device="cpu")
    assert set(result) == {
        "n_points", "iters_per_call", "iterations_run", "reps",
        "iters_per_sec", "ms_per_iter", "vs_baseline", "device", "fixture",
        "nn_arm",
    }
    assert result["nn_arm"] == "dense"  # the CPU default, as in JAX
    assert result["n_points"] == 2048
    assert result["iterations_run"] == result["iters_per_call"] == 2
    assert result["device"] == "cpu"
    assert result["fixture"] in ("uniform-box", "tiled-bunny")
    assert result["iters_per_sec"] > 0 and result["ms_per_iter"] > 0


def test_measure_reads_n_points_from_the_pair():
    pair = measure.build_headline_pair(1024, device="cpu")
    result = measure.measure_icp_100k(iters=1, reps=1, pair=pair)
    assert result["n_points"] == 1024  # not the 102,400 default


def test_package_imports_neither_jax_nor_tpuslam():
    code = (
        "import sys, numpy as np\n"
        "import tpuslam_torch\n"
        "rng = np.random.default_rng(0)\n"
        "b = rng.random((256, 3)).astype(np.float32)\n"
        "a = b + np.float32(0.01)\n"
        "rot, t, iters, err = tpuslam_torch.register(b, a, device='cpu',"
        " max_iterations=5)\n"
        "assert np.isfinite(err)\n"
        "import tpuslam_torch.interop, tpuslam_torch.harness.measure\n"
        "import tpuslam_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'tpuslam'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(force=True)


def test_build_digest_follows_the_sources(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._digest(tmp_path)
    assert build._digest(tmp_path) == first
    src.write_text("// two\n")
    second = build._digest(tmp_path)
    assert second != first
    # a header every kernel includes counts too
    header = tmp_path / "shared.cuh"
    header.write_text("// a\n")
    third = build._digest(tmp_path)
    assert third != second
    header.write_text("// b\n")
    assert build._digest(tmp_path) != third
    assert [p.name for p in build._sources()] == [
        "bound.cu", "cpd_cand.cu", "cpd_dense.cu", "nn_cand.cu", "nn_dense.cu"]
    assert (build.CSRC / "nn_fold.cuh").is_file()
    assert (build.CSRC / "cpd_gauss.cuh").is_file()
