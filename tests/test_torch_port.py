"""The PyTorch port's entry points — ``tpuslam_torch.register``,
``run_with_configuration``, the headline measurement — against the JAX
package, plus the package's import boundary and its kernel build.

Whole-registration tolerances are those of ``test_torch_icp.py``: equal
iterations, R and t within 1e-4, the error within 1e-4 relative.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

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
    # every method runs with both checkpoint variables set: ICP (cold and
    # NICP-prealigned) and CPD through their chunked drivers, NICP, which
    # the JAX package never chunks, as it is
    cloud = make_cloud(rng, 64)
    whole = tpuslam_torch.register(cloud, cloud, device="cpu", **what)
    monkeypatch.setenv("TPUSLAM_CPD_CKPT", str(tmp_path / "cpd.ckpt"))
    monkeypatch.setenv("TPUSLAM_ICP_CKPT", str(tmp_path / "icp.ckpt"))
    rot, trans, iters, err = tpuslam_torch.register(cloud, cloud, device="cpu", **what)
    assert np.isfinite(rot).all(), match
    np.testing.assert_array_equal(rot, whole[0])
    np.testing.assert_array_equal(trans, whole[1])
    assert (iters, err) == whole[2:]
    if what.get("computation_method") == ComputationMethod.NoniterativeIcp:
        assert iters == 4


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
        "nn_arm", "call_ms", "launches",
    }
    assert len(result["call_ms"]) == result["reps"] == 1
    assert set(result["launches"].values()) == {0}  # the plain versions
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


@pytest.mark.parametrize("entry", [
    "register", "register_pairs", "register_sequence", "pad_cloud", "measure_icp_100k"])
def test_entry_points_refuse_the_cpu_unasked(entry, monkeypatch):
    """With no card and no device named, every entry point raises: the
    port runs on the CPU only when the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(3)
    pts = rng.random((64, 3)).astype(np.float32)
    calls = {
        "register": lambda: tpuslam_torch.register(pts, pts, max_iterations=1),
        "register_pairs": lambda: tpuslam_torch.register_pairs([pts], [pts], max_iterations=1),
        "register_sequence": lambda: tpuslam_torch.register_sequence([pts, pts],
                                                                     max_iterations=1),
        "pad_cloud": lambda: tpuslam_torch.pad_cloud(pts),
        "measure_icp_100k": lambda: measure.measure_icp_100k(n_points=256, iters=1, reps=1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_package_imports_neither_jax_nor_tpuslam(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "method": "icp", "before-path": "synthetic://256", "after-path": "synthetic://256",
        "cloud-spread": 10.0, "random-seed": 7, "rotation-range": 0.2,
        "translation-range": 1.0, "max-iterations": 5,
        "save-output-path": str(tmp_path / "out.obj")}))
    code = (
        "import runpy, sys, numpy as np\n"
        "import tpuslam_torch\n"
        "rng = np.random.default_rng(0)\n"
        "b = rng.random((256, 3)).astype(np.float32)\n"
        "a = b + np.float32(0.01)\n"
        "rot, t, iters, err = tpuslam_torch.register(b, a, device='cpu',"
        " max_iterations=5)\n"
        "assert np.isfinite(err)\n"
        "import tpuslam_torch.interop, tpuslam_torch.harness.measure\n"
        "import tpuslam_torch.kernels.build\n"
        "import tpuslam_torch.harness.cli, tpuslam_torch.harness.runner\n"
        "import tpuslam_torch.harness.noise, tpuslam_torch.harness.testsets\n"
        "import tpuslam_torch.native.bindings, tpuslam_torch.viz.webgl\n"
        "import tpuslam_torch.viz.view, tpuslam_torch.data.writer\n"
        "import tpuslam_torch.parallel.distributed, tpuslam_torch.parallel.mesh\n"
        "import tpuslam_torch.parallel.collectives, tpuslam_torch.parallel.nn\n"
        "import tpuslam_torch.parallel.icp, tpuslam_torch.parallel.nicp\n"
        "import tpuslam_torch.parallel.cpd, tpuslam_torch.parallel.batch\n"
        "import tpuslam_torch.parallel.comm_model\n"
        "import tpuslam_torch.harness.benchkit, tpuslam_torch.harness.bench\n"
        "import tpuslam_torch.harness.bench_report, tpuslam_torch.harness.cpd_large\n"
        "import tpuslam_torch.harness.cpd_crossover, tpuslam_torch.harness.sweep_hier\n"
        "import tpuslam_torch.harness.batch_diag, tpuslam_torch.harness.sequence_bench\n"
        "import tpuslam_torch.harness.scaling_bench\n"
        "import tpuslam_torch.harness.convergence_study\n"
        "from tpuslam_torch.parallel.launch import run_cases, run_world\n"
        "if __name__ == '__main__':\n"
        "    rank0, _ = run_world(run_cases, 2, 'gloo', 'cpu', 30.0, [('modules', {})])\n"
        "    child = set(rank0[0]['result']['modules'])\n"
        "    assert 'tpuslam_torch' in child, sorted(child)\n"
        "    assert not child & {'jax', 'jaxlib', 'tpuslam', 'tests'}, sorted(child)\n"
        f"sys.argv = ['tpuslam_torch', '--device', 'cpu', {str(cfg)!r}]\n"
        "try:\n"
        "    runpy.run_module('tpuslam_torch', run_name='__main__')\n"
        "except SystemExit as stop:\n"
        "    assert stop.code == 0, stop.code\n"
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
    out = proc.stdout.strip().splitlines()
    assert "Results for the icp method:" in out and out[-1] == "ok"
    assert (tmp_path / "out.obj").exists()


def test_no_module_of_the_port_imports_jax_or_tpuslam():
    """Every file of the package, imported or not by the test above (the
    measurement programs under ``harness/`` included)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpuslam)(\.|\s|$)")
    files = [os.path.join(root, name)
             for root, _, names in os.walk(os.path.join(REPO_ROOT, "tpuslam_torch"))
             for name in names if name.endswith(".py")]
    assert any(f.endswith(os.path.join("harness", "bench_report.py")) for f in files)
    bad = [(f, i + 1) for f in files for i, line in enumerate(open(f)) if pattern.match(line)]
    assert not bad, bad


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
        "bound.cu", "cpd_cand.cu", "cpd_dense.cu", "cpd_plan.cu", "fgt.cu", "nn_cand.cu",
        "nn_dense.cu", "procrustes.cu"]
    assert (build.CSRC / "nn_fold.cuh").is_file()
    assert (build.CSRC / "cpd_gauss.cuh").is_file()
