"""The port's headline entry and benchmark report
(``tpuslam_torch/harness/{bench,bench_report}.py``) against the JAX
repository's ``bench.py`` and ``tools/bench_report.py``, on the CPU at
tiny sizes, and the rule every measurement program keeps: no card and no
``--device cpu`` is an error that prints no number.

Tolerances: the drawn pairs are compared bit for bit (tolerance 0); the
report's rows are checked for their keys and stamps, not their times,
which on the CPU say nothing of the card.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuslam_torch.harness import bench_report, benchkit
from tpuslam_torch.kernels import KERNELS, P_ENTRIES, SKIPPED

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
TINY_REPORT = dict(nn=512, nicp=1024, cpd=256, amortized=(256, 384), chain=2, batch_pairs=2,
                   batch_large=384, batch_small=256, batch_iters=2, rungs=(512, 640),
                   ladder=(256,))
# JAX report keys the port leaves out, each with its reason
LEFT_OUT = {
    "nn_sustained_gops": "a count of TPU vector operations (14 a pair), not the card's work",
}
PROGRAMS = {
    "bench": ["--n-points", "256", "--iters", "1", "--reps", "1"],
    "bench_report": ["--reps", "1"],
    "cpd_large": ["512", "--reps", "1", "--iters", "2"],
    "cpd_crossover": ["512", "--reps", "1"],
    "sweep_hier": ["1024", "--reps", "1", "--iters", "1", "--triples", "auto"],
    "batch_diag": ["256", "--pairs", "2", "--iters", "1", "--reps", "1"],
    "sequence_bench": ["--reps", "1", "--sizes", "n_scans=3,n_points=256,parent=300"],
    "scaling_bench": ["--size", "512", "--iters", "1", "--reps", "1"],
    "convergence_study": ["--methods", "icp", "--sizes", "icp=300", "--repeats", "1"],
}


def _headline(tmp_path, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "tpuslam_torch.harness.bench", *args],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, **(env or {})))


def test_headline_prints_one_json_line(tmp_path):
    out = tmp_path / "headline.json"
    proc = _headline(tmp_path, "--device", "cpu", "--n-points", "1024", "--iters", "2",
                     "--reps", "2", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert set(line) == HEADLINE_KEYS
    assert line["metric"].startswith("icp_iters_per_sec_") and line["metric"].endswith("_cpu")
    assert line["unit"] == "iter/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 10.0, rel=1e-12)
    record = json.loads(out.read_text())
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    assert record["fixture"] in ("uniform-box", "tiled-bunny")
    assert record["iters_per_sec"] == line["value"] and len(record["call_ms"]) == 2
    (row,) = record["rows"]
    assert row["reps"] == 2 and row["min_ms"] <= row["median_ms"] <= row["max_ms"]


def test_headline_without_a_card_fails_and_prints_no_value(tmp_path):
    # no --device and no visible card: an error, never a number
    proc = _headline(tmp_path, "--n-points", "256", "--out", str(tmp_path / "x.json"),
                     env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "value" not in proc.stdout
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_refuse_the_cpu_unasked(name, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"tpuslam_torch.harness.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([*PROGRAMS[name], "--out", str(tmp_path / "out")])
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "out").exists()


def test_report_pairs_are_the_jax_draws():
    from tpuslam.core.types import pad_cloud
    from tpuslam.data.synthesis import (
        get_random_rotation_matrix,
        get_random_translation_vector,
    )

    # the JAX report's make_pair (nested in its main), in its draw order
    rng = np.random.Generator(np.random.PCG64(666))

    def make_pair(n, angle=0.2, trans=10.0):
        before = (rng.random((n, 3), dtype=np.float64) * 10.0).astype(np.float32)
        r = get_random_rotation_matrix(rng, angle)
        t = get_random_translation_vector(rng, trans)
        after = (before @ r.T + t)[rng.permutation(n)].astype(np.float32)
        return pad_cloud(before), pad_cloud(after)

    sizes = TINY_REPORT
    want = [make_pair(sizes["nn"]), make_pair(sizes["nicp"]), make_pair(sizes["cpd"], trans=1.0)]
    want += [make_pair(n, trans=1.0) for n in sizes["amortized"]]
    want += [make_pair(sizes["batch_large"]) for _ in range(sizes["batch_pairs"])]
    want += [make_pair(sizes["batch_small"]) for _ in range(sizes["batch_pairs"])]
    got = bench_report.draw_pairs(sizes)
    got = [got["nn"], got["nicp"], got["cpd"], *got["amortized"], *got["batch_large"],
           *got["batch_small"]]
    assert len(got) == len(want)
    for (gb, ga), (wb, wa) in zip(got, want):
        for g, w in ((gb, wb), (ga, wa)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w.points)[: int(w.count)])


PERF_CSV = ("test-no;cloud-size;rotation;translation;time(ms);iterations;error\n"
            "0;900000;0.2;10;900;45;0.1\n"
            "1;1100000;0.2;10;1500;50;0.1\n"
            "2;1300000;0.2;10;2000;40;0.1\n")


def test_report_keys_cover_the_jax_report(tmp_path):
    # the large rungs from a performance-set CSV, as the JAX report reads them
    out, csv = tmp_path / "report.json", tmp_path / "performance-icp.csv"
    csv.write_text(PERF_CSV)
    sizes = ",".join(f"{k}={':'.join(map(str, v)) if isinstance(v, tuple) else v}"
                     for k, v in TINY_REPORT.items())
    assert bench_report.main(["--device", "cpu", "--reps", "1", "--sizes", sizes,
                              "--perf-csv", str(csv), "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    with open(os.path.join(REPO_ROOT, "bench_report.json")) as fh:
        jax_keys = set(json.load(fh))
    missing = jax_keys - set(report) - set(LEFT_OUT)
    assert not missing, sorted(missing)
    assert set(LEFT_OUT) <= jax_keys
    for n in TINY_REPORT["ladder"]:
        assert {f"icp_iter_{n}_dense_ms", f"icp_iter_{n}_hier_ms"} <= set(report)
    assert report["sizes"]["nn"] == TINY_REPORT["nn"]
    assert report["icp_iter_100k_ms"] == report["icp_iter_100k_hier_ms"]
    assert report["icp_iter_largest_rung_points"] == 1_300_000
    assert report["icp_iter_largest_rung_ms"] == pytest.approx(50.0, rel=1e-12)
    assert report["icp_iter_1M_plus_median_ms"] == pytest.approx(40.0, rel=1e-12)
    assert report["icp_vs_ref_gpu_10s_per_iter_1M"] == pytest.approx(250.0, rel=1e-12)
    for row in report["rows"]:
        assert row["device"] == "cpu" and row["power_limit_w"] is None
        assert row["fixture"] in ("uniform-box", "tiled-bunny")
        assert row["reps"] == len(row["ms"]) == 1
        assert row["min_ms"] <= row["median_ms"] <= row["max_ms"]
        assert set(row["launches"]) == set(KERNELS) | set(P_ENTRIES) | set(SKIPPED)
        assert set(row["launches"].values()) == {0}  # the plain versions launch nothing
        assert row["expects"]


def test_report_measures_the_rungs_without_a_csv(tmp_path):
    out = tmp_path / "report.json"
    sizes = "nn=256,nicp=256,cpd=128,amortized=128:128,chain=1,batch_pairs=1,batch_large=128," \
            "batch_small=128,batch_iters=1,rungs=384:512,ladder="
    assert bench_report.main(["--device", "cpu", "--reps", "1", "--sizes", sizes,
                              "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["icp_iter_largest_rung_points"] == 512
    names = [r["name"] for r in report["rows"]]
    assert {"icp_iter_384", "icp_iter_512"} <= set(names)
    assert "icp_iter_1M_plus_median_ms" not in report  # no rung of 1M points or more


def test_default_outputs_are_new_files():
    dev = torch.device("cuda")
    path = benchkit.default_out("headline_100k", dev)
    assert path == benchkit.REPO_ROOT / "bench_results" / "h100_headline_100k.json"
    cpu = benchkit.default_out("headline_100k", torch.device("cpu"))
    assert cpu.relative_to(benchkit.REPO_ROOT).parts[0] == "build"
