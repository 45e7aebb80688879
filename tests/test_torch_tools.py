"""The port's measurement programs beside the headline
(``tpuslam_torch/harness/{cpd_large,cpd_crossover,sweep_hier,batch_diag,
sequence_bench,scaling_bench,convergence_study}.py``) against the JAX
repository's ``tools/`` originals, on the CPU at tiny sizes.

Tolerances: the stream generator, the drift and the sweep loop's nearest
neighbours are compared bit for bit (tolerance 0); a convergence run's
verdict must be equal and its gt-MSE within 1e-4 (the whole-registration
tolerance of ``test_torch_icp.py``); the sharded one-rank rung must equal
the solo run bit for bit.
"""

import ast
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from tpuslam_torch.config.configuration import ComputationMethod
from tpuslam_torch.harness import (
    batch_diag,
    convergence_study,
    cpd_crossover,
    cpd_large,
    scaling_bench,
    sequence_bench,
    sweep_hier,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO_ROOT, "tpuslam_torch", "harness")
PROGRAMS = ("bench", "bench_report", "cpd_large", "cpd_crossover", "sweep_hier", "batch_diag",
            "sequence_bench", "scaling_bench", "convergence_study")
# cpd_large keys of the JAX record the port leaves out, each with its reason
CPD_LARGE_LEFT_OUT = {
    "chunk_slow": "the port's automatic CPD chunking is off on every device",
    "chunk_fast": "as chunk_slow",
    "estep_cand_traj_entry_s_per_iter": "the Hybrid row records each iteration's E-step",
    "estep_cand_traj_exit_s_per_iter": "as the entry rate",
    "budget": "a wall budget from those sampled rates",
}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO_ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_constant(name, constant):
    """A literal module-level constant of a JAX tool, read from its source
    (the tool itself imports its siblings from ``tools/``)."""
    with open(os.path.join(REPO_ROOT, "tools", f"{name}.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == constant:
            return ast.literal_eval(node.value)
    raise KeyError(constant)


def _jax_record(name):
    with open(os.path.join(REPO_ROOT, "bench_results", name)) as fh:
        return json.load(fh)


def test_cpd_crossover_rows_have_the_jax_schema(tmp_path):
    out = tmp_path / "crossover.json"
    assert cpd_crossover.main(["640", "1024", "--device", "cpu", "--reps", "1",
                               "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    jax_row_keys = set(_jax_record("cpd_crossover.json")["rows"][0])
    assert "crossover_size" in got
    assert [r["size"] for r in got["rows"]] == [640, 1024]
    for row in got["rows"]:
        assert jax_row_keys <= set(row)
        assert row["fgt_speedup"] == pytest.approx(row["exact_s_per_iter"]
                                                   / row["fgt_s_per_iter"], rel=1e-12)
        assert set(row["arms"]) == {"exact", "fgt", "fgt_uncached"}
        assert row["device"] == "cpu" and row["power_limit_w"] is None and row["reps"] == 1
    assert cpd_crossover.crossover([{"size": 10, "fgt_speedup": 0.5},
                                    {"size": 30, "fgt_speedup": 1.5}]) == 20
    assert cpd_crossover.DEFAULT_SIZES[0] == 20_480
    assert set(_tool_constant("cpd_crossover", "DEFAULT_SIZES")) <= set(
        cpd_crossover.DEFAULT_SIZES)


def test_cpd_large_has_the_jax_schema(tmp_path):
    out = tmp_path / "cpd_large.json"
    assert cpd_large.main(["1024", "--device", "cpu", "--reps", "1", "--iters", "3",
                           "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = set()
    for key in _jax_record("cpd_large.json"):
        if key in CPD_LARGE_LEFT_OUT:
            continue
        # one protocol: tolerance 0 and --iters iterations, not 15 at 1e-4
        want.add(key.replace("hybrid_15iter", "hybrid_3iter"))
    assert want <= set(got), sorted(want - set(got))
    assert got["size"] == 1024 and got["hybrid_3iter_iterations"] == 3
    rows = {r["name"]: r for r in got["rows"]}
    assert rows["hybrid_3iter"]["phases"]["exact"] == 3  # the CPU: no FGT below the gate
    for row in rows.values():
        assert row["device"] == "cpu" and row["power_limit_w"] is None and row["reps"] == 1


@pytest.mark.parametrize("method", [ComputationMethod.Icp, ComputationMethod.NoniterativeIcp,
                                    ComputationMethod.Cpd])
def test_convergence_run_one_matches_jax(method):
    from tpuslam.config.configuration import ComputationMethod as JaxMethod

    tool = _tool("convergence_study")
    assert convergence_study.COMBOS == tool.COMBOS
    assert convergence_study.REPEATS == tool.REPEATS
    assert {m.value: s for m, s in convergence_study.SIZES.items()} == {
        m.value: s for m, s in tool.SIZES.items()}
    for rot, trans in ((0.2, 10.0), (0.6, 30.0)):
        got = convergence_study.run_one(method, 1000, rot, trans, 1000, device="cpu")
        want = tool.run_one(JaxMethod(method.value), 1000, rot, trans, 1000)
        assert got["converged"] == want["converged"]
        assert got["gt_mse"] == pytest.approx(want["gt_mse"], abs=1e-4)
        assert {k: got[k] for k in ("method", "size", "rotation", "translation", "seed")} == {
            k: want[k] for k in ("method", "size", "rotation", "translation", "seed")}


def test_convergence_study_writes_rows_and_summary(tmp_path):
    out = tmp_path / "conv.jsonl"
    assert convergence_study.main(["--device", "cpu", "--methods", "icp,cpd", "--sizes",
                                   "icp=300,cpd=200", "--repeats", "1", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 2 * len(convergence_study.COMBOS)
    assert {r["method"] for r in rows} == {"icp", "cpd"}
    for row in rows:
        assert row["fixture"] in ("uniform-box", "tiled-bunny") and row["device"] == "cpu"
        assert row["reps"] == 1 and row["ms"] == [row["wall_s"] * 1e3]
    summary = (tmp_path / "conv_summary.txt").read_text()
    assert summary.startswith("=== convergence rates ===") and "icp: overall" in summary


def test_stream_and_drift_match_the_jax_tool():
    tool = _tool("sequence_bench")
    got = sequence_bench.make_stream(5, 200, 300)
    want = tool.make_stream(5, 200, 300)
    np.testing.assert_array_equal(got[0], want[0])
    for (gr, gt), (wr, wt) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gt, wt)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(sequence_bench.rot_axis_angle(np.array([0.3, 1.0, 0.2]), 0.05),
                                  tool.rot_axis_angle(np.array([0.3, 1.0, 0.2]), 0.05))

    class Pose:
        def __init__(self, r, t):
            self.rotation, self.translation = r, t

    class Out:
        # an estimate near the truth: the inverse of each true pose, nudged
        absolute = [Pose(r.T, -(r.T @ t) + np.float32(0.01 * k))
                    for k, (r, t) in enumerate(want[1])]

    assert sequence_bench.drift_rms(got[0], got[1], Out, 5) == tool.drift_rms(
        want[0], want[1], Out, 5)


def test_sequence_bench_cpu_rows(tmp_path):
    out = tmp_path / "seq.json"
    assert sequence_bench.main(["--device", "cpu", "--reps", "1", "--sizes",
                                "n_scans=3,n_points=256,parent=400", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    names = [r["name"] for r in got["rows"]]
    assert names == ["scan_seeded", "scan_unseeded", "perpair_seeded"]
    for key in ("scan_seeded_wall_s", "scan_unseeded_mean_iters", "perpair_seeded_final_drift_rms",
                "dispatch_amortization_speedup", "seed_iteration_savings"):
        assert key in got
    assert "scan_seeded_syncs_per_pair" not in got  # counted on the card only


def test_scaling_bench_virtual_two_ranks(tmp_path):
    out = tmp_path / "scaling.json"
    assert scaling_bench.main(["--device", "cpu", "--virtual", "--ranks", "2", "--size", "1024",
                               "--iters", "3", "--reps", "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["complete_sweep"] is True and got["correctness_only"] is True
    assert got["backend"] == "gloo"
    assert [r["devices"] for r in got["rows"]] == [1, 2]
    for row in got["rows"]:
        assert row["correctness_only"] is True
        assert row["equal_to_solo"] and row["solo_max_abs_diff"] == 0.0
        assert 0.0 < row["predicted_efficiency"] <= 1.0
    assert got["rows"][0]["efficiency_vs_1"] == 1.0
    assert scaling_bench.world_sizes(6) == [1, 2, 4, 6]


@pytest.mark.parametrize("triple", sweep_hier.GRID + ["auto"], ids=str)
def test_sweep_loop_finds_the_dense_neighbours(triple):
    from tpuslam_torch.kernels.nn_dense import nearest_neighbors_dense
    from tpuslam_torch.ops.nn_hier import auto_tile_params, prepare_hier_target

    n = 4096
    g, gsrc, l_budget = auto_tile_params(n) if triple == "auto" else triple
    src, mask, ca = sweep_hier.make_pair(n, "cpu")
    target = prepare_hier_target(ca.points, ca.mask(), ca.count, g=g)
    record = []
    sweep_hier.icp_loop(src, mask, target, g, gsrc, l_budget, 2, record=record)
    # the hierarchical search is exact whatever the tiles: every query,
    # the first one (cold) included, equals the dense plain version
    for moved, idx, dist in record:
        want_idx, want_dist = nearest_neighbors_dense(moved, ca.points, ca.count)
        assert torch.equal(idx, want_idx)
        assert torch.equal(dist, want_dist)


def test_batch_diag_rows(tmp_path):
    out = tmp_path / "batch_diag.json"
    assert batch_diag.main(["256", "--pairs", "2", "--iters", "2", "--device", "cpu",
                            "--reps", "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert [r["name"] for r in got["rows"]] == [
        f"{k}_2x256" for k in ("nn_batched", "nn_solo", "icp_batched_dense", "icp_batched_hier",
                               "icp_solo_dense", "icp_solo_default")]
    assert set(got["summary"]["2x256"]) >= {"nn_batched_over_solo",
                                            "icp_batched_dense_over_solo_dense"}


def test_default_outputs_are_not_read_by_render_numbers():
    with open(os.path.join(REPO_ROOT, "tools", "render_numbers.py")) as fh:
        loaded = set(re.findall(r'_load\("([^"]+)"\)', fh.read()))
    assert "bench_report.json" in loaded and "bench_results/cpd_large.json" in loaded
    from tpuslam_torch.harness import benchkit

    for name in PROGRAMS:
        with open(os.path.join(HARNESS, f"{name}.py")) as fh:
            names = re.findall(r'default_out\(f?"([^"]+)"', fh.read())
        assert names, name  # every program writes through benchkit.default_out
        for stem in names:
            for suffix in ("", "_1m", "_prealign"):
                for dev in ("cuda", "cpu"):
                    path = benchkit.default_out(stem.replace("{suffix}", suffix),
                                                torch.device(dev))
                    rel = path.relative_to(benchkit.REPO_ROOT).as_posix()
                    assert rel not in loaded
                    assert os.path.basename(rel).startswith(("h100_", "cpu_"))
