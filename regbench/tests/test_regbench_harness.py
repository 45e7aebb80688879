"""The harness on the CPU at tiny sizes: the result line's keys, a cell
added by files alone, the faults that must come out not correct, the
JAX-import check, and no result without a card."""

import hashlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import harness
from conftest import BENCH, ROOT, tiny_copy

SEED = 2**31 + 4242
CPU = torch.device("cpu")
CELLS = ("icp-perf.100k", "cpd-conv.4k-20k")


def _quiet(*args, **kwargs):
    pass


def _run(bench, cell, trace=False, system=None, seconds=0.2):
    return harness.run(bench, cell, SEED, seconds, trace, 0.0, CPU, system=system, log=_quiet)


def _keys(spec, cell, kind):
    return {m["name"] for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_expected_keys(tiny_bench, trace):
    spec = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    out = json.loads(json.dumps(_run(tiny_bench, "cpd-conv.4k-20k", trace)))
    expected = ["correct", "attempted", "failed", "metrics", "device", "readings", "checks"]
    if trace:
        expected.insert(5, "breakdown")
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) <= _keys(spec, "cpd-conv.4k-20k", "per_layer")
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(out["metrics"]) == _keys(spec, "cpd-conv.4k-20k", "end_to_end")
    assert list(out) == expected
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert out["attempted"] >= 2 and out["failed"] == 0  # each size once at least
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(out["readings"]) == set(harness.compare.NUMBERS)


def _digests(bench):
    return {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_traffic_metric_and_kernel_added_by_files_alone(tmp_path):
    bench = tiny_copy(tmp_path)
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "icp-perf.json").read_text())
    cfg["registration"]["max_iterations"] = 20
    (bench / "configs" / "icp-short.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "mixed.json").write_text(json.dumps(
        {"why": "two sizes", "sizes": [256, 384], "pool_pairs_per_size": 2,
         "sync_registrations": 1}))
    (bench / "checks" / "icp-short.mixed.json").write_text(json.dumps(
        {"per_size": 1, "limits": {"rot_deg": 0.1}}))
    (bench / "metrics" / "extra.profiled_regs.py").write_text(
        'LAYER = "entry"\n\n\ndef read(trace):\n    return float(len(trace.profiled))\n')
    (bench / "kernels" / "extra.json").write_text(json.dumps(
        {"kernel": "X", "pattern": "\\bextra_kernel\\b", "layer": "entry"}))
    spec_path = tmp_path / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "icp-short", "source": "a test", "file":
                            "regbench/configs/icp-short.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "icp-short.mixed", "config": "icp-short",
                              "traffic": "mixed", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "extra.profiled_regs", "unit": "reg", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "registrations_per_s",
                              "workloads": ["icp-short.mixed"]})
    spec_path.write_text(json.dumps(spec))
    plain = _run(bench, "icp-short.mixed")
    traced = _run(bench, "icp-short.mixed", trace=True)
    assert set(plain["metrics"]) == {"registrations_per_s", "setup_s"}
    assert traced["metrics"]["extra.profiled_regs"]["value"] >= 1.0
    assert set(plain["checks"]) == {"rot_deg"}
    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())  # no file of the harness edited


class Reference:
    """The plain reference in the program's place, with a planted fault;
    ``control``: computed in bfloat16, the precision below the float32
    that the configurations state (``control.py`` reads it, and the
    program with half the points left out, on the card at the cells' own
    sizes)."""

    def __init__(self, config, fault=None):
        self.config, self.fault = config, fault

    def __call__(self, before, after):
        if self.fault == "half":  # half of the points left out
            before, after = before[::2], after[::2]
        dtype = torch.bfloat16 if self.fault == "control" else torch.float32
        r, t, iterations, error = harness.reference(self.config, before, after, dtype, CPU)
        if self.fault == "unchanged":  # the state the loop started from
            return np.eye(3), np.zeros(3), 0, 1e5
        if self.fault == "altered":  # the answer altered where it is produced
            c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
            tilt = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            return tilt @ r, t + np.array([0.2, 0.0, 0.0]), iterations, error
        return r, t, iterations, error


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "control", "unchanged", "half", "altered"])
def test_faults_come_out_not_correct(tiny_bench, cell, fault):
    config = harness.load_cell(tiny_bench, cell).config
    out = _run(tiny_bench, cell, system=Reference(config, fault))
    assert out["correct"] is (fault is None)
    assert out["failed"] == 0


def test_the_port_drives_a_whole_run_on_the_cpu(tiny_bench):
    out = _run(tiny_bench, "cpd-conv.4k-20k")
    assert out["attempted"] >= 2 and out["failed"] == 0  # each size once at least
    assert np.isfinite(out["checks"]["rot_deg"]["value"])


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    tiny_copy(tmp_path)
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r]; torch.set_num_threads(1)\n"
        "import harness\n"
        "harness.run(__import__('pathlib').Path(%r), 'icp-perf.100k', 7, 0.2, True, 0.0,"
        " torch.device('cpu'), log=lambda *a, **k: None)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('tpuslam')"
        " or m.split('.')[0] in ('jax', 'jaxlib', 'flax'))[:3], harness.forbidden_modules())\n"
        % (str(ROOT), str(tmp_path / "regbench"), str(tmp_path / "regbench")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, found = out.stdout.strip().rsplit("] ", 1)
    assert "tpuslam_torch" in loaded  # the port ran, and its name begins with the JAX package's
    assert found == "[]"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--workload", "icp-perf.100k", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    for where in (ROOT, tmp_path):
        if where == tmp_path:  # only BENCHMARK.json and the benchmark's own files
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "regbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run([sys.executable, "regbench/run.py", *args], capture_output=True,
                             text=True, timeout=300, cwd=where)
        assert out.returncode != 0 and out.stdout == ""
