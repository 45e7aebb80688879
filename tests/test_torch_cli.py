"""The port's command line (``python -m tpuslam_torch``,
``tpuslam_torch.harness.cli``) against the JAX package's
(``tpuslam.harness.cli``) on the same configs and requests.

``run_config`` must print what the JAX CLI prints, line for line: the
same echo and messages, the numbers of the matrix and the error within
1e-4 and the same iterations.  ``--serve`` must answer the same requests
with the same ``ok`` flags and messages, the same iterations, R and t
within 1e-4 and the error within 1e-4 relative.  ``--device`` stands
where the JAX CLI's ``--platform`` stands; its default is the card, and
without one the CLI refuses unless ``--device cpu`` asks for the CPU.

The clouds are whole synthetic clouds registered with a moved copy of
themselves, so that each run stops by convergence: on subsamples drawn
apart ICP stops on a plateau when the error rises by a rounding, which
two implementations need not do at the same iteration.
"""

import io
import json
import sys

import numpy as np
import pytest
import torch

from tpuslam.harness import cli as jax_cli
from tpuslam_torch.algorithms.registry import run_with_configuration
from tpuslam_torch.config.parser import ConfigParser
from tpuslam_torch.data.loader import load_cloud
from tpuslam_torch.data.synthesis import get_clouds_from_config, transform_cloud
from tpuslam_torch.harness import cli, testsets

REQUESTS = {
    "icp": {"method": "icp", "before-path": "synthetic://256", "after-path": "synthetic://256",
            "cloud-spread": 10.0, "random-seed": 7, "rotation-range": 0.2,
            "translation-range": 1.0, "max-iterations": 30},
    # the box's isotropic spectrum would widen NICP's candidates, and the
    # plain K1 on the CPU makes that slow; test_torch_nicp.py holds it
    "nicp": {"method": "nicp", "before-path": "synthetic://300", "after-path": "synthetic://300",
             "cloud-spread": 10.0, "random-seed": 3, "rotation-range": 0.3,
             "translation-range": 2.0, "nicp-degenerate-widening": 0},
    "cpd": {"method": "cpd", "before-path": "synthetic://200", "after-path": "synthetic://200",
            "cloud-spread": 10.0, "random-seed": 5, "rotation-range": 0.2,
            "translation-range": 0.5, "max-iterations": 30, "cpd-weight": 0.1,
            "approximation-type": "none"},
}


def _config_file(tmp_path, request, name="cfg.json"):
    path = tmp_path / name
    path.write_text(json.dumps(request))
    return str(path)


def _numbers(line):
    return [float(tok) for tok in line.replace("|", " ").split()]


def _assert_same_output(ours: str, ref: str):
    ours, ref = ours.splitlines(), ref.splitlines()
    assert len(ours) == len(ref)
    in_matrix = False
    for a, b in zip(ours, ref):
        if in_matrix and "|" in b:
            np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=0, atol=1e-4)
            continue
        in_matrix = b == "Transformation matrix:"
        if b.startswith("Error: "):
            assert float(a.split()[1]) == pytest.approx(float(b.split()[1]), abs=1e-4)
        else:
            assert a == b  # the echo, the messages, "Iterations: N"


@pytest.mark.parametrize("method", list(REQUESTS))
def test_run_config_prints_what_jax_prints(tmp_path, capsys, method):
    path = _config_file(tmp_path, REQUESTS[method])
    assert cli.run_config([path], device="cpu") == 0
    ours = capsys.readouterr()
    assert jax_cli.run_config([path]) == 0
    ref = capsys.readouterr()
    assert f"Results for the {method} method:" in ours.out
    _assert_same_output(ours.out, ref.out)
    assert ours.err == "[tpuslam_torch] device: cpu\n"


@pytest.mark.parametrize("payload", [
    {"method": "icp"},  # parse error
    {**REQUESTS["icp"], "before-path": "no/such/cloud.obj"},  # empty cloud
])
def test_run_config_refusals_match_jax(tmp_path, capsys, payload):
    path = _config_file(tmp_path, payload)
    assert cli.run_config([path], device="cpu") == jax_cli.run_config([path]) == 1
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]  # both printed the same


def test_save_output_path_writes_the_registered_cloud(tmp_path, capsys):
    out = str(tmp_path / "registered.obj")
    path = _config_file(tmp_path, {**REQUESTS["icp"], "save-output-path": out})
    assert cli.main(["--device", "cpu", path]) == 0
    assert f"Transformed cloud saved to {out}" in capsys.readouterr().out
    config = ConfigParser([path]).get_configuration()
    before, after, _ = get_clouds_from_config(config)
    rot, trans, _, _ = run_with_configuration(before, after, config, device="cpu")
    np.testing.assert_array_equal(load_cloud(out), transform_cloud(before, rot, trans))
    bad = _config_file(tmp_path, {**REQUESTS["icp"], "save-output-path": str(tmp_path / "x.ply")},
                       "bad.json")
    assert cli.main(["--device", "cpu", bad]) == 0
    assert "Could not save transformed cloud" in capsys.readouterr().out


@pytest.mark.parametrize("matplotlib", [True, False])
def test_show_visualisation_writes_html(tmp_path, monkeypatch, capsys, matplotlib):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = _config_file(tmp_path, {**REQUESTS["icp"], "show-visualisation": True})
    assert cli.main(["--device", "cpu", path]) == 0
    captured = capsys.readouterr()
    assert (tmp_path / "registration.html").exists()
    assert (tmp_path / "registration.png").exists() == matplotlib
    assert ("matplotlib is not installed" in captured.err) != matplotlib


def test_serve_answers_as_jax_does(tmp_path, capsys):
    saved = str(tmp_path / "served.off")
    lines = [
        "not json {",
        "[1, 2]",
        json.dumps({"method": "icp"}),
        json.dumps({**REQUESTS["icp"], "method": "supericp"}),
        json.dumps({**REQUESTS["icp"], "before-path": "synthetic://0"}),
        json.dumps(REQUESTS["icp"]),
        "",
        json.dumps({**REQUESTS["icp"], "random-seed": 8, "save-output-path": saved}),
        json.dumps(REQUESTS["nicp"]),
        json.dumps(REQUESTS["cpd"]),
    ]
    requests = "\n".join(lines) + "\n"
    ours, ref = io.StringIO(), io.StringIO()
    assert cli.run_serve(io.StringIO(requests), ours, device="cpu") == 0
    err = capsys.readouterr().err
    assert jax_cli.run_serve(io.StringIO(requests), ref) == 0
    assert "Served 9 request(s)" in err and "device: cpu" in err
    got = [json.loads(ln) for ln in ours.getvalue().splitlines()]
    want = [json.loads(ln) for ln in ref.getvalue().splitlines()]
    assert len(got) == len(want) == 9
    assert [g["ok"] for g in got] == [False] * 5 + [True] * 4
    for g, w in zip(got, want):
        assert g["ok"] == w["ok"] and set(g) == set(w)
        if not g["ok"]:
            assert g["error"] == w["error"]
            continue
        assert g["iterations"] == w["iterations"]
        np.testing.assert_allclose(g["rotation"], w["rotation"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["translation"], w["translation"], rtol=0, atol=1e-4)
        assert g["error"] == pytest.approx(w["error"], rel=1e-4, abs=1e-9)
    assert load_cloud(saved).shape == (256, 3)


def test_serve_through_main_reads_stdin(monkeypatch, capsys):
    requests = [REQUESTS["icp"], {"method": "icp"}]
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(json.dumps(r) + "\n"
                                                          for r in requests)))
    assert cli.main(["--device", "cpu", "--serve"]) == 0
    captured = capsys.readouterr()
    good, bad = captured.out.splitlines()  # the responses alone on stdout
    assert json.loads(good)["ok"] is True and json.loads(bad)["ok"] is False
    # the parser's messages went to stderr
    assert "Parsing error: param before-path is required" in captured.err
    assert "Served 2 request(s)" in captured.err


@pytest.mark.parametrize("argv", [
    ["CFG"],  # the default device, the card
    ["--device", "cuda", "CFG"],
    ["--device", "cuda:1", "--serve"],
    ["--device", "tpu", "CFG"],
    ["--device", "nonsense", "--test-set", "sizes"],
])
def test_device_is_the_card_unless_cpu_is_asked_for(tmp_path, monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _config_file(tmp_path, REQUESTS["icp"])
    argv = [path if a == "CFG" else a for a in argv]
    assert cli.main(argv) == 1
    captured = capsys.readouterr()
    assert "Results for" not in captured.out and captured.out == ""
    (line,) = captured.err.splitlines()
    assert "--device" in line
    if argv[0] != "--device" or argv[1].startswith("cuda"):
        assert "no CUDA device" in line and "--device cpu" in line


def test_device_cpu_runs(tmp_path, capsys):
    path = _config_file(tmp_path, REQUESTS["icp"])
    assert cli.main(["--device", "cpu", path]) == 0
    assert "Results for the icp method" in capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["sizes", "--methods", "icp,nipc"],
    ["bogus"],
    ["sizes", "--frobnicate"],
])
def test_test_set_cli_refusals_match_jax(capsys, args):
    assert cli.run_test_set_cli(args, device="cpu") == jax_cli.run_test_set_cli(args) == 1
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]


def test_test_set_cli_writes_what_jax_writes(tmp_path, monkeypatch, capsys):
    from dataclasses import replace

    from tpuslam.harness import testsets as jax_testsets

    def small(gen):
        # the reference's test sets draw their motion unseeded: seed it here
        return lambda m: [replace(c, before_path="synthetic://256", after_path="synthetic://256",
                                  cloud_before_resize=256, cloud_after_resize=256,
                                  random_seed=11)
                          for c in gen(m)[:1]]

    monkeypatch.setitem(testsets.TEST_SETS, "sizes", small(testsets.TEST_SETS["sizes"]))
    monkeypatch.setitem(jax_testsets.TEST_SETS, "sizes", small(jax_testsets.TEST_SETS["sizes"]))
    args = ["sizes", "--methods", "icp,cpd", "--resume"]
    assert cli.main(["--device", "cpu", "--test-set", *args, "--out", str(tmp_path / "o")]) == 0
    assert jax_cli.main(["--test-set", *args, "--out", str(tmp_path / "r")]) == 0
    assert f"Wrote: {tmp_path / 'o' / 'sizes-icp.csv'}" in capsys.readouterr().out
    for method in ("icp", "cpd"):
        rows = [[ln.rstrip("\n").split(";") for ln in open(tmp_path / d / f"sizes-{method}.csv")]
                for d in ("o", "r")]
        assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 2
        got, want = rows[0][1], rows[1][1]
        assert got[:4] + got[5:6] == want[:4] + want[5:6]  # all but time(ms) and error
        assert float(got[6]) == pytest.approx(float(want[6]), abs=1e-4)
    # the noise suite has no ICP configs: nothing to run, nothing written
    assert cli.main(["--device", "cpu", "--test-set", "noise", "--methods", "icp",
                     "--out", str(tmp_path / "n")]) == 0
    assert "[noise] no configs for method 'icp'" in capsys.readouterr().out

