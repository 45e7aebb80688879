"""The readers of the Fast Gauss Transform's spans
(``regbench/span_time.py`` and ``fgt.device_ms_per_reg``,
``fgt.setup_ms_per_reg``, ``loop.trunc_ms_per_reg``) on a canned profiler
trace: each device operation counts under the span whose range holds its
launch, a replay's kernels through their ``cudaGraphLaunch``, a capture's
copies with the phase chunk around it; each reader gives None where the
trace lacks its span, as the trace of a program without these spans does.
Then the cell ``cpd-conv.100k`` from its files alone, on the CPU at a tiny
size."""

import json

import pytest

import harness
import span_time
import tracing as traces
from conftest import BENCH, ROOT, tiny_copy

SEED = 2**31 + 977
READERS = ("fgt.device_ms_per_reg", "fgt.setup_ms_per_reg", "loop.trunc_ms_per_reg")


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _launch(name, ts, corr):
    return _ev(name, "cuda_runtime", ts, 2.0, corr)


TORCH = "void at::native::elementwise_kernel<128, 4>()"
SPANS = [
    _span("regbench.window", 0.0, 1000.0),
    _span("tpuslam.register", 10.0, 480.0),
    _span("tpuslam.entry.prepare", 20.0, 80.0),
    _span("tpuslam.entry.fgt", 30.0, 50.0),
    _span("tpuslam.loop", 110.0, 300.0),
    _span("tpuslam.loop.fgt", 110.0, 100.0),
    _span("tpuslam.loop.capture", 150.0, 40.0),
    _span("tpuslam.loop.fgt", 220.0, 60.0),
    _span("tpuslam.loop.trunc", 300.0, 100.0),
    _span("tpuslam.register", 500.0, 400.0),
    _span("tpuslam.entry.prepare", 510.0, 40.0),
    _span("tpuslam.entry.fgt", 515.0, 30.0),
    _span("tpuslam.loop", 560.0, 300.0),
    _span("tpuslam.loop.fgt", 560.0, 200.0),
    _span("tpuslam.loop.trunc", 770.0, 80.0),
]
OPS = [
    # first registration: the entry (a kernel before the FGT's set-up, two
    # inside it), an eager fast chunk, its capture's copies, a fast replay
    # (two kernels), a slow chunk's kernel and fill
    _launch("cudaLaunchKernel", 22.0, 1), _ev(TORCH, "kernel", 25.0, 4.0, 1),
    _launch("cudaLaunchKernel", 35.0, 2), _ev(TORCH, "kernel", 40.0, 10.0, 2),
    _launch("cudaLaunchKernel", 60.0, 3), _ev(TORCH, "kernel", 62.0, 6.0, 3),
    _launch("cudaLaunchKernel", 120.0, 4), _ev(TORCH, "kernel", 125.0, 20.0, 4),
    _launch("cudaMemcpyAsync", 155.0, 5), _ev("Memcpy DtoD", "gpu_memcpy", 156.0, 3.0, 5),
    _launch("cudaGraphLaunch", 225.0, 6), _ev(TORCH, "kernel", 230.0, 30.0, 6),
    _ev("moments1_kernel(float const*)", "kernel", 260.0, 12.0, 6),
    _launch("cudaLaunchKernel", 310.0, 7), _ev("cpd_cand_denom_kernel()", "kernel", 315.0, 9.0, 7),
    _launch("cudaMemsetAsync", 320.0, 8), _ev("Memset", "gpu_memset", 325.0, 1.0, 8),
    # second registration: the set-up's kernel, one fast and one slow replay
    _launch("cudaLaunchKernel", 520.0, 9), _ev(TORCH, "kernel", 522.0, 8.0, 9),
    _launch("cudaGraphLaunch", 600.0, 10), _ev(TORCH, "kernel", 605.0, 50.0, 10),
    _launch("cudaGraphLaunch", 780.0, 11), _ev(TORCH, "kernel", 785.0, 15.0, 11),
    # a kernel whose launch the trace lacks
    _ev(TORCH, "kernel", 950.0, 10.0, 99),
]
PROFILED = [{"iterations": 3}, {"iterations": 2}]


def _trace(events):
    return traces.Trace(events, traces.load_families(BENCH / "kernels"), PROFILED, PROFILED,
                        None)


def _read(name, t):
    return harness.load_reader(BENCH, name).read(t)


def test_fgt_span_readers_on_a_canned_trace():
    t = _trace(SPANS + OPS)
    # fast chunks: the eager kernel 20, the capture's copy 3, the replays
    # 30 + 12 and 50; two registrations
    assert _read("fgt.device_ms_per_reg", t) == pytest.approx(115 / 1000 / 2)
    # the set-up's kernels 10 + 6 and 8 (not the prepare kernel before it)
    assert _read("fgt.setup_ms_per_reg", t) == pytest.approx(24 / 1000 / 2)
    # slow chunks: a kernel 9 and a fill 1, a replay 15
    assert _read("loop.trunc_ms_per_reg", t) == pytest.approx(25 / 1000 / 2)


def test_a_span_counts_what_is_launched_inside_it_at_any_depth():
    t = _trace(SPANS + OPS)
    # the capture's copy is the capture's stage and counts with the phase
    # around it; the whole loop is the two phases' sum
    loop = span_time.device_ms_per_reg(t, "tpuslam.loop")
    assert loop == pytest.approx((115 + 25) / 1000 / 2)
    assert span_time.device_ms_per_reg(t, "tpuslam.loop.capture") == pytest.approx(3 / 1000 / 2)


@pytest.mark.parametrize("name", READERS)
def test_fgt_span_readers_find_nothing_without_their_spans(name):
    # the parent's trace: registrations and loops but no FGT or phase span
    parent = [e for e in SPANS + OPS
              if e["name"] not in ("tpuslam.entry.fgt", "tpuslam.loop.fgt",
                                   "tpuslam.loop.trunc")]
    assert _read(name, _trace(parent)) is None
    without = [e for e in SPANS + OPS if e["name"] != "tpuslam.register"]
    assert _read(name, _trace(without)) is None
    assert _read(name, _trace(SPANS)) is None  # no device operation


def test_the_100k_cell_is_cpd_conv_at_100000_points():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(BENCH, "cpd-conv.100k")
    conv = json.loads((BENCH / "configs" / "cpd-conv.json").read_text())
    for key in ("registration", "protocol", "precision", "guarantees", "combos"):
        assert cell.config[key] == conv[key], key
    assert cell.traffic["sizes"] == cell.config["sizes"] == [100000]
    assert set(cell.check["limits"]) == {"rot_deg", "trans", "error_rel", "iters"}
    names = [m["name"] for m in cell.per_layer]
    assert set(READERS) <= set(names)
    assert "registration_p95_ms" not in [m["name"] for m in cell.end_to_end]
    for m in spec["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == ["cpd-conv.100k"]


def test_the_100k_cell_runs_from_its_files_on_the_cpu(tmp_path):
    """At a tiny size the FGT does not run, so its readers read nothing."""
    bench = tiny_copy(tmp_path)
    f = bench / "traffic" / "100k-p128.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), "sizes": [400],
                             "pool_pairs_per_size": 2, "sync_registrations": 1}))
    out = harness.run(bench, "cpd-conv.100k", SEED, 0.2, True, 0.0,
                      harness.torch.device("cpu"), log=lambda *a, **k: None)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"rot_deg", "trans", "error_rel", "iters"}
    for name in READERS:
        assert name not in out["metrics"]
