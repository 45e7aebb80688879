"""Each per-layer reader gives its number from a canned profiler trace and
canned counts, and nothing where there is nothing to read."""

import json

import pytest

import harness
import tracing as traces
from conftest import BENCH, ROOT


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


CANNED = [
    _ev("regbench.window", "user_annotation", 1000.0, 1000.0),
    _ev("regbench.register", "user_annotation", 1000.0, 990.0),
    _ev("cudaGraphLaunch", "cuda_runtime", 1010.0, 40.0),
    _ev("void nn_cand_kernel<128>(float const*, float4 const*)", "kernel", 1100.0, 200.0),
    _ev("bound_kernel(__nv_bfloat16 const*)", "kernel", 1300.0, 100.0),
    _ev("moments1_kernel(float const*)", "kernel", 1450.0, 50.0),
    _ev("void at::native::elementwise_kernel<128, 4>()", "kernel", 1600.0, 100.0),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1800.0, 50.0),
    _ev("cudaStreamSynchronize", "cuda_runtime", 1710.0, 80.0),
    _ev("void nn_dense_kernel()", "kernel", 500.0, 100.0),  # before the window: not read
]
PROFILED = [{"iterations": 2}, {"iterations": 3}]
WINDOW = [{"iterations": 2}, {"iterations": 3}, {"iterations": 7}]


def _trace(syncs=(12, 3), events=CANNED):
    return traces.Trace(events, traces.load_families(BENCH / "kernels"), PROFILED, WINDOW, syncs)


def _read(name, t):
    return harness.load_reader(BENCH, name).read(t)


def test_readers_on_a_canned_trace():
    t = _trace()
    assert _read("nn.device_ms_per_iter", t) == pytest.approx((200 + 100) / 1000 / 5)
    assert _read("procrustes.device_ms_per_iter", t) == pytest.approx(50 / 1000 / 5)
    assert _read("torch_ops.device_ms_per_iter", t) == pytest.approx(100 / 1000 / 5)
    assert _read("estep.device_ms_per_iter", t) is None  # no K4/K5 kernel ran
    assert _read("device.idle_pct", t) == pytest.approx(100 * (1 - 500 / 1000))
    assert _read("loop.syncs_per_reg", t) == pytest.approx(4.0)
    assert _read("loop.iterations_per_reg", t) == pytest.approx(12 / 3)
    assert t.window_us == 1000.0 and t.busy_us == 500.0


def test_readers_find_nothing_to_read():
    t = _trace(syncs=None, events=[_ev("regbench.window", "user_annotation", 0.0, 10.0)])
    for name in ("nn.device_ms_per_iter", "estep.device_ms_per_iter",
                 "procrustes.device_ms_per_iter", "torch_ops.device_ms_per_iter",
                 "device.idle_pct", "loop.syncs_per_reg"):
        assert _read(name, t) is None, name


def test_breakdown_names_ops_and_gaps():
    b = _trace().breakdown()
    name, seconds = b["device_ops"][0]
    assert name == "void nn_cand_kernel<128>(float const*, float4 const*)"
    assert seconds == pytest.approx(200e-6)
    assert len(b["device_ops"]) == 5
    gaps = dict((name, s) for name, s in b["idle_gaps"])
    # the gap 1700-1800 lies under the synchronisation, the first under the launch
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-6)
    assert all(len(b[k]) <= 10 for k in b)


def test_every_per_layer_metric_has_a_reader_of_its_layer():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert harness.load_reader(BENCH, m["name"]).LAYER == m["layer"], m["name"]


def test_every_kernel_of_the_port_has_a_family():
    fams = traces.load_families(BENCH / "kernels")
    src = (ROOT / "tpuslam_torch" / "csrc")
    import re

    names = set()
    for f in src.glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                f.read_text()))
    assert names
    for name in names:
        assert any(fam.pattern.search(f"void {name}(float const*)") for fam in fams), name
