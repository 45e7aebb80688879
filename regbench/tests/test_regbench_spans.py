"""The readers of the port's spans (``regbench/stages.py`` and the five
metrics that use it) on a canned profiler trace: each device operation
goes to the stage whose span launched it, through ``args.correlation``;
each reader gives its hand-computed number, and None where the trace
holds no ``tpuslam.register`` span, as the trace of a program without
spans does."""

import pytest

import harness
import stages
import tracing as traces
from conftest import BENCH

SEED = 2**31 + 4242


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _launch(name, ts, corr):
    return _ev(name, "cuda_runtime", ts, 2.0, corr)


TORCH = "void at::native::elementwise_kernel<128, 4>()"  # no family claims it
SPANS = [
    _span("regbench.window", 0.0, 1000.0),
    _span("tpuslam.register", 10.0, 480.0),
    _span("tpuslam.entry.copy_in", 20.0, 40.0),
    _span("tpuslam.entry.prepare", 70.0, 80.0),
    _span("tpuslam.loop", 160.0, 240.0),
    _span("tpuslam.loop.capture", 230.0, 70.0),
    _span("tpuslam.entry.read_out", 410.0, 70.0),
    _span("tpuslam.register", 500.0, 400.0),
    _span("tpuslam.entry.copy_in", 510.0, 30.0),
    _span("tpuslam.entry.prepare", 545.0, 15.0),
    _span("tpuslam.loop", 560.0, 290.0),
    _span("tpuslam.entry.read_out", 860.0, 30.0),
]
OPS = [
    # first registration: copy in, prepare (a kernel and a fill), a kernel
    # between the set-up and the loop, the loop (eager chunk, capture,
    # replay), the read
    _launch("cudaMemcpyAsync", 30.0, 1), _ev("Memcpy HtoD", "gpu_memcpy", 40.0, 10.0, 1),
    _launch("cudaLaunchKernel", 80.0, 2), _ev(TORCH, "kernel", 90.0, 20.0, 2),
    _launch("cudaMemsetAsync", 100.0, 3), _ev("Memset", "gpu_memset", 115.0, 5.0, 3),
    _launch("cudaLaunchKernel", 155.0, 4), _ev("reduce_kernel<512>()", "kernel", 156.0, 4.0, 4),
    _launch("cudaLaunchKernel", 170.0, 5),
    _ev("void nn_cand_kernel<128>(float const*)", "kernel", 175.0, 40.0, 5),
    _launch("cudaLaunchKernel", 180.0, 6), _ev("where_kernel()", "kernel", 215.0, 10.0, 6),
    _launch("cudaLaunchKernel", 240.0, 7), _ev(TORCH, "kernel", 300.0, 6.0, 7),
    _launch("cudaGraphLaunch", 320.0, 8), _ev(TORCH, "kernel", 325.0, 20.0, 8),
    _ev("moments1_kernel(float const*)", "kernel", 345.0, 10.0, 8),
    _launch("cudaMemcpyAsync", 420.0, 9), _ev("Memcpy DtoH", "gpu_memcpy", 430.0, 6.0, 9),
    # second registration: a copy in and one replay
    _launch("cudaMemcpyAsync", 515.0, 10), _ev("Memcpy HtoD", "gpu_memcpy", 520.0, 10.0, 10),
    _launch("cudaGraphLaunch", 570.0, 11), _ev(TORCH, "kernel", 580.0, 20.0, 11),
    # a launch under no span, and a kernel whose launch the trace lacks
    _launch("cudaLaunchKernel", 920.0, 12), _ev(TORCH, "kernel", 925.0, 5.0, 12),
    _ev(TORCH, "kernel", 950.0, 10.0, 99),
]
PROFILED = [{"iterations": 3}, {"iterations": 2}]


def _trace(events):
    return traces.Trace(events, traces.load_families(BENCH / "kernels"), PROFILED, PROFILED,
                        None)


def _read(name, t):
    return harness.load_reader(BENCH, name).read(t)


def test_each_device_operation_goes_to_the_stage_that_launched_it():
    ops = stages.stage_of_ops(_trace(SPANS + OPS))
    got = {op["args"]["correlation"]: stage for op, stage in ops}
    assert got == {1: "tpuslam.entry.copy_in", 2: "tpuslam.entry.prepare",
                   3: "tpuslam.entry.prepare", 4: "tpuslam.register", 5: "tpuslam.loop",
                   6: "tpuslam.loop", 7: "tpuslam.loop.capture", 8: "tpuslam.loop",
                   9: "tpuslam.entry.read_out", 10: "tpuslam.entry.copy_in",
                   11: "tpuslam.loop", 12: None, 99: None}


def test_span_readers_on_a_canned_trace():
    t = _trace(SPANS + OPS)
    # copies 10 + 6 + 10, the prepare kernel 20 and fill 5; two registrations
    assert _read("entry.device_ms_per_reg", t) == pytest.approx(51 / 1000 / 2)
    # entry spans 40 + 80 + 70 + 30 + 15 + 30 µs less 10 + 25 + 6 + 10 busy
    assert _read("entry.idle_ms_per_reg", t) == pytest.approx(214 / 1000 / 2)
    # unclaimed kernels launched in the loop: 10 + 6 + 20 + 20, 5 iterations
    assert _read("loop.torch_ms_per_iter", t) == pytest.approx(56 / 1000 / 5)
    # loop spans 240 + 290 µs less 50 + 6 + 30 + 20 busy
    assert _read("loop.idle_ms_per_reg", t) == pytest.approx(424 / 1000 / 2)
    assert _read("loop.captures_per_reg", t) == pytest.approx(0.5)


def test_the_unclaimed_kernels_split_with_nothing_lost():
    t = _trace(SPANS + OPS)
    split = stages.unclaimed_split(t)
    assert split == pytest.approx({"entry": 20.0, "loop": 56.0, "register": 4.0,
                                   "none": 15.0, "total": 95.0})
    assert split["total"] == pytest.approx(t.kernel_us(None)[0])
    assert _read("torch_ops.device_ms_per_iter", t) * 1000 * 5 == pytest.approx(95.0)


@pytest.mark.parametrize("name", ["entry.device_ms_per_reg", "entry.idle_ms_per_reg",
                                  "loop.torch_ms_per_iter", "loop.idle_ms_per_reg",
                                  "loop.captures_per_reg"])
def test_span_readers_find_nothing_without_a_register_span(name):
    without = [e for e in SPANS + OPS if e["name"] != "tpuslam.register"]
    assert _read(name, _trace(without)) is None
    no_spans = [e for e in SPANS + OPS if not e["name"].startswith("tpuslam.")]
    assert _read(name, _trace(no_spans)) is None


def test_a_traced_cpu_run_reads_the_spans(tiny_bench):
    """On the CPU the spans are there but no device operation is: the
    capture count reads 0 and the device readers nothing."""
    out = harness.run(tiny_bench, "icp-perf.100k", SEED, 0.2, True, 0.0,
                      harness.torch.device("cpu"), log=lambda *a, **k: None)
    assert out["metrics"]["loop.captures_per_reg"]["value"] == 0.0
    for name in ("entry.device_ms_per_reg", "entry.idle_ms_per_reg",
                 "loop.torch_ms_per_iter", "loop.idle_ms_per_reg"):
        assert name not in out["metrics"]
