"""The port's spans (``tpuslam_torch/core/spans.py``) on the CPU: off, a
span is one shared no-op that never reaches ``record_function``; under
``torch.profiler`` a registration through ``tpuslam_torch.register``
emits one ``tpuslam.register`` span holding its stages in order (CPD on
the Fast Gauss Transform also its set-up's span and a phase span a
chunk), and the result is the same bit for bit with the profiler as
without."""

import math

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpuslam_torch
from tpuslam_torch import ApproximationType, ComputationMethod
from tpuslam_torch.algorithms import cpd
from tpuslam_torch.core import spans
from tpuslam_torch.data.synthesis import (
    get_random_rotation_matrix,
    get_random_translation_vector,
)

STAGES = ["tpuslam.entry.copy_in", "tpuslam.entry.prepare", "tpuslam.loop",
          "tpuslam.entry.read_out"]
METHODS = {
    "icp": dict(computation_method=ComputationMethod.Icp, convergence_epsilon=1e-7,
                max_iterations=6),
    "cpd": dict(computation_method=ComputationMethod.Cpd,
                approximation_type=ApproximationType.Hybrid, cpd_weight=0.1,
                cpd_const_scale=True, cpd_tolerance=1e-6, max_iterations=6),
    # forced onto the FGT below its crossover: 13 fast-phase iterations,
    # then the slow phase until it converges at 15
    "cpd_fgt": dict(computation_method=ComputationMethod.Cpd,
                    approximation_type=ApproximationType.Hybrid, cpd_weight=0.1,
                    cpd_const_scale=True, cpd_tolerance=1e-6, max_iterations=20,
                    cpd_use_fgt=True),
}
FGT_SPANS = ("tpuslam.entry.fgt", "tpuslam.loop.fgt", "tpuslam.loop.trunc")


def _refuse(*args, **kwargs):
    raise AssertionError("reached while no profiler records")


def test_span_off_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(spans, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "_lazy_init", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    assert not torch._C._autograd._profiler_enabled()
    first = spans.span("tpuslam.register")
    assert spans.span("tpuslam.loop") is first
    with first:
        with spans.span("tpuslam.loop.capture"):
            pass
    assert spans.span(None) is first
    # nothing that the call allocates is alive inside the block
    mine = [tracemalloc.Filter(True, spans.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(mine)
        with spans.span("tpuslam.loop"):
            inside = tracemalloc.take_snapshot().filter_traces(mine)
    finally:
        tracemalloc.stop()
    grown = [d for d in inside.compare_to(before, "lineno") if d.size_diff > 0]
    assert not grown, grown


def _pair(seed: int, n: int = 300):
    rng = np.random.Generator(np.random.PCG64(seed))
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.15)
    after = (before @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    return before, after[rng.permutation(n)]


def _register(method: str):
    before, after = _pair(7)
    return tpuslam_torch.register(before, after, device="cpu", **METHODS[method])


@pytest.mark.parametrize("method", list(METHODS))
def test_a_registration_emits_its_stages_inside_one_register_span(method):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _register(method)
    ours = sorted((e for e in prof.events() if e.name.startswith("tpuslam.")),
                  key=lambda e: e.time_range.start)
    regs = [e for e in ours if e.name == "tpuslam.register"]
    assert len(regs) == 1
    reg = regs[0].time_range
    stages = [e for e in ours if e.name in STAGES]
    assert [e.name for e in stages] == STAGES
    for e in stages:
        assert reg.start <= e.time_range.start <= e.time_range.end <= reg.end, e.name
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)
    # the CPU's loop runs eager chunks: nothing captured
    assert not any(e.name == "tpuslam.loop.capture" for e in ours)


@pytest.mark.parametrize("method", list(METHODS))
def test_results_are_the_same_with_the_profiler_as_without(method):
    want = _register(method)
    with profile(activities=[ProfilerActivity.CPU]):
        got = _register(method)
    assert got[2] == want[2] and got[3] == want[3]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _ours(method: str) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _register(method)
    return sorted((e for e in prof.events() if e.name.startswith("tpuslam.")),
                  key=lambda e: e.time_range.start)


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            <= inner.time_range.end <= outer.time_range.end)


def test_the_fgt_emits_its_setup_span_and_a_phase_span_a_chunk():
    cpd.PHASE_TRACE.clear()
    ours = _ours("cpd_fgt")
    ran = list(cpd.PHASE_TRACE)
    prepare = [e for e in ours if e.name == "tpuslam.entry.prepare"]
    setup = [e for e in ours if e.name == "tpuslam.entry.fgt"]
    assert len(prepare) == 1 and len(setup) == 1
    assert _inside(setup[0], prepare[0])
    loop = [e for e in ours if e.name == "tpuslam.loop"]
    assert len(loop) == 1
    chunks = [e for e in ours if e.name in FGT_SPANS[1:]]
    for e in chunks:
        assert _inside(e, loop[0]), e.name
    for a, b in zip(chunks, chunks[1:]):
        assert a.time_range.end <= b.time_range.start
    # the fast phase's chunks, then the slow phase's, one span a chunk
    names = [e.name for e in chunks]
    fast, slow = ran.count("fgt"), ran.count("trunc")
    assert fast > 0 and slow > 0 and fast + slow == len(ran)
    k = cpd.LOOP_CHUNK
    assert names == (["tpuslam.loop.fgt"] * math.ceil(fast / k)
                     + ["tpuslam.loop.trunc"] * math.ceil(slow / k))


@pytest.mark.parametrize("method", ["icp", "cpd"])
def test_no_fgt_span_without_the_fgt(method):
    """ICP, and Hybrid CPD below the crossover, whose phase is a flag on
    the device."""
    ours = _ours(method)
    assert any(e.name == "tpuslam.loop" for e in ours)
    assert not [e.name for e in ours if e.name in FGT_SPANS]
