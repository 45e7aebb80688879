"""Benchmark test-set generators — the reference's three suites
(``testset.cpp:48-187``) with the same methods, sizes, ladders and knobs.

A numpy-only copy of ``tpuslam/harness/testsets.py`` on the port's
``Configuration`` and loader: importing the original runs
``tpuslam/__init__.py``, which imports JAX.  ``tests/test_torch_front.py``
holds every generator to its original.

The size->model ladder (``testset.cpp:19-38``) picks the smallest bundled
model with at least the requested vertex count; models above bird (35008
merged points) are missing blobs in this checkout (SURVEY §2.8), so those
rungs substitute a deterministic ``synthetic://`` cloud, clearly visible in
the emitted config paths and CSV.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Callable, Dict, List, Tuple

from tpuslam_torch.config.configuration import (
    ApproximationType,
    ComputationMethod,
    Configuration,
    ExecutionPolicy,
)
from tpuslam_torch.data.loader import resolve_path

# (name, merged vertex count) — testset.cpp:19-38
_MODEL_LADDER = [
    ("bunny", 14904),
    ("bird", 35008),
    ("rose", 333536),
    ("mustang", 376401),
    ("airbus", 1375028),
]


def get_object_with_min_size(size: int) -> str:
    """``GetObjectWithMinSize`` (``testset.cpp:19-38``), with missing-blob
    fallback to ``synthetic://``."""
    for name, count in _MODEL_LADDER:
        if size <= count:
            path = f"data/{name}.obj"
            if os.path.exists(resolve_path(path)):
                return path
            return f"synthetic://{size}"
    raise ValueError(f"no model with at least {size} points")


def _sweep(min_size: int, span: int, max_size: int):
    return range(min_size, max_size + 1, span)


def get_sizes_test_set(method: ComputationMethod) -> List[Configuration]:
    """``GetSizesTestSet`` (``testset.cpp:48-80``)."""
    params: Dict[ComputationMethod, Tuple[int, int, int]] = {
        ComputationMethod.Icp: (1000, 4000, 100000),
        ComputationMethod.Cpd: (100, 100, 1000),
        ComputationMethod.NoniterativeIcp: (1000, 4000, 200000),
    }
    out = []
    for size in _sweep(*params[method]):
        path = get_object_with_min_size(size)
        out.append(
            Configuration(
                computation_method=method,
                before_path=path,
                after_path=path,
                max_iterations=50,
                max_distance_squared=10000.0,
                transformation_parameters=(0.2, 10.0),
                cloud_before_resize=size,
                cloud_after_resize=size,
                execution_policy=(
                    ExecutionPolicy.Parallel
                    if method == ComputationMethod.Icp
                    else ExecutionPolicy.Sequential
                ),
                approximation_type=ApproximationType.NONE,
                cpd_weight=0.1,
            )
        )
    return out


def get_performance_test_set(method: ComputationMethod) -> List[Configuration]:
    """``GetPerformanceTestSet`` (``testset.cpp:82-117``)."""
    params: Dict[ComputationMethod, Tuple[int, int, int]] = {
        ComputationMethod.Icp: (25000, 25000, 1300000),
        ComputationMethod.Cpd: (100, 100, 1000),
        ComputationMethod.NoniterativeIcp: (10000, 10000, 300000),
    }
    out = []
    for size in _sweep(*params[method]):
        path = get_object_with_min_size(size)
        out.append(
            Configuration(
                computation_method=method,
                before_path=path,
                after_path=path,
                max_iterations=50,
                cloud_spread=10.0,
                max_distance_squared=10000.0,
                transformation_parameters=(0.2, 10.0),
                cloud_before_resize=size,
                cloud_after_resize=size,
                execution_policy=ExecutionPolicy.Sequential,
                approximation_type=ApproximationType.Hybrid,
                nicp_subcloud_size=1000,
                nicp_iterations=64,
                cpd_weight=0.1,
            )
        )
    return out


def get_convergence_test_set(method: ComputationMethod) -> List[Configuration]:
    """``GetConvergenceTestSet`` (``testset.cpp:119-187``): 5 repeats x
    size ladder x 9 (rotation, translation) combos."""
    params: Dict[ComputationMethod, Tuple[int, int, int]] = {
        ComputationMethod.Icp: (20000, 20000, 100000),
        ComputationMethod.Cpd: (4000, 4000, 20000),
        ComputationMethod.NoniterativeIcp: (250000, 250000, 1250000),
    }
    combos = [
        (r, t) for t in (10.0, 20.0, 30.0) for r in (0.2, 0.4, 0.6)
    ]
    out = []
    for _ in range(5):
        for size in _sweep(*params[method]):
            path = get_object_with_min_size(size)
            base = Configuration(
                computation_method=method,
                before_path=path,
                after_path=path,
                max_iterations=100,
                cloud_spread=10.0,
                max_distance_squared=10000.0,
                transformation_parameters=(0.2, 10.0),
                cloud_before_resize=size,
                cloud_after_resize=size,
                execution_policy=ExecutionPolicy.Parallel,
                approximation_type=(
                    ApproximationType.Hybrid
                    if method == ComputationMethod.Cpd
                    else ApproximationType.NONE
                ),
                nicp_subcloud_size=5000,
                nicp_batch_size=1,
                nicp_iterations=16,
                cpd_weight=0.1,
                cpd_tolerance=1e-4,
                # The reference generator builds Configuration structs
                # directly (testset.cpp:137), bypassing the parser, so the
                # STRUCT default CpdConstScale = true (configuration.h:34)
                # is in effect for its published convergence study — not
                # the parser default false.  Free scale collapses at
                # translation 30 (scale -> ~0.02, sigma^2 plateaus); const
                # scale converges every combo, matching the published
                # "> 0.9 throughout" (documentation.tex:626-642).
                cpd_const_scale=True,
            )
            for rot, trans in combos:
                out.append(
                    replace(base, transformation_parameters=(rot, trans))
                )
    return out


def get_noise_test_set(method: ComputationMethod) -> List[Configuration]:
    """The reference's 39-config noise/outlier robustness suite
    (``doc/noise/configs``) as a first-class test set — this method's
    slice at full size.  ``--test-set noise`` additionally writes the
    graded tier sidecar (``tpuslam_torch.harness.noise.run_noise_test_set``)."""
    from tpuslam_torch.harness.noise import get_noise_test_set as _gen

    return _gen(method)


TEST_SETS: Dict[str, Callable[[ComputationMethod], List[Configuration]]] = {
    "sizes": get_sizes_test_set,
    "performance": get_performance_test_set,
    "convergence": get_convergence_test_set,
    "noise": get_noise_test_set,
}
